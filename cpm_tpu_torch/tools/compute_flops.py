"""FLOPs and parameter count of a config's eval forward, on the port.

The counterpart of tools/scripts/compute_flops.py (same flags): builds the
port's model for `--cfg` on `--device` (cuda unless told cpu), runs one
eval forward on a seeded synthetic batch of one image at `--height` x
`--width`, and prints utils/measure.py::flops_and_params as JSON.

Usage: python -m cpm_tpu_torch.tools.compute_flops --cfg cfgs/... [--height H --width W]
"""

import argparse
import json


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--height", type=int, default=800)
    ap.add_argument("--width", type=int, default=1344)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from cpm_tpu_torch.config import get_default_cfg, merge_cfg_from_file
    from cpm_tpu_torch.data.synthetic import synthetic_batch
    from cpm_tpu_torch.modeling.model import build_model
    from cpm_tpu_torch.utils.measure import flops_and_params

    cfg = get_default_cfg()
    merge_cfg_from_file(args.cfg, target=cfg)
    model = build_model(cfg, args.device)
    batch = synthetic_batch(batch_size=1, height=args.height, width=args.width,
                            num_classes=cfg.MODEL.NUM_CLASSES, seed=0)
    stats = flops_and_params(cfg, model, batch["images"], batch["image_sizes"])
    print(json.dumps(stats, indent=2))
    return stats


if __name__ == "__main__":
    main()
