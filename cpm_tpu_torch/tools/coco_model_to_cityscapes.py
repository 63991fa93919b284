"""Remap a COCO-trained checkpoint's class heads for Cityscapes fine-tuning.

The counterpart of tools/scripts/coco_model_to_cityscapes.py on the port's
checkpoints (engine/checkpoint.py): every model tensor whose class axis is
NUM_COCO_CLS (81) or 4 * NUM_COCO_CLS wide is remapped to the 9 Cityscapes
classes. Rows with a COCO <-> Cityscapes correspondence are copied; the
others are drawn from a Gaussian with the source tensor's mean and std (the
reference's tools/rcnn/scripts/convert_coco_model_to_cityscapes.py). In
torch the class axis is dim 0 of a Linear's or Conv's `[out, in, ...]`
weight and of its bias, the reference's layout (flax's kernels carry it
last). The optimizer's per-parameter state is dropped, since its class-sized
buffers no longer fit, so fine-tuning starts its momentum afresh; the step
and the samplers' draws are kept.

Usage:
  python -m cpm_tpu_torch.tools.coco_model_to_cityscapes --ckpt <dir> --out <dir>
"""

import argparse
import os

import numpy as np

NUM_COCO_CLS = 81
# Cityscapes class -> COCO contiguous class; 0 is the background (the
# reference script's cityscapes_to_coco)
CITYSCAPES_TO_COCO = {
    0: 0,  # background
    1: 1,  # person
    2: 1,  # rider -> person
    3: 3,  # car
    4: 8,  # truck
    5: 6,  # bus
    6: 7,  # train
    7: 4,  # motorcycle
    8: 2,  # bicycle
}
NUM_CS_CLS = len(CITYSCAPES_TO_COCO)


def remap_class_axis(arr: np.ndarray, factor: int, mapping=CITYSCAPES_TO_COCO) -> np.ndarray:
    """Remap dim 0, NUM_COCO_CLS * factor wide and class-major, from COCO
    to Cityscapes. A class that `mapping` sends to a negative COCO class is
    drawn from N(mean, std) of the whole source tensor (RandomState(0), as
    the JAX tool draws)."""
    shaped = arr.reshape((NUM_COCO_CLS, factor) + arr.shape[1:])
    mean, std = shaped.mean(), shaped.std()
    rng = np.random.RandomState(0)
    out = (rng.randn(*((len(mapping), factor) + arr.shape[1:])) * std + mean).astype(arr.dtype)
    for cs_id, coco_id in mapping.items():
        if coco_id >= 0:
            out[cs_id] = shaped[coco_id]
    return out.reshape((len(mapping) * factor,) + arr.shape[1:])


def convert_state_dict(state_dict, log=print):
    """The model's state_dict with every class-sized tensor remapped."""
    import torch

    out = {}
    for name, t in state_dict.items():
        rows = t.shape[0] if t.dim() else 0
        if t.is_floating_point() and rows in (NUM_COCO_CLS, 4 * NUM_COCO_CLS):
            factor = rows // NUM_COCO_CLS
            new = remap_class_axis(t.detach().cpu().numpy(), factor)
            log(f"remapping {'class' if factor == 1 else 'box'} blob {name} "
                f"{tuple(t.shape)} -> {new.shape}")
            t = torch.from_numpy(new).to(t.device)
        out[name] = t
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True, help="checkpoint directory (its model_latest)")
    ap.add_argument("--out", required=True, help="output checkpoint directory")
    args = ap.parse_args(argv)

    import torch

    src = os.path.join(args.ckpt, "model_latest")
    if not os.path.exists(src):
        raise FileNotFoundError(f"no checkpoint under {args.ckpt}")
    payload = torch.load(src, map_location="cpu", weights_only=True)
    payload["model"] = convert_state_dict(payload["model"])
    payload["optimizer"] = dict(payload["optimizer"], state={})
    os.makedirs(args.out, exist_ok=True)
    dst = os.path.join(args.out, "model_latest")
    torch.save(payload, f"{dst}.tmp")
    os.replace(f"{dst}.tmp", dst)
    print(f"wrote remapped checkpoint to {args.out}")
    return payload


if __name__ == "__main__":
    main()
