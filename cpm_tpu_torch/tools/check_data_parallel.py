"""N data-parallel ranks held against one process on the same global batch.

    python3 -m cpm_tpu_torch.tools.check_data_parallel [--ranks N]
        [--device cuda|cpu] [--cfg file.yaml] [--steps S] [KEY VALUE ...]

The model of a YAML (by default the headline CPM R-50-FPN YAML,
e2e_grid_cascade@56_rcnn_R-50-FPN_2x.yaml) at its full width, in f32 with TF32
off, over the repository's synthetic COCO set, from a seeded step-0 state
whose frozen affines are folded from the first batch of N images of the
port's TrainLoader (a random trunk with unit affines diverges). One process
takes a step on those N images; then N ranks, spawned by
parallel/launch.py, take S steps on one image each: one card each over NCCL
(`cuda:rank`, so N cards must be visible), or on the CPU over gloo
(`hold_ranks`). The ranks' first step is held against the one process's
(LOSS_RTOL; PARAM_RTOL / PARAM_ATOL), and their parameters must be bit-equal
after every step. It prints, beside the card's name and power limit, the
largest differences, each rank's step wall times, and of the last step the
number of torch.distributed calls and their host time, the
`train_step/allreduce` span on the host clock and the NCCL kernels' device
time (torch.profiler); any failure raises. chip_smoke.py's phase 16 runs
`hold_ranks` with two ranks sharing one card over gloo.
"""

import argparse
import math
import os
import sys
import tempfile
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
HEADLINE_YAML = ("cfgs/rcnn/mscoco/grid_cascade/iou_helper/rescore/"
                 "e2e_grid_cascade@56_rcnn_R-50-FPN_2x.yaml")
# the synthetic set and the YAML's 0.02 for 16 images scaled to 2, as the CLIs' cell
OPTS = ["TRAIN.DATASETS", "('coco_debug_synthetic',)", "SOLVER.BASE_LR", "0.0025",
        "TPU.COMPUTE_DTYPE", "float32"]
# the ranks' first step against one process's on the same images and draws,
# f32 with TF32 off: cuDNN picks other algorithms for batch 1 than for batch
# N, and the ranks' gradients are summed in another order
LOSS_RTOL = 1e-4
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-6


def step0_state(cfg, device, n_images: int):
    """(the train state from cfg.SEED with its frozen affines folded from the
    loader's first batch of n_images, that batch)."""
    from cpm_tpu_torch.data.coco import build_dataset
    from cpm_tpu_torch.data.loader import TrainLoader
    from cpm_tpu_torch.engine.train import create_train_state
    from cpm_tpu_torch.tools.profile_train import fold_batch_statistics

    _, _, state = create_train_state(cfg, device, cfg.SEED)
    (dataset,) = build_dataset(cfg, cfg.TRAIN.DATASETS, is_train=True)
    batch = next(iter(TrainLoader(cfg, dataset, n_images, seed=cfg.SEED, prefetch=0)))
    fold_batch_statistics(state.model, batch["images"])
    return state, batch


def check_ranks(one: dict, ranks: list, what: str):
    """Raise unless the ranks' losses are finite and their parameters and
    losses bit-equal after every step, and their first step is within
    LOSS_RTOL / PARAM_RTOL / PARAM_ATOL of the one process's (`train_steps`
    results; rank 0 and the one process keep their parameters after step 1).
    Returns (the largest relative loss difference, the largest parameter
    difference)."""
    for r, out in enumerate(ranks):
        for m in out["metrics"]:
            if not all(math.isfinite(v) for v in m.values()):
                raise AssertionError(f"{what}: rank {r}'s losses {m}")
        if (out["digests"], out["metrics"]) != (ranks[0]["digests"], ranks[0]["metrics"]):
            raise AssertionError(f"{what}: rank {r}'s parameters or losses differ from rank 0's")
    want, got = one["metrics"][0], ranks[0]["metrics"][0]
    names = [k for k in want if k.startswith("loss_") or k == "total_loss"]
    if sorted(got) != sorted(want):
        raise AssertionError(f"{what}: the ranks' losses {sorted(got)}, one process's "
                             f"{sorted(want)}")
    worst_loss = max(abs(got[k] - want[k]) / abs(want[k]) for k in names)
    if worst_loss > LOSS_RTOL:
        raise AssertionError(f"{what}: the ranks' losses {got} vs one process's {want}")
    worst_param = 0.0
    for k, w in one["params"][1].items():
        d = (ranks[0]["params"][1][k] - w).abs()
        worst_param = max(worst_param, d.max().item())
        if (d > PARAM_ATOL + PARAM_RTOL * w.abs()).any():
            raise AssertionError(f"{what}: parameter {k} after step 1 differs by {d.max().item()}")
    return worst_loss, worst_param


def rank_steps(rank, world_size, workdir, spec, **overrides):
    """A spawned rank: `train_steps` on `spec` (a dict, or the path of one
    saved with torch.save) updated with `overrides`, with TF32 off, as in
    the parent (a new process starts with cuDNN's TF32 on, which moves the
    losses by 1e-3); rank 0 alone returns its parameters."""
    from cpm_tpu_torch.parallel.launch import train_steps

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if isinstance(spec, str):
        spec = torch.load(spec, weights_only=False)
    spec = dict(spec, **overrides)
    if rank > 0:
        spec["params_after"] = ()
    return train_steps(rank, world_size, workdir, spec)


def hold_ranks(spec: dict, world_size: int, steps: int, what: str, rank_fn=rank_steps,
               timeout_s: float = 900) -> dict:
    """One process's step on the spec's global batch (`train_steps`' spec:
    cfg, device, seed, batch, state_dict), then `world_size` spawned ranks of
    `rank_fn` (`rank_steps`, or a function that calls it), each taking
    `steps` steps on its rows, the last profiled; raises unless
    `check_ranks` holds. The ranks read the spec from one file (pickling
    the weights into each child's arguments costs seconds a rank). Returns
    `one` and `ranks` (their results), `worst_loss`, `worst_param` and
    `spawn_s` (the spawn to the ranks' results)."""
    from cpm_tpu_torch.parallel.launch import spawn_ranks, train_steps

    one = train_steps(0, 1, None, dict(spec, steps=1, params_after=(1,)))
    if spec["device"] == "cuda":
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="cpm_dp_spec_") as tmp:
        path = os.path.join(tmp, "spec.pt")
        torch.save(dict(spec, steps=steps, params_after=(1,), profile_step=steps), path)
        t0 = time.perf_counter()
        ranks = spawn_ranks(rank_fn, world_size, path, timeout_s=timeout_s)
        spawn_s = time.perf_counter() - t0
    worst_loss, worst_param = check_ranks(one, ranks, what)
    return dict(one=one, ranks=ranks, worst_loss=worst_loss, worst_param=worst_param,
                spawn_s=spawn_s)


def ms(seconds) -> str:
    return "not measured" if seconds is None else f"{seconds * 1e3:.1f} ms"


def main(argv=None):
    from cpm_tpu_torch.tools.train_net import load_config

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cfg", default=os.path.join(REPO, HEADLINE_YAML))
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("opts", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no card (pass --device cpu to run on the CPU)")
    if cuda and torch.cuda.device_count() < args.ranks:
        raise RuntimeError(f"{args.ranks} ranks, one card each, and "
                           f"{torch.cuda.device_count()} cards are visible")
    card = "cpu"
    if cuda:
        from cpm_tpu_torch.tools.profile_eval import card_line

        card = card_line()
    cfg = load_config(args.cfg, OPTS + ["DATA_DIR", os.path.join(REPO, "data")] + args.opts)
    n = args.ranks
    t0 = time.perf_counter()
    state, batch = step0_state(cfg, args.device, n)
    weights = {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()}
    spec = dict(cfg=cfg, device=args.device, seed=cfg.SEED, batch=batch, state_dict=weights)
    del state
    if cuda:
        torch.cuda.empty_cache()
    held = hold_ranks(spec, n, args.steps, f"[dp check] {n} ranks")
    one, ranks = held["one"], held["ranks"]
    print(f"[dp check] {n} ranks ({'NCCL, a card each' if cuda else 'gloo'}), one image each, "
          f"against one process on the batch of {n} on {'cuda:0' if cuda else 'the CPU'} "
          f"({os.path.basename(args.cfg)}, f32, TF32 off): step-1 losses within "
          f"{held['worst_loss']:.3g} relative (bound {LOSS_RTOL}), parameters within "
          f"{held['worst_param']:.3g} (rtol {PARAM_RTOL}, atol {PARAM_ATOL}); the ranks "
          f"bit-equal after each of {args.steps} steps | {card}")
    for r, out in enumerate(ranks):
        print(f"[dp check] rank {r}: step wall times "
              f"{[round(s * 1e3, 1) for s in out['step_s']]} ms; step {args.steps}: "
              f"{out['collectives']} torch.distributed calls taking {ms(out['collective_s'])} "
              f"on the host clock, the train_step/allreduce span {ms(out['allreduce_s'])}, NCCL "
              f"kernels {ms(out['nccl_s'])} of device time | {card}")
    print(f"[dp check] the one process's step on {n} images {one['step_s'][0] * 1e3:.1f} ms (its "
          f"first); the ranks' spawn to their results {held['spawn_s']:.1f} s; all "
          f"{time.perf_counter() - t0:.1f} s | {card}")


if __name__ == "__main__":
    main(sys.argv[1:])
