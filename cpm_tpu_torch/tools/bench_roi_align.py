"""Microbenchmark of every multilevel RoIAlign backend on one NVIDIA GPU.

    python3 -m cpm_tpu_torch.tools.bench_roi_align [--rois 768] [--pool 14]
        [--channels 256] [--dtype bfloat16] [--valid-frac 1.0]

Port of tools/bench_roi_align.py, with its arguments and its shapes: the four
FPN levels of the 832x1344 training bucket at batch 2, rois of areas across
all levels with aspect ratios up to 4, levels from the level mapper. It times
the forward and the forward plus backward of the plain gather formulation
and of the three kernel backends (multilevel, stacked, clustered) through the
functions the `Pooler` calls, so the clustered path's grouping is inside its
times, and the single-level op on the C4 map of the same bucket. The stacked
path makes its stack once for each set of maps, as the five pooler calls of a
forward share it: its forward times reuse the stack of the maps they repeat
on, its forward-plus-backward times (fresh leaves each call) build it each
call. Times are medians of CUDA-event pairs; every
line that holds a number ends with the card's name and power limit.
"""

import argparse
import statistics
import sys

import numpy as np
import torch

from cpm_tpu_torch.tools.profile_eval import card_line

SHAPES = [(208, 336), (104, 168), (52, 84), (26, 42)]
SCALES = (0.25, 0.125, 0.0625, 0.03125)
C4_SHAPE, C4_SCALE = (52, 84), 0.0625


def make_rois(rng, num, batch):
    """[num, 5] rois as the JAX tool draws them: areas from 16^2 to 600^2,
    aspect ratios from 1/4 to 4, inside an 832x1344 image."""
    rois = np.zeros((num, 5), np.float32)
    rois[:, 0] = rng.randint(0, batch, num)
    area = np.exp(rng.uniform(np.log(16.0**2), np.log(600.0**2), num))
    aspect = np.exp(rng.uniform(np.log(0.25), np.log(4.0), num))
    w = np.sqrt(area * aspect)
    h = np.sqrt(area / aspect)
    rois[:, 1] = rng.rand(num) * (1344 - w)
    rois[:, 2] = rng.rand(num) * (832 - h)
    rois[:, 3] = rois[:, 1] + w
    rois[:, 4] = rois[:, 2] + h
    return rois


def cuda_ms(fn, iters=30):
    """Median CUDA-event time of fn() in ms, after two warm-up calls."""
    fn()
    fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def touched_cells(shapes, rois, levels, valid, pool, scales=SCALES):
    """How many level cells the valid rois read: those that receive a
    non-zero gradient from an all-ones output gradient, counted with the
    plain backward at C=1."""
    from cpm_tpu_torch.ops.cuda.multilevel_roi_align import plain_multilevel_roi_align_backward

    ones = torch.ones((rois.shape[0], *pool, 1), device=rois.device)
    touched = plain_multilevel_roi_align_backward(
        [(*s[:3], 1) for s in shapes], rois, levels, valid, ones, scales, 2)
    return sum(int((t != 0).sum()) for t in touched)


def roi_align_bounds(shapes, rois, levels, valid, pool, elem_size, scales=SCALES):
    """((forward bound ms, by), (backward bound ms, by)) of one multilevel
    RoIAlign call on these inputs, `by` 'bytes' or 'operations'. Forward: the
    level cells the rois touch, the rois, level ids and mask read, the output
    written; backward: the valid rois' rows of `g` and the rois read, every
    level map's gradient written once. One multiply-add per channel of each of
    a valid sample's four cells."""
    from cpm_tpu_torch.tools.probe_dcn_sampler import bound_of

    channels = shapes[0][3]
    cells = touched_cells(shapes, rois, levels, valid, pool, scales)
    n, n_valid = rois.shape[0], int(valid.sum())
    bins = pool[0] * pool[1]
    roi_bytes = n * (5 * 4 + 4 + 1)
    out_bytes = n * bins * channels * elem_size
    fwd_bytes = cells * channels * elem_size + roi_bytes + out_bytes
    map_bytes = sum(s[0] * s[1] * s[2] for s in shapes) * channels * elem_size
    bwd_bytes = n_valid * bins * channels * elem_size + roi_bytes + map_bytes
    flops = n_valid * bins * 4 * 4 * channels * 2  # samples x cells x (mul, add)
    return bound_of(fwd_bytes, flops), bound_of(bwd_bytes, flops)


def clustered_bound(shapes, rois, levels, valid, pool, elem_size, grouping, scales=SCALES):
    """(ms, by) of the clustered forward: every group's rectangle read once (a
    singleton whose rectangle exceeds the tile reads the cells it touches),
    the rois, the grouping arrays, and the output written once."""
    from cpm_tpu_torch.ops.roi_align import TILE
    from cpm_tpu_torch.tools.probe_dcn_sampler import bound_of

    channels = shapes[0][3]
    g = grouping.groups.long()
    fits = (g[:, 6] <= TILE) & (g[:, 7] <= TILE)
    cells = int((g[:, 6] * g[:, 7])[fits & (g[:, 1] > 0)].sum())
    # the members of the groups beyond the tile: all singletons
    big = torch.zeros_like(valid)
    big[grouping.order.long()[g[~fits & (g[:, 1] > 0), 0]]] = True
    if big.any():
        cells += touched_cells(shapes, rois, levels, big, pool, scales)
    n, n_valid = rois.shape[0], int(valid.sum())
    bins = pool[0] * pool[1]
    nbytes = (cells * channels * elem_size + n * (5 * 4 + 1) + n * 4 + n * 8 * 4
              + n * bins * channels * elem_size)
    return bound_of(nbytes, n_valid * bins * 4 * 4 * channels * 2)


def grouping_bound(num_rois):
    """(ms, by) of grouping `num_rois` rois: the rois, level ids and mask
    read, the order, group rows, slot groups and group count written."""
    from cpm_tpu_torch.tools.probe_dcn_sampler import bound_of

    return bound_of(num_rois * (5 * 4 + 4 + 1) + num_rois * (4 + 8 * 4 + 8) + 8, 0)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rois", type=int, default=768)
    ap.add_argument("--pool", type=int, default=14)
    ap.add_argument("--channels", type=int, default=256)
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument(
        "--valid-frac", type=float, default=1.0,
        help="fraction of rois marked valid (what the kernels save on padding: the "
        "training sites run fixed-size roi sets that are partly masked)",
    )
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("bench_roi_align: needs a CUDA device")

    from cpm_tpu_torch.ops.cuda.clustered_roi_align import multilevel_roi_align_clustered
    from cpm_tpu_torch.ops.cuda.multilevel_roi_align import multilevel_roi_align
    from cpm_tpu_torch.ops.cuda.roi_align import roi_align_cuda
    from cpm_tpu_torch.ops.cuda.stacked_roi_align import multilevel_roi_align_stacked
    from cpm_tpu_torch.ops.pooler import assign_fpn_levels
    from cpm_tpu_torch.ops.roi_align import multilevel_roi_align as plain_gather
    from cpm_tpu_torch.ops.roi_align import roi_align as plain_roi_align

    card = card_line()
    dev = "cuda"
    batch, channels = 2, args.channels
    pool = (args.pool, args.pool)
    dtype = getattr(torch, args.dtype)
    rng = np.random.RandomState(0)
    feats = [torch.from_numpy(rng.rand(batch, h, w, channels).astype(np.float32)).to(dev, dtype)
             for h, w in SHAPES]
    rois = torch.from_numpy(make_rois(rng, args.rois, batch)).to(dev)
    levels = assign_fpn_levels(rois[:, 1:5], 2, 5) - 2
    n_valid = max(1, int(round(args.rois * args.valid_frac)))
    valid = torch.arange(args.rois, device=dev) < n_valid
    print(f"# {args.rois} rois ({n_valid} valid), pool {pool}, C={channels}, {args.dtype}, "
          f"levels {SHAPES} at batch {batch} | {card}")

    def gather(fs):
        out = plain_gather(fs, rois, levels, pool, SCALES, 2)
        return out * valid.to(out.dtype)[:, None, None, None]

    backends = {
        "plain gather": gather,
        "multilevel kernels": lambda fs: multilevel_roi_align(fs, rois, levels, valid, pool, SCALES, 2),
        "stacked kernels": lambda fs: multilevel_roi_align_stacked(
            fs, rois, levels, valid, pool, SCALES, 2),
        "clustered kernel": lambda fs: multilevel_roi_align_clustered(
            fs, rois, levels, valid, pool, SCALES, 2),
    }
    g = torch.randn(args.rois, *pool, channels, device=dev).to(dtype)

    def forward_backward(fn):
        fs = [f.detach().requires_grad_() for f in feats]
        fn(fs).backward(g)

    times = {}
    for name, fn in backends.items():
        with torch.no_grad():
            fwd = cuda_ms(lambda: fn(feats))
        both = cuda_ms(lambda: forward_backward(fn), iters=10 if name == "plain gather" else 30)
        times[name] = (fwd, both)
        print(f"{name:22s} fwd {fwd:8.4f} ms   fwd+bwd {both:8.4f} ms | {card}")
    base = times["multilevel kernels"]
    for name in ("plain gather", "stacked kernels", "clustered kernel"):
        print(f"multilevel kernels vs {name}: fwd {times[name][0] / base[0]:.2f}x   "
              f"fwd+bwd {times[name][1] / base[1]:.2f}x | {card}")

    with torch.no_grad():
        outs = {name: fn(feats).float() for name, fn in backends.items()}
    for name in ("multilevel kernels", "stacked kernels", "clustered kernel"):
        err = (outs[name] - outs["plain gather"]).abs().max().item()
        print(f"max |plain gather - {name}| on the card: {err:.2e} | {card}")

    # the single-level op on the bucket's C4 map (1024 channels, float32 out)
    c4 = torch.from_numpy(rng.rand(batch, *C4_SHAPE, 1024).astype(np.float32)).to(dev, dtype)
    with torch.no_grad():
        fwd = cuda_ms(lambda: roi_align_cuda(c4, rois, pool, C4_SCALE, 2))
        few = rois[:64].contiguous()
        err = (roi_align_cuda(c4, few, pool, C4_SCALE, 2)
               - plain_roi_align(c4.float(), few, pool, C4_SCALE, 2)).abs().max().item()
    g4 = torch.randn(args.rois, *pool, 1024, device=dev)

    def single_forward_backward():
        f = c4.detach().requires_grad_()
        roi_align_cuda(f, rois, pool, C4_SCALE, 2).backward(g4)

    both = cuda_ms(single_forward_backward)
    print(f"{'single-level kernel C4':22s} fwd {fwd:8.4f} ms   fwd+bwd {both:8.4f} ms "
          f"(map {tuple(c4.shape)} {args.dtype}, cast to float32 inside; max |plain - kernel| "
          f"over 64 rois {err:.2e}) | {card}")


if __name__ == "__main__":
    main()
