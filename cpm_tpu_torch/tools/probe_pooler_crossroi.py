"""The cross-roi shared-window RoIAlign kernel alone on one NVIDIA GPU.

    python3 -m cpm_tpu_torch.tools.probe_pooler_crossroi [--rois 1024] [--pool 7]
        [--channels 256]

Port of tools/probe_pooler_crossroi.py (`main`), with its shapes: one P2-sized
level `[2, 208, 336, C]` in bf16 and rois of areas 56^2 to 110^2 px with
aspect ratios 1/2 to 2 inside an 832x1344 image, the same numpy draws. For
G in {1, 2, 4, 8} rois per shared window it holds the kernel against its
plain version (`crossroi_roi_align_plain`) in f32 and bf16 and prints its
median CUDA-event time beside the plain version's and its bound; then the
times of the single-level kernel and of the multilevel kernel at one level on
the same map and rois, the reference points the JAX probe compares with.
Every line that holds a number ends with the card's name and power limit.

Tolerances: f32 atol 1e-5 (kernel and plain version weigh the same window
cells with the same weights and differ in the order of 16 sums per bin), bf16
rtol 1.6e-2 / atol 1e-2 (one bf16 rounding of an f32 sum).
"""

import argparse
import sys

import numpy as np
import torch

from cpm_tpu_torch.tools.bench_roi_align import cuda_ms
from cpm_tpu_torch.tools.probe_dcn_sampler import beyond, bound_of
from cpm_tpu_torch.tools.profile_eval import card_line

MAP_HW, BATCH, SCALE = (208, 336), 2, 0.25
GROUPS = (1, 2, 4, 8)
F32_ATOL = 1e-5
BF16_TOL = dict(rtol=1.6e-2, atol=1e-2)


def make_inputs(dev, rois=1024, channels=256, seed=0):
    """(map `[2, 208, 336, C]` f32, rois `[R, 5]`) as the JAX probe draws them."""
    rng = np.random.RandomState(seed)
    feat = rng.rand(BATCH, *MAP_HW, channels).astype(np.float32)
    r = np.zeros((rois, 5), np.float32)
    r[:, 0] = rng.randint(0, BATCH, rois)
    area = np.exp(rng.uniform(np.log(56.0**2), np.log(110.0**2), rois))
    aspect = np.exp(rng.uniform(np.log(0.5), np.log(2.0), rois))
    w = np.sqrt(area * aspect)
    h = np.sqrt(area / aspect)
    r[:, 1] = rng.rand(rois) * (1344 - w)
    r[:, 2] = rng.rand(rois) * (832 - h)
    r[:, 3] = r[:, 1] + w
    r[:, 4] = r[:, 2] + h
    return torch.from_numpy(feat).to(dev), torch.from_numpy(r).to(dev)


def weighed_cells(prep, group, map_shape):
    """How many map cells the call weighs: the distinct cells of `[B, H, W]`
    that some member's sample weighs non-zero, each in the window of its
    step's leader (roi i for step i), counted once over the call as
    `bench_roi_align.touched_cells` counts kernel 1's."""
    from cpm_tpu_torch.ops.roi_align import CROSSROI_WINDOW, _hat_axis

    b, h, w = (int(d) for d in map_shape[:3])
    n, window, dev = prep.batch.shape[0], CROSSROI_WINDOW, prep.batch.device

    def reached(pos):
        """[R, window]: the window cells that a roi's positions weigh."""
        cells, weights = _hat_axis(pos.float())
        hit = torch.zeros(n, window, dtype=torch.bool, device=dev)
        roi = torch.arange(n, device=dev)[:, None, None].expand_as(cells)
        hit[roi[weights > 0], cells[weights > 0]] = True
        return hit

    r, cy, cx = (reached(prep.ys)[:, :, None] & reached(prep.xs)[:, None, :]).nonzero().unbind(1)
    lead = r // group
    flat = ((prep.batch.long()[lead] * h + prep.y0.long()[lead] + cy) * w
            + prep.x0.long()[lead] + cx)
    seen = torch.zeros(b * h * w, dtype=torch.bool, device=dev)
    seen[flat] = True
    return int(seen.sum())


def crossroi_bound(prep, group, map_shape, elem_size, pool):
    """(bound ms, by): the map cells the call weighs (`weighed_cells`), read
    once; the origins and positions; the output written once; against a
    multiply-add per channel of every weighed cell of every sample."""
    from cpm_tpu_torch.ops.roi_align import _hat_axis

    n, channels = prep.batch.shape[0], int(map_shape[3])
    cells = weighed_cells(prep, group, map_shape)
    wy, wx = _hat_axis(prep.ys)[1], _hat_axis(prep.xs)[1]
    weighed = int(((wy > 0).sum(dim=(1, 2)) * (wx > 0).sum(dim=(1, 2))).sum())
    nbytes = (cells * channels * elem_size + n * 12 + (prep.ys.numel() + prep.xs.numel()) * 4
              + n * pool[0] * pool[1] * channels * elem_size)
    return bound_of(nbytes, weighed * channels * 2)


def check_group(feat, rois, group, pool, card, reps=20):
    """The kernel at `group` rois per window against its plain version, f32
    and bf16, with the bf16 times and bound. Raises on a disagreement."""
    from cpm_tpu_torch.ops.cuda.crossroi_roi_align import KERNEL
    from cpm_tpu_torch.ops.roi_align import (
        WindowedRois,
        crossroi_prep_rois,
        crossroi_roi_align_plain,
    )

    prep = crossroi_prep_rois(rois, SCALE, feat.shape[1:3], pool, 2)
    prep = WindowedRois(*(t.contiguous() for t in prep))

    def plain(f):
        return crossroi_roi_align_plain(f, prep, group, pool, 2)

    got = KERNEL(feat, prep, group, pool, 2)
    want = plain(feat)
    torch.cuda.synchronize()
    err32 = (got - want).abs().max().item()
    if not torch.isfinite(got).all() or err32 > F32_ATOL:
        raise AssertionError(f"cross-roi G={group}: f32 kernel vs plain max |err| {err32}")
    half = feat.to(torch.bfloat16)
    got = KERNEL(half, prep, group, pool, 2).float()
    want = plain(half.float()).to(torch.bfloat16).float()
    torch.cuda.synchronize()
    err16 = (got - want).abs().max().item()
    bad = beyond(got, want, **BF16_TOL)
    if bad:
        raise AssertionError(f"cross-roi G={group}: bf16 {bad} elements beyond {BF16_TOL}")
    del got, want
    ms = cuda_ms(lambda: KERNEL(half, prep, group, pool, 2), reps)
    plain_ms = cuda_ms(lambda: plain(half), 5)
    bound_ms, bound_by = crossroi_bound(prep, group, feat.shape, 2, pool)
    print(f"[kernel] crossroi_roi_align G={group}: map {tuple(feat.shape)} R={rois.shape[0]} "
          f"pool={pool} f32 max|err|={err32:.3g} (atol {F32_ATOL}) bf16 max|err|={err16:.3g} "
          f"(rtol {BF16_TOL['rtol']}, atol {BF16_TOL['atol']}) bf16 kernel {ms:.4f} ms "
          f"({ms / rois.shape[0] * 1e3:.3f} us/roi), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} "
          f"ms ({bound_by}) | {card}")
    return dict(group=group, err=err32, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def reference_points(feat, rois, pool, card, reps=20):
    """(single-level kernel ms, multilevel kernel at one level ms) on the same
    bf16 map and rois: what the shared-window numbers are read against."""
    from cpm_tpu_torch.ops.cuda import multilevel_roi_align, roi_align

    half = feat.to(torch.bfloat16)
    n = rois.shape[0]
    levels = torch.zeros(n, dtype=torch.int32, device=rois.device)
    valid = torch.ones(n, dtype=torch.bool, device=rois.device)
    f32 = feat.float().contiguous()
    single = cuda_ms(lambda: roi_align.KERNEL(f32, rois, pool, SCALE, 2), reps)
    multi = cuda_ms(lambda: multilevel_roi_align.KERNEL([half], rois, levels, valid, pool,
                                                       (SCALE,), 2), reps)
    print(f"[kernel] same map and rois: single-level kernel (f32) {single:.4f} ms, multilevel "
          f"kernel at one level (bf16) {multi:.4f} ms | {card}")
    return single, multi


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rois", type=int, default=1024)
    ap.add_argument("--pool", type=int, default=7)
    ap.add_argument("--channels", type=int, default=256)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("probe_pooler_crossroi: needs a CUDA device")
    card = card_line()
    pool = (args.pool, args.pool)
    feat, rois = make_inputs("cuda", args.rois, args.channels)
    single, multi = reference_points(feat, rois, pool, card)
    results = [check_group(feat, rois, g, pool, card) for g in GROUPS]
    for r in results:
        print(f"G={r['group']}: {results[0]['ms'] / r['ms']:.2f}x vs G=1, {multi / r['ms']:.2f}x vs "
              f"the multilevel kernel, {single / r['ms']:.2f}x vs the single-level kernel | {card}")


if __name__ == "__main__":
    main()
