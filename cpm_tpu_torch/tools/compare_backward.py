"""The two backward kernels of the port's training steps against an older tree's, on one GPU.

    python3 -m cpm_tpu_torch.tools.compare_backward --parent build/parent

`--parent` is an unpacked copy of an earlier commit of this repository (for
example `git archive HEAD | tar -x -C build/parent` before a change). The tool
captures what the deformable-conv sampler's backward (30 calls) is given in
one training step of CPM X-101-32x4d-FPN-DCN and what the multilevel RoIAlign
backward (5 calls) is given in one training step of the flagship CPM
R-50-FPN, both at the operating point of `profile_train.training_cfg` (batch
2 at 800x1344, bf16, seeded random weights, offset convs spread, affines
folded). Then it times the backward wrapper of this tree and of the parent
tree on those inputs, in turns (parent, this, this, parent), each call the
median of CUDA-event times, summed over the sites, and prints the sums beside
their bounds (`probe_dcn_sampler.sampler_bounds`, `roi_align_backward_bound`),
this tree's sampler backward in its parts (the binning kernels alone, the map
gradient alone, the coordinate gradients alone) and the binning's plain
version; `torch.profiler` then breaks this tree's calls down by kernel.

The random-weight step's rois spread: its proposals are random and its
positives are mostly the appended gt boxes. A trained model's positives crowd
on the objects, so the RoIAlign backward is also timed on two crowded
versions of its five sites (`crowded_sites`: the captured shapes, mask and
`g`, new rois): `coco`, one box over most of the image beside four smaller
ones, as a COCO image often has, and `one object`, every positive on one
120x100 box. The parent's wrappers and sources are loaded from its tree; its
kernels are built like this tree's, into `build/`.

Every line that holds a number ends with the card's name and power limit.
"""

import argparse
import contextlib
import importlib.util
import sys
from pathlib import Path

import numpy as np
import torch

from cpm_tpu_torch.ops.deform_conv import window_tiles
from cpm_tpu_torch.tools.bench_roi_align import cuda_ms
from cpm_tpu_torch.tools.probe_dcn_sampler import bound_of, sampler_bounds
from cpm_tpu_torch.tools.profile_eval import card_line

SCALES = (0.25, 0.125, 0.0625, 0.03125)
IMAGE_HW = (800, 1344)
# gt boxes (x1, y1, x2, y2) of the crowded layouts, and the share of the
# positives each draws
CROWDS = {
    "coco": ([(60, 40, 1290, 770), (700, 300, 1000, 550), (200, 500, 290, 570),
              (1100, 100, 1140, 130), (400, 200, 424, 220)], (0.5, 0.2, 0.1, 0.1, 0.1)),
    "one object": ([(600, 350, 720, 450)], (1.0,)),
}


def roi_align_backward_bound(shapes, rois, valid, g):
    """(ms, by) for one multilevel RoIAlign backward: the valid rois' rows of
    `g` read, the rois, level ids and mask read, every level map's gradient
    written once; one multiply-add per channel of each of a valid sample's
    four cells."""
    e = g.element_size()
    n_valid = int(valid.sum())
    bins, channels = g.shape[1] * g.shape[2], g.shape[3]
    maps = sum(s[0] * s[1] * s[2] for s in shapes) * channels * e
    nbytes = n_valid * bins * channels * e + rois.shape[0] * (5 * 4 + 4 + 1) + maps
    return bound_of(nbytes, n_valid * bins * 4 * 4 * channels * 2)


@contextlib.contextmanager
def capture(owner, name, keep):
    """While open, every call of `owner.name` first appends keep(*args)."""
    calls, real = [], getattr(owner, name)

    def wrapper(*args, **kwargs):
        calls.append(keep(*args))
        return real(*args, **kwargs)

    setattr(owner, name, wrapper)
    try:
        yield calls
    finally:
        setattr(owner, name, real)


def captured_step(config, owner, keep):
    """The calls of owner.backward in one training step of `config`, after a
    warm-up step."""
    from cpm_tpu_torch.data.synthetic import synthetic_batch
    from cpm_tpu_torch.engine.train import create_train_state, make_train_step
    from cpm_tpu_torch.tools.profile_train import (
        fold_batch_statistics,
        spread_offset_convs,
        training_cfg,
    )

    cfg = training_cfg(config)
    model, optimizer, state = create_train_state(cfg, "cuda", seed=0)
    spread_offset_convs(model, seed=1)
    step_fn = make_train_step(cfg, model, optimizer)

    def batch_for(seed):
        return synthetic_batch(2, 800, 1344, max_gt=32, num_classes=cfg.MODEL.NUM_CLASSES,
                               seed=seed, uint8=True)

    fold_batch_statistics(model, batch_for(99)["images"])
    state, _ = step_fn(state, batch_for(100))
    with capture(owner, "backward", keep) as calls:
        step_fn(state, batch_for(101))
        torch.cuda.synchronize()
    del model, optimizer, state, step_fn
    torch.cuda.empty_cache()
    return calls


def load_parent(parent: Path, name: str):
    """The parent tree's wrapper module `ops/cuda/<name>.py`, reading its
    own source."""
    spec = importlib.util.spec_from_file_location(
        f"parent_{name}", parent / "cpm_tpu_torch" / "ops" / "cuda" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.SOURCE = parent / "cpm_tpu_torch" / "csrc" / f"{name}.cu"
    mod.KERNEL = type(mod.KERNEL)()
    return mod


def crowded_sites(sites, crowd, seed=0):
    """The RoIAlign backward's captured sites with new rois that crowd on the
    gt boxes of CROWDS[crowd], in both images: a quarter of the valid rois of
    a 7x7 site (the sampler's positive fraction) and every roi of a 14x14
    grid-stage site, all valid (a stage pools up to GRID_RCNN.
    MAX_SAMPLE_NUM_GRID positives an image, which a trained model fills; the
    random-weight step has about ten), are copies of a gt box,
    each side moved by up to 6% of the box's size (IoU above 0.6); the other
    rois are boxes drawn over the image. Levels by the FPN rule, as the pooler
    assigns them."""
    from cpm_tpu_torch.ops.pooler import assign_fpn_levels

    boxes, shares = CROWDS[crowd]
    boxes = np.array(boxes, np.float32)
    rng = np.random.RandomState(seed)
    height, width = IMAGE_HW
    out = []
    for shapes, rois, _, valid, g in sites:
        n = rois.shape[0]
        stage = g.shape[1] != 7
        positive = rng.rand(n) < (1.0 if stage else 0.25)
        if stage:
            valid = torch.ones_like(valid)
        which = rng.choice(len(boxes), n, p=shares)
        size = np.tile(boxes[which, 2:] - boxes[which, :2], 2)
        jittered = boxes[which] + rng.uniform(-0.06, 0.06, (n, 4)).astype(np.float32) * size
        wh = rng.uniform(16, 600, (n, 2)).astype(np.float32)
        x1 = rng.uniform(0, width - wh[:, 0])
        y1 = rng.uniform(0, height - wh[:, 1])
        drawn = np.stack([x1, y1, x1 + wh[:, 0], y1 + wh[:, 1]], 1).astype(np.float32)
        coords = torch.from_numpy(np.where(positive[:, None], jittered, drawn)).to(rois.device)
        new = torch.cat([rois[:, :1], coords], 1).contiguous()
        levels = (assign_fpn_levels(coords, 2, 5) - 2).int()
        out.append((shapes, new, levels, valid, g))
    return out


def kernel_breakdown(label, sites, run, card):
    """Device time of each CUDA kernel over one run of every site
    (torch.profiler), the largest first."""
    from torch.profiler import ProfilerActivity, profile

    for site in sites:
        run(*site)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for site in sites:
            run(*site)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda e: -e.self_device_time_total)
    for e in rows[:8]:
        print(f"[kernels] {label}: {e.self_device_time_total / 1e3:.4f} ms in {e.count} launches "
              f"over {len(sites)} calls, {e.key[:90]} | {card}")


def in_turns(label, sites, runners, card, reps):
    """Sum over the sites of each runner's median time, in the order
    parent, this, this, parent (then any other runner once). Returns
    {runner: [sums]}."""
    order = ["parent", "this", "this", "parent"] + [k for k in runners if k not in ("parent", "this")]
    sums = {k: [] for k in runners}
    for who in order:
        run = runners[who]
        total = sum(cuda_ms(lambda: run(*site), reps) for site in sites)
        sums[who].append(total)
        print(f"[turn] {label} {who}: {total:.4f} ms over {len(sites)} calls | {card}")
    return sums


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("compare_backward: needs a CUDA device")
    from cpm_tpu_torch.ops.cuda import deform_sample, multilevel_roi_align

    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    parent = args.parent.resolve()
    old_sampler = load_parent(parent, "deform_sample")
    old_pooler = load_parent(parent, "multilevel_roi_align")

    def keep_sampler(feat, ys, xs, g, *_):
        return feat.detach().clone(), ys.clone(), xs.clone(), g.clone()

    def keep_pooler(shapes, rois, levels, valid, g, *_):
        return [tuple(s) for s in shapes], rois.clone(), levels.clone(), valid.clone(), g.clone()

    sampler_sites = captured_step("x101_dcn", deform_sample.KERNEL, keep_sampler)
    pooler_sites = captured_step("flagship", multilevel_roi_align.KERNEL, keep_pooler)
    print(f"[sites] {len(sampler_sites)} sampler backward calls of one X-101-DCN step, "
          f"{len(pooler_sites)} RoIAlign backward calls of one flagship step, {sampler_sites[0][3].dtype}")

    sampler = {"parent": old_sampler.KERNEL.backward, "this": deform_sample.KERNEL.backward,
               "this, map gradient only": lambda *a: deform_sample.KERNEL.backward(
                   *a, need_coords=False),
               "this, coordinate gradients only": lambda *a: deform_sample.KERNEL.backward(
                   *a, need_map=False)}
    pooler = {"parent": lambda *a: old_pooler.KERNEL.backward(*a, SCALES, 2),
              "this": lambda *a: multilevel_roi_align.KERNEL.backward(*a, SCALES, 2)}
    # the parent's and this tree's results on the first site of each
    got = deform_sample.KERNEL.backward(*sampler_sites[0])
    old = old_sampler.KERNEL.backward(*sampler_sites[0])
    diffs = [(a.float() - b.float()).abs().max().item() for a, b in zip(got, old)]
    print(f"[check] sampler site 0: this vs parent max |diff| map {diffs[0]:.3g}, gys "
          f"{diffs[1]:.3g}, gxs {diffs[2]:.3g}")
    got = multilevel_roi_align.KERNEL.backward(*pooler_sites[0], SCALES, 2)
    old = old_pooler.KERNEL.backward(*pooler_sites[0], SCALES, 2)
    print(f"[check] RoIAlign site 0: this vs parent max |diff| "
          f"{max((a.float() - b.float()).abs().max().item() for a, b in zip(got, old)):.3g}")
    del got, old

    binning = sum(cuda_ms(lambda: deform_sample.KERNEL.bin_samples(f, y, x), args.reps)
                  for f, y, x, _ in sampler_sites)
    plain_binning = sum(cuda_ms(lambda: window_tiles(y, x, f.shape[1:3], deform_sample.KERNEL.tile),
                                args.reps) for f, y, x, _ in sampler_sites)
    bound_6b = sum(sampler_bounds(f, y, x)[1][0] for f, y, x, _ in sampler_sites)
    bound_2 = sum(roi_align_backward_bound(s, r, v, g)[0] for s, r, _, v, g in pooler_sites)
    print(f"[binning] the binning kernels over the {len(sampler_sites)} sampler sites: {binning:.4f} "
          f"ms (inside this tree's backward times); its plain version window_tiles (torch ops) "
          f"{plain_binning:.4f} ms | {card}")
    cases = [("6b sampler backward", sampler_sites, sampler, bound_6b),
             ("2 RoIAlign backward", pooler_sites, pooler, bound_2)]
    for crowd in CROWDS:
        sites = crowded_sites(pooler_sites, crowd)
        got = multilevel_roi_align.KERNEL.backward(*sites[0], SCALES, 2)
        old = old_pooler.KERNEL.backward(*sites[0], SCALES, 2)
        levels = torch.bincount(sites[0][2].long()[sites[0][3]], minlength=4).tolist()
        print(f"[check] RoIAlign {crowd} site 0: valid rois per level {levels}, this vs parent max "
              f"|diff| {max((a.float() - b.float()).abs().max().item() for a, b in zip(got, old)):.3g}")
        del got, old
        bound = sum(roi_align_backward_bound(s, r, v, g)[0] for s, r, _, v, g in sites)
        cases.append((f"2 RoIAlign backward, {crowd} crowd", sites, pooler, bound))
    for label, sites, runners, bound in cases:
        sums = in_turns(label, sites, runners, card, args.reps)
        mean = {k: sum(v) / len(v) for k, v in sums.items()}
        print(f"[compare] {label}: parent {mean['parent']:.4f} ms, this {mean['this']:.4f} ms "
              f"({mean['parent'] / mean['this']:.2f}x), bound {bound:.4f} ms, this at "
              f"{mean['this'] / bound:.1f}x its bound, over {len(sites)} calls | {card}")
        for k, v in mean.items():
            if k not in ("parent", "this"):
                print(f"[compare] {label}: {k} {v:.4f} ms | {card}")
        if runners is pooler:
            for i, site in enumerate(sites):
                times = {k: cuda_ms(lambda: run(*site), args.reps) for k, run in runners.items()}
                print(f"[site] {label} site {i} ({site[4].shape[1]}x{site[4].shape[2]}, "
                      f"{int(site[3].sum())} of {site[3].numel()} rois valid): parent "
                      f"{times['parent']:.4f} ms, this {times['this']:.4f} ms | {card}")
        kernel_breakdown(label, sites, runners["this"], card)


if __name__ == "__main__":
    main()
