"""The kernels redesigned lately against an older tree's, on one GPU.

    python3 -m cpm_tpu_torch.tools.compare_kernels --parent build/parent

`--parent` is an unpacked copy of an earlier commit of this repository (for
example `git archive HEAD | tar -x -C build/parent` before a change). The tool
captures what four kernels are given on the paths that run them, at the
operating point of `profile_train.training_cfg` (batch 2 at 800x1344, bf16,
seeded random weights, offset convs spread, affines folded):

* 6f, the deformable-conv sampler's forward: its 30 calls in one batch-2
  training step of CPM X-101-32x4d-FPN-DCN and in one batch-1 eval forward of
  the same model, and the probe's three geometries
  (`probe_dcn_sampler.GEOMETRIES`, scattered coordinates);
* 6b, the sampler's backward: its 30 calls in that training step;
* 2, the multilevel RoIAlign backward: its 5 calls in one training step of
  the flagship CPM R-50-FPN under `auto`;
* 4b, the stacked RoIAlign backward: its 5 calls in one such step under
  `stacked`.

Then it times this tree's wrappers and the parent tree's on those inputs, in
turns (parent, this, this, parent), and prints each turn's two sums over the
sites beside their bounds (`probe_dcn_sampler.sampler_bounds`,
`roi_align_backward_bound`): the calls' median CUDA-event times, which hold
the wrapper's host time, and their device time (`torch.profiler`), which
does not; for 6f also by channel width (res3, res4, res5) and beside a
torch fill of the same outputs, a floor for writing them. It also times
this tree's sampler backward in its parts (the binning kernels alone, the
map gradient alone, the coordinate gradients alone) and the binning's plain
version; `torch.profiler` then breaks this tree's calls down by kernel. It
asserts that this tree's 6f and kernel 2 give the parent's bits at every
site, and that 4b gives kernel 2's bits at every site of both backends'
steps and on the crowded sets.

The random-weight step's rois spread: its proposals are random and its
positives are mostly the appended gt boxes. A trained model's positives crowd
on the objects, so the RoIAlign backwards are also timed on two crowded
versions of their five sites (`crowded_sites`: the captured shapes, mask and
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


def captured_step(config, captures, backend="auto"):
    """What the captured functions were given in one training step of
    `config` under the pooler `backend`, after a warm-up step: `captures`
    maps a name to (owner, attribute, keep); returns name -> the calls."""
    from cpm_tpu_torch.data.synthetic import synthetic_batch
    from cpm_tpu_torch.engine.train import create_train_state, make_train_step
    from cpm_tpu_torch.tools.profile_train import (
        fold_batch_statistics,
        spread_offset_convs,
        training_cfg,
    )

    cfg = training_cfg(config)
    cfg.TPU.POOLER_KERNEL = backend
    model, optimizer, state = create_train_state(cfg, "cuda", seed=0)
    spread_offset_convs(model, seed=1)
    step_fn = make_train_step(cfg, model, optimizer)

    def batch_for(seed):
        return synthetic_batch(2, 800, 1344, max_gt=32, num_classes=cfg.MODEL.NUM_CLASSES,
                               seed=seed, uint8=True)

    fold_batch_statistics(model, batch_for(99)["images"])
    state, _ = step_fn(state, batch_for(100))
    with contextlib.ExitStack() as stack:
        calls = {k: stack.enter_context(capture(*c)) for k, c in captures.items()}
        step_fn(state, batch_for(101))
        torch.cuda.synchronize()
    del model, optimizer, state, step_fn
    torch.cuda.empty_cache()
    return calls


def captured_eval_forward(owner, name, keep):
    """The calls of owner.name in one batch-1 eval forward of CPM
    X-101-32x4d-FPN-DCN at 800x1344, after a warm-up forward."""
    from cpm_tpu_torch.config import x101_dcn_cfg
    from cpm_tpu_torch.engine.test import make_forward_fn
    from cpm_tpu_torch.modeling.model import build_model
    from cpm_tpu_torch.tools.profile_eval import make_request
    from cpm_tpu_torch.tools.profile_train import fold_batch_statistics, spread_offset_convs

    rng = np.random.RandomState(0)
    cfg = x101_dcn_cfg()
    model = build_model(cfg, "cuda", seed=0)
    spread_offset_convs(model, seed=1)
    fold_batch_statistics(model, make_request(np.random.RandomState(99), [(800, 1344)])[0])
    forward = make_forward_fn(cfg, model)
    forward(*make_request(rng, [(800, 1333)]))
    with capture(owner, name, keep) as calls:
        forward(*make_request(rng, [(800, 1333)]))
        torch.cuda.synchronize()
    del model, forward
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


def device_ms(sites, run, tries=3):
    """Device time of one run of every site: the CUDA kernels' and memsets'
    time that `torch.profiler` records, summed (the wrapper's host time
    between launches is left out). A short session now and then comes back
    with no device record at all (seen with one call of 0.02-0.1 ms): it is
    profiled again, and raises after `tries` empty sessions."""
    from torch.profiler import ProfilerActivity, profile

    for site in sites:
        run(*site)
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for site in sites:
                run(*site)
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        if total > 0:
            return total
    raise RuntimeError(f"torch.profiler recorded no device time in {tries} sessions")


def in_turns(label, sites, runners, card, reps, by_width=False):
    """Each runner over the sites in the order parent, this, this, parent
    (then any other runner once): the sum of its calls' median CUDA-event
    times and the device time of one run of every site, and with `by_width`
    the device time by the map's channel width (one profiled run a site).
    Returns {runner: [(event ms, device ms) a turn]}."""
    order = ["parent", "this", "this", "parent"] + [k for k in runners if k not in ("parent", "this")]
    sums = {k: [] for k in runners}
    for who in order:
        run = runners[who]
        event = sum(cuda_ms(lambda: run(*site), reps) for site in sites)
        note = ""
        if by_width:
            widths = {}
            for site in sites:
                c = site[0].shape[-1]
                widths[c] = widths.get(c, 0.0) + device_ms([site], run)
            device = sum(widths.values())
            note = ", by width " + ", ".join(f"C={c} {t:.4f}" for c, t in sorted(widths.items()))
        else:
            device = device_ms(sites, run)
        sums[who].append((event, device))
        print(f"[turn] {label} {who}: {event:.4f} ms of event time, {device:.4f} ms of device "
              f"time{note}, over {len(sites)} calls | {card}")
    return sums


def same_bits(label, got, want):
    """Raise unless got and want (tensors or lists of them) are equal to the bit."""
    got = got if isinstance(got, (list, tuple)) else [got]
    want = want if isinstance(want, (list, tuple)) else [want]
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"{label}: not bit-equal")


def describe(site):
    """A short name of a site's shapes."""
    if len(site) in (3, 4):                               # sampler forward, backward
        feat, ys = site[:2]
        rows = f", rows of {ys.shape[2]}" if ys.dim() == 3 else ""
        return f"map {tuple(feat.shape)}, {ys[0].numel()} samples an image{rows}"
    g, valid = site[4], site[3]
    return f"{g.shape[1]}x{g.shape[2]}, {int(valid.sum())} of {valid.numel()} rois valid"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("compare_kernels: needs a CUDA device")
    from cpm_tpu_torch.ops.cuda import deform_sample, multilevel_roi_align, stacked_roi_align
    from cpm_tpu_torch.tools.probe_dcn_sampler import GEOMETRIES, make_inputs

    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    parent = args.parent.resolve()
    old_sampler = load_parent(parent, "deform_sample")
    old_pooler = load_parent(parent, "multilevel_roi_align")
    old_stacked = load_parent(parent, "stacked_roi_align")

    def keep_forward(feat, ys, xs):
        return feat.detach().clone(), ys.detach().clone(), xs.detach().clone()

    def keep_sampler(feat, ys, xs, g, *_):
        return feat.detach().clone(), ys.clone(), xs.clone(), g.clone()

    def keep_pooler(shapes, rois, levels, valid, g, *_):
        return [tuple(s) for s in shapes], rois.clone(), levels.clone(), valid.clone(), g.clone()

    x101 = captured_step("x101_dcn", {
        "forward": (deform_sample, "deform_sample_cuda", keep_forward),
        "backward": (deform_sample.KERNEL, "backward", keep_sampler)})
    train_forward, sampler_sites = x101["forward"], x101["backward"]
    eval_forward = captured_eval_forward(deform_sample, "deform_sample_cuda", keep_forward)
    probe_forward = [make_inputs(h, w, c, torch.bfloat16, "cuda") for _, h, w, c in GEOMETRIES]
    pooler_sites = captured_step("flagship", {
        "backward": (multilevel_roi_align.KERNEL, "backward", keep_pooler)})["backward"]
    stacked_sites = captured_step("flagship", {
        "backward": (stacked_roi_align.KERNEL, "backward", keep_pooler)}, "stacked")["backward"]
    print(f"[sites] {len(train_forward)} sampler forward calls of one X-101-DCN training step "
          f"(batch 2) and {len(eval_forward)} of one batch-1 eval forward, {len(sampler_sites)} "
          f"sampler backward calls, {len(pooler_sites)} RoIAlign backward calls of one flagship "
          f"step under auto and {len(stacked_sites)} under stacked, {sampler_sites[0][3].dtype}")

    # the parent's sampler takes the flat [B, P] list; this one the rows too
    forward = {"parent": lambda f, y, x: old_sampler.KERNEL(f, y.flatten(1), x.flatten(1)),
               "this": lambda f, y, x: deform_sample.KERNEL(f, y, x).flatten(1, -2)}
    sampler = {"parent": lambda f, y, x, g: old_sampler.KERNEL.backward(
                   f, y.flatten(1), x.flatten(1), g.flatten(1, -2)),
               "this": deform_sample.KERNEL.backward,
               "this, map gradient only": lambda *a: deform_sample.KERNEL.backward(
                   *a, need_coords=False),
               "this, coordinate gradients only": lambda *a: deform_sample.KERNEL.backward(
                   *a, need_map=False)}
    pooler = {"parent": lambda *a: old_pooler.KERNEL.backward(*a, SCALES, 2),
              "this": lambda *a: multilevel_roi_align.KERNEL.backward(*a, SCALES, 2)}
    stacked = {"parent": lambda *a: old_stacked.KERNEL.backward(*a, SCALES, 2),
               "this": lambda *a: stacked_roi_align.KERNEL.backward(*a, SCALES, 2),
               "kernel 2 on the same inputs": pooler["this"]}

    # bits: 6f as the parent's, kernel 2 as the parent's, 4b as kernel 2
    for label, sites in (("training step", train_forward), ("eval forward", eval_forward),
                         ("probe", probe_forward)):
        for i, site in enumerate(sites):
            same_bits(f"6f {label} site {i} vs the parent", forward["this"](*site),
                      forward["parent"](*site))
        print(f"[check] 6f {label}: the {len(sites)} sites bit-equal to the parent's 6f")
    crowds = {crowd: (crowded_sites(pooler_sites, crowd), crowded_sites(stacked_sites, crowd))
              for crowd in CROWDS}
    roi_sets = [("auto step", pooler_sites), ("stacked step", stacked_sites)] + [
        (f"{crowd} crowd of the {which} step", sets[k]) for crowd, sets in crowds.items()
        for k, which in enumerate(("auto", "stacked"))]
    for label, sites in roi_sets:
        for i, site in enumerate(sites):
            got = pooler["this"](*site)
            same_bits(f"kernel 2 {label} site {i} vs the parent", got, pooler["parent"](*site))
            same_bits(f"4b {label} site {i} vs kernel 2", stacked["this"](*site), got)
            again = stacked["this"](*site)
            same_bits(f"4b {label} site {i} rerun", again, got)
            del got, again
        print(f"[check] RoIAlign backward, {label}: kernel 2 bit-equal to the parent's kernel 2 "
              f"and 4b bit-equal to kernel 2 (twice) at all {len(sites)} sites")
    got = deform_sample.KERNEL.backward(*sampler_sites[0])
    old = sampler["parent"](*sampler_sites[0])
    diffs = [(a.float().flatten() - b.float().flatten()).abs().max().item()
             for a, b in zip(got, old)]
    print(f"[check] sampler backward site 0: this vs parent max |diff| map {diffs[0]:.3g}, gys "
          f"{diffs[1]:.3g}, gxs {diffs[2]:.3g}")
    del got, old

    binning = sum(cuda_ms(lambda: deform_sample.KERNEL.bin_samples(f, y, x), args.reps)
                  for f, y, x, _ in sampler_sites)
    plain_binning = sum(cuda_ms(lambda: window_tiles(y.flatten(1), x.flatten(1), f.shape[1:3],
                                                     deform_sample.KERNEL.tile),
                                args.reps) for f, y, x, _ in sampler_sites)
    print(f"[binning] the binning kernels over the {len(sampler_sites)} sampler sites: {binning:.4f} "
          f"ms (inside this tree's backward times); its plain version window_tiles (torch ops) "
          f"{plain_binning:.4f} ms | {card}")

    def forward_bound(sites):
        return sum(sampler_bounds(f, y, x)[0][0] for f, y, x in sites)

    def pooler_bound(sites):
        return sum(roi_align_backward_bound(s, r, v, g)[0] for s, r, _, v, g in sites)

    cases = [("6f sampler forward, X-101-DCN training step (batch 2)", train_forward, forward,
              forward_bound(train_forward)),
             ("6f sampler forward, X-101-DCN eval forward (batch 1)", eval_forward, forward,
              forward_bound(eval_forward)),
             ("6f sampler forward, probe geometries", probe_forward, forward,
              forward_bound(probe_forward)),
             ("6b sampler backward", sampler_sites, sampler,
              sum(sampler_bounds(f, y, x)[1][0] for f, y, x, _ in sampler_sites)),
             ("2 RoIAlign backward", pooler_sites, pooler, pooler_bound(pooler_sites)),
             ("4b stacked RoIAlign backward", stacked_sites, stacked, pooler_bound(stacked_sites))]
    for crowd, (auto_sets, stacked_sets) in crowds.items():
        cases.append((f"2 RoIAlign backward, {crowd} crowd", auto_sets, pooler,
                      pooler_bound(auto_sets)))
        cases.append((f"4b stacked RoIAlign backward, {crowd} crowd", stacked_sets, stacked,
                      pooler_bound(stacked_sets)))
    for label, sites, runners, bound in cases:
        sums = in_turns(label, sites, runners, card, args.reps, by_width=runners is forward)
        mean = {k: [sum(t[j] for t in v) / len(v) for j in (0, 1)] for k, v in sums.items()}
        (pe, pd), (te, td) = mean["parent"], mean["this"]
        print(f"[compare] {label}: event time parent {pe:.4f} ms, this {te:.4f} ms "
              f"({pe / te:.2f}x); device time parent {pd:.4f} ms, this {td:.4f} ms "
              f"({pd / td:.2f}x); bound {bound:.4f} ms, this at {td / bound:.1f}x its bound in "
              f"device time; over {len(sites)} calls, means of two turns | {card}")
        for k, (e, d) in mean.items():
            if k not in ("parent", "this"):
                print(f"[compare] {label}: {k} event time {e:.4f} ms, device time {d:.4f} ms "
                      f"| {card}")
        if runners is forward:
            # the floor of a forward: its output written alone, by one torch fill
            fill = device_ms(sites, lambda f, y, x: torch.empty(
                (*y.shape, f.shape[3]), dtype=f.dtype, device=f.device).fill_(1))
            print(f"[floor] {label}: writing the outputs alone (torch fill) {fill:.4f} ms of device "
                  f"time over {len(sites)} calls | {card}")
        for i, site in enumerate(sites):
            times = {k: cuda_ms(lambda: runners[k](*site), args.reps) for k in ("parent", "this")}
            device = ""
            if runners is forward:
                device = ("; device time parent {:.4f} ms, this {:.4f} ms".format(
                    *(device_ms([site], runners[k]) for k in ("parent", "this"))))
            print(f"[site] {label} site {i} ({describe(site)}): parent {times['parent']:.4f} ms, "
                  f"this {times['this']:.4f} ms{device} | {card}")
        kernel_breakdown(label, sites, runners["this"], card)


if __name__ == "__main__":
    main()
