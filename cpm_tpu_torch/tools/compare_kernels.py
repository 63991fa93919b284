"""The kernels redesigned lately against an older tree's, on one GPU.

    python3 -m cpm_tpu_torch.tools.compare_kernels --parent build/parent [--only stacked]

`--parent` is an unpacked copy of an earlier commit of this repository (for
example `git archive HEAD | tar -x -C build/parent` before a change). The tool
captures what the kernels are given on the paths that run them, at the
operating point of `profile_train.training_cfg` (batch 2 at 800x1344, bf16,
seeded random weights, offset convs spread, affines folded) and of a batch-1
eval forward at 800x1344 (`GRID_RCNN.SCORE_THRESH` 0.0, as `profile_eval`
sets it). Five sections, all by default, any with `--only`:

* `sampler`: 6f, the deformable-conv sampler's forward, at its 30 calls in
  one batch-2 training step of CPM X-101-32x4d-FPN-DCN and in one batch-1 eval
  forward of the same model, and at the probe's three geometries
  (`probe_dcn_sampler.GEOMETRIES`, scattered coordinates); 6b, its backward,
  at its 30 calls in that step;
* `backward`: kernel 2, the multilevel RoIAlign backward, at its 5 calls in
  one training step of the flagship CPM R-50-FPN under `auto`, and 4b, the
  stacked backward, at its 5 calls under `stacked`;
* `forward`: kernel 1, the multilevel RoIAlign forward, at its 5 calls in a
  batch-1 eval forward (cls, three grid stages, rescore) and a batch-2
  training step of the flagship under `auto`; kernel 3, the clustered
  forward, with its grouping, at its 5 calls under `clustered` in the same
  two runs, and the grouping alone (`cluster_rois` in the parent, the
  grouping kernel here); then, for this tree only, the device time of 7
  (the cross-roi forward at the probe's shapes);
* `stacked`: 4f, the stacked forward, at its 5 calls under `stacked` in the
  same two runs and the crowded sets (each on a stack made beforehand, with
  kernel 1 on the same inputs beside it), and the stack of those calls'
  maps: the parent's five pad-and-cat copies a forward against this tree's
  one build (`stack_levels_in_one_pass`, made once a forward by `STACKS`);
* `single`: 5, the single-level forward, on a C4 map [2, 50, 84, 1024] f32
  with 1024 rois at 7x7 and 14x14, with kernel 1 at one level beside it.

Then it times this tree's wrappers and the parent tree's on those inputs, in
turns (parent, this, this, parent), and prints each turn's two sums over the
sites beside their bounds (`probe_dcn_sampler.sampler_bounds`,
`roi_align_backward_bound`, `bench_roi_align.roi_align_bounds`,
`clustered_bound`, `grouping_bound`, `stack_bound`): the calls' median CUDA-event times,
which hold the wrapper's host time, and their device time
(`torch.profiler`), which does not; for 6f also by channel width (res3,
res4, res5) and beside a torch fill of the same outputs, a floor for writing
them; for kernels 1 and 4f also each site's device time. `torch.profiler`
then breaks this tree's calls down by kernel. It asserts that this tree's
6f, kernel 2, kernel 1, 4f and 5 give the parent's bits at every site, that
4b gives kernel 2's bits, that the grouping kernel gives `cluster_rois`'
integers, that kernels 3 and 4f give kernel 1's bits, that 5 gives kernel
1's at one level (not aligned, every roi valid) and that the one-pass stack
gives `stack_levels`' bits. It also times this tree's sampler
backward in its parts (the binning kernels alone, the map gradient alone,
the coordinate gradients alone) and the binning's plain version.

The random-weight step's rois spread: its proposals are random and its
positives are mostly the appended gt boxes. A trained model's positives crowd
on the objects, so the RoIAlign kernels are also timed on two crowded
versions of their five training-step sites (`crowd_rois`: the captured
shapes, mask and maps or `g`, new rois): `coco`, one box over most of the
image beside four smaller ones, as a COCO image often has, and `one object`,
every positive on one 120x100 box. The parent's wrappers and sources are
loaded from its tree; its kernels are built like this tree's, into `build/`.

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
SECTIONS = ("sampler", "backward", "forward", "stacked", "single")
C4_SHAPE, C4_SCALE, C4_ROIS = (2, 50, 84, 1024), 0.0625, 1024
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


def captured_eval_forward(owner, name, keep, config="x101_dcn", backend="auto"):
    """The calls of owner.name in one batch-1 eval forward of `config`
    ('x101_dcn': CPM X-101-32x4d-FPN-DCN, offset convs spread, affines
    folded; 'flagship': CPM R-50-FPN) at 800x1344 under the pooler
    `backend`, after a warm-up forward. GRID_RCNN.SCORE_THRESH is 0.0, as in
    `profile_eval`, so that every grid stage pools a full detection set."""
    from cpm_tpu_torch import config as configs
    from cpm_tpu_torch.engine.test import make_forward_fn
    from cpm_tpu_torch.modeling.model import build_model
    from cpm_tpu_torch.tools.profile_eval import make_request
    from cpm_tpu_torch.tools.profile_train import fold_batch_statistics, spread_offset_convs

    rng = np.random.RandomState(0)
    cfg = {"flagship": configs.flagship_cfg, "x101_dcn": configs.x101_dcn_cfg}[config]()
    cfg.TPU.POOLER_KERNEL = backend
    cfg.GRID_RCNN.SCORE_THRESH = 0.0
    model = build_model(cfg, "cuda", seed=0)
    if spread_offset_convs(model, seed=1):
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


def crowd_rois(rois, valid, stage, crowd, rng):
    """New rois for one site that crowd on the gt boxes of CROWDS[crowd], in
    both images: a quarter of the valid rois of a 7x7 site (the sampler's
    positive fraction) and every roi of a 14x14 grid-stage site (`stage`),
    all valid (a stage pools up to GRID_RCNN.MAX_SAMPLE_NUM_GRID positives an
    image, which a trained model fills; the random-weight step has about
    ten), are copies of a gt box, each side moved by up to 6% of the box's
    size (IoU above 0.6); the other rois are boxes drawn over the image.
    Levels by the FPN rule, as the pooler assigns them. Returns (rois,
    levels, valid)."""
    from cpm_tpu_torch.ops.pooler import assign_fpn_levels

    boxes, shares = CROWDS[crowd]
    boxes = np.array(boxes, np.float32)
    height, width = IMAGE_HW
    n = rois.shape[0]
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
    return new, (assign_fpn_levels(coords, 2, 5) - 2).int(), valid


def crowded_sites(sites, crowd, seed=0):
    """The RoIAlign backward's captured sites `(shapes, rois, levels, valid,
    g)` with the rois of `crowd_rois`: the captured shapes and `g`."""
    rng = np.random.RandomState(seed)
    out = []
    for shapes, rois, _, valid, g in sites:
        new, levels, valid = crowd_rois(rois, valid, g.shape[1] != 7, crowd, rng)
        out.append((shapes, new, levels, valid, g))
    return out


def crowded_forward_sites(sites, crowd, seed=0):
    """A pooler forward's captured sites (`keep_pool`) with the rois of
    `crowd_rois`: the captured maps and arguments."""
    rng = np.random.RandomState(seed)
    out = []
    for maps, rois, _, valid, pool, *rest in sites:
        new, levels, valid = crowd_rois(rois, valid, pool[0] != 7, crowd, rng)
        out.append((maps, new, levels, valid, pool, *rest))
    return out


def keep_pool(features, rois, levels, valid, output_size, spatial_scales, sampling_ratio=0,
              aligned=False):
    """What a pooler forward op was given, copied: (maps, rois, levels, valid,
    pool, scales, sampling ratio, aligned)."""
    return ([f.detach().clone() for f in features], rois.clone(), levels.clone(), valid.clone(),
            tuple(int(s) for s in output_size), tuple(float(s) for s in spatial_scales),
            sampling_ratio, aligned)


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


def device_ms(sites, run, tries=5, repeat=3):
    """Device time of one run of every site: the CUDA kernels' and memsets'
    time that `torch.profiler` records over `repeat` runs of every site,
    summed and divided by `repeat` (the wrapper's host time between launches
    is left out). A short session now and then comes back with no device
    record at all (seen with calls of 0.02-0.1 ms): it is profiled again,
    and raises after `tries` empty sessions."""
    from torch.profiler import ProfilerActivity, profile

    for site in sites:
        run(*site)
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(repeat):
                for site in sites:
                    run(*site)
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        if total > 0:
            return total / repeat
    raise RuntimeError(f"torch.profiler recorded no device time in {tries} sessions")


def in_turns(label, sites, runners, card, reps, by_width=False):
    """Each runner over the sites in the order parent, this, this, parent
    (then any other runner once): the sum of its calls' median CUDA-event
    times and of their device times (one profiled session a call, so that a
    session that loses a record shows as an empty one and is profiled
    again), and with `by_width` the device time by the map's channel width.
    Returns {runner: [(event ms, device ms) a turn]}."""
    order = ["parent", "this", "this", "parent"] + [k for k in runners if k not in ("parent", "this")]
    sums = {k: [] for k in runners}
    for who in order:
        run = runners[who]
        event = sum(cuda_ms(lambda: run(*site), reps) for site in sites)
        note = ""
        widths = {}
        for site in sites:
            c = site[0].shape[-1] if by_width else None
            widths[c] = widths.get(c, 0.0) + device_ms([site], run)
        device = sum(widths.values())
        if by_width:
            note = ", by width " + ", ".join(f"C={c} {t:.4f}" for c, t in sorted(widths.items()))
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
    if len(site) == 1:                                    # a stack's maps
        return f"levels {[tuple(f.shape) for f in site[0]]}"
    if len(site) == 5 and isinstance(site[2], tuple):      # single-level forward
        return f"map {tuple(site[0].shape)}, {site[1].shape[0]} rois, {site[2][0]}x{site[2][1]}"
    valid = site[3]
    pool = site[4] if len(site) in (8, 9) else tuple(site[4].shape[1:3])  # forward, backward
    return f"{pool[0]}x{pool[1]}, {int(valid.sum())} of {valid.numel()} rois valid"


def same_grouping(label, got, want):
    """Raise unless two `Grouping`s are equal integer for integer."""
    for field in ("order", "groups", "slot_group", "n_groups"):
        a, b = getattr(got, field), getattr(want, field)
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"{label}: {field} differs from cluster_rois'")


def level_hw(maps):
    return [(int(f.shape[1]), int(f.shape[2])) for f in maps]


def sampler_section(parent, card, reps):
    """6f and 6b: captures, bit checks, the binning line; returns the cases."""
    from cpm_tpu_torch.ops.cuda import deform_sample
    from cpm_tpu_torch.tools.probe_dcn_sampler import GEOMETRIES, make_inputs

    old_sampler = load_parent(parent, "deform_sample")

    def keep_forward(feat, ys, xs):
        return feat.detach().clone(), ys.detach().clone(), xs.detach().clone()

    def keep_sampler(feat, ys, xs, g, *_):
        return feat.detach().clone(), ys.clone(), xs.clone(), g.clone()

    x101 = captured_step("x101_dcn", {
        "forward": (deform_sample, "deform_sample_cuda", keep_forward),
        "backward": (deform_sample.KERNEL, "backward", keep_sampler)})
    train_forward, sampler_sites = x101["forward"], x101["backward"]
    eval_forward = captured_eval_forward(deform_sample, "deform_sample_cuda", keep_forward)
    probe_forward = [make_inputs(h, w, c, torch.bfloat16, "cuda") for _, h, w, c in GEOMETRIES]
    print(f"[sites] {len(train_forward)} sampler forward calls of one X-101-DCN training step "
          f"(batch 2) and {len(eval_forward)} of one batch-1 eval forward, {len(sampler_sites)} "
          f"sampler backward calls, {sampler_sites[0][3].dtype}")

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
    for label, sites in (("training step", train_forward), ("eval forward", eval_forward),
                         ("probe", probe_forward)):
        for i, site in enumerate(sites):
            same_bits(f"6f {label} site {i} vs the parent", forward["this"](*site),
                      forward["parent"](*site))
        print(f"[check] 6f {label}: the {len(sites)} sites bit-equal to the parent's 6f")
    got = deform_sample.KERNEL.backward(*sampler_sites[0])
    old = sampler["parent"](*sampler_sites[0])
    diffs = [(a.float().flatten() - b.float().flatten()).abs().max().item()
             for a, b in zip(got, old)]
    print(f"[check] sampler backward site 0: this vs parent max |diff| map {diffs[0]:.3g}, gys "
          f"{diffs[1]:.3g}, gxs {diffs[2]:.3g}")
    del got, old

    binning = sum(cuda_ms(lambda: deform_sample.KERNEL.bin_samples(f, y, x), reps)
                  for f, y, x, _ in sampler_sites)
    plain_binning = sum(cuda_ms(lambda: window_tiles(y.flatten(1), x.flatten(1), f.shape[1:3],
                                                     deform_sample.KERNEL.tile),
                                reps) for f, y, x, _ in sampler_sites)
    print(f"[binning] the binning kernels over the {len(sampler_sites)} sampler sites: {binning:.4f} "
          f"ms (inside this tree's backward times); its plain version window_tiles (torch ops) "
          f"{plain_binning:.4f} ms | {card}")

    def forward_bound(sites):
        return sum(sampler_bounds(f, y, x)[0][0] for f, y, x in sites)

    def fill(f, y, x):
        # the floor of a forward: its output written alone, by one torch fill
        return torch.empty((*y.shape, f.shape[3]), dtype=f.dtype, device=f.device).fill_(1)

    sampler_case = dict(runners=forward, by_width=True, site_device=True, floor=fill)
    return [
        dict(sampler_case, label="6f sampler forward, X-101-DCN training step (batch 2)",
             sites=train_forward, bound=forward_bound(train_forward)),
        dict(sampler_case, label="6f sampler forward, X-101-DCN eval forward (batch 1)",
             sites=eval_forward, bound=forward_bound(eval_forward)),
        dict(sampler_case, label="6f sampler forward, probe geometries", sites=probe_forward,
             bound=forward_bound(probe_forward)),
        dict(label="6b sampler backward", sites=sampler_sites, runners=sampler,
             bound=sum(sampler_bounds(f, y, x)[1][0] for f, y, x, _ in sampler_sites)),
    ]


def backward_section(parent, steps):
    """Kernels 2 and 4b: bit checks on the captured and crowded sites;
    returns the cases."""
    from cpm_tpu_torch.ops.cuda import multilevel_roi_align, stacked_roi_align

    old_pooler = load_parent(parent, "multilevel_roi_align")
    old_stacked = load_parent(parent, "stacked_roi_align")
    pooler_sites, stacked_sites = steps("auto")["backward"], steps("stacked")["backward"]
    print(f"[sites] {len(pooler_sites)} RoIAlign backward calls of one flagship step under auto "
          f"and {len(stacked_sites)} under stacked")
    pooler = {"parent": lambda *a: old_pooler.KERNEL.backward(*a, SCALES, 2),
              "this": lambda *a: multilevel_roi_align.KERNEL.backward(*a, SCALES, 2)}
    stacked = {"parent": lambda *a: old_stacked.KERNEL.backward(*a, SCALES, 2),
               "this": lambda *a: stacked_roi_align.KERNEL.backward(*a, SCALES, 2),
               "kernel 2 on the same inputs": pooler["this"]}

    # bits: kernel 2 as the parent's, 4b as kernel 2
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

    def bound(sites):
        return sum(roi_align_backward_bound(s, r, v, g)[0] for s, r, _, v, g in sites)

    cases = [dict(label="2 RoIAlign backward", sites=pooler_sites, runners=pooler,
                  bound=bound(pooler_sites)),
             dict(label="4b stacked RoIAlign backward", sites=stacked_sites, runners=stacked,
                  bound=bound(stacked_sites))]
    for crowd, (auto_sets, stacked_sets) in crowds.items():
        cases.append(dict(label=f"2 RoIAlign backward, {crowd} crowd", sites=auto_sets,
                          runners=pooler, bound=bound(auto_sets)))
        cases.append(dict(label=f"4b stacked RoIAlign backward, {crowd} crowd",
                          sites=stacked_sets, runners=stacked, bound=bound(stacked_sets)))
    return cases


def forward_sets(eval_sites, step_sites):
    """(label, sites) of a pooler forward: a flagship batch-1 eval forward's
    five calls, a batch-2 training step's, and the step's two crowded
    versions."""
    return ([("flagship eval forward (batch 1)", eval_sites),
             ("flagship training step (batch 2)", step_sites)]
            + [(f"{crowd} crowd of the training step", crowded_forward_sites(step_sites, crowd))
               for crowd in CROWDS])


def site_shapes(site):
    return [tuple(f.shape) for f in site[0]]


def level_bound(sites):
    """The multilevel forward's bound summed over pooler sites (`keep_pool`)."""
    from cpm_tpu_torch.tools.bench_roi_align import roi_align_bounds

    return sum(roi_align_bounds(site_shapes(s), s[1], s[2], s[3], s[4], s[0][0].element_size(),
                                s[5])[0][0] for s in sites)


def stack_bound(maps):
    """(ms, by) of one stack of `maps`: every level read once, the stacked
    buffer written once; no arithmetic."""
    from cpm_tpu_torch.ops.roi_align import stack_geometry

    _, rows, wmax = stack_geometry(level_hw(maps))
    f0 = maps[0]
    stack = f0.shape[0] * rows * wmax * f0.shape[3] * f0.element_size()
    return bound_of(sum(f.numel() * f.element_size() for f in maps) + stack, 0)


def forward_section(parent, steps):
    """Kernel 1 and kernel 3 with its grouping: captured sites (a batch-1
    eval forward and a batch-2 training step of the flagship, under auto and
    under clustered) and their crowded versions; checks that kernel 1 gives
    the parent's bits, the grouping kernel `cluster_rois`' integers and
    kernel 3 kernel 1's bits; returns the cases."""
    from cpm_tpu_torch.ops.cuda import clustered_roi_align, multilevel_roi_align
    from cpm_tpu_torch.ops.roi_align import cluster_rois
    from cpm_tpu_torch.tools.bench_roi_align import clustered_bound, grouping_bound

    old_level = load_parent(parent, "multilevel_roi_align")
    old_clustered = load_parent(parent, "clustered_roi_align")
    eval_auto = captured_eval_forward(multilevel_roi_align, "multilevel_roi_align", keep_pool,
                                      "flagship")
    eval_clustered = captured_eval_forward(clustered_roi_align, "multilevel_roi_align_clustered",
                                           keep_pool, "flagship", "clustered")
    step_auto, step_clustered = steps("auto")["forward"], steps("clustered")["forward"]
    print(f"[sites] multilevel forward: {len(eval_auto)} calls of a flagship batch-1 eval forward "
          f"and {len(step_auto)} of a batch-2 training step; clustered forward: "
          f"{len(eval_clustered)} and {len(step_clustered)}")

    def grouping_of(runner):
        return lambda maps, rois, levels, valid, pool, scales, sr, aligned: runner(
            rois, levels, valid, level_hw(maps), int(maps[0].shape[0]), pool, scales, sr, aligned)

    level = {"parent": old_level.KERNEL, "this": multilevel_roi_align.KERNEL}
    clustered = {"parent": old_clustered.KERNEL, "this": clustered_roi_align.KERNEL}
    grouping = {"parent": grouping_of(cluster_rois),
                "this": grouping_of(clustered_roi_align.KERNEL.group)}
    level_sets = forward_sets(eval_auto, step_auto)
    clustered_sets = forward_sets(eval_clustered, step_clustered)
    for label, sites in level_sets:
        for i, site in enumerate(sites):
            same_bits(f"kernel 1 {label} site {i} vs the parent", level["this"](*site),
                      level["parent"](*site))
        print(f"[check] kernel 1, {label}: bit-equal to the parent's kernel 1 at all "
              f"{len(sites)} sites ({', '.join(describe(s) for s in sites)})")
    for label, sites in clustered_sets:
        for i, site in enumerate(sites):
            same_grouping(f"grouping {label} site {i}", grouping["this"](*site),
                          grouping["parent"](*site))
            same_bits(f"kernel 3 {label} site {i} vs kernel 1", clustered["this"](*site),
                      level["this"](*site))
        print(f"[check] clustered, {label}: the grouping kernel equals cluster_rois (order, "
              f"groups, slot_group, n_groups) and kernel 3 gives kernel 1's bits at all "
              f"{len(sites)} sites")

    def clustered_bound_of(sites):
        return sum(clustered_bound(site_shapes(s), s[1], s[2], s[3], s[4],
                                   s[0][0].element_size(), grouping["parent"](*s), s[5])[0]
                   for s in sites)

    cases = [dict(label=f"1 multilevel forward, {label}", sites=sites, runners=level,
                  bound=level_bound(sites), site_device=True) for label, sites in level_sets]
    cases += [dict(label=f"3 clustered forward with its grouping, {label}", sites=sites,
                   runners=clustered, bound=clustered_bound_of(sites))
              for label, sites in clustered_sets]
    cases += [dict(label=f"3's grouping alone, {label}", sites=sites, runners=grouping,
                   bound=sum(grouping_bound(int(s[1].shape[0]))[0] for s in sites))
              for label, sites in clustered_sets]
    return cases


def stacked_section(parent, steps):
    """4f and its stack: captured sites (a batch-1 eval forward and a batch-2
    training step of the flagship under stacked) and the step's crowded
    versions, each site on a stack made beforehand; checks that 4f gives the
    parent's bits and kernel 1's, and that the one-pass stack gives
    `stack_levels`' bits; returns the cases."""
    from cpm_tpu_torch.ops.cuda import multilevel_roi_align, stacked_roi_align
    from cpm_tpu_torch.ops.roi_align import stack_levels, stack_levels_in_one_pass

    old_stacked = load_parent(parent, "stacked_roi_align")
    eval_stacked = captured_eval_forward(stacked_roi_align, "multilevel_roi_align_stacked",
                                         keep_pool, "flagship", "stacked")
    step_stacked = steps("stacked")["forward"]
    print(f"[sites] stacked forward: {len(eval_stacked)} calls of a flagship batch-1 eval forward "
          f"and {len(step_stacked)} of a batch-2 training step")

    def on_stack(kernel):
        # a site of `stacked_sites`: the pooler call's arguments and its stack
        return lambda maps, rois, levels, valid, pool, scales, sr, aligned, stack: kernel(
            stack, level_hw(maps), rois, levels, valid, pool, scales, sr, aligned)

    def on_maps(kernel):
        # kernel 1 on the same site, reading the level maps
        return lambda maps, rois, levels, valid, pool, scales, sr, aligned, stack: kernel(
            maps, rois, levels, valid, pool, scales, sr, aligned)

    level_kernel = on_maps(multilevel_roi_align.KERNEL)
    runners = {"parent": on_stack(old_stacked.KERNEL), "this": on_stack(stacked_roi_align.KERNEL),
               "kernel 1 on the same inputs": level_kernel}
    sets = [(label, [(*site, stack_levels(site[0])) for site in sites])
            for label, sites in forward_sets(eval_stacked, step_stacked)]
    for label, sites in sets:
        for i, site in enumerate(sites):
            got = runners["this"](*site)
            same_bits(f"4f {label} site {i} vs the parent", got, runners["parent"](*site))
            same_bits(f"4f {label} site {i} vs kernel 1", got, level_kernel(*site))
        print(f"[check] 4f, {label}: bit-equal to the parent's 4f and to kernel 1 at all "
              f"{len(sites)} sites ({', '.join(describe(s) for s in sites)})")
    cases = [dict(label=f"4f stacked forward, {label}", sites=sites, runners=runners,
                  bound=level_bound(sites), site_device=True) for label, sites in sets]

    # the stack: the parent made one with every pooler call, this tree one a forward
    stacks = {"parent": lambda maps: [stack_levels(maps) for _ in range(len(eval_stacked))],
              "this": stack_levels_in_one_pass}
    for label, sites in sets[:2]:
        maps = sites[0][0]
        same_bits(f"one-pass stack, {label}", stack_levels_in_one_pass(maps), stack_levels(maps))
        print(f"[check] stack, {label}: the one-pass stack is bit-equal to stack_levels "
              f"(levels {[tuple(f.shape) for f in maps]})")
        cases.append(dict(label=f"the stack of one forward's maps, {label}: parent five pad and "
                                f"cat copies, this one pass", sites=[(maps,)], runners=stacks,
                          bound=stack_bound(maps)[0]))
    return cases


def single_section(parent):
    """Kernel 5 on a C4 map [2, 50, 84, 1024] f32 with 1024 rois at 7x7 and
    14x14; checks that it gives the parent's bits and kernel 1's at one
    level, not aligned, every roi valid; returns the cases."""
    from cpm_tpu_torch.ops.cuda import multilevel_roi_align, roi_align
    from cpm_tpu_torch.tools.bench_roi_align import make_rois, roi_align_bounds

    old_single = load_parent(parent, "roi_align")
    rng = np.random.RandomState(0)
    c4 = torch.from_numpy(rng.rand(*C4_SHAPE).astype(np.float32)).cuda()
    rois = torch.from_numpy(make_rois(rng, C4_ROIS, C4_SHAPE[0])).cuda()
    zeros = torch.zeros(C4_ROIS, dtype=torch.int32, device=rois.device)
    everyone = torch.ones(C4_ROIS, dtype=torch.bool, device=rois.device)

    def level_kernel(feats, rois, pool, scale, sr):
        return multilevel_roi_align.KERNEL([feats], rois, zeros, everyone, pool, (scale,), sr)

    runners = {"parent": old_single.KERNEL, "this": roi_align.KERNEL,
               "kernel 1 at one level on the same inputs": level_kernel}
    cases = []
    for pool in ((7, 7), (14, 14)):
        site = (c4, rois, pool, C4_SCALE, 2)
        got = roi_align.KERNEL(*site)
        same_bits(f"5 at {pool} vs the parent", got, old_single.KERNEL(*site))
        same_bits(f"5 at {pool} vs kernel 1", got, level_kernel(*site))
        print(f"[check] 5, {describe(site)}: bit-equal to the parent's 5 and to kernel 1 at one "
              f"level")
        del got
        (bound, _), _ = roi_align_bounds([C4_SHAPE], rois, zeros, everyone, pool, 4,
                                         scales=(C4_SCALE,))
        cases.append(dict(label=f"5 single-level forward, C4 {C4_SHAPE} f32, {C4_ROIS} rois, "
                                f"{pool[0]}x{pool[1]}", sites=[site], runners=runners, bound=bound))
    return cases


def device_times_of_this_tree(card, reps):
    """Device time (and event time) of kernel 7 at the probe's shapes at G in
    {1, 2, 4, 8}, this tree only."""
    from cpm_tpu_torch.ops.cuda import crossroi_roi_align
    from cpm_tpu_torch.ops.roi_align import WindowedRois, crossroi_prep_rois
    from cpm_tpu_torch.tools import probe_pooler_crossroi as probe

    def report(label, sites, run):
        event = sum(cuda_ms(lambda: run(*site), reps) for site in sites)
        device = sum(device_ms([site], run) for site in sites)
        print(f"[device] {label}: {event:.4f} ms of event time, {device:.4f} ms of device time, "
              f"over {len(sites)} calls (this tree) | {card}")

    feat, rois = probe.make_inputs("cuda")
    half = feat.to(torch.bfloat16)
    prep = crossroi_prep_rois(rois, probe.SCALE, feat.shape[1:3], (7, 7), 2)
    prep = WindowedRois(*(t.contiguous() for t in prep))
    report(f"7 cross-roi forward, the probe's map {tuple(feat.shape)} bf16, 1024 rois, 7x7, G in "
           f"{probe.GROUPS}", [(half, prep, g, (7, 7), 2) for g in probe.GROUPS],
           crossroi_roi_align.KERNEL)


def time_cases(cases, card, reps):
    """Each case in turns (`in_turns`), its means beside its bound, and its
    calls one by one, parent against this."""
    for case in cases:
        label, sites, runners, bound = (case[k] for k in ("label", "sites", "runners", "bound"))
        sums = in_turns(label, sites, runners, card, reps, by_width=case.get("by_width", False))
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
        if case.get("floor") is not None:
            fill = device_ms(sites, case["floor"])
            print(f"[floor] {label}: writing the outputs alone (torch fill) {fill:.4f} ms of device "
                  f"time over {len(sites)} calls | {card}")
        for i, site in enumerate(sites):
            times = {k: cuda_ms(lambda: runners[k](*site), reps) for k in ("parent", "this")}
            device = ""
            if case.get("site_device"):
                device = ("; device time parent {:.4f} ms, this {:.4f} ms".format(
                    *(device_ms([site], runners[k]) for k in ("parent", "this"))))
            print(f"[site] {label} site {i} ({describe(site)}): parent {times['parent']:.4f} ms, "
                  f"this {times['this']:.4f} ms{device} | {card}")
        kernel_breakdown(label, sites, runners["this"], card)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--only", action="append", choices=SECTIONS,
                    help="run only these sections (repeatable); all by default")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("compare_kernels: needs a CUDA device")
    from cpm_tpu_torch.ops.cuda import clustered_roi_align, multilevel_roi_align, stacked_roi_align

    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    parent = args.parent.resolve()
    sections = args.only or SECTIONS
    # one training step of the flagship under each backend, captured once:
    # the pooler forward op's calls and the backward kernel's
    ops = {"auto": (multilevel_roi_align, "multilevel_roi_align"),
           "stacked": (stacked_roi_align, "multilevel_roi_align_stacked"),
           "clustered": (clustered_roi_align, "multilevel_roi_align_clustered")}
    backward_kernel = {"auto": multilevel_roi_align.KERNEL, "stacked": stacked_roi_align.KERNEL}
    captured = {}

    def keep_pooler(shapes, rois, levels, valid, g, *_):
        return [tuple(s) for s in shapes], rois.clone(), levels.clone(), valid.clone(), g.clone()

    def steps(backend):
        if backend not in captured:
            wanted = {"forward": (*ops[backend], keep_pool)}
            if backend in backward_kernel:
                wanted["backward"] = (backward_kernel[backend], "backward", keep_pooler)
            captured[backend] = captured_step("flagship", wanted, backend)
        return captured[backend]

    cases = []
    if "sampler" in sections:
        cases += sampler_section(parent, card, args.reps)
    if "backward" in sections:
        cases += backward_section(parent, steps)
    if "forward" in sections:
        cases += forward_section(parent, steps)
    if "stacked" in sections:
        cases += stacked_section(parent, steps)
    if "single" in sections:
        cases += single_section(parent)
    captured.clear()
    torch.cuda.empty_cache()
    time_cases(cases, card, args.reps)
    if "forward" in sections:
        device_times_of_this_tree(card, args.reps)


if __name__ == "__main__":
    main()
