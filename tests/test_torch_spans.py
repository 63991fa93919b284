"""The port's spans (cpm_tpu_torch/utils/spans.py) and the tools that read
them: the helper costs nothing without a profiler, the tiny flagship's eval
forward and train step open the named spans, nested as the names say, on
one thread; the NMS's sync spans count its fixed-point iterations; and
tools/sync_sites.py and tools/profile_eval.py read the spans back.

torch and the port's modules are imported inside the tests, so that
collecting this file loads no torch into a test worker.
"""

import sys
import types

import numpy as np
import pytest

from tests.torch_support import _one_torch_thread  # noqa: F401  (autouse)
from tests.torch_support import memo


@pytest.fixture(scope="module", autouse=True)
def _drop_stub_modules_that_answer_every_name():
    """tests/test_weight_parity.py leaves stub modules in `sys.modules` whose
    `__getattr__` answers every name, `__file__` included, with a function.
    torch registers custom ops at the first backward or optimizer of a process
    and looks its caller up with `inspect.getmodule`, which walks
    `sys.modules` and fails on such a `__file__`. Whether that file ran
    earlier in this worker depends on the scheduling, so the stubs go before
    this file's first torch call; that file installs them again when it needs
    them."""
    for name, mod in list(sys.modules.items()):
        if isinstance(mod, types.ModuleType) and callable(getattr(mod, "__file__", None)):
            del sys.modules[name]


# each span's innermost enclosing span, of those the tiny flagship opens
EVAL_PARENTS = {
    "cpm/forward": {None},
    "cpm/sync/inputs": {"cpm/forward"},
    "cpm/sync/consts": {"cpm/forward", "cpm/head/stage1", "cpm/head/stage2", "cpm/head/stage3"},
    "cpm/backbone": {"cpm/forward"},
    "cpm/fpn": {"cpm/forward"},
    "cpm/rpn/head": {"cpm/forward"},
    "cpm/rpn/proposals": {"cpm/forward"},
    "cpm/sync/nms": {"cpm/rpn/proposals", "cpm/head/filter"},
    "cpm/head/cls": {"cpm/forward"},
    "cpm/head/filter": {"cpm/head/cls"},
    "cpm/sync/tower_size": {"cpm/forward"},
    "cpm/head/stage1": {"cpm/forward"},
    "cpm/head/stage2": {"cpm/forward"},
    "cpm/head/stage3": {"cpm/forward"},
    "cpm/head/rescore": {"cpm/forward"},
}
TRAIN_PARENTS = {
    "cpm/sync/inputs": {None},
    "train_step/forward": {None},
    "train_step/backward": {None},
    "train_step/allreduce": {None},
    "train_step/optimizer": {None},
    "cpm/cast": {"train_step/forward"},
    "cpm/sync/consts": {"train_step/forward", "cpm/head/stage1", "cpm/head/stage2",
                        "cpm/head/stage3"},
    "cpm/sync/ism_row": {"cpm/head/stage3"},
    "cpm/backbone": {"train_step/forward"},
    "cpm/fpn": {"train_step/forward"},
    "cpm/rpn/head": {"train_step/forward"},
    "cpm/rpn/proposals": {"train_step/forward"},
    "cpm/sync/nms": {"cpm/rpn/proposals"},
    "cpm/rpn/losses": {"train_step/forward"},
    "cpm/sync/draws": {"cpm/rpn/losses", "cpm/head/cls", "cpm/head/rescore",
                       "train_step/forward"},
    "cpm/head/cls": {"train_step/forward"},
    "cpm/sync/tower_size": {"cpm/head/stage1", "cpm/head/stage2", "cpm/head/stage3"},
    "cpm/head/stage1": {"train_step/forward"},
    "cpm/head/stage2": {"train_step/forward"},
    "cpm/head/stage3": {"train_step/forward"},
    "cpm/head/rescore": {"train_step/forward"},
}


def _spans(prof, prefixes=("cpm/", "train_step/")):
    """(start, end, name, thread, user annotation?) of the host spans of
    `prof` with a prefix of `prefixes`, in start order."""
    return sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name(), e.start_thread_id(),
                   e.is_user_annotation())
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith(prefixes))


def _parents(spans):
    """{name: names of the innermost span around each of its ranges}, and
    whether every two spans nest or are apart."""
    parents, nested = {}, True
    for i, (a, b, name, *_) in enumerate(spans):
        around = [s for j, s in enumerate(spans) if j != i and s[0] <= a and b <= s[1]]
        inner = min(around, key=lambda s: s[1] - s[0])[2] if around else None
        parents.setdefault(name, set()).add(inner)
        nested &= all(b <= s[0] or s[1] <= a or (s[0] <= a and b <= s[1])
                      or (a <= s[0] and s[1] <= b) for s in spans)
    return parents, nested


def _tiny():
    """The tiny flagship in f32 with every detection kept, its train step
    and eval forward, a uint8 batch of two images."""
    import torch

    from cpm_tpu_torch.config import flagship_cfg
    from cpm_tpu_torch.data.synthetic import synthetic_batch
    from cpm_tpu_torch.engine.test import make_forward_fn
    from cpm_tpu_torch.engine.train import create_train_state, make_train_step

    cfg = flagship_cfg(tiny=True)
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.GRID_RCNN.SCORE_THRESH = 0.0
    model, optimizer, state = create_train_state(cfg, "cpu", seed=0)
    step_fn = make_train_step(cfg, model, optimizer)
    batch = synthetic_batch(2, 64, 96, max_gt=4, num_classes=cfg.MODEL.NUM_CLASSES, seed=3,
                            uint8=True)
    with torch.no_grad():
        forward = make_forward_fn(cfg, model)
    return dict(cfg=cfg, state=state, step_fn=step_fn, forward=forward, batch=batch)


def _traced(kind, n=1):
    from torch.profiler import ProfilerActivity, profile

    t = memo("spans_tiny", _tiny)
    b = t["batch"]
    run = ((lambda: t["forward"](b["images"][:1], b["image_sizes"][:1])) if kind == "eval"
           else (lambda: t["step_fn"](t["state"], b)))
    run()  # outside the profiler: no span opens
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(n):
            run()
    return prof


def test_a_span_without_a_profiler_is_one_shared_null_context():
    import contextlib

    from cpm_tpu_torch.utils.spans import span, sync

    assert span("cpm/forward") is span("cpm/backbone") is sync("nms")
    assert isinstance(span("cpm/forward"), contextlib.nullcontext)


@pytest.mark.parametrize("kind,parents", [("eval", EVAL_PARENTS), ("train", TRAIN_PARENTS)])
def test_a_traced_forward_opens_the_named_spans_nested_on_one_thread(kind, parents):
    spans = _spans(_traced(kind))
    found, nested = _parents(spans)
    assert set(found) == set(parents), set(found) ^ set(parents)
    for name, inner in found.items():
        assert inner <= parents[name], (name, inner)
    assert nested
    assert len({s[3] for s in spans}) == 1
    # op ranges: the profiler lays no copy of them on the device's timeline
    assert not any(s[4] for s in spans)
    names = [s[2] for s in spans]
    # the sync sites a request and a step pass, as tools/sync_sites.py lists
    # them on the card: consts are the normalisation's two, and a grid
    # decode's one plus two for each of its four votes, and in training the
    # targets' two a stage
    if kind == "eval":
        want = {"cpm/forward": 1, "cpm/sync/inputs": 2, "cpm/sync/tower_size": 1,
                "cpm/sync/consts": 2 + 3 * 9}
    else:
        want = {"cpm/sync/inputs": len(memo("spans_tiny", _tiny)["batch"]),
                "cpm/sync/tower_size": 3, "cpm/sync/draws": 7, "cpm/sync/ism_row": 2,
                "cpm/sync/consts": 2 + 3 * 2 + 2 * 9}
    assert {k: names.count(k) for k in want} == want


def _fixed_point_iterations(iou, valid, thresh):
    """The comparisons `_sorted_keep_mask`'s loop makes, counted on numpy."""
    n = iou.shape[-1]
    earlier = np.arange(n)[:, None] < np.arange(n)[None, :]
    over = (iou > thresh) & earlier & valid[..., :, None] & valid[..., None, :]
    keep, count = valid, 0
    while True:
        new = ~np.any(over & keep[..., :, None], axis=-2) & valid
        count += 1
        if (new == keep).all():
            return count, keep
        keep = new


@pytest.mark.parametrize("chain", [1, 2, 5, 9])
def test_the_nms_sync_spans_count_its_fixed_point_iterations(chain):
    """Boxes in a row, each overlapping the next by IoU 1/3: greedy NMS keeps
    every other one, and the fixed point takes about `chain` rounds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cpm_tpu_torch.ops.nms import nms
    from cpm_tpu_torch.structures.boxes import box_iou

    x = torch.arange(chain, dtype=torch.float32) * 5.0
    boxes = torch.stack([x, torch.zeros_like(x), x + 10.0, torch.full_like(x, 10.0)], -1)
    scores = torch.linspace(1.0, 0.5, chain)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        idx, keep = nms(boxes, scores, 0.3, chain)
    counted = sum(1 for s in _spans(prof) if s[2] == "cpm/sync/nms")
    want, kept = _fixed_point_iterations(box_iou(boxes, boxes).numpy(), np.ones(chain, bool), 0.3)
    assert counted == want >= min(chain, 2)
    assert idx[keep].tolist() == np.flatnonzero(kept).tolist() == list(range(0, chain, 2))


def test_sync_sites_names_the_span_around_a_blocking_call():
    import inspect
    import traceback

    from cpm_tpu_torch.ops import nms
    from cpm_tpu_torch.tools.sync_sites import covering_span, site_of
    from cpm_tpu_torch.utils import sampler

    def frame(module, text):
        lines, first = inspect.getsourcelines(module)
        lineno = first + next(i for i, line in enumerate(lines) if text in line)
        return traceback.FrameSummary(inspect.getsourcefile(module), lineno, "f")

    equal = frame(nms, "converged = torch.equal(")
    draws = frame(sampler, "return u.to(device)")
    outside = frame(nms, "new_keep = ~torch.any(")
    torch_inside = traceback.FrameSummary("/elsewhere/torch/functional.py", 3, "g")
    assert covering_span([equal]) == "cpm/sync/nms"
    assert covering_span([draws, torch_inside]) == "cpm/sync/draws"
    assert covering_span([outside, torch_inside]) is None
    # an enclosing statement in a caller covers the frames below it
    assert covering_span([equal, outside]) == "cpm/sync/nms"
    assert site_of([equal, outside, torch_inside]) is outside


@pytest.mark.parametrize("kind,root", [("eval", "cpm/forward"), ("train", "train_step/forward")])
def test_the_profilers_stage_table_reads_the_spans(kind, root):
    from cpm_tpu_torch.tools.profile_eval import stage_table

    rows = stage_table(_traced(kind, n=2), 2)
    parents = EVAL_PARENTS if kind == "eval" else TRAIN_PARENTS
    assert set(rows) == set(parents) | {"outside any span"}
    assert list(rows)[0] == ("cpm/forward" if kind == "eval" else "cpm/sync/inputs")
    assert all(rows[k][1] == 1 for k in (root, "cpm/backbone", "cpm/head/stage3"))
    assert 0 < rows["cpm/backbone"][0] < rows[root][0]
    # no device on the CPU: the card is "idle" from the first span to the
    # last, which holds both runs' spans
    assert sum(r[2] for r in rows.values()) >= rows[root][0]
