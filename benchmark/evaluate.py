"""Evaluation: the port's `run_inference_on_dataset` (engine/test.py, the
loop that tools/test_net.py runs) with the configuration's TTA passes and
their merge, over successive slices of the tree.

The window calls the loop on the mix's `slice_images` images at a time,
from image 0 and cycling, and ends at the first slice boundary after
`--seconds`; an image counts once its slice has returned (the loop reads
every batch's detections back before it returns). In a traced run the
profiler covers the first TRACED_IMAGES images, a slice of their own, and
the rest of the first slice follows untraced. Set-up warms each distinct
pass bucket once: the loop over one landscape and one portrait image.

The check follows the port from its own state. The mix's `check_images`
are drawn from the seed among the first slice's images; the first time
each is evaluated in the window, each pass's served detections and pooler
calls are kept (the forward that the loop makes, wrapped), and the merged
set as the loop served it (what it hands `detections_to_coco`). After the
window, in float32:

  per pass       the reference on its own PIL decode of the pass (scale,
                 max size, flip) follows the pass from the port's rois
                 through the cell's head replay (replays/<head>.py):
                 `count_gap`, `proposal_stage`, `decode_stage`, each the
                 worst pass's; `box_p10`, the worst pass's and stage's
                 first decile, over the checked images' detections, of the
                 replay's box distances (the stage's output against the
                 reference's decode at the port's roi, over the box's
                 longer side). The first decile and not the replay's
                 quartile (`box_p25`, read): the 64x4d trunk in bfloat16
                 flips the grid argmax for 40-55 % of the boxes
                 (`decode_miss`), so that an image's quartile falls
                 between round-off and the flips' half cells (read up to
                 0.011 on sound seeds), where its decile stays at
                 round-off. `score_gap` is read: the worst of 72 passes
                 reaches the control's least reading
  merge_gap      the reference's own unflip, rescale and soft-NMS merge
                 (reference/engine/test.py) of the port's per-pass
                 detections against the served merged set, slot by slot:
                 infinite where a slot's validity or label differs (the
                 count is compared exactly), else the widest of each kept
                 box's coordinate difference over its longer side and of
                 its score's difference
  soft_nms_gap   over the checked images, 0 where the port's merge ran
                 soft-NMS (ops/nms.py's `ml_soft_nms`) once, over every
                 pass's detections, as TEST.SOFT_NMS says, else 1. At
                 random weights no candidate of a label overlaps a kept
                 one by more than the 0.5 of FAST_RCNN.NMS while scoring
                 over twice the hundredth's, so that soft-NMS keeps hard
                 NMS's 100 exactly and only its run tells them apart
  sampler_stage  replay.sampler_stage at the 30 deformable sampler calls
                 of the first checked image's first pass (the port's
                 forward run once more after the window, its inputs kept)

The control (reference/precision.py) is the reference in the port's
bfloat16 regime with every bfloat16 value rounded to float8 through every
pass, and its merge one step below the port's float32: the passes' boxes
and scores rounded to bfloat16 before it.
"""

import contextlib
import copy
import gc
import math
import time

import numpy as np
import torch

from benchmark import models
from benchmark.bounds import Captures
from benchmark.common import Run, free, log, prepare, reference_precision, subseed, sync
from benchmark.replay import PoolerCalls, StageFns, sampler_stage
from benchmark.serve import pack
from benchmark.trace import WINDOW, profiler, summarise

TRACED_IMAGES = 3   # whole images under the profiler
CAPTURED = 1        # traced images whose pooler and sampler inputs set the bounds
# the port's spans whose host time the metrics read, besides trace.py's
EVAL_SPANS = ("cpm/tta/", "cpm/data/load")
INFINITE = ("score_gap", "box_p25", "box_p10", "count_gap", "decode_stage", "proposal_stage",
            "merge_gap", "soft_nms_gap", "sampler_stage")


def _engine():
    from cpm_tpu_torch.engine import test

    return test


class Recorder:
    """While installed, wraps the names that `run_inference_on_dataset`
    looks up in engine/test.py: `tta_passes` (the passes of this call),
    `make_forward_fn` (each forward: the image and pass it serves, from the
    call's `start` and the count of forwards, at TEST.IMS_PER_GPU 1; the
    pooler calls and served detections of wanted images, and the inputs of
    the bound images' pooler and sampler calls, through `captures`) and
    `detections_to_coco` (each image's merged set as served); and
    ops/nms.py's `ml_soft_nms` outside a forward (the candidates of each
    soft-NMS in a wanted image's merge). `hooks` ({name: wrapper}) are
    planted faults, wrapping a name of the engine module first."""

    def __init__(self, captures: Captures, id_to_index: dict):
        self.captures, self.id_to_index = captures, id_to_index
        self.want, self.bound = set(), set()
        # image index -> dict(passes=[(served [K, 7], calls)], merged, soft_nms=[candidates])
        self.records = {}
        self.bound_calls = []
        self.start, self.forwards, self.n_passes = 0, 0, 1
        self.current, self.in_forward = None, False

    def begin(self, start: int):
        """Before each call of the loop, which starts at image `start`."""
        self.start, self.forwards = start, 0

    @contextlib.contextmanager
    def installed(self, hooks=None):
        engine = _engine()
        names = ("tta_passes", "make_forward_fn", "detections_to_coco", *(hooks or {}))
        saved = {n: getattr(engine, n) for n in names}
        for name, wrap in (hooks or {}).items():
            setattr(engine, name, wrap(getattr(engine, name)))
        real_passes, real_make, real_coco = (getattr(engine, n) for n in names[:3])

        def tta_passes(cfg):
            passes = real_passes(cfg)
            self.n_passes = len(passes)
            return passes

        def make_forward_fn(cfg, model):
            return self._wrap(real_make(cfg, model))

        def detections_to_coco(dets_np, image_id, scale_hw, c2j):
            rec = self.records.get(self.id_to_index[int(image_id)])
            if rec is not None and rec["merged"] is None:
                rec["merged"] = {k: np.array(v) for k, v in dets_np.items()}
            return real_coco(dets_np, image_id, scale_hw, c2j)

        engine.tta_passes, engine.make_forward_fn = tta_passes, make_forward_fn
        engine.detections_to_coco = detections_to_coco
        try:
            with counted_soft_nms(self._soft_nms):
                yield self
        finally:
            for n, v in saved.items():
                setattr(engine, n, v)

    def _soft_nms(self, candidates: int):
        rec = self.records.get(self.current)
        if not self.in_forward and rec is not None and rec["merged"] is None:
            rec["soft_nms"].append(candidates)

    def _wrap(self, forward):
        def recorded(images, image_sizes):
            idx = self.start + self.forwards // self.n_passes
            self.forwards += 1
            rec = self.records.get(idx)
            if idx in self.want and rec is None:
                rec = self.records[idx] = dict(passes=[], merged=None, soft_nms=[])
            self.current = idx
            check = rec is not None and rec["merged"] is None
            bound = idx in self.bound
            cap = self.captures
            cap.pooler.calls = []
            cap.armed = bound
            cap.pooler.armed = check or bound
            self.in_forward = True
            try:
                dets = forward(images, image_sizes)
            finally:
                self.in_forward = False
            cap.armed = False
            if check:
                rec["passes"].append((pack(dets), cap.pooler.calls))
            if bound:
                self.bound_calls.extend(cap.pooler.calls)
            return dets
        return recorded

    def host_records(self) -> dict:
        """The records with their served detections on the host."""
        return {i: dict(r, passes=[(s.cpu().numpy(), c) for s, c in r["passes"]])
                for i, r in self.records.items()}


@contextlib.contextmanager
def counted_soft_nms(count, owner=None):
    """While open, `count(candidates)` at each call of `owner.ml_soft_nms`
    (the port's ops/nms.py by default)."""
    if owner is None:
        from cpm_tpu_torch.ops import nms as owner
    real = owner.ml_soft_nms

    def soft(boxes, scores, *args, **kwargs):
        count(int(scores.shape[-1]))
        return real(boxes, scores, *args, **kwargs)

    owner.ml_soft_nms = soft
    try:
        yield
    finally:
        owner.ml_soft_nms = real


def check_sample(cell, seed: int) -> set:
    """The checked images, drawn from the seed among the first slice's."""
    rng = np.random.RandomState(subseed(seed, "check"))
    first = min(int(cell.mix["slice_images"]), int(cell.mix["images"]))
    return set(rng.choice(first, min(int(cell.mix["check_images"]), first), replace=False).tolist())


def port_dataset(prep):
    from cpm_tpu_torch.data.coco import COCODataset

    return COCODataset(prep.tree["annotations"], prep.tree["images"])


def warm_images(dataset) -> list:
    """One landscape and one portrait image of the tree (the loader's rule:
    landscape where the width is not under the height): between them every
    pass's two buckets."""
    found = {}
    for i in range(len(dataset)):
        info = dataset.get_img_info(i)
        found.setdefault(info["width"] >= info["height"], i)
    return sorted(found.values())


def port_sampler_calls(prep, model, index: int, device) -> list:
    """The inputs (on the host) of every deformable sampler call of the
    port's first pass of image `index`, through the forward the loop makes."""
    from cpm_tpu_torch.data.loader import TestLoader
    from cpm_tpu_torch.ops import deform_conv

    item = next(iter(TestLoader(prep.pcfg, port_dataset(prep), start=index, end=index + 1)))
    forward = _engine().make_forward_fn(prep.pcfg, model)
    return _sampled(deform_conv, lambda: forward(item["images"], item["image_sizes"]))


def _sampled(owner, run) -> list:
    calls, real = [], owner.deform_sample

    def sample(feat, ys, xs):
        calls.append({k: t.detach().to("cpu") for k, t in (("feat", feat), ("ys", ys), ("xs", xs))})
        return real(feat, ys, xs)

    owner.deform_sample = sample
    try:
        with torch.no_grad():
            run()
    finally:
        owner.deform_sample = real
    return calls


def run(cell, seed: int, seconds: float, trace: bool, device, workdir: str, t_start: float,
        hooks=None) -> Run:
    from cpm_tpu_torch.data.loader import describe_decode_path

    engine = _engine()
    out = Run()
    prep = prepare(cell, seed, device, workdir)
    dataset = port_dataset(prep)
    n, per_slice = len(dataset), int(cell.mix["slice_images"])
    t_model = time.perf_counter()
    model = models.program_model(prep.pcfg, prep.state, device)
    t_model = time.perf_counter() - t_model
    captures = Captures()
    recorder = Recorder(captures, {v: k for k, v in dataset.id_to_img_map.items()})
    seconds_a_batch = []

    def evaluate(start, end, into=None):
        recorder.begin(start)
        engine.run_inference_on_dataset(prep.pcfg, model, dataset, start=start, end=end,
                                        progress_every=0, batch_seconds=into)
        return end - start

    with captures.installed(), recorder.installed(hooks):
        t_warm = time.perf_counter()
        warm = warm_images(dataset)
        for i in warm:
            evaluate(i, i + 1)
        sync(device)
        passes = engine.tta_passes(prep.pcfg)
        buckets = 2 * len({(p["scale"], p["max_size"]) for p in passes})
        log(f"[setup] decode path: {describe_decode_path([engine.TestLoader(prep.pcfg, dataset)])}"
            f" (a flip pass decodes with PIL); the port's model in {t_model:.2f} s; warm-up of "
            f"{len(passes)} passes over images {warm} ({buckets} buckets) in "
            f"{time.perf_counter() - t_warm:.2f} s")

        recorder.want = check_sample(cell, seed)
        recorder.bound = set(range(CAPTURED)) if trace else set()
        # the slices of the window: in a traced run the first TRACED_IMAGES
        # images are a slice of their own, under the profiler
        first = [(0, min(TRACED_IMAGES, per_slice))] if trace else []
        if not first or first[0][1] < per_slice:
            first.append((first[0][1] if first else 0, per_slice))

        def slices():
            yield from first
            k = 1
            while True:
                start = (k * per_slice) % n
                yield start, min(start + per_slice, n)
                k += 1

        setup_peak = 0
        if torch.device(device).type == "cuda":
            setup_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        prof = profiler() if trace else None
        gc.collect()
        gc.disable()
        t0 = time.perf_counter()
        out.setup_s = t0 - t_start
        for k, (start, end) in enumerate(slices()):
            if k == 0 and prof is not None:
                prof.start()
                with torch.profiler.record_function(WINDOW):
                    out.images += evaluate(start, end, seconds_a_batch)
                    sync(device)
                out.traced_units = end - start
                out.host["traced_window_s"] = [time.perf_counter() - t0]
                prof.stop()
                recorder.bound = set()
            else:
                out.images += evaluate(start, end, seconds_a_batch)
            now = time.perf_counter()
            if now - t0 >= seconds and (k > 0 or prof is None):
                break
        out.window_s = now - t0
        gc.enable()
    out.attempted = out.images
    out.host["batch_seconds"] = seconds_a_batch
    if torch.device(device).type == "cuda":
        out.peak_window_bytes = torch.cuda.max_memory_allocated()
        out.peak_bytes = max(setup_peak, out.peak_window_bytes)
    log(f"[window] {out.images} images ({len(passes)} passes each) in {out.window_s:.3f} s; "
        f"memory peak {out.peak_window_bytes} bytes (set-up's {setup_peak})")
    if prof is not None:
        out.trace = summarise(prof)
        out.trace.spans.update(span_totals(prof))
        out.captured_units = CAPTURED
        captures.pooler.calls = recorder.bound_calls
        out.bounds = captures.totals()
        merges = out.trace.spans.get("cpm/tta/soft_nms", (0.0, 0))[1]
        log(f"[count] soft-NMS steps in the traced part: {merges} merges x "
            f"{prep.pcfg.FAST_RCNN.DETECTIONS_PER_IMG} = "
            f"{merges * prep.pcfg.FAST_RCNN.DETECTIONS_PER_IMG}")
    captures.pooler.calls, captures.sampler_calls, recorder.bound_calls = [], [], []
    del prof

    records = recorder.host_records()
    t = time.perf_counter()
    first_checked = min(records) if records else None
    calls = [] if first_checked is None else port_sampler_calls(prep, model, first_checked, device)
    del model
    free(device)
    out.numbers, out.flops_per_image = judge_images(prep, records, device, cell.head_replay(),
                                                    calls, seed, flops=trace)
    log(f"[check] {len(records)} images' {len(passes)} passes and merges against the reference "
        f"in {time.perf_counter() - t:.2f} s; candidates reaching each checked merge: "
        f"{[sum(int(s[:, 6].sum()) for s, _ in r['passes']) for r in records.values()]}")
    return out


def span_totals(prof) -> dict:
    """{name: (host s, count)} of the port's EVAL_SPANS inside the window,
    from the trace's events (trace.summarise keeps its own prefixes)."""
    cuda = torch.autograd.DeviceType.CUDA
    events = list(prof.profiler.kineto_results.events())
    window = next(e for e in events if e.name() == WINDOW and e.device_type() != cuda)
    a0, b0 = window.start_ns(), window.start_ns() + window.duration_ns()
    out = {}
    for e in events:
        name = e.name()
        if (name.startswith(EVAL_SPANS) and e.device_type() != cuda and a0 <= e.start_ns()
                and e.start_ns() + e.duration_ns() <= b0):
            s, c = out.get(name, (0.0, 0))
            out[name] = (s + e.duration_ns() * 1e-9, c + 1)
    return out


def reference_pass_input(prep, index: int, spec: dict, device, cfg=None):
    """Image `index` as the reference loads it for one pass (its own PIL
    decode, resize at the pass's scale and flip): (images, image_sizes,
    meta)."""
    from benchmark.reference.data.coco import COCODataset
    from benchmark.reference.data.loader import TestLoader

    data = COCODataset(prep.tree["annotations"], prep.tree["images"])
    item = next(iter(TestLoader(cfg or prep.rcfg, data, start=index, end=index + 1,
                                scale=spec["scale"], max_size=spec["max_size"],
                                hflip=spec["hflip"])))
    return (torch.as_tensor(item["images"], device=device),
            torch.as_tensor(item["image_sizes"], device=device), item["meta"][0])


def unpack(served, device) -> dict:
    """Served detections [K, 7] (box, score, label, mask) as the fields of
    a batch of one."""
    t = torch.as_tensor(served, device=device)[None]
    return dict(boxes=t[..., :4], scores=t[..., 4], labels=t[..., 5].long(), mask=t[..., 6] > 0)


def merge_difference(want: dict, got: dict) -> float:
    """`merge_gap` of one image: the reference's merged set `want` (fields
    [1, K]) against the served one `got` (numpy fields [K], the loop's)."""
    wm = want["mask"][0].cpu().numpy()
    gm = np.asarray(got["mask"]).astype(bool)
    if wm.shape != gm.shape or (wm != gm).any() or not wm.any():
        return math.inf
    wl, gl = want["labels"][0].cpu().numpy()[wm], np.asarray(got["labels"])[gm]
    if (wl.astype(np.int64) != gl.astype(np.int64)).any():
        return math.inf
    wb = want["boxes"][0].detach().float().cpu().numpy()[wm]
    gb = np.asarray(got["boxes"], np.float32)[gm]
    side = np.maximum(np.maximum(wb[:, 2] - wb[:, 0], wb[:, 3] - wb[:, 1]), 1.0)
    box = float((np.abs(gb - wb).max(axis=1) / side).max())
    ws = want["scores"][0].detach().float().cpu().numpy()[wm]
    return max(box, float(np.abs(np.asarray(got["scores"], np.float32)[gm] - ws).max()))


def merged_as_served(merged: dict) -> dict:
    """A merged set (fields [1, K]) as the loop hands it on: numpy [K]."""
    return dict(boxes=merged["boxes"][0].float().cpu().numpy(),
                scores=merged["scores"][0].float().cpu().numpy(),
                labels=merged["labels"][0].cpu().numpy().astype(np.int32),
                mask=merged["mask"][0].cpu().numpy())


def judge_images(prep, records, device, head, sampler_calls, seed, flops=False, control=False):
    """The numbers of the recorded images (module docstring), the reference
    in float32 following each pass from the port's pooler calls through
    `head` and merging the port's passes itself; with `control`, the
    control's records, its stage functions in its precision. With
    `flops`, the FLOPs of the reference's forwards of one image's passes
    (FlopCounterMode)."""
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.reference.engine import test as ref_tta

    passes = ref_tta.tta_passes(prep.rcfg)
    reference_precision(True)
    try:
        model = models.on_device(models.reference_meta(prep.rcfg), prep.state, device)
        fns = StageFns(control)
        rows, merge_gap, soft_gap, n_flops = [[] for _ in passes], 0.0, 0.0, 0.0
        runs = 1 if prep.rcfg.TEST.SOFT_NMS.ENABLED else 0
        whole = bool(records)
        with torch.no_grad():
            for k, (idx, rec) in enumerate(sorted(records.items())):
                if len(rec["passes"]) != len(passes) or rec["merged"] is None:
                    log(f"[check] image {idx}: {len(rec['passes'])} passes recorded of "
                        f"{len(passes)}, merged set {'kept' if rec['merged'] else 'missing'}")
                    whole = False
                    continue
                mapped = []
                for p, spec in enumerate(passes):
                    images, sizes, meta = reference_pass_input(prep, idx, spec, device)
                    if flops and k == 0:
                        counter = FlopCounterMode(display=False)
                        with counter:
                            model(images, sizes)
                        n_flops += float(counter.get_total_flops())
                    served, calls = rec["passes"][p]
                    rows[p].append(head.serve_numbers(model, images, sizes, calls, served, fns))
                    mapped.append(ref_tta.to_original(unpack(served, device), spec["hflip"],
                                                      sizes.cpu(), meta["scale_hw"]))
                want = ref_tta.merge_tta_detections(prep.rcfg, mapped)
                merge_gap = max(merge_gap, merge_difference(want, rec["merged"]))
                candidates = sum(len(m["scores"][0]) for m in mapped)
                soft_gap = max(soft_gap, float(rec["soft_nms"] != [candidates] * runs))
        if not whole:
            return {k: math.inf for k in INFINITE}, n_flops
        out, by_pass = {}, [head.combine(r) for r in rows]
        for numbers in by_pass:
            for name, v in numbers.items():
                if not name.startswith("box_p25_"):
                    out[name] = max(out.get(name, 0.0), v)
        out["box_p10"] = max(decile(r) for r in rows)
        log("[check] by pass (" + ", ".join(
            f"{p['scale'] or 'base'}{' flip' if p['hflip'] else ''}" for p in passes) + "): " +
            "; ".join(f"{k} " + " ".join(f"{n[k]:.4g}" for n in by_pass)
                      for k in ("score_gap", "box_p25", "decode_miss")))
        out["merge_gap"], out["soft_nms_gap"] = merge_gap, soft_gap
        if sampler_calls:
            out["sampler_stage"] = sampler_stage(sampler_calls, fns, subseed(seed, "sampler"),
                                                 device)
        return out, n_flops
    finally:
        reference_precision(False)


def decile(rows) -> float:
    """The largest over the stages of the first decile of the replay's box
    distances of one pass, pooled over the checked images (`rows`: each
    image's serve_numbers)."""
    worst = 0.0
    for s in range(len(rows[0]["box_dist"])):
        dist = torch.cat([r["box_dist"][s] for r in rows])
        worst = max(worst, float(torch.quantile(dist, 0.1)) if len(dist) else math.inf)
    return worst


def drop_last_pass(merge):
    """A merge that leaves the last pass's detections out."""
    return lambda cfg, per_pass: merge(cfg, per_pass[:-1])


def flip_undone(unflip):
    """A flip pass whose boxes stay in the flipped frame."""
    return lambda boxes, resized_w: boxes


def hard_nms(merge):
    """The merge under label-aware hard NMS in soft-NMS's place."""
    def merged(cfg, per_pass):
        cfg = copy.deepcopy(cfg)
        cfg.TEST.SOFT_NMS.ENABLED = False
        return merge(cfg, per_pass)
    return merged


# each a hook of the engine's names (Recorder.installed)
FAULTS = {"pass_dropped": {"merge_tta_detections": drop_last_pass},
          "flip_undone": {"_unflip_boxes": flip_undone},
          "hard_nms": {"merge_tta_detections": hard_nms}}


def port_records(cell, prep, seed, device, hooks=None):
    """(records, sampler calls) of the checked images through the port's
    loop, one image a call (under `hooks`, a planted fault)."""
    dataset = port_dataset(prep)
    model = models.program_model(prep.pcfg, prep.state, device)
    recorder = Recorder(Captures(), {v: k for k, v in dataset.id_to_img_map.items()})
    recorder.want = check_sample(cell, seed)
    with recorder.captures.installed(), recorder.installed(hooks):
        for i in sorted(recorder.want):
            recorder.begin(i)
            _engine().run_inference_on_dataset(prep.pcfg, model, dataset, start=i, end=i + 1,
                                               progress_every=0)
    records = recorder.host_records()
    calls = port_sampler_calls(prep, model, min(records), device)
    del model
    free(device)
    return records, calls


def control_records(cell, prep, seed, device):
    """(records, sampler calls) of the checked images through the control:
    each pass its forward on the reference's decode, the merge of its
    passes with their boxes and scores in bfloat16."""
    from benchmark.common import control_config
    from benchmark.reference.engine import test as ref_tta
    from benchmark.reference.ops import deform_conv as ref_deform_conv
    from benchmark.reference.ops import pooler as ref_pooler
    from benchmark.reference.precision import fp8_compute
    from benchmark.reference.utils.amp import cast_floating_to, compute_dtype

    cfg = control_config(prep)
    model = models.on_device(models.reference_meta(cfg), prep.state, device)
    cast = cast_floating_to({**dict(model.named_parameters()), **dict(model.named_buffers())},
                            compute_dtype(cfg))
    from benchmark.reference.ops import soft_nms as ref_soft_nms

    calls, records, sampled = PoolerCalls(), {}, []
    passes = ref_tta.tta_passes(cfg)
    picked = sorted(check_sample(cell, seed))
    with calls.installed(ref_pooler), torch.no_grad():
        for i in picked:
            rec, mapped = dict(passes=[], merged=None, soft_nms=[]), []
            for p, spec in enumerate(passes):
                images, sizes, meta = reference_pass_input(prep, i, spec, device, cfg)
                calls.calls, calls.armed = [], True
                run = lambda: torch.func.functional_call(model, cast, (images, sizes))
                with fp8_compute():
                    if i == picked[0] and p == 0:
                        holder = []
                        sampled = _sampled(ref_deform_conv, lambda: holder.append(run()))
                        dets = holder[0]
                    else:
                        dets = run()
                calls.armed = False
                served = pack(dets)
                rec["passes"].append((served.cpu().numpy(), calls.calls))
                m = ref_tta.to_original(unpack(served, device), spec["hflip"], sizes.cpu(),
                                        meta["scale_hw"])
                mapped.append(dict(m, boxes=m["boxes"].bfloat16().float(),
                                   scores=m["scores"].bfloat16().float()))
            with counted_soft_nms(rec["soft_nms"].append, ref_soft_nms):
                rec["merged"] = merged_as_served(ref_tta.merge_tta_detections(cfg, mapped))
            records[i] = rec
    del model, cast
    free(device)
    return records, sampled


def readings(cell, seed: int, device, kinds, workdir: str) -> dict:
    """calibrate.py's readings of one seed: {kind: numbers}. `program`: the
    port's checked images through its loop against the reference; each
    fault of FAULTS (with `fault`); `control`: the control's."""
    head = cell.head_replay()
    prep = prepare(cell, seed, device, workdir)
    out = {}
    plan = [("program", None)] if "program" in kinds else []
    plan += list(FAULTS.items()) if "fault" in kinds else []
    for name, hooks in plan:
        records, calls = port_records(cell, prep, seed, device, hooks)
        out[name] = judge_images(prep, records, device, head, calls, seed)[0]
        free(device)
    if "control" in kinds:
        records, calls = control_records(cell, prep, seed, device)
        out["control"] = judge_images(prep, records, device, head, calls, seed, control=True)[0]
        free(device)
    return out
