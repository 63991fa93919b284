"""Serving: a closed loop of batch-1 requests through the port's eval path.

A request is the port's `TestLoader` read of the next image (its fused
decode, resize and pad, on the caller's thread), the `make_forward_fn`
forward, and its detections read back to the host; then the next request
starts. The mix's images are cycled. Set-up warms every image once (both
orientations' buckets). A sample of the mix's images is drawn from the
seed before the window; the first request of each in the window keeps what
its pooler calls were given (replay.py). After the window the plain
reference, in float32 from the same JPEGs and weights, follows each of those
requests from the port's rois through the cell's head replay
(replays/<head>.py) and judges its served detections.
"""

import gc
import time

import numpy as np
import torch

from benchmark import faults, models
from benchmark.bounds import Captures
from benchmark.common import Run, free, log, prepare, reference_precision, subseed, sync
from benchmark.replay import PoolerCalls, StageFns
from benchmark.trace import WINDOW, profiler, span, summarise

TRACE_SECONDS = 6.0   # the traced part of a traced run's window
CAPTURED = 2          # requests whose pooler inputs set the bound


def pack(dets) -> torch.Tensor:
    """One image's detections as [K, 7]: box, score, label, mask."""
    return torch.cat([dets.boxes.float(), dets.scores.float()[..., None],
                      dets.labels.float()[..., None], dets.mask.float()[..., None]], -1)[0]


def port_serving(prep, device, hook=None):
    """The port's serving as a run builds it: the model holding the
    benchmark's weights, `make_forward_fn`'s forward (wrapped by `hook`, a
    planted fault) and the TestLoader."""
    from cpm_tpu_torch.data.coco import COCODataset
    from cpm_tpu_torch.data.loader import TestLoader
    from cpm_tpu_torch.engine.test import make_forward_fn

    model = models.program_model(prep.pcfg, prep.state, device)
    forward = make_forward_fn(prep.pcfg, model)
    if hook is not None:
        forward = hook(forward)
    return model, forward, TestLoader(prep.pcfg, COCODataset(prep.tree["annotations"],
                                                             prep.tree["images"]))


def run(cell, seed: int, seconds: float, trace: bool, device, workdir: str, t_start: float,
        hooks=None) -> Run:
    from cpm_tpu_torch.data.loader import describe_decode_path

    out = Run()
    prep = prepare(cell, seed, device, workdir)
    t_model = time.perf_counter()
    model, forward, loader = port_serving(prep, device, (hooks or {}).get("forward"))
    t_model = time.perf_counter() - t_model

    def cycle():
        while True:
            yield from loader

    stream = cycle()

    def request(tracing: bool, arm=None):
        t0 = time.perf_counter()
        with span("bench/load", tracing):
            item = next(stream)
        if arm is not None:
            arm(int(item["index"]))
        t1 = time.perf_counter()
        with span("bench/forward", tracing):
            dets = forward(item["images"], item["image_sizes"])
            sync(device)
        t2 = time.perf_counter()
        with span("bench/readback", tracing):
            host = pack(dets).cpu().numpy()
        t3 = time.perf_counter()
        return item["index"], host, (t1 - t0, t2 - t1, t3 - t0)

    t_warm = time.perf_counter()
    for _ in range(len(loader)):
        request(False)
    sync(device)
    log(f"[setup] decode path: {describe_decode_path([loader])}; the port's model in "
        f"{t_model:.2f} s; warm-up over {len(loader)} images in {time.perf_counter() - t_warm:.2f} s")

    picked = check_sample(cell, len(loader), seed)
    records = {}  # image index -> (served detections, pooler calls) of its first request
    captures = Captures()
    prof = profiler() if trace else None
    served, load, fwd, lat = [], [], [], []
    roofline_calls, for_bound = [], [False]

    def arm(idx):
        """Keep this request's pooler calls where the bound or the check
        wants them: the first CAPTURED traced requests, each sampled image's
        first request."""
        for_bound[0] = window is not None and out.traced_units < CAPTURED
        captures.pooler.calls = []
        captures.armed = for_bound[0] or (idx in picked and idx not in records)

    setup_peak = 0
    if torch.device(device).type == "cuda":
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    # the window allocates on the host at every request or step; the cyclic
    # collector's pauses are kept out of it (reference counting frees it all)
    gc.collect()
    gc.disable()
    with captures.installed():
        window = None
        if prof is not None:
            prof.start()
            window = torch.profiler.record_function(WINDOW)
            window.__enter__()
        t0 = time.perf_counter()
        out.setup_s = t0 - t_start
        traced_end = None
        while True:
            tracing = window is not None
            idx, host, (t_load, t_fwd, t_all) = request(tracing, arm)
            if captures.armed:
                captures.armed = False
                if for_bound[0]:
                    roofline_calls.extend(captures.pooler.calls)
                if idx in picked and idx not in records:
                    records[idx] = (host, captures.pooler.calls)
            served.append(idx)
            load.append(t_load * 1e3)
            fwd.append(t_fwd * 1e3)
            lat.append(t_all * 1e3)
            now = time.perf_counter()
            if tracing:
                out.traced_units += 1
                if now - t0 >= min(TRACE_SECONDS, seconds):
                    window.__exit__(None, None, None)
                    window = None
                    traced_end = now
            if now - t0 >= seconds:
                break
        out.window_s = now - t0
    gc.enable()
    if prof is not None:
        if window is not None:
            window.__exit__(None, None, None)
            traced_end = now
        prof.stop()
        out.trace = summarise(prof)
        out.host["traced_window_s"] = [traced_end - t0]
        out.captured_units = min(CAPTURED, out.traced_units)
    captures.armed = False
    stream.close()
    out.attempted = out.images = len(served)
    out.host.update(load_ms=load, forward_ms=fwd, latency_ms=lat)
    if torch.device(device).type == "cuda":
        out.peak_window_bytes = torch.cuda.max_memory_allocated()
    log(f"[window] {len(served)} requests in {out.window_s:.3f} s")

    del forward, model
    gc.collect()
    if torch.device(device).type == "cuda":
        out.peak_bytes = max(setup_peak, out.peak_window_bytes)
        torch.cuda.empty_cache()
    if trace:
        captures.pooler.calls = roofline_calls
        out.bounds = captures.totals()
    t = time.perf_counter()
    out.numbers, out.flops_per_image = judge_requests(prep, records, device, cell.head_replay(),
                                                      flops=trace)
    log(f"[check] {len(records)} of {len(picked)} sampled images' requests against the "
        f"reference in {time.perf_counter() - t:.2f} s")
    return out


def check_sample(cell, n_images: int, seed: int) -> set:
    """The images whose first request in the window is checked, drawn from
    the seed before the window."""
    rng = np.random.RandomState(subseed(seed, "check"))
    n = min(int(cell.mix["check_requests"]), n_images)
    return set(rng.choice(n_images, n, replace=False).tolist())


def reference_model(prep, device):
    return models.on_device(models.reference_meta(prep.rcfg), prep.state, device)


def reference_input(prep, index, device):
    """Image `index` as the reference loads it: its own PIL decode and
    resize of the JPEG."""
    from benchmark.reference.data.coco import COCODataset
    from benchmark.reference.data.loader import TestLoader

    data = COCODataset(prep.tree["annotations"], prep.tree["images"])
    item = next(iter(TestLoader(prep.rcfg, data, start=index, end=index + 1)))
    return (torch.as_tensor(item["images"], device=device),
            torch.as_tensor(item["image_sizes"], device=device))


def judge_requests(prep, records, device, head, flops=False, control=False):
    """The numbers of the recorded requests, the reference in float32
    following each from the port's pooler calls through `head` (the cell's
    replay module, whose `combine` puts the requests' numbers together; with
    `control`, the control's records, its stage functions in its
    precision); with `flops`, the FLOPs of one reference forward
    (FlopCounterMode)."""
    from torch.utils.flop_counter import FlopCounterMode

    reference_precision(True)
    try:
        model = reference_model(prep, device)
        rows, n_flops, fns = [], 0.0, StageFns(control)
        with torch.no_grad():
            for k, (idx, (host, calls)) in enumerate(sorted(records.items())):
                images, sizes = reference_input(prep, idx, device)
                if flops and k == 0:
                    counter = FlopCounterMode(display=False)
                    with counter:
                        model(images, sizes)
                    n_flops = float(counter.get_total_flops())
                rows.append(head.serve_numbers(model, images, sizes, calls, host, fns))
        return (head.combine(rows) if rows else {"score_gap": float("inf")}), n_flops
    finally:
        reference_precision(False)


FAULTS = {"altered_answer": faults.altered_answer, "shifted_boxes": faults.shifted_boxes,
          "cut_count": faults.cut_count}


def check_records(cell, prep, seed, device, control=False, hook=None):
    """{image index: (served detections, pooler calls)} of the check's
    sampled images: through the port's loader and forward (wrapped by
    `hook`, a planted fault), or with `control` through the control
    (reference/precision.py)."""
    import contextlib

    from benchmark.common import control_config
    from benchmark.reference.precision import fp8_compute
    from benchmark.reference.utils.amp import cast_floating_to, compute_dtype

    picked = check_sample(cell, int(cell.mix["images"]), seed)
    calls, records = PoolerCalls(), {}
    if control:
        from benchmark.reference.ops import pooler as owner

        cfg = control_config(prep)
        model = models.on_device(models.reference_meta(cfg), prep.state, device)
        cast = cast_floating_to({**dict(model.named_parameters()), **dict(model.named_buffers())},
                                compute_dtype(cfg))
        run = lambda i: torch.func.functional_call(model, cast, reference_input(prep, i, device))
        items = sorted(picked)
    else:
        from cpm_tpu_torch.ops import pooler as owner

        model, forward, loader = port_serving(prep, device, hook)
        loaded = {int(it["index"]): it for it in loader if int(it["index"]) in picked}
        run = lambda i: forward(loaded[i]["images"], loaded[i]["image_sizes"])
        items = sorted(loaded)
    with calls.installed(owner), torch.no_grad(), \
            (fp8_compute() if control else contextlib.nullcontext()):
        for i in items:
            calls.calls, calls.armed = [], True
            host = pack(run(i)).cpu().numpy()
            calls.armed = False
            records[i] = (host, calls.calls)
    del model, run
    free(device)
    return records


def readings(cell, seed: int, device, kinds, workdir: str) -> dict:
    """calibrate.py's readings of one seed: {kind: numbers}. `program`: the
    port's served detections of the sampled images against the reference;
    each fault of FAULTS (with `fault`); `control`: the control's."""
    head = cell.head_replay()
    prep = prepare(cell, seed, device, workdir)
    out = {}
    plan = [("program", None)] if "program" in kinds else []
    plan += list(FAULTS.items()) if "fault" in kinds else []
    for name, hook in plan:
        records = check_records(cell, prep, seed, device, hook=hook)
        out[name] = judge_requests(prep, records, device, head)[0]
    if "control" in kinds:
        records = check_records(cell, prep, seed, device, control=True)
        out["control"] = judge_requests(prep, records, device, head, control=True)[0]
    return out
