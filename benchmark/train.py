"""Training: steps back to back through the port's `make_train_step`, fed by
its `TrainLoader` (the native decode pool beneath the prefetch thread).

Set-up builds one train state from the seed's weights and drives it through
its first three steps on the window's own loader; the optimizer's state
after step 1 gives the first gradient (SGD's buffer is g + wd * p0), the
parameters after step 3 the change; what their RoI head and (step 1's)
deformable sampler were given is kept (replay.TrainCapture). The same state
then warms the loader's other orientation and runs the window. After the
window the reference, in float32 from the same weights, draws and JPEGs
(its own PIL decode of the same batch plan), takes the same three steps
through the cell's head replay, and checks the stages it skips (check.py,
replay.py).
"""

import gc
import math
import time

import torch

from benchmark import check, faults, models
from benchmark.bounds import Captures
from benchmark.common import (LOADER_SEEDS, Run, free, log, prepare, reference_precision,
                              subseed, sync)
from benchmark.replay import ReplayMismatch, StageFns, TrainCapture
from benchmark.trace import WINDOW, profiler, span, summarise

CHECKED_STEPS = 3
TRACE_SECONDS = 6.0
CAPTURED = 2        # steps whose pooler and sampler inputs set the bounds
MAX_WARMUP = 40


def leaf_norms(model, optimizer, p0: dict, device):
    """(first gradient's norm per leaf, from SGD's buffer after one step)."""
    names = {id(p): n for n, p in model.named_parameters()}
    out = {}
    for group in optimizer.param_groups:
        for p in group["params"]:
            name = names[id(p)]
            buf = optimizer.state.get(p, {}).get("momentum_buffer")
            if buf is None:
                out[name] = math.nan
                continue
            g = buf - group["weight_decay"] * p0[name].to(device)
            out[name] = float(torch.linalg.vector_norm(g.float()))
    return out


def change_norms(model, optimizer, p0: dict, device):
    names = {id(p): n for n, p in model.named_parameters()}
    return {names[id(p)]: float(torch.linalg.vector_norm((p.detach() - p0[names[id(p)]].to(device)).float()))
            for group in optimizer.param_groups for p in group["params"]}


def drive_checked(step_fn, state, batches, model, optimizer, p0, device, first_step=None,
                  capture=None):
    """The first CHECKED_STEPS steps: their total losses, the first
    gradient's and the change's norms per leaf. `first_step` wraps step 1
    (the reference counts its FLOPs there); `capture` (replay.TrainCapture)
    records what each step's RoI head was given."""
    import contextlib

    losses, parts, grad = [], [], {}
    with capture.installed() if capture is not None else contextlib.nullcontext():
        if capture is not None:
            capture.armed = True
        state, losses, parts, grad = _steps(step_fn, state, batches, model, optimizer, p0,
                                            device, first_step)
        if capture is not None:
            capture.armed = False
    return state, dict(losses=losses, parts=parts, grad=grad,
                       delta=change_norms(model, optimizer, p0, device))


def _steps(step_fn, state, batches, model, optimizer, p0, device, first_step):
    losses, parts, grad = [], [], {}
    for s in range(CHECKED_STEPS):
        batch = next(batches)
        if s == 0 and first_step is not None:
            with first_step:
                state, metrics = step_fn(state, batch)
        else:
            state, metrics = step_fn(state, batch)
        losses.append(float(metrics["total_loss"]))
        parts.append({k: float(v) for k, v in metrics.items() if k.startswith("loss")})
        if s == 0:
            grad = leaf_norms(model, optimizer, p0, device)
    return state, losses, parts, grad


def port_training(prep, per_card: int, seed: int, device, hook=None):
    """The port's training as a run builds it: the model holding the
    benchmark's weights, its optimizer and state (draws from the seed), the
    step (wrapped by `hook`, a planted fault), the TrainLoader, and the
    capture of what the checked steps' RoI head is given."""
    from cpm_tpu_torch.data.coco import COCODataset
    from cpm_tpu_torch.data.loader import TrainLoader
    from cpm_tpu_torch.engine.train import TrainState, make_train_step
    from cpm_tpu_torch.ops import deform_conv, pooler
    from cpm_tpu_torch.solver.optimizer import build_optimizer
    from cpm_tpu_torch.utils.sampler import Draws

    model = models.program_model(prep.pcfg, prep.state, device)
    optimizer = build_optimizer(prep.pcfg, model)
    state = TrainState(step=0, model=model, optimizer=optimizer,
                       draws=Draws(torch.Generator().manual_seed(subseed(seed, "draws"))))
    step_fn = make_train_step(prep.pcfg, model, optimizer)
    if hook is not None:
        step_fn = hook(step_fn)
    loader = TrainLoader(prep.pcfg, COCODataset(prep.tree["annotations"], prep.tree["images"]),
                         per_card, seed=subseed(seed, "loader", LOADER_SEEDS))
    return model, optimizer, state, step_fn, loader, TrainCapture(model, pooler, deform_conv)


def run(cell, seed: int, seconds: float, trace: bool, device, workdir: str, t_start: float,
        hooks=None) -> Run:
    from cpm_tpu_torch.data.loader import describe_decode_path

    out = Run()
    per_card = int(cell.mix["images_per_card"])
    prep = prepare(cell, seed, device, workdir, train_images=per_card * cell.chips)
    t_model = time.perf_counter()
    model, optimizer, state, step_fn, loader, capture = port_training(
        prep, per_card, seed, device, (hooks or {}).get("step"))
    t_model = time.perf_counter() - t_model
    batches = iter(loader)

    shapes = set()

    def feed():
        while True:
            batch = next(batches)
            shapes.add(tuple(batch["images"].shape))
            yield batch

    stream = feed()
    t_warm = time.perf_counter()
    state, got = drive_checked(step_fn, state, stream, model, optimizer, prep.state, device,
                               capture=capture)
    buckets = set(loader.buckets.values())
    warm = 0
    while warm < MAX_WARMUP and ({s[1:3] for s in shapes} != buckets or warm < 2):
        state, _ = step_fn(state, next(stream))
        warm += 1
    sync(device)
    log(f"[setup] decode path: {describe_decode_path([loader])}; the port's model in "
        f"{t_model:.2f} s; {CHECKED_STEPS} checked and {warm} warm-up steps over shapes "
        f"{sorted(shapes)} in {time.perf_counter() - t_warm:.2f} s")

    captures = Captures()
    prof = profiler() if trace else None
    waits, totals = [], []
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
            captures.armed = tracing and out.attempted < CAPTURED
            tw = time.perf_counter()
            with span("bench/next_batch", tracing):
                batch = next(stream)
            waits.append((time.perf_counter() - tw) * 1e3)
            state, metrics = step_fn(state, batch)
            totals.append(metrics["total_loss"])
            out.attempted += 1
            out.images += int(batch["images"].shape[0])
            now = time.perf_counter()
            if tracing:
                out.traced_units += 1
                if now - t0 >= min(TRACE_SECONDS, seconds):
                    sync(device)
                    window.__exit__(None, None, None)
                    window = None
                    traced_end = time.perf_counter()
            if now - t0 >= seconds:
                break
        sync(device)
        out.window_s = time.perf_counter() - t0
    gc.enable()
    if prof is not None:
        if window is not None:
            window.__exit__(None, None, None)
            traced_end = t0 + out.window_s
        prof.stop()
        out.trace = summarise(prof)
        out.host["traced_window_s"] = [traced_end - t0]
        out.captured_units = min(CAPTURED, out.traced_units)
    stream.close()
    out.failed = int((~torch.isfinite(torch.stack(totals))).sum())
    out.host["loader_wait_ms"] = waits
    if torch.device(device).type == "cuda":
        out.peak_window_bytes = torch.cuda.max_memory_allocated()
    log(f"[window] {out.attempted} steps, {out.images} images in {out.window_s:.3f} s; "
        f"step 1-{CHECKED_STEPS} total losses {got['losses']}")

    del step_fn, state, optimizer, model, metrics, totals
    gc.collect()
    if torch.device(device).type == "cuda":
        out.peak_bytes = max(setup_peak, out.peak_window_bytes)
        torch.cuda.empty_cache()
    if trace:
        out.bounds = captures.totals()
    captures.pooler.calls.clear()
    captures.sampler_calls.clear()
    t = time.perf_counter()
    want, flops = reference_steps(prep, per_card, seed, device, cell.head_replay(), capture,
                                  flops=trace)
    out.numbers = check.train_numbers(got, want)
    out.flops_per_image = flops / per_card
    log(f"[check] {CHECKED_STEPS} reference steps in {time.perf_counter() - t:.2f} s; total "
        f"losses {want['losses'] if want else None}")
    return out


def reference_steps(prep, per_card: int, seed: int, device, head, capture, flops=False,
                    regime=None, of_control=False):
    """The reference's first CHECKED_STEPS steps on the same weights, draws
    and batch plan. In float32, replaying `capture` (the port's, or the
    control's TrainCapture) through `head` (the cell's replay module) from
    each step's proposals and rois; with `regime` "fp8" the control
    (reference/precision.py), or "bf16" the reference in the port's
    bfloat16 regime, each recording its own; `of_control` says that
    `capture` is the control's, whose stage functions are then the
    reference's in the control's precision. Returns (the steps' readings,
    with the stage checks', and the FLOPs of step 1 with `flops`; or with a
    `regime`, the readings and its TrainCapture)."""
    import contextlib

    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.common import control_config
    from benchmark.reference.data.coco import COCODataset
    from benchmark.reference.data.loader import TrainLoader
    from benchmark.reference.engine.train import TrainState, make_train_step
    from benchmark.reference.ops import deform_conv as ref_deform_conv
    from benchmark.reference.ops import pooler as ref_pooler
    from benchmark.reference.precision import fp8_compute
    from benchmark.reference.solver.optimizer import build_optimizer
    from benchmark.reference.utils.sampler import Draws

    reference_precision(True)
    try:
        cfg = control_config(prep) if regime else prep.rcfg
        model = models.on_device(models.reference_meta(cfg), prep.state, device)
        optimizer = build_optimizer(cfg, model)
        state = TrainState(step=0, model=model, optimizer=optimizer,
                           draws=Draws(torch.Generator().manual_seed(subseed(seed, "draws"))))
        data = COCODataset(prep.tree["annotations"], prep.tree["images"])
        batches = iter(TrainLoader(cfg, data, per_card, seed=subseed(seed, "loader", LOADER_SEEDS),
                                   prefetch=0))
        counter = FlopCounterMode(display=False) if flops else None
        own = replay = None
        if regime:
            own = TrainCapture(model, ref_pooler, ref_deform_conv)
        else:
            replay = head.TrainReplay(capture, StageFns(of_control), subseed(seed, "sampler"))
            model.replay = model.roi_head.replay = replay
        try:
            with fp8_compute() if regime == "fp8" else contextlib.nullcontext():
                _, want = drive_checked(make_train_step(cfg, model, optimizer), state, batches,
                                        model, optimizer, prep.state, device, first_step=counter,
                                        capture=own)
        except ReplayMismatch as e:
            log(f"[check] the replay does not fit: {e}")
            want = None
        batches.close()
        if regime:
            return want, own
        if want is not None:
            want.update(replay.numbers(device))
        return want, float(counter.get_total_flops()) if counter else 0.0
    finally:
        reference_precision(False)


FAULTS = {"half_batch": faults.half_batch, "unchanged_state": faults.unchanged_state}


def program_steps(prep, per_card, seed, device, hook=None):
    """The port's first three steps as a run drives them, and the capture of
    what they were given."""
    model, optimizer, state, step_fn, loader, capture = port_training(
        prep, per_card, seed, device, hook)
    batches = iter(loader)
    _, got = drive_checked(step_fn, state, batches, model, optimizer, prep.state, device,
                           capture=capture)
    batches.close()
    del step_fn, state, optimizer, model
    free(device)
    return got, capture


def readings(cell, seed: int, device, kinds, workdir: str) -> dict:
    """calibrate.py's readings of one seed: {kind: numbers}. `program`: the
    port's first three steps against the reference; each fault of FAULTS
    (with `fault`); `control`: the control against the reference; `bf16`:
    the reference in the port's bfloat16 regime against the reference, the
    witness of what bfloat16 alone does to the numbers."""
    head = cell.head_replay()
    per_card = int(cell.mix["images_per_card"])
    prep = prepare(cell, seed, device, workdir, train_images=per_card * cell.chips)
    out = {}
    plan = [("program", None)] if "program" in kinds else []
    plan += [(name, hook) for name, hook in FAULTS.items() if "fault" in kinds]
    for name, hook in plan:
        got, capture = program_steps(prep, per_card, seed, device, hook)
        want, _ = reference_steps(prep, per_card, seed, device, head, capture)
        out[name] = dict(check.train_numbers(got, want), **check.worst_leaves(got, want))
        free(device)
    for kind, regime in (("control", "fp8"), ("bf16", "bf16")):
        if kind in kinds:
            ctl, capture = reference_steps(prep, per_card, seed, device, head, None, regime=regime)
            free(device)
            want, _ = reference_steps(prep, per_card, seed, device, head, capture,
                                      of_control=regime == "fp8")
            out[kind] = dict(check.train_numbers(ctl, want), **check.worst_leaves(ctl, want))
            free(device)
    return out
