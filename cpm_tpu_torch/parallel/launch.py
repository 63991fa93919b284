"""Spawned ranks, and one rank's train steps from a saved spec.

`spawn_ranks` runs a function in N processes started with the spawn method
(a parent with live CUDA must not fork), which meet through a fresh
`file://` store, and returns their results; a rank that raises, dies or
outlasts the timeout fails the call, and the others are killed. `train_steps`
is one rank's part in holding the data-parallel step against one process:
it builds the model, takes its rows of a global batch and of the draws, and
steps. tests/test_torch_parallel.py and chip_smoke.py's phase 16 drive both.
"""

import hashlib
import os
import shutil
import tempfile
import time
import traceback
from contextlib import nullcontext
from typing import Callable, List

import torch

from cpm_tpu_torch.parallel.mesh import destroy_data_group, init_data_group


def file_init_method(workdir: str, name: str) -> str:
    """A `file://` init_method in `workdir`; one name a group, since a store
    file left by an earlier group would block the rendezvous."""
    return "file://" + os.path.join(workdir, f"store-{name}")


def _rank_main(fn, rank: int, world_size: int, workdir: str, args, threads: int):
    torch.set_num_threads(threads)
    try:
        result = fn(rank, world_size, workdir, *args)
        tmp = os.path.join(workdir, f"rank{rank}.pt.tmp")
        torch.save(result, tmp)
        os.replace(tmp, os.path.join(workdir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(workdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn_ranks(fn: Callable, world_size: int, *args, timeout_s: float = 600,
                threads: int = 1) -> List:
    """fn(rank, world_size, workdir, *args) in `world_size` spawned processes
    of `threads` CPU threads each; returns their results in rank order. `fn`
    is a module-level function (it is pickled by name); `workdir` is a fresh
    directory the ranks share (`file_init_method` names stores in it), gone
    when the call returns. Raises when a rank fails or the ranks are not done
    within `timeout_s`, after killing the ones still running."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    workdir = tempfile.mkdtemp(prefix="cpm_ranks_")
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world_size, workdir, args, threads),
                         name=f"rank{r}") for r in range(world_size)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        failed = []
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
            if p.exitcode is None:
                failed.append(f"{p.name} still running after {timeout_s} s")
                break
            if p.exitcode != 0:
                failed.append(f"{p.name} exited with {p.exitcode}")
                break
        if failed:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(10)
            errors = []
            for r in range(world_size):
                path = os.path.join(workdir, f"rank{r}.err")
                if os.path.exists(path):
                    with open(path) as f:
                        errors.append(f"rank {r}:\n{f.read()}")
            raise RuntimeError("; ".join(failed) + "\n" + "\n".join(errors))
        return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
                for r in range(world_size)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        shutil.rmtree(workdir, ignore_errors=True)


def params_digest(model: torch.nn.Module) -> str:
    """A hash of every parameter's bits, in name order."""
    h = hashlib.sha256()
    for name, p in model.named_parameters():
        h.update(name.encode())
        h.update(p.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def train_steps(rank: int, world_size: int, workdir, spec) -> dict:
    """One rank's train steps. `spec` (a dict, or the path of one saved with
    torch.save) holds `cfg`, `device` ('cpu' or 'cuda'), `seed`, `steps`,
    `batch` (the global batch, numpy; rank r takes rows r * B / world_size
    on), and optionally `state_dict` (the weights to start from, else the
    seed's), `draws` (a list of global arrays that every step consumes anew,
    else the seeded generator's stream), `group` (join a group even at world
    size 1; a group is joined whenever world_size > 1), `backend` and
    `local_rank` (two ranks on one card: 'gloo' and 0), `params_after` (the
    steps after which this rank returns its parameters, on the CPU) and
    `profile_step` (a step to run under torch.profiler).

    Returns `metrics` (a dict of floats a step), `digests` (the parameters'
    hash after each step), `params` ({step: {name: tensor}}), `step_s` (each
    step's wall time, the device synchronised), and of the profiled step
    `allreduce_s` (its `train_step/allreduce` span on the host clock),
    `collectives` and `collective_s` (the number of its torch.distributed
    calls, the loss counts' and the top-k's included, and their time on the
    host clock) and, on a card, `nccl_s` (the device time of its NCCL
    kernels; None when the profiler recorded no device time)."""
    from torch.profiler import ProfilerActivity, profile

    from cpm_tpu_torch.engine.train import create_train_state, make_train_step
    from cpm_tpu_torch.utils.sampler import Draws

    if isinstance(spec, str):
        spec = torch.load(spec, weights_only=False)
    cfg = spec["cfg"]
    device = torch.device(spec["device"])
    joined = world_size > 1 or spec.get("group", False)
    if joined:
        device = init_data_group(
            spec["device"], rank=rank, world_size=world_size,
            local_rank=spec.get("local_rank", rank), backend=spec.get("backend"),
            init_method=file_init_method(workdir, "steps")).device
    try:
        model, optimizer, state = create_train_state(cfg, device, spec.get("seed", 0))
        if spec.get("state_dict") is not None:
            model.load_state_dict(spec["state_dict"])
        n = len(spec["batch"]["images"]) // world_size
        batch = {k: v[rank * n:(rank + 1) * n] for k, v in spec["batch"].items()}
        step_fn = make_train_step(cfg, model, optimizer)
        sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        out = dict(metrics=[], digests=[], params={}, step_s=[], allreduce_s=None,
                   collectives=None, collective_s=None, nccl_s=None)
        for i in range(1, int(spec["steps"]) + 1):
            if spec.get("draws") is not None:
                state.draws = Draws(spec["draws"], rank, world_size)
            profiled = i == spec.get("profile_step")
            with profile(activities=activities) if profiled else nullcontext() as prof:
                sync()
                t0 = time.perf_counter()
                state, metrics = step_fn(state, batch)
                sync()
                out["step_s"].append(time.perf_counter() - t0)
            if profiled:
                events = prof.key_averages()
                host = torch.autograd.DeviceType.CPU
                on_host = [e for e in events if e.device_type == host]
                out["allreduce_s"] = 1e-6 * next(e.cpu_time_total for e in on_host
                                                 if e.key == "train_step/allreduce")
                # the dispatcher's ops (c10d::allreduce_, ...), once a call
                calls = [e for e in on_host if e.key.startswith("c10d::")]
                out["collectives"] = sum(e.count for e in calls)
                out["collective_s"] = 1e-6 * sum(e.cpu_time_total for e in calls)
                on_card = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
                if on_card:
                    out["nccl_s"] = 1e-6 * sum(e.self_device_time_total for e in on_card
                                               if e.key.startswith("nccl"))
            out["metrics"].append({k: float(v) for k, v in metrics.items()})
            out["digests"].append(params_digest(model))
            if i in spec.get("params_after", ()):
                out["params"][i] = {k: p.detach().cpu().clone()
                                    for k, p in model.named_parameters()}
        return out
    finally:
        if joined:
            destroy_data_group()
