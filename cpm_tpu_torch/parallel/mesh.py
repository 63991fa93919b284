"""The data-parallel group: one process per card, joined by torch.distributed.

Port of cpm_tpu/parallel/mesh.py. The JAX package jits its train step over a
1-D ('data',) mesh with the batch sharded and the parameters replicated, and
XLA keeps the program's meaning whatever the sharding: a step over N devices
computes the one-device step on the global batch
(tests/test_torch_parallel.py holds make_mesh(1) against make_mesh(2)). Here
each process holds its rank's rows of the global batch, in rank order, and a
copy of the parameters, and every place where that program reads the whole
batch becomes a collective:

* the counts that normalise the losses: `batch_total`, which only
  ops/losses.py calls;
* the RPN's per-batch train top-k: `concat_ranks` of every rank's top-k
  scores;
* the gradient: each rank's loss is its share of the global loss, so the
  gradients are summed, `reduce_gradients`, in flat f32 buckets;
* the parameters at the start: `broadcast_module`;
* a synchronised batch norm's statistics (modeling/layers.py::SyncBatchNorm,
  which no config selects): `sum_ranks`, whose backward sums the ranks'
  gradients.

With no group initialised every helper is the identity and launches nothing,
so a one-process step keeps its bits. The group is torch.distributed's
default group; `init_data_group` starts it from torchrun's environment or
from explicit arguments, and raises where it cannot: there is no fallback
from NCCL to gloo, and two ranks never share a card unless the caller names
the card.
"""

import datetime
import os
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

BUCKET_BYTES = 64 * 2**20  # the size of one flat collective over many tensors
TIMEOUT_S = 600  # how long a collective waits for a rank that does not come


@dataclass(frozen=True)
class DataGroup:
    """Where this process stands in the group."""

    rank: int
    world_size: int
    device: torch.device
    backend: str


def _env_int(name: str) -> int:
    value = os.environ.get(name)
    if value is None:
        raise RuntimeError(f"{name} is not set: start the ranks with torchrun, or pass it")
    return int(value)


def in_torchrun() -> bool:
    """Whether torchrun (or a caller that sets its variables) started this process."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"))


def rank_device(device_type: str, local_rank: int) -> torch.device:
    """`cuda:local_rank` for `cuda`, the CPU for `cpu`. Raises when the card
    does not exist: a rank never falls back to another card or to the CPU."""
    if device_type == "cpu":
        return torch.device("cpu")
    if device_type != "cuda":
        raise ValueError(f"device {device_type!r}: cuda or cpu")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if local_rank >= n:
        raise RuntimeError(f"LOCAL_RANK {local_rank} needs card {local_rank}, and {n} are visible")
    return torch.device("cuda", local_rank)


def init_data_group(
    device_type: str = "cuda",
    *,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    local_rank: Optional[int] = None,
    init_method: str = "env://",
    backend: Optional[str] = None,
    timeout_s: float = TIMEOUT_S,
) -> DataGroup:
    """Join the group as torchrun's RANK, WORLD_SIZE and LOCAL_RANK (and, for
    env://, MASTER_ADDR and MASTER_PORT) say, or as the arguments say.

    The rank's device is `cuda:local_rank` (raises when there is no such
    card) or the CPU. The backend is NCCL for cuda and gloo for cpu unless
    named: two ranks that share one card name gloo and local_rank 0. A
    group that does not start raises."""
    rank = _env_int("RANK") if rank is None else rank
    world_size = _env_int("WORLD_SIZE") if world_size is None else world_size
    local_rank = _env_int("LOCAL_RANK") if local_rank is None else local_rank
    device = rank_device(device_type, local_rank)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    kw = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        if backend == "nccl":
            # binds the communicator to the card and starts it now, so that
            # a failure raises here and not at the first collective
            kw["device_id"] = device
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return DataGroup(rank=rank, world_size=world_size, device=device, backend=backend)


def destroy_data_group() -> None:
    if _active():
        dist.destroy_process_group()


def _active() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank_and_world() -> Tuple[int, int]:
    """(this process's rank, the number of ranks); (0, 1) with no group."""
    return (dist.get_rank(), dist.get_world_size()) if _active() else (0, 1)


def is_main_process() -> bool:
    return rank_and_world()[0] == 0


def batch_total(x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` (a count over this rank's images) over every rank: the
    count over the global batch. `x` itself with no group."""
    if not _active():
        return x
    total = x.detach().clone()
    dist.all_reduce(total)
    return total


def batch_totals(values: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """`batch_total` of each scalar of a dict, in one all-reduce; the dict
    itself with no group."""
    if not _active():
        return values
    return dict(zip(values, batch_total(torch.stack(list(values.values()))).unbind()))


class _SumRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        total = x.clone()
        dist.all_reduce(total)
        return total

    @staticmethod
    def backward(ctx, grad):
        # every rank's output is the same total, so each rank's input takes
        # the sum of every rank's gradient
        total = grad.clone()
        dist.all_reduce(total)
        return total


def sum_ranks(x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over every rank, differentiable (the backward sums the
    ranks' gradients): the cross-rank statistics of a synchronised batch
    norm. `x` itself with no group."""
    return _SumRanks.apply(x) if _active() else x


def concat_ranks(x: torch.Tensor) -> torch.Tensor:
    """Every rank's `x` (floating or integer, of one shape on every rank),
    concatenated along dim 0 in rank order: the global batch's rows. Built
    as one all-reduce of a zero-filled global tensor in which each rank
    fills its own rows, since gloo takes CUDA tensors in all_reduce and
    broadcast alone; the shape is the caller's to keep equal, so that no
    size is read on the host. `x` itself with no group."""
    if not _active():
        return x
    rank, world = rank_and_world()
    n = x.shape[0]
    out = x.new_zeros((world * n,) + tuple(x.shape[1:]))
    out[rank * n:(rank + 1) * n] = x.detach()
    dist.all_reduce(out)
    return out


def _buckets(tensors: Sequence[torch.Tensor], bucket_bytes: int) -> List[List[torch.Tensor]]:
    """Consecutive runs of tensors of one dtype, each up to `bucket_bytes`
    (a larger tensor is a bucket of its own)."""
    out, size = [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if not out or out[-1][0].dtype != t.dtype or size + nbytes > bucket_bytes:
            out.append([])
            size = 0
        out[-1].append(t)
        size += nbytes
    return out


def _flat_collective(tensors: Sequence[torch.Tensor], collective, bucket_bytes: int) -> int:
    """Run `collective` (in place on a flat tensor) over `tensors` in flat
    buckets and copy the results back; returns the number of collectives."""
    buckets = _buckets(tensors, bucket_bytes)
    for bucket in buckets:
        flat = torch.cat([t.reshape(-1) for t in bucket])
        collective(flat)
        offset = 0
        for t in bucket:
            t.copy_(flat[offset:offset + t.numel()].view(t.shape))
            offset += t.numel()
    return len(buckets)


def reduce_gradients(params: Iterable[torch.nn.Parameter], bucket_bytes: int = BUCKET_BYTES) -> int:
    """Sum the gradients of `params` over every rank, in place: one
    all-reduce a flat f32 bucket, not one a parameter. Every parameter must
    hold a gradient (the train step gives the ones no loss reached zeros),
    so that every rank's buckets line up. Returns the number of all-reduces;
    0 with no group."""
    if not _active():
        return 0
    grads = []
    for p in params:
        if p.grad is None:
            raise ValueError("reduce_gradients: a parameter has no gradient")
        grads.append(p.grad)
    return _flat_collective(grads, dist.all_reduce, bucket_bytes)


def broadcast_module(model: torch.nn.Module, bucket_bytes: int = BUCKET_BYTES) -> int:
    """Every rank takes rank 0's parameters and buffers. Returns the number
    of broadcasts; 0 with no group."""
    if not _active():
        return 0
    tensors = [t.data for t in list(model.parameters()) + list(model.buffers())]
    return _flat_collective(tensors, lambda flat: dist.broadcast(flat, src=0), bucket_bytes)


def ranks_agree(model: torch.nn.Module, bucket_bytes: int = BUCKET_BYTES) -> bool:
    """Whether every rank holds rank 0's parameters and buffers, bit for bit
    (rank 0's checkpoint is then every rank's model): each flat bucket of
    rank 0's is broadcast and compared byte for byte, and the verdicts meet
    in one all-reduce. True with no group."""
    if not _active():
        return True
    tensors = [t.detach() for t in list(model.parameters()) + list(model.buffers())]
    same = True
    for bucket in _buckets(tensors, bucket_bytes):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        theirs = flat.clone()
        dist.broadcast(theirs, src=0)
        same = same and torch.equal(flat.view(torch.uint8), theirs.view(torch.uint8))
    verdict = torch.tensor(int(same), device=tensors[0].device)
    dist.all_reduce(verdict, op=dist.ReduceOp.MIN)
    return bool(verdict.item())


def rank0_value(value):
    """Rank 0's `value` (a picklable object), on every rank; `value` with no
    group. A decision that every rank must take alike is taken by rank 0."""
    if not _active():
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def barrier() -> None:
    """Wait for every rank; nothing with no group."""
    if _active():
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()
