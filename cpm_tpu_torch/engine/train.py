"""Training engine: the train state and one eager train step.

Port of cpm_tpu/engine/train.py (`TrainState`, `batch_gt`,
`create_train_state`, `make_train_step`, and `jit_train_step`'s data
parallelism). One step is forward, backward, learning-rate schedule and
optimizer update; `total_loss` is the sum of the loss dict. Mixed precision
as in the JAX package: the forward runs on casts of the f32 master
parameters to TPU.COMPUTE_DTYPE and the gradients arrive in f32 at the
masters (see utils/amp.py).

Under a data-parallel group (parallel/mesh.py) each rank steps on its rows
of the global batch and computes what one process over the global batch
does: its losses are its shares of the global losses, the gradients are
summed over the ranks, and the update runs alike on every rank, so the
parameters stay bit-equal across ranks. The step's parts run inside
spans (utils/spans.py: `train_step/forward`, `/backward`, `/allreduce`,
`/optimizer`), which tools/profile_train.py and the benchmark read.
"""

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch

from cpm_tpu_torch.modeling.model import build_model
from cpm_tpu_torch.parallel.mesh import (
    batch_totals,
    broadcast_module,
    rank_and_world,
    reduce_gradients,
)
from cpm_tpu_torch.solver.lr_schedule import make_lr_fn
from cpm_tpu_torch.solver.optimizer import build_optimizer
from cpm_tpu_torch.utils.amp import cast_floating_to, cast_images, compute_dtype
from cpm_tpu_torch.utils.sampler import Draws
from cpm_tpu_torch.utils.spans import span, sync


@dataclass
class TrainState:
    """What a step carries to the next; updated in place by `train_step`."""

    step: int                        # completed updates
    model: torch.nn.Module           # f32 master parameters
    optimizer: torch.optim.Optimizer
    draws: Draws                     # the samplers' source of uniform draws


def batch_gt(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return dict(boxes=batch["gt_boxes"], labels=batch["gt_labels"], mask=batch["gt_mask"])


def create_train_state(cfg, device, seed: int = 0):
    """(model, optimizer, state) for `cfg` on `device`: fresh weights from
    `seed` (under a group, rank 0's on every rank), the frozen parameters
    marked, and the samplers' draws from a CPU generator seeded with
    seed + 1, so that the same seed gives the same draws on every device;
    under a group each rank takes its rows of the global draws."""
    model = build_model(cfg, device, seed=seed)
    broadcast_module(model)
    optimizer = build_optimizer(cfg, model)
    draws = Draws(torch.Generator().manual_seed(seed + 1), *rank_and_world())
    return model, optimizer, TrainState(step=0, model=model, optimizer=optimizer, draws=draws)


def make_train_step(cfg, model: torch.nn.Module, optimizer: torch.optim.Optimizer) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics). `batch` holds
    images, image_sizes, gt_boxes, gt_labels and gt_mask as numpy arrays or
    tensors (under a group, this rank's rows); `metrics` holds every loss,
    `total_loss` (detached f32 tensors, the global batch's) and `lr` (a
    float)."""
    lr_fn = make_lr_fn(cfg.SOLVER)
    cdtype = compute_dtype(cfg)
    device = next(model.parameters()).device
    trainable = [p for group in optimizer.param_groups for p in group["params"]]

    def upload(v):
        with sync("inputs"):
            return torch.as_tensor(v, device=device)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        lr = lr_fn(state.step)
        for group in optimizer.param_groups:
            group["lr"] = group["lr_scale"] * lr
        batch = {k: upload(v) for k, v in batch.items()}
        with span("train_step/forward"):
            with span("cpm/cast"):
                params = cast_floating_to(dict(model.named_parameters()), cdtype)
            losses = torch.func.functional_call(
                model, params,
                (cast_images(batch["images"], cdtype), batch["image_sizes"]),
                dict(gt=batch_gt(batch), train=True, draws=state.draws),
            )
            losses = {k: v.float() for k, v in losses.items()}
            total = sum(losses.values())
        with span("train_step/backward"):
            optimizer.zero_grad(set_to_none=True)
            total.backward()
            # a parameter that no loss reaches (OFFSET_ON's offset branch
            # under FUSED_ON) has a zero gradient in the JAX package, and
            # its weight decay and momentum still move it; torch's
            # optimizers skip a parameter whose gradient is None
            for p in trainable:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["total_loss"] = total.detach()
        with span("train_step/allreduce"):
            # the zero gradients above are in the buckets too, so every
            # rank's buckets line up
            reduce_gradients(trainable)
            metrics = batch_totals(metrics)
        with span("train_step/optimizer"):
            optimizer.step()
        state.step += 1
        metrics["lr"] = lr
        return state, metrics

    return train_step
