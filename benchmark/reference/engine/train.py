"""Training engine: the train state and one eager train step, in one
process.

Port of cpm_tpu/engine/train.py (`TrainState`, `batch_gt`,
`make_train_step`). One step is forward, backward, learning-rate schedule
and optimizer update; `total_loss` is the sum of the loss dict. Mixed
precision as in the JAX package: the forward runs on casts of the f32
master parameters to TPU.COMPUTE_DTYPE and the gradients arrive in f32 at
the masters (see utils/amp.py).
"""

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch
from torch.profiler import record_function

from benchmark.reference.solver.lr_schedule import make_lr_fn
from benchmark.reference.utils.amp import cast_floating_to, cast_images, compute_dtype
from benchmark.reference.utils.sampler import Draws


@dataclass
class TrainState:
    """What a step carries to the next; updated in place by `train_step`."""

    step: int                        # completed updates
    model: torch.nn.Module           # f32 master parameters
    optimizer: torch.optim.Optimizer
    draws: Draws                     # the samplers' source of uniform draws


def batch_gt(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return dict(boxes=batch["gt_boxes"], labels=batch["gt_labels"], mask=batch["gt_mask"])


def make_train_step(cfg, model: torch.nn.Module, optimizer: torch.optim.Optimizer) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics). `batch` holds
    images, image_sizes, gt_boxes, gt_labels and gt_mask as numpy arrays or
    tensors; `metrics` holds every loss, `total_loss` (detached f32
    tensors) and `lr` (a float)."""
    lr_fn = make_lr_fn(cfg.SOLVER)
    cdtype = compute_dtype(cfg)
    device = next(model.parameters()).device
    trainable = [p for group in optimizer.param_groups for p in group["params"]]

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        lr = lr_fn(state.step)
        for group in optimizer.param_groups:
            group["lr"] = group["lr_scale"] * lr
        batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        with record_function("train_step/forward"):
            params = cast_floating_to(dict(model.named_parameters()), cdtype)
            losses = torch.func.functional_call(
                model, params,
                (cast_images(batch["images"], cdtype), batch["image_sizes"]),
                dict(gt=batch_gt(batch), train=True, draws=state.draws),
            )
            losses = {k: v.float() for k, v in losses.items()}
            total = sum(losses.values())
        with record_function("train_step/backward"):
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
        with record_function("train_step/optimizer"):
            optimizer.step()
        state.step += 1
        metrics["lr"] = lr
        return state, metrics

    return train_step
