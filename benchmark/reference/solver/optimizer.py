"""Optimizer construction: SGD, ADAM or RMSPROP with the reference's parameter groups.

Port of cpm_tpu/solver/optimizer.py (`classify_param`, `build_optimizer`):

* three groups: nonbias (weight decay), bias (twice the learning rate under
  BIAS_DOUBLE_LR, weight decay only under BIAS_WEIGHT_DECAY) and GroupNorm
  weights (weight decay scaled by WEIGHT_DECAY_GN);
* SOLVER.OPTIMIZER SGD: `torch.optim.SGD`, whose update is the one the JAX
  package builds from optax: buf = m * buf + (g + wd * p), p -= lr * buf,
  the buffer starting at the first gradient;
* ADAM: optax.scale_by_adam() (b1 0.9, b2 0.999, eps 1e-8 outside the root,
  bias-corrected), which `torch.optim.Adam` computes; RMSPROP:
  optax.scale_by_rms() (decay 0.9, nu from 0, g / sqrt(nu + 1e-8) with eps
  inside the root, no bias correction) then optax.trace(SOLVER.MOMENTUM),
  `RMSProp` below (`torch.optim.RMSprop` decays by 0.99 and adds eps outside
  the root). Under both, as in the JAX package, no group takes weight decay
  and the bias learning rate is not doubled;
* freezing: every AffineChannel (frozen BatchNorm), the trunk's stem and
  layer1 .. layer{FREEZE_AT - 1} get `requires_grad = False` and join no
  group. FREEZE_AT is read from BACKBONE.RESNET whatever the trunk, a
  ResNeXt too, as the JAX package reads it.

A deformable conv's offset conv (`conv_offset.bias`) lands in the bias group
and its main `weight` in nonbias, like any conv's.

The JAX package labels parameters by their flax names; here the module
types and the port's names decide, and a test holds the two labellings
equal parameter by parameter.
"""

from typing import Dict

import torch
from torch import nn

from benchmark.reference.modeling.norm import AffineChannel

GROUPS = ("nonbias", "bias", "gn")


def classify_params(model: nn.Module, freeze_at: int) -> Dict[str, str]:
    """Parameter name -> 'frozen' | 'bias' | 'gn' | 'nonbias'."""
    frozen_prefixes = []
    if freeze_at >= 1:
        frozen_prefixes += [f"backbone.conv{i}." for i in (1, 2, 3)]
    frozen_prefixes += [f"backbone.layer{k}." for k in range(1, max(freeze_at, 1))]
    labels = {}
    for mod_name, mod in model.named_modules():
        for leaf, _ in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{leaf}" if mod_name else leaf
            if isinstance(mod, AffineChannel) or name.startswith(tuple(frozen_prefixes)):
                labels[name] = "frozen"
            elif "bias" in leaf:
                # the bias test runs before the GroupNorm test, as in the
                # reference: GroupNorm biases land in the bias group
                labels[name] = "bias"
            elif isinstance(mod, nn.GroupNorm):
                labels[name] = "gn"
            else:
                labels[name] = "nonbias"
    return labels


class RMSProp(torch.optim.Optimizer):
    """optax.chain(scale_by_rms(decay, eps), trace(momentum)): per parameter
    nu = decay * nu + (1 - decay) * g^2 (from 0), u = g / sqrt(nu + eps),
    trace = u + momentum * trace (from 0; u itself when momentum is 0), and
    p -= lr * trace."""

    def __init__(self, params, lr: float, momentum: float = 0.0, decay: float = 0.9,
                 eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, momentum=momentum, decay=decay, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("RMSProp takes no closure")
        for group in self.param_groups:
            decay, momentum = group["decay"], group["momentum"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                    if momentum:
                        state["trace"] = torch.zeros_like(p)
                nu = state["nu"]
                nu.mul_(decay).addcmul_(g, g, value=1.0 - decay)
                u = g * torch.rsqrt(nu + group["eps"])
                if momentum:
                    u = state["trace"].mul_(momentum).add_(u)
                p.add_(u, alpha=-group["lr"])


def build_optimizer(cfg, model: nn.Module) -> torch.optim.Optimizer:
    """SOLVER.OPTIMIZER (SGD, ADAM or RMSPROP) over the model's trainable
    parameters; sets `requires_grad` to False on the frozen ones. Each group
    carries `lr_scale`; the train step sets the group's `lr` to
    lr_scale * schedule(step) before every update."""
    s = cfg.SOLVER
    if s.OPTIMIZER not in ("SGD", "ADAM", "RMSPROP"):
        raise ValueError(f"unsupported SOLVER.OPTIMIZER: {s.OPTIMIZER}")
    sgd = s.OPTIMIZER == "SGD"
    wd = float(s.WEIGHT_DECAY) if sgd else 0.0
    group_wd = {
        "nonbias": wd,
        "bias": wd if s.BIAS_WEIGHT_DECAY else 0.0,
        "gn": float(s.WEIGHT_DECAY_GN) * wd,
    }
    bias_scale = float(s.BIAS_DOUBLE_LR) + 1.0 if sgd else 1.0
    lr_scale = {"nonbias": 1.0, "bias": bias_scale, "gn": 1.0}
    labels = classify_params(model, int(cfg.BACKBONE.RESNET.FREEZE_AT))
    members = {name: [] for name in GROUPS}
    for name, p in model.named_parameters():
        if labels[name] == "frozen":
            p.requires_grad_(False)
        else:
            members[labels[name]].append(p)
    groups = [
        dict(params=members[name], weight_decay=group_wd[name], lr_scale=lr_scale[name],
             name=name)
        for name in GROUPS if members[name]
    ]
    if s.OPTIMIZER == "ADAM":
        return torch.optim.Adam(groups, lr=float(s.BASE_LR), betas=(0.9, 0.999), eps=1e-8)
    if s.OPTIMIZER == "RMSPROP":
        return RMSProp(groups, lr=float(s.BASE_LR), momentum=float(s.MOMENTUM))
    return torch.optim.SGD(groups, lr=float(s.BASE_LR), momentum=float(s.MOMENTUM))
