"""Optimizer construction: SGD with the reference's parameter groups.

Port of cpm_tpu/solver/optimizer.py (`classify_param`, `build_optimizer`):

* three groups: nonbias (weight decay), bias (twice the learning rate under
  BIAS_DOUBLE_LR, weight decay only under BIAS_WEIGHT_DECAY) and GroupNorm
  weights (weight decay scaled by WEIGHT_DECAY_GN);
* `torch.optim.SGD`, whose update is the one the JAX package builds from
  optax: buf = m * buf + (g + wd * p), p -= lr * buf, the buffer starting
  at the first gradient;
* freezing: every AffineChannel (frozen BatchNorm), the trunk's stem and
  layer1 .. layer{FREEZE_AT - 1} get `requires_grad = False` and join no
  group. FREEZE_AT is read from BACKBONE.RESNET whatever the trunk, a
  ResNeXt too, as the JAX package reads it.

A deformable conv's offset conv (`conv_offset.bias`) lands in the bias group
and its main `weight` in nonbias, like any conv's.

The JAX package labels parameters by their flax names; here the module
types and the port's names decide, and a test holds the two labellings
equal parameter by parameter. ADAM and RMSPROP are not ported.
"""

from typing import Dict

import torch
from torch import nn

from cpm_tpu_torch.modeling.norm import AffineChannel

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


def build_optimizer(cfg, model: nn.Module) -> torch.optim.SGD:
    """SGD over the model's trainable parameters; sets `requires_grad` to
    False on the frozen ones. Each group carries `lr_scale`; the train step
    sets the group's `lr` to lr_scale * schedule(step) before every update."""
    s = cfg.SOLVER
    if s.OPTIMIZER != "SGD":
        raise NotImplementedError(f"SOLVER.OPTIMIZER {s.OPTIMIZER} is not ported (SGD only)")
    wd = float(s.WEIGHT_DECAY)
    group_wd = {
        "nonbias": wd,
        "bias": wd if s.BIAS_WEIGHT_DECAY else 0.0,
        "gn": float(s.WEIGHT_DECAY_GN) * wd,
    }
    lr_scale = {"nonbias": 1.0, "bias": float(s.BIAS_DOUBLE_LR) + 1.0, "gn": 1.0}
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
    return torch.optim.SGD(groups, lr=float(s.BASE_LR), momentum=float(s.MOMENTUM))
