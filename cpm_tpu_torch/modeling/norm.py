"""Normalization layers.

Port of cpm_tpu/modeling/norm.py. Detection trunks run frozen BatchNorm,
which is a per-channel affine (`AffineChannel`). `GroupNorm` keeps the
reference's group-count rule. Tensors are NCHW (in channels_last memory).
"""

import torch
from torch import nn


class AffineChannel(nn.Module):
    """y = x * weight + bias per channel of an NCHW tensor. Fresh init is
    unit scale and zero bias (the reference's from-scratch BN fold)."""

    def __init__(self, num_channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x):
        return x * self.weight[:, None, None] + self.bias[:, None, None]


class GroupNorm(nn.GroupNorm):
    """GroupNorm with the reference's defaults: 32 groups, eps 1e-5."""

    def __init__(self, num_channels: int, num_groups: int = 32, eps: float = 1e-5):
        super().__init__(num_groups, num_channels, eps=eps)
