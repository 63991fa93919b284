"""Channel-context blocks.

Port of cpm_tpu/modeling/context.py's `SeBlock` only, which the grid head's
output tower runs under GRID_RCNN.SE_ON (roi_heads/grid_modules.py). The
trunk's context options (STAGE_WITH_CONTEXT, the global-context block) are
not ported.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from cpm_tpu_torch.modeling import initializers as init


class SeBlock(nn.Module):
    """Squeeze-and-excitation over an NCHW tensor: the per-sample global
    average pool, a 1x1 conv to `reduced` channels, relu, a 1x1 conv back to
    `features`, and the sigmoid of that as a per-channel gate. Fresh weights
    are flax's nn.Conv defaults: lecun normal (drawn untruncated here) and
    zero biases."""

    def __init__(self, features: int, reduced: int, generator: torch.Generator = None):
        super().__init__()
        self.fc1 = nn.Conv2d(features, reduced, 1)
        self.fc2 = nn.Conv2d(reduced, features, 1)
        for conv in (self.fc1, self.fc2):
            init.normal_(conv.weight, math.sqrt(1.0 / conv.in_channels), generator)
            nn.init.zeros_(conv.bias)

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.fc2(F.relu(self.fc1(s)))
        return x * torch.sigmoid(s)
