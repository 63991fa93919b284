"""Channel-context blocks.

Port of cpm_tpu/modeling/context.py (`SeBlock`, `GlobalContextBlock`,
`make_context`): the grid head's output tower runs `SeBlock` under
GRID_RCNN.SE_ON (roi_heads/grid_modules.py), and a trunk stage runs either
after its blocks' last norm under BACKBONE.*.STAGE_WITH_CONTEXT ('se' or
'gcb', reduced to max(1, int(C * CTX_RATIO)) channels).
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


class GlobalContextBlock(nn.Module):
    """GCNet block over an NCHW tensor: attention pooling (a 1x1 conv to one
    channel, softmax over the H*W positions, the weighted sum of x), then a
    1x1 conv to `reduced`, a LayerNorm (flax's epsilon, 1e-6, not torch's
    1e-5), relu, a 1x1 conv back to `features`, added to every position.
    Fresh weights are flax's nn.Conv defaults, as `SeBlock`'s."""

    def __init__(self, features: int, reduced: int, generator: torch.Generator = None):
        super().__init__()
        self.conv_mask = nn.Conv2d(features, 1, 1)
        self.transform_reduce = nn.Conv2d(features, reduced, 1)
        self.transform_ln = nn.LayerNorm(reduced, eps=1e-6)
        self.transform_expand = nn.Conv2d(reduced, features, 1)
        for conv in (self.conv_mask, self.transform_reduce, self.transform_expand):
            init.normal_(conv.weight, math.sqrt(1.0 / conv.in_channels), generator)
            nn.init.zeros_(conv.bias)

    def forward(self, x):
        B, C, H, W = x.shape
        attn = torch.softmax(self.conv_mask(x).reshape(B, H * W), dim=1)
        ctx = torch.einsum("bcp,bp->bc", x.reshape(B, C, H * W), attn)[:, :, None, None]
        t = self.transform_reduce(ctx)
        t = self.transform_ln(t.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        return x + self.transform_expand(F.relu(t))


def make_context(features: int, context: str, ctx_ratio: float = 0.0625,
                 generator: torch.Generator = None):
    """The block STAGE_WITH_CONTEXT names ('none' -> None)."""
    if context == "none":
        return None
    reduced = max(1, int(features * ctx_ratio))
    if context == "se":
        return SeBlock(features, reduced, generator)
    if context == "gcb":
        return GlobalContextBlock(features, reduced, generator)
    raise ValueError(f"unsupported context: {context}")
