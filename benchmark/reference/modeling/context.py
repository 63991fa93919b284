"""Channel-context blocks.

Port of cpm_tpu/modeling/context.py (`SeBlock`, `GlobalContextBlock`,
`make_context`): the grid head's output tower runs `SeBlock` under
GRID_RCNN.SE_ON (roi_heads/grid_modules.py), and a trunk stage runs either
after its blocks' last norm under BACKBONE.*.STAGE_WITH_CONTEXT ('se' or
'gcb', reduced to max(1, int(C * CTX_RATIO)) channels).
"""

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.modeling import initializers as init


class SeBlock(nn.Module):
    """Squeeze-and-excitation over an NCHW tensor: the per-sample global
    average pool, a 1x1 conv to `reduced` channels, relu, a 1x1 conv back to
    `features`, and the sigmoid of that as a per-channel gate. Fresh weights
    are flax's nn.Conv defaults: lecun normal (truncated, as flax draws it)
    and zero biases."""

    def __init__(self, features: int, reduced: int, generator: torch.Generator = None):
        super().__init__()
        self.fc1 = nn.Conv2d(features, reduced, 1)
        self.fc2 = nn.Conv2d(reduced, features, 1)
        for conv in (self.fc1, self.fc2):
            init.lecun_normal_(conv.weight, generator)
            nn.init.zeros_(conv.bias)

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.fc2(F.relu(self.fc1(s)))
        return x * torch.sigmoid(s)


class FlaxLayerNorm(nn.LayerNorm):
    """flax's nn.LayerNorm over the last axis, in flax's formula: the
    variance as mean(x^2) - mean(x)^2 (at least 0), then (x - mean) times
    rsqrt(var + eps) * weight, plus bias, all in at least float32 (flax
    promotes the statistics so), the result in the input's and the
    parameters' common dtype. Over one channel its gradient to x is exactly
    0, as flax's is; torch's fused backward leaves a rounding residual
    there, scaled by rsqrt(eps) (1000 at flax's 1e-6)."""

    def forward(self, x):
        out_dtype = torch.promote_types(x.dtype, self.weight.dtype)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean(-1, keepdim=True)
        var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight.to(xf.dtype))
        return (y + self.bias.to(xf.dtype)).to(out_dtype)


class GlobalContextBlock(nn.Module):
    """GCNet block over an NCHW tensor: attention pooling (a 1x1 conv to one
    channel, softmax over the H*W positions, the weighted sum of x), then a
    1x1 conv to `reduced`, a LayerNorm (flax's epsilon, 1e-6, not torch's
    1e-5, and flax's formula: `FlaxLayerNorm`), relu, a 1x1 conv back to
    `features`, added to every position. Fresh weights are flax's nn.Conv
    defaults, as `SeBlock`'s."""

    def __init__(self, features: int, reduced: int, generator: torch.Generator = None):
        super().__init__()
        self.conv_mask = nn.Conv2d(features, 1, 1)
        self.transform_reduce = nn.Conv2d(features, reduced, 1)
        self.transform_ln = FlaxLayerNorm(reduced, eps=1e-6)
        self.transform_expand = nn.Conv2d(reduced, features, 1)
        for conv in (self.conv_mask, self.transform_reduce, self.transform_expand):
            init.lecun_normal_(conv.weight, generator)
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
