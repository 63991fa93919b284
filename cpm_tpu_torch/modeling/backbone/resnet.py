"""ResNet detection trunk (bottleneck blocks, plain 7x7 stem, frozen BN).

Port of cpm_tpu/modeling/backbone/resnet.py (`ResNetBody` and `Bottleneck`
with `norm='affine'`): 7x7/2 stem, 3x3/2 max pool, four stages with strides
(1, 2, 2, 2) and the stride on the first 1x1 conv (STRIDE_3X3 False).
Returns [C2, C3, C4, C5] as NCHW tensors; fed an NCHW view of NHWC memory
(channels_last), every map stays channels_last.
"""

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from cpm_tpu_torch.modeling import initializers as init
from cpm_tpu_torch.modeling.norm import AffineChannel


def _conv(cin, cout, k, stride, padding, g):
    conv = nn.Conv2d(cin, cout, k, stride=stride, padding=padding, bias=False)
    init.kaiming_normal_fan_out(conv.weight, g)
    return conv


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 with a residual; the stride on the 1x1 (or on the
    3x3 when stride_3x3)."""

    expansion = 4

    def __init__(self, inplanes, planes, base_width=64, stride=1,
                 stride_3x3=False, downsample=False, generator=None):
        super().__init__()
        s1, s3 = (1, stride) if stride_3x3 else (stride, 1)
        width = int(planes * (base_width / 64.0))
        out_dim = planes * self.expansion
        g = generator
        self.conv1 = _conv(inplanes, width, 1, s1, 0, g)
        self.bn1 = AffineChannel(width)
        self.conv2 = _conv(width, width, 3, s3, 1, g)
        self.bn2 = AffineChannel(width)
        self.conv3 = _conv(width, out_dim, 1, 1, 0, g)
        self.bn3 = AffineChannel(out_dim)
        self.downsample = (
            nn.Sequential(_conv(inplanes, out_dim, 1, stride, 0, g), AffineChannel(out_dim))
            if downsample else None
        )

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        r = self.downsample(x) if self.downsample is not None else x
        return F.relu(h + r)


class ResNetBody(nn.Module):
    """Detection trunk returning [C2, C3, C4, C5]."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), width: int = 64,
                 base_planes: int = 64, stride_3x3: bool = False,
                 generator: torch.Generator = None):
        super().__init__()
        bp = base_planes
        self.conv1 = _conv(3, bp, 7, 2, 3, generator)
        self.bn1 = AffineChannel(bp)
        inplanes = bp
        for i, n_blocks in enumerate(layers):
            planes = bp * 2 ** i
            stride = 1 if i == 0 else 2
            blocks = []
            for b in range(n_blocks):
                blocks.append(Bottleneck(
                    inplanes, planes, base_width=width,
                    stride=stride if b == 0 else 1, stride_3x3=stride_3x3,
                    downsample=(b == 0), generator=generator,
                ))
                inplanes = planes * Bottleneck.expansion
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
        self.num_stages = len(layers)
        self.dim_out = tuple(bp * 4 * 2 ** i for i in range(len(layers)))

    def forward(self, x) -> List[torch.Tensor]:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.max_pool2d(h, 3, stride=2, padding=1)
        feats = []
        for i in range(self.num_stages):
            h = getattr(self, f"layer{i + 1}")(h)
            feats.append(h)
        return feats


def build_resnet(cfg, generator: torch.Generator) -> ResNetBody:
    r = cfg.BACKBONE.RESNET
    if r.USE_GN or r.USE_WS or r.USE_ALIGN or r.USE_3x3x3HEAD or r.AVG_DOWN:
        raise NotImplementedError("the port runs the plain R-50 trunk only")
    if not r.BOTTLENECK or r.C5_DILATION != 1:
        raise NotImplementedError("the port runs bottleneck blocks, C5 stride 2")
    if any(c != "normal" for c in r.STAGE_WITH_CONV) or any(
        c != "none" for c in r.STAGE_WITH_CONTEXT
    ):
        raise NotImplementedError("the port runs plain convs without context")
    return ResNetBody(
        layers=tuple(r.LAYERS), width=r.WIDTH,
        base_planes=getattr(r, "BASE_PLANES", 64), stride_3x3=r.STRIDE_3X3,
        generator=generator,
    )
