"""ResNet and ResNeXt detection trunks (bottleneck blocks, plain 7x7 stem,
frozen BN), with plain or deformable 3x3 convs per stage.

Port of cpm_tpu/modeling/backbone/resnet.py (`ResNetBody`, `Bottleneck` with
`norm='affine'`, `_conv_op`, `build_resnet`, `build_resnet_c4`,
`build_resnext`): 7x7/2 stem, 3x3/2 max pool, four stages with strides
(1, 2, 2, 2), or with C5_DILATION d > 1 (1, 2, 2, 1) and stage 5's 3x3 convs
dilated by d; `resnet_c4` stops after the third stage (stride 16) and leaves
stage 5 to the C4 RoI heads (roi_heads/c4_heads.py). A ResNet has the
stride on the first 1x1 conv unless STRIDE_3X3; a ResNeXt (`groups` > 1, the
cardinality) has it on the grouped 3x3 and takes the width rule
floor(planes * WIDTH / 64) * C. STAGE_WITH_CONV makes a stage's 3x3 convs
`normal`, `deform` (v1) or `deformv2` (cpm_tpu_torch/ops/deform_conv.py),
grouped like the conv they replace. Returns [C2, C3, C4, C5] as NCHW tensors;
fed an NCHW view of NHWC memory (channels_last), every map stays
channels_last.
"""

import math
from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from cpm_tpu_torch.modeling import initializers as init
from cpm_tpu_torch.modeling.norm import AffineChannel
from cpm_tpu_torch.ops.deform_conv import DeformConvPack, ModulatedDeformConvPack

CONV_OPS = ("normal", "deform", "deformv2")


def _conv(cin, cout, k, stride, padding, g, groups=1, dilation=1):
    conv = nn.Conv2d(cin, cout, k, stride=stride, padding=padding, dilation=dilation,
                     groups=groups, bias=False)
    init.kaiming_normal_fan_out(conv.weight, g)
    return conv


def _conv_op(conv, width, stride, groups, g, dilation=1):
    """The block's 3x3 conv by the stage's conv option."""
    if conv == "normal":
        return _conv(width, width, 3, stride, dilation, g, groups, dilation)
    kw = dict(stride=stride, dilation=dilation, groups=groups, generator=g)
    if conv == "deform":
        return DeformConvPack(width, width, 3, **kw)
    if conv == "deformv2":
        return ModulatedDeformConvPack(width, width, 3, **kw)
    raise ValueError(f"unsupported conv op: {conv}")


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 with a residual; the stride on the 1x1 (or on the
    3x3 when stride_3x3). `groups` > 1 is the ResNeXt block: a grouped 3x3
    of width floor(planes * base_width / 64) * groups."""

    expansion = 4

    def __init__(self, inplanes, planes, base_width=64, stride=1, groups=1, conv="normal",
                 stride_3x3=False, downsample=False, dilation=1, generator=None):
        super().__init__()
        s1, s3 = (1, stride) if stride_3x3 else (stride, 1)
        if groups == 1:
            width = int(planes * (base_width / 64.0))
        else:
            width = int(math.floor(planes * (base_width / 64.0)) * groups)
        out_dim = planes * self.expansion
        g = generator
        self.conv1 = _conv(inplanes, width, 1, s1, 0, g)
        self.bn1 = AffineChannel(width)
        self.conv2 = _conv_op(conv, width, s3, groups, g, dilation)
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


def make_stage(inplanes, planes, n_blocks, stride, width, groups, conv, stride_3x3,
               dilation, generator) -> nn.Sequential:
    """One stage of bottleneck blocks, the first with the stride and the
    projection shortcut; the trunk's and the C4 heads' stage 5."""
    blocks = []
    for b in range(n_blocks):
        blocks.append(Bottleneck(
            inplanes, planes, base_width=width, stride=stride if b == 0 else 1, groups=groups,
            conv=conv, stride_3x3=stride_3x3, downsample=(b == 0), dilation=dilation,
            generator=generator,
        ))
        inplanes = planes * Bottleneck.expansion
    return nn.Sequential(*blocks)


class ResNetBody(nn.Module):
    """Detection trunk returning [C2, C3, C4, C5] (or its first stages)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), width: int = 64,
                 base_planes: int = 64, groups: int = 1, stride_3x3: bool = False,
                 stage_with_conv: Sequence[str] = ("normal",) * 4, c5_dilation: int = 1,
                 generator: torch.Generator = None):
        super().__init__()
        if len(stage_with_conv) < len(layers) or any(c not in CONV_OPS for c in stage_with_conv):
            raise ValueError(f"stage_with_conv {tuple(stage_with_conv)}: one of {CONV_OPS} per stage")
        bp = base_planes
        self.conv1 = _conv(3, bp, 7, 2, 3, generator)
        self.bn1 = AffineChannel(bp)
        strides, dilations = [1, 2, 2, 2], [1, 1, 1, 1]
        if len(layers) == 4 and c5_dilation != 1:
            strides[3], dilations[3] = 1, c5_dilation
        inplanes = bp
        for i, n_blocks in enumerate(layers):
            planes = bp * 2 ** i
            self.add_module(f"layer{i + 1}", make_stage(
                inplanes, planes, n_blocks, strides[i], width, groups, stage_with_conv[i],
                stride_3x3, dilations[i], generator))
            inplanes = planes * Bottleneck.expansion
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


def check_plain_options(r, what):
    """Raise on the trunk options the port does not run (the C4 heads' stage
    5 takes the same options)."""
    if r.USE_GN or r.USE_WS or r.USE_ALIGN or r.USE_3x3x3HEAD or r.AVG_DOWN:
        raise NotImplementedError(
            f"the port runs the plain {what} trunk only (no GN, WS, aligned blocks, "
            "3x3x3 stem or AVG_DOWN)")
    if any(c != "none" for c in r.STAGE_WITH_CONTEXT):
        raise NotImplementedError("the port runs no context modules")
    if any(c not in CONV_OPS for c in r.STAGE_WITH_CONV):
        raise NotImplementedError(f"STAGE_WITH_CONV {tuple(r.STAGE_WITH_CONV)}: one of {CONV_OPS}")


def build_resnet(cfg, generator: torch.Generator, num_stages: int = 4) -> ResNetBody:
    r = cfg.BACKBONE.RESNET
    check_plain_options(r, "ResNet")
    if not r.BOTTLENECK:
        raise NotImplementedError("the port runs bottleneck blocks")
    return ResNetBody(
        layers=tuple(r.LAYERS)[:num_stages], width=r.WIDTH,
        base_planes=getattr(r, "BASE_PLANES", 64), stride_3x3=r.STRIDE_3X3,
        stage_with_conv=tuple(r.STAGE_WITH_CONV)[:num_stages], c5_dilation=r.C5_DILATION,
        generator=generator,
    )


def build_resnet_c4(cfg, generator: torch.Generator) -> ResNetBody:
    """The stride-16 trunk that stops at C4 (`resnet_c4`), for the C4 heads."""
    return build_resnet(cfg, generator, num_stages=3)


def build_resnext(cfg, generator: torch.Generator) -> ResNetBody:
    """BACKBONE.RESNEXT: cardinality C, width per group WIDTH, the stride on
    the grouped 3x3; it has no BASE_PLANES key."""
    r = cfg.BACKBONE.RESNEXT
    check_plain_options(r, "ResNeXt")
    return ResNetBody(
        layers=tuple(r.LAYERS), width=r.WIDTH, groups=r.C, stride_3x3=True,
        stage_with_conv=tuple(r.STAGE_WITH_CONV), c5_dilation=r.C5_DILATION,
        generator=generator,
    )


BACKBONES = {"resnet": build_resnet, "resnet_c4": build_resnet_c4, "resnext": build_resnext}
