"""ResNet and ResNeXt detection trunks: bottleneck, aligned and basic
blocks, the 7x7 or 3x3x3 stem, frozen BN or GroupNorm, with plain or
deformable 3x3 convs and a context block per stage.

Port of cpm_tpu/modeling/backbone/resnet.py (`ResNetBody`, `Bottleneck`,
`AlignedBottleneck`, `BasicBlock`, `_conv_op`, `build_resnet`,
`build_resnet_c4`, `build_resnext`): a 7x7/2 stem (or under USE_3x3x3HEAD
three 3x3 convs at BASE_PLANES/2, BASE_PLANES/2 and BASE_PLANES, the first
at stride 2), 3x3/2 max pool, four stages with strides (1, 2, 2, 2), or
with C5_DILATION d > 1 (1, 2, 2, 1) and stage 5's 3x3 convs dilated by d;
`resnet_c4` stops after the third stage (stride 16) and leaves stage 5 to
the C4 RoI heads (roi_heads/c4_heads.py). A ResNet bottleneck has the
stride on the first 1x1 conv unless STRIDE_3X3; a ResNeXt one (`groups` >
1, the cardinality) has it on the grouped 3x3 and takes the width rule
floor(planes * WIDTH / 64) * C. USE_ALIGN runs `AlignedBottleneck`s and
BOTTLENECK False `BasicBlock`s. Every norm of the trunk is a frozen
`AffineChannel`, or under USE_GN a `GroupNorm`. STAGE_WITH_CONV makes a
stage's 3x3 convs `normal`, `deform` (v1) or `deformv2`
(cpm_tpu_torch/ops/deform_conv.py), grouped like the conv they replace;
STAGE_WITH_CONTEXT puts an `se` or `gcb` block (modeling/context.py) after
a block's last norm. AVG_DOWN makes a strided projection shortcut an
average pool and a stride-1 1x1 conv (ResNet-D). USE_WS standardises every
conv's weight (modeling/ws.py). Returns [C2, C3, C4, C5] as NCHW tensors;
fed an NCHW view of NHWC memory (channels_last), every map stays
channels_last.

The JAX package's quirks, which the port keeps (ROADMAP Queue 3): a
`BasicBlock` takes a 1x1 projection at the first block of every stage, even
at 64 -> 64 and stride 1, and ignores AVG_DOWN; an `AlignedBottleneck`'s
first branch has no norm after its 3x3, only the concatenation is normed.
"""

import math
from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.modeling import initializers as init
from benchmark.reference.modeling.context import make_context
from benchmark.reference.modeling.norm import make_norm
from benchmark.reference.modeling.ws import maybe_ws
from benchmark.reference.ops.deform_conv import DeformConvPack, ModulatedDeformConvPack

CONV_OPS = ("normal", "deform", "deformv2")


def _conv(cin, cout, k, stride, padding, g, groups=1, dilation=1):
    conv = nn.Conv2d(cin, cout, k, stride=stride, padding=padding, dilation=dilation,
                     groups=groups, bias=False)
    init.backbone_conv(conv.weight, g)
    return conv


def _conv_op(conv, cin, cout, stride, groups, g, dilation=1):
    """A block's 3x3 conv by the stage's conv option."""
    if conv == "normal":
        return _conv(cin, cout, 3, stride, dilation, g, groups, dilation)
    kw = dict(stride=stride, dilation=dilation, groups=groups, generator=g)
    if conv == "deform":
        return DeformConvPack(cin, cout, 3, **kw)
    if conv == "deformv2":
        return ModulatedDeformConvPack(cin, cout, 3, **kw)
    raise ValueError(f"unsupported conv op: {conv}")


def _block_width(planes, base_width, groups):
    if groups == 1:
        return int(planes * (base_width / 64.0))
    return int(math.floor(planes * (base_width / 64.0)) * groups)


class _Residual(nn.Module):
    """What the blocks share: the context block after the last norm, the
    projection shortcut (`downsample`: conv, norm; under `avg_down` at a
    stride above 1 an average pool before a stride-1 conv) and the final
    relu of the sum."""

    def _shortcut(self, inplanes, out_dim, stride, downsample, avg_down, norm, g):
        self.pool = stride if (downsample and avg_down and stride > 1) else 1
        conv_stride = 1 if self.pool > 1 else stride
        self.downsample = (
            nn.Sequential(_conv(inplanes, out_dim, 1, conv_stride, 0, g), make_norm(out_dim, norm))
            if downsample else None
        )

    def _finish(self, h, x):
        if self.context is not None:
            h = self.context(h)
        if self.downsample is None:
            return F.relu(h + x)
        if self.pool > 1:
            x = F.avg_pool2d(x, self.pool, self.pool)
        return F.relu(h + self.downsample(x))


class Bottleneck(_Residual):
    """1x1 -> 3x3 -> 1x1 with a residual; the stride on the 1x1 (or on the
    3x3 when stride_3x3). `groups` > 1 is the ResNeXt block: a grouped 3x3
    of width floor(planes * base_width / 64) * groups."""

    expansion = 4

    def __init__(self, inplanes, planes, base_width=64, stride=1, groups=1, conv="normal",
                 stride_3x3=False, downsample=False, dilation=1, norm="affine", context="none",
                 ctx_ratio=0.0625, avg_down=False, generator=None):
        super().__init__()
        s1, s3 = (1, stride) if stride_3x3 else (stride, 1)
        width = _block_width(planes, base_width, groups)
        out_dim = planes * self.expansion
        g = generator
        self.conv1 = _conv(inplanes, width, 1, s1, 0, g)
        self.bn1 = make_norm(width, norm)
        self.conv2 = _conv_op(conv, width, width, s3, groups, g, dilation)
        self.bn2 = make_norm(width, norm)
        self.conv3 = _conv(width, out_dim, 1, 1, 0, g)
        self.bn3 = make_norm(out_dim, norm)
        self.context = make_context(out_dim, context, ctx_ratio, g)
        self._shortcut(inplanes, out_dim, stride, downsample, avg_down, norm, g)

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        return self._finish(self.bn3(self.conv3(h)), x)


class AlignedBottleneck(_Residual):
    """Two branches (USE_ALIGN): 1x1 -> 3x3, and 1x1 at half the width ->
    3x3 -> 3x3 at max(groups // 2, 1) groups; their concatenation normed,
    then a 1x1 `conv` to planes * 4. The stride is always on the first 3x3
    of each branch."""

    expansion = 4

    def __init__(self, inplanes, planes, base_width=64, stride=1, groups=1, conv="normal",
                 stride_3x3=False, downsample=False, dilation=1, norm="affine", context="none",
                 ctx_ratio=0.0625, avg_down=False, generator=None):
        super().__init__()
        width = _block_width(planes, base_width, groups)
        half = width // 2
        g1, g2 = groups, max(groups // 2, 1)
        out_dim = planes * self.expansion
        g = generator
        self.conv1_1 = _conv(inplanes, width, 1, 1, 0, g)
        self.bn1_1 = make_norm(width, norm)
        self.conv1_2 = _conv_op(conv, width, width, stride, g1, g, dilation)
        self.conv2_1 = _conv(inplanes, half, 1, 1, 0, g)
        self.bn2_1 = make_norm(half, norm)
        self.conv2_2 = _conv_op(conv, half, half, stride, g2, g, dilation)
        self.bn2_2 = make_norm(half, norm)
        self.conv2_3 = _conv_op(conv, half, half, 1, g2, g, dilation)
        self.bn_concat = make_norm(width + half, norm)
        self.conv = _conv(width + half, out_dim, 1, 1, 0, g)
        self.bn = make_norm(out_dim, norm)
        self.context = make_context(out_dim, context, ctx_ratio, g)
        self._shortcut(inplanes, out_dim, stride, downsample, avg_down, norm, g)

    def forward(self, x):
        b1 = self.conv1_2(F.relu(self.bn1_1(self.conv1_1(x))))
        b2 = F.relu(self.bn2_1(self.conv2_1(x)))
        b2 = self.conv2_3(F.relu(self.bn2_2(self.conv2_2(b2))))
        h = F.relu(self.bn_concat(torch.cat([b1, b2], dim=1)))
        return self._finish(self.bn(self.conv(h)), x)


class BasicBlock(_Residual):
    """Two 3x3 convs with a residual (BOTTLENECK False); its shortcut is
    never average-pooled."""

    expansion = 1

    def __init__(self, inplanes, planes, base_width=64, stride=1, groups=1, conv="normal",
                 stride_3x3=False, downsample=False, dilation=1, norm="affine", context="none",
                 ctx_ratio=0.0625, avg_down=False, generator=None):
        super().__init__()
        width = int(planes * (base_width / 64.0))
        g = generator
        self.conv1 = _conv_op(conv, inplanes, width, stride, 1, g, dilation)
        self.bn1 = make_norm(width, norm)
        self.conv2 = _conv_op(conv, width, width, 1, 1, g, dilation)
        self.bn2 = make_norm(width, norm)
        self.context = make_context(width, context, ctx_ratio, g)
        self._shortcut(inplanes, width, stride, downsample, False, norm, g)

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        return self._finish(self.bn2(self.conv2(h)), x)


def make_stage(inplanes, planes, n_blocks, stride, width, groups, conv, stride_3x3,
               dilation, generator, block=Bottleneck, **options) -> nn.Sequential:
    """One stage of `block`s, the first with the stride and the projection
    shortcut; the trunk's and the C4 heads' stage 5. `options` are the
    blocks' norm, context, ctx_ratio and avg_down."""
    blocks = []
    for b in range(n_blocks):
        blocks.append(block(
            inplanes, planes, base_width=width, stride=stride if b == 0 else 1, groups=groups,
            conv=conv, stride_3x3=stride_3x3, downsample=(b == 0), dilation=dilation,
            generator=generator, **options,
        ))
        inplanes = planes * block.expansion
    return nn.Sequential(*blocks)


class ResNetBody(nn.Module):
    """Detection trunk returning [C2, C3, C4, C5] (or its first stages)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), width: int = 64,
                 base_planes: int = 64, groups: int = 1, stride_3x3: bool = False,
                 stage_with_conv: Sequence[str] = ("normal",) * 4, c5_dilation: int = 1,
                 bottleneck: bool = True, aligned: bool = False, norm: str = "affine",
                 avg_down: bool = False, use_3x3x3stem: bool = False,
                 stage_with_context: Sequence[str] = ("none",) * 4, ctx_ratio: float = 0.0625,
                 generator: torch.Generator = None):
        super().__init__()
        if len(stage_with_conv) < len(layers) or any(c not in CONV_OPS for c in stage_with_conv):
            raise ValueError(f"stage_with_conv {tuple(stage_with_conv)}: one of {CONV_OPS} per stage")
        bp, g = base_planes, generator
        self.use_3x3x3stem = use_3x3x3stem
        if use_3x3x3stem:
            self.conv1 = _conv(3, bp // 2, 3, 2, 1, g)
            self.bn1 = make_norm(bp // 2, norm)
            self.conv2 = _conv(bp // 2, bp // 2, 3, 1, 1, g)
            self.bn2 = make_norm(bp // 2, norm)
            self.conv3 = _conv(bp // 2, bp, 3, 1, 1, g)
            self.bn3 = make_norm(bp, norm)
        else:
            self.conv1 = _conv(3, bp, 7, 2, 3, g)
            self.bn1 = make_norm(bp, norm)
        if not bottleneck:
            block = BasicBlock
        else:
            block = AlignedBottleneck if aligned else Bottleneck
        strides, dilations = [1, 2, 2, 2], [1, 1, 1, 1]
        if len(layers) == 4 and c5_dilation != 1:
            strides[3], dilations[3] = 1, c5_dilation
        inplanes = bp
        for i, n_blocks in enumerate(layers):
            planes = bp * 2 ** i
            self.add_module(f"layer{i + 1}", make_stage(
                inplanes, planes, n_blocks, strides[i], width, groups, stage_with_conv[i],
                stride_3x3, dilations[i], g, block=block, norm=norm,
                context=stage_with_context[i], ctx_ratio=ctx_ratio, avg_down=avg_down))
            inplanes = planes * block.expansion
        self.num_stages = len(layers)
        self.dim_out = tuple(bp * block.expansion * 2 ** i for i in range(len(layers)))

    def forward(self, x) -> List[torch.Tensor]:
        h = F.relu(self.bn1(self.conv1(x)))
        if self.use_3x3x3stem:
            h = F.relu(self.bn2(self.conv2(h)))
            h = F.relu(self.bn3(self.conv3(h)))
        h = F.max_pool2d(h, 3, stride=2, padding=1)
        feats = []
        for i in range(self.num_stages):
            h = getattr(self, f"layer{i + 1}")(h)
            feats.append(h)
        return feats


def check_options(r, what):
    """Raise on the trunk options the JAX package refuses too (a
    STAGE_WITH_CONV outside `normal` / `deform` / `deformv2`); the C4 heads'
    stage 5 takes the same options."""
    if any(c not in CONV_OPS for c in r.STAGE_WITH_CONV):
        raise NotImplementedError(
            f"{what} STAGE_WITH_CONV {tuple(r.STAGE_WITH_CONV)}: one of {CONV_OPS}")


def block_options(r) -> dict:
    """The blocks' options from BACKBONE.RESNET / RESNEXT, for the trunk and
    the C4 heads' stage 5."""
    return dict(norm="gn" if r.USE_GN else "affine", avg_down=r.AVG_DOWN, ctx_ratio=r.CTX_RATIO)


def build_resnet(cfg, generator: torch.Generator, num_stages: int = 4) -> ResNetBody:
    r = cfg.BACKBONE.RESNET
    check_options(r, "ResNet")
    body = ResNetBody(
        layers=tuple(r.LAYERS)[:num_stages], width=r.WIDTH,
        base_planes=getattr(r, "BASE_PLANES", 64), stride_3x3=r.STRIDE_3X3,
        stage_with_conv=tuple(r.STAGE_WITH_CONV)[:num_stages], c5_dilation=r.C5_DILATION,
        bottleneck=r.BOTTLENECK, aligned=r.USE_ALIGN, use_3x3x3stem=r.USE_3x3x3HEAD,
        stage_with_context=tuple(r.STAGE_WITH_CONTEXT)[:num_stages], generator=generator,
        **block_options(r),
    )
    return maybe_ws(body, r.USE_WS)


def build_resnet_c4(cfg, generator: torch.Generator) -> ResNetBody:
    """The stride-16 trunk that stops at C4 (`resnet_c4`), for the C4 heads."""
    return build_resnet(cfg, generator, num_stages=3)


def build_resnext(cfg, generator: torch.Generator) -> ResNetBody:
    """BACKBONE.RESNEXT: cardinality C, width per group WIDTH, the stride on
    the grouped 3x3; bottleneck blocks (aligned under USE_ALIGN) at 64 base
    planes, as the JAX builder passes no BASE_PLANES."""
    r = cfg.BACKBONE.RESNEXT
    check_options(r, "ResNeXt")
    body = ResNetBody(
        layers=tuple(r.LAYERS), width=r.WIDTH, groups=r.C, stride_3x3=True,
        stage_with_conv=tuple(r.STAGE_WITH_CONV), c5_dilation=r.C5_DILATION,
        aligned=r.USE_ALIGN, use_3x3x3stem=r.USE_3x3x3HEAD,
        stage_with_context=tuple(r.STAGE_WITH_CONTEXT), generator=generator,
        **block_options(r),
    )
    return maybe_ws(body, r.USE_WS)


BACKBONES = {"resnet": build_resnet, "resnet_c4": build_resnet_c4, "resnext": build_resnext}
