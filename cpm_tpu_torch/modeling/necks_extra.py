"""The other FPN bodies: HRFPN, NAS-FPN and BiFPN, and the neck table.

Port of cpm_tpu/modeling/necks_extra.py (`_resize_merge`, `RefConv`,
`HRFPN`, `MergeCell`, `NASFPN`, `Fusion`, `BiFPN` and the builders; its
helpers `_interp_nearest`, `_interp_bilinear` and `_max_pool_ceil` emulate
torch's `F.interpolate` (nearest, and bilinear with align_corners False)
and `F.max_pool2d(ceil_mode=True)`, which the port calls):

* HRFPN: every level upsampled bilinearly (align_corners False) to the
  finest one, concatenated, a 1x1 reduce, then an AVG or MAX pooling
  pyramid (NUM_EXTRA_POOLING levels more than the trunk gives) with a 3x3
  conv a level;
* NAS-FPN: NUM_STACK stages of the fixed 9-cell GP / Sum wiring over five
  levels (the trunk's, 1x1-reduced, and stride-2 subsamples above them); a
  GP cell gates its second input with the sigmoid of the *global max* pool
  of its first, and the two mid-stage GP cells have no conv; a cell resizes
  by nearest upsampling or a ceil-mode max pool;
* BiFPN: NUM_STACK top-down and bottom-up stages over five levels (the
  extra one a 2x2 max pool), each fusion a learned scalar weighting with
  EPS; the three-input fusion adds its third input *unweighted*, `x3 +
  w3`, the reference's formula, which the JAX package and the port keep
  (ROADMAP Queue 3).

Module names are flax's (`reduction_conv`, `fpn_conv{i}`, `nasfpn_in{i}`,
`stage{s}_{cell}`, `bifpn_in{i}`, the fusion weights `w1`..`w3`), so the
bridge maps them as they are; a `RefConv`'s norm is `norm`. Fresh weights
are flax's nn.Conv defaults (lecun normal, truncated as flax draws it,
and zero biases), the fusion weights 0.5 or 0.333. NCHW tensors in channels_last
memory; every neck returns five levels, finest first, and carries
`dim_out`.
"""

import math
from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from cpm_tpu_torch.modeling import initializers as init
from cpm_tpu_torch.modeling.fpn import build_fpn, get_min_max_levels
from cpm_tpu_torch.modeling.norm import make_norm

NUM_LEVELS = 5  # NAS-FPN's and BiFPN's wiring is fixed at five levels


def _resize_merge(x: torch.Tensor, out_hw) -> torch.Tensor:
    """NAS-FPN's and BiFPN's resize: nearest up, a ceil-mode max pool with
    kernel ceil(in / out) down."""
    h, w = x.shape[-2:]
    th, tw = out_hw
    if (h, w) == (th, tw):
        return x
    if h < th:
        return F.interpolate(x, size=tuple(out_hw), mode="nearest")
    k = (math.ceil(h / th), math.ceil(w / tw))
    return F.max_pool2d(x, k, stride=k, ceil_mode=True)


def _flax_conv(cin, cout, k, groups=1, bias=True, g=None):
    conv = nn.Conv2d(cin, cout, k, padding=(k - 1) // 2, groups=groups, bias=bias)
    init.lecun_normal_(conv.weight, g)
    if bias:
        nn.init.zeros_(conv.bias)
    return conv


class RefConv(nn.Module):
    """conv [+ norm] [+ relu] [+ 1x1 suffix], the reference's make_conv:
    depthwise under `use_dwconv`, no conv bias under a norm, the norm a
    frozen `AffineChannel` (`use_bn`) or a `GroupNorm` (`use_gn`)."""

    def __init__(self, cin, features, kernel=3, use_dwconv=False, use_bn=False, use_gn=False,
                 use_relu=False, suffix_1x1=False, generator=None):
        super().__init__()
        bias = not (use_bn or use_gn)
        self.conv = _flax_conv(cin, features, kernel, cin if use_dwconv else 1, bias, generator)
        self.norm = make_norm(features, "bn" if use_bn else "gn") if (use_bn or use_gn) else None
        self.use_relu = use_relu
        self.suffix = _flax_conv(features, features, 1, 1, bias, generator) if suffix_1x1 else None

    def forward(self, x):
        x = self.conv(x)
        if self.norm is not None:
            x = self.norm(x)
        if self.use_relu:
            x = F.relu(x)
        if self.suffix is not None:
            x = self.suffix(x)
        return x


class HRFPN(nn.Module):
    """len(in_dims) + num_extra_pooling levels, fine to coarse."""

    def __init__(self, in_dims: Sequence[int], fpn_dim=256, pooling="AVG", num_extra_pooling=1,
                 use_lite=False, use_bn=False, use_gn=False, generator=None):
        super().__init__()
        if pooling not in ("AVG", "MAX"):
            raise ValueError(f"unsupported HRFPN.POOLING_TYPE: {pooling}")
        self.dim_out = fpn_dim
        self.pooling = pooling
        self.num_output = len(in_dims) + num_extra_pooling
        norm = dict(use_bn=use_bn, use_gn=use_gn, generator=generator)
        self.reduction_conv = RefConv(sum(in_dims), fpn_dim, 1, **norm)
        for i in range(self.num_output):
            self.add_module(f"fpn_conv{i}", RefConv(fpn_dim, fpn_dim, 3, use_dwconv=use_lite,
                                                    suffix_1x1=use_lite, **norm))

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        ups = [feats[0]] + [
            F.interpolate(f, size=(f.shape[-2] * 2 ** i, f.shape[-1] * 2 ** i), mode="bilinear",
                          align_corners=False)
            for i, f in enumerate(feats) if i > 0
        ]
        x = self.reduction_conv(torch.cat(ups, dim=1))
        pool = F.avg_pool2d if self.pooling == "AVG" else F.max_pool2d
        outs = [x] + [pool(x, 2 ** i, 2 ** i) for i in range(1, self.num_output)]
        return [getattr(self, f"fpn_conv{i}")(o) for i, o in enumerate(outs)]


class MergeCell(nn.Module):
    """A Sum or GP cell: both inputs resized to the output size, summed (GP:
    the second gated by the sigmoid of the first's global max), then relu
    and a 3x3 `conv_out` unless `with_conv` is False."""

    def __init__(self, fpn_dim, op, with_conv=True, use_lite=False, use_bn=False, use_gn=False,
                 generator=None):
        super().__init__()
        self.op = op
        self.conv_out = RefConv(fpn_dim, fpn_dim, 3, use_dwconv=use_lite, use_bn=use_bn,
                                use_gn=use_gn, suffix_1x1=use_lite,
                                generator=generator) if with_conv else None

    def forward(self, x1, x2, out_hw):
        x1 = _resize_merge(x1, out_hw)
        x2 = _resize_merge(x2, out_hw)
        if self.op == "gp":
            x = x1 + x2 * torch.sigmoid(x1.amax(dim=(2, 3), keepdim=True))
        else:
            x = x1 + x2
        return self.conv_out(F.relu(x)) if self.conv_out is not None else x


# (cell key, op, with_conv) in the reference's stage order
_NASFPN_CELLS = (
    ("gp_64_4", "gp", True),
    ("sum_44_4", "sum", True),
    ("sum_43_3", "sum", True),
    ("sum_43_4", "sum", True),
    ("gp_43_5", "gp", False),
    ("sum_55_5", "sum", True),
    ("gp_54_7", "gp", False),
    ("sum_77_7", "sum", True),
    ("gp_75_6", "gp", True),
)


def _input_convs(module, prefix, in_dims, fpn_dim, min_level, lowest_backbone_lvl, extra_levels,
                 norm):
    """The 1x1 reductions of the trunk's maps, coarsest first; how many."""
    n_stages = len(in_dims) - (min_level - lowest_backbone_lvl)
    if n_stages + extra_levels != NUM_LEVELS:
        raise ValueError(f"{type(module).__name__}'s wiring is fixed at {NUM_LEVELS} levels, got "
                         f"{n_stages} from the trunk and {extra_levels} extra")
    for i in range(n_stages):
        module.add_module(f"{prefix}{i}", RefConv(in_dims[-1 - i], fpn_dim, 1, **norm))
    return n_stages


class NASFPN(nn.Module):
    """NUM_STACK stages of the fixed cell wiring over five levels."""

    def __init__(self, in_dims: Sequence[int], fpn_dim=256, num_stack=7, min_level=2,
                 lowest_backbone_lvl=2, extra_levels=1, use_lite=False, use_bn=False,
                 use_gn=False, generator=None):
        super().__init__()
        self.dim_out = fpn_dim
        self.num_stack, self.extra_levels = num_stack, extra_levels
        norm = dict(use_bn=use_bn, use_gn=use_gn, generator=generator)
        self.n_stages = _input_convs(self, "nasfpn_in", in_dims, fpn_dim, min_level,
                                     lowest_backbone_lvl, extra_levels, norm)
        for s in range(num_stack):
            for key, op, with_conv in _NASFPN_CELLS:
                self.add_module(f"stage{s}_{key}", MergeCell(fpn_dim, op, with_conv, use_lite,
                                                             **norm))

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        px = [getattr(self, f"nasfpn_in{i}")(feats[-1 - i]) for i in range(self.n_stages)]
        for _ in range(self.extra_levels):
            # F.max_pool2d(kernel 1, stride 2): the stride-2 subsample
            px.insert(0, px[0][:, :, ::2, ::2])
        p7, p6, p5, p4, p3 = px

        def hw(t):
            return t.shape[-2:]

        for s in range(self.num_stack):
            def cell(key, a, b, out):
                return getattr(self, f"stage{s}_{key}")(a, b, hw(out))

            p4_1 = cell("gp_64_4", p6, p4, p4)
            p4_2 = cell("sum_44_4", p4_1, p4, p4)
            p3 = cell("sum_43_3", p4_2, p3, p3)
            p4 = cell("sum_43_4", p4_2, p3, p4)
            p5_tmp = cell("gp_43_5", p4, p3, p5)
            p5 = cell("sum_55_5", p5, p5_tmp, p5)
            p7_tmp = cell("gp_54_7", p5, p4_2, p7)
            p7 = cell("sum_77_7", p7, p7_tmp, p7)
            p6 = cell("gp_75_6", p7, p5, p6)
        return [p3, p4, p5, p6, p7]


class Fusion(nn.Module):
    """Learned scalar fusion of n = 2 or 3 maps: (sum of x_i * w_i) / (sum of
    w_i + eps), except that the third input enters as `x3 + w3`."""

    def __init__(self, n, eps=1e-4):
        super().__init__()
        self.n, self.eps = n, eps
        for i in range(n):
            self.register_parameter(f"w{i + 1}",
                                    nn.Parameter(torch.full((1,), 0.5 if n == 2 else 0.333)))

    def forward(self, *xs):
        ws = [getattr(self, f"w{i + 1}") for i in range(self.n)]
        num = xs[0] * ws[0] + xs[1] * ws[1]
        if self.n == 3:
            num = num + xs[2] + ws[2]
        return num / (sum(ws) + self.eps)


class BiFPN(nn.Module):
    """NUM_STACK top-down and bottom-up stages over five levels, a fusion and
    a 3x3 conv (with relu under a norm) at each node."""

    _TD = ("p6_td", "p5_td", "p4_td", "p3_out")
    _BU = ("p4_out", "p5_out", "p6_out", "p7_out")

    def __init__(self, in_dims: Sequence[int], fpn_dim=256, num_stack=7, eps=1e-4, min_level=2,
                 lowest_backbone_lvl=2, extra_levels=1, use_lite=False, use_bn=False,
                 use_gn=False, generator=None):
        super().__init__()
        self.dim_out = fpn_dim
        self.num_stack, self.extra_levels = num_stack, extra_levels
        norm = dict(use_bn=use_bn, use_gn=use_gn, generator=generator)
        self.n_stages = _input_convs(self, "bifpn_in", in_dims, fpn_dim, min_level,
                                     lowest_backbone_lvl, extra_levels, norm)
        for s in range(num_stack):
            for node in self._TD + self._BU:
                n = 3 if node in ("p4_out", "p5_out", "p6_out") else 2
                self.add_module(f"stage{s}_{node}_fusion", Fusion(n, eps))
                self.add_module(f"stage{s}_{node}_conv", RefConv(
                    fpn_dim, fpn_dim, 3, use_dwconv=use_lite, use_relu=use_bn or use_gn,
                    suffix_1x1=use_lite, **norm))

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        px = [getattr(self, f"bifpn_in{i}")(feats[-1 - i]) for i in range(self.n_stages)]
        for _ in range(self.extra_levels):
            px.insert(0, F.max_pool2d(px[0], 2, 2))
        p7, p6, p5, p4, p3 = px
        s7, s6, s5, s4, s3 = (t.shape[-2:] for t in px)
        for s in range(self.num_stack):
            def node(name, *xs):
                fused = getattr(self, f"stage{s}_{name}_fusion")(*xs)
                return getattr(self, f"stage{s}_{name}_conv")(fused)

            p6_td = node("p6_td", p6, _resize_merge(p7, s6))
            p5_td = node("p5_td", p5, _resize_merge(p6_td, s5))
            p4_td = node("p4_td", p4, _resize_merge(p5_td, s4))
            p3 = node("p3_out", p3, _resize_merge(p4_td, s3))
            p4 = node("p4_out", p4, p4_td, _resize_merge(p3, s4))
            p5 = node("p5_out", p5, p5_td, _resize_merge(p4, s5))
            p6 = node("p6_out", p6, p6_td, _resize_merge(p5, s6))
            p7 = node("p7_out", p7, _resize_merge(p6, s7))
        return [p3, p4, p5, p6, p7]


def build_hrfpn(cfg, in_dims: Sequence[int], generator: torch.Generator) -> HRFPN:
    h = cfg.FPN.HRFPN
    return HRFPN(in_dims, fpn_dim=h.DIM, pooling=h.POOLING_TYPE,
                 num_extra_pooling=h.NUM_EXTRA_POOLING, use_lite=h.USE_LITE, use_bn=h.USE_BN,
                 use_gn=h.USE_GN, generator=generator)


def _stacked_kw(cfg, section):
    min_level, max_level = get_min_max_levels(cfg)
    return dict(fpn_dim=section.DIM, num_stack=section.NUM_STACK, min_level=min_level,
                lowest_backbone_lvl=cfg.FPN.LOWEST_BACKBONE_LVL,
                extra_levels=max_level - cfg.FPN.HIGHEST_BACKBONE_LVL,
                use_lite=section.USE_LITE, use_bn=section.USE_BN, use_gn=section.USE_GN)


def build_nasfpn(cfg, in_dims: Sequence[int], generator: torch.Generator) -> NASFPN:
    return NASFPN(in_dims, generator=generator, **_stacked_kw(cfg, cfg.FPN.NASFPN))


def build_bifpn(cfg, in_dims: Sequence[int], generator: torch.Generator) -> BiFPN:
    b = cfg.FPN.BIFPN
    return BiFPN(in_dims, eps=b.EPS, generator=generator, **_stacked_kw(cfg, b))


# FPN.BODY -> builder(cfg, the trunk's widths, generator)
NECKS = {"fpn": build_fpn, "hrfpn": build_hrfpn, "nasfpn": build_nasfpn, "bifpn": build_bifpn}
