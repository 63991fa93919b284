"""The C4 (non-FPN) RoI box heads: ResNet's stage 5 as the head.

Port of cpm_tpu/modeling/roi_heads/c4_heads.py (`_stage5`, `ResNetC5Head`,
`ResNet2MLPHead`), for the `resnet_c4` trunk (backbone/resnet.py), which
stops at the stride-16 C4 map:

* `resnet_c5_head`: RoIAlign on the C4 map, then stage 5 at stride
  min(resolution) // 7 (a 14x14 pool gives 7x7), returned as a 4-D block
  that `BoxOutput` average-pools;
* `resnet_2mlp_head`: stage 5 over the whole C4 map (stride 1 under
  C5_DILATION 2, as its configs set), a 1x1 `conv_new` to 256 with relu,
  then RoIAlign, `fc1` and `fc2` with relu. As in the reference, the
  pooler keeps the C4 scale even where stage 5 strides the map.

Both pool one level, so their pooler calls go to the single-level RoIAlign
kernel (ops/cuda/roi_align.py) on the card. Stage 5's blocks are the
trunk's (`layer4`, names as in the trunk, so the bridge and the importer
map them alike) and take its options: BASE_PLANES, WIDTH, STRIDE_3X3,
STAGE_WITH_CONV[3], STAGE_WITH_CONTEXT[3], CTX_RATIO, USE_GN, AVG_DOWN and
C5_DILATION, and USE_WS standardises the head's convs (the 2mlp head's
`conv_new` too); its AffineChannels are frozen like the trunk's. Stage 5 is
made of bottleneck blocks whatever USE_ALIGN and BOTTLENECK say, as in the
JAX package. Pooled features enter and leave NHWC.
"""

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from cpm_tpu_torch.modeling import initializers as init
from cpm_tpu_torch.modeling.backbone.resnet import Bottleneck, block_options, make_stage
from cpm_tpu_torch.ops.pooler import Pooler


def _stage5(cfg, in_channels: int, stride: int, generator) -> nn.Sequential:
    """The trunk's stage 5 (`layer4`) from BACKBONE.RESNET."""
    r = cfg.BACKBONE.RESNET
    bp = getattr(r, "BASE_PLANES", 64)
    return make_stage(in_channels, bp * 8, r.LAYERS[3], stride, r.WIDTH, 1,
                      r.STAGE_WITH_CONV[3], r.STRIDE_3X3, r.C5_DILATION, generator,
                      context=r.STAGE_WITH_CONTEXT[3], **block_options(r))


class ResNetC5Head(nn.Module):
    """RoIAlign(C4) -> stage 5 -> [R, h, w, 8 * BASE_PLANES * 4] NHWC."""

    def __init__(self, cfg, in_channels: int, resolution: Sequence[int] = (14, 14),
                 scales: Sequence[float] = (0.0625,), sampling_ratio: int = 0,
                 generator: torch.Generator = None):
        super().__init__()
        self.pooler = Pooler(tuple(resolution), scales, sampling_ratio)
        self.layer4 = _stage5(cfg, in_channels, min(resolution) // 7, generator)
        self.dim_out = getattr(cfg.BACKBONE.RESNET, "BASE_PLANES", 64) * 8 * Bottleneck.expansion

    def forward(self, features, rois, roi_mask=None):
        x = self.pooler(features, rois, roi_mask).permute(0, 3, 1, 2)
        return self.layer4(x).permute(0, 2, 3, 1)


class ResNet2MLPHead(nn.Module):
    """Stage 5 over the C4 map -> conv_new (1x1, 256, relu) -> RoIAlign ->
    fc1 -> fc2, each with relu."""

    def __init__(self, cfg, in_channels: int, resolution: Sequence[int] = (7, 7),
                 scales: Sequence[float] = (0.0625,), sampling_ratio: int = 0,
                 mlp_dim: int = 1024, generator: torch.Generator = None):
        super().__init__()
        r = cfg.BACKBONE.RESNET
        self.layer4 = _stage5(cfg, in_channels, 2 if r.C5_DILATION == 1 else 1, generator)
        self.conv_new = nn.Conv2d(getattr(r, "BASE_PLANES", 64) * 8 * Bottleneck.expansion, 256, 1)
        init.backbone_conv(self.conv_new.weight, generator)
        nn.init.zeros_(self.conv_new.bias)
        self.pooler = Pooler(tuple(resolution), scales, sampling_ratio)
        self.fc1 = nn.Linear(resolution[0] * resolution[1] * 256, mlp_dim)
        self.fc2 = nn.Linear(mlp_dim, mlp_dim)
        # the generic trunk init the reference applies here: N(0, 1e-4)
        for fc in (self.fc1, self.fc2):
            init.normal_fc(fc.weight, generator)
            nn.init.zeros_(fc.bias)
        self.dim_out = mlp_dim

    def forward(self, features, rois, roi_mask=None):
        x = self.layer4(features[0].permute(0, 3, 1, 2))
        x = F.relu(self.conv_new(x)).permute(0, 2, 3, 1)
        x = self.pooler([x], rois, roi_mask)
        x = x.reshape(x.shape[0], -1)
        return F.relu(self.fc2(F.relu(self.fc1(x))))
