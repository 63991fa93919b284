"""Grid head modules: conv tower, neighbour fusion, grouped-deconv output,
and the classification head.

Port of cpm_tpu/modeling/roi_heads/grid_modules.py in the untiled form
(`GridHead`, `GridOutput`, `ClsHead`, `ClsOutput`, `TransitionConv`,
`get_neighbor_points`). At the module boundaries the layouts are the JAX
package's: pooled features and tower outputs NHWC `[R, s, s, C]`, heatmaps
`[R, P, 2s', 2s']`. Inside, convolutions run NCHW on channels_last memory,
so the permutes between the two are views.

The JAX grouped transposed conv (`grouped_deconv`: a flipped kernel over a
2x-dilated input) is `ConvTranspose2d(k=4, stride=2, padding=1,
groups=P)`; utils/param_bridge.py maps its kernel.
"""

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cpm_tpu_torch.modeling import initializers as init
from cpm_tpu_torch.modeling.norm import GroupNorm
from cpm_tpu_torch.ops.pooler import Pooler


def get_neighbor_points(grid_size: int) -> List[Tuple[int, ...]]:
    """4-neighbourhood in the reference's column-major point order."""
    pts = []
    for i in range(grid_size):
        for j in range(grid_size):
            nb = []
            if i > 0:
                nb.append((i - 1) * grid_size + j)
            if j > 0:
                nb.append(i * grid_size + j - 1)
            if j < grid_size - 1:
                nb.append(i * grid_size + j + 1)
            if i < grid_size - 1:
                nb.append((i + 1) * grid_size + j)
            pts.append(tuple(nb))
    return pts


def _torch_default_conv(conv: nn.Module, g: torch.Generator) -> nn.Module:
    init.torch_default(conv.weight, conv.bias, g)
    return conv


class TransitionConv(nn.Module):
    """5x5 depthwise + 1x1 pointwise transition."""

    def __init__(self, channels: int, generator: torch.Generator = None):
        super().__init__()
        self.dw = _torch_default_conv(
            nn.Conv2d(channels, channels, 5, padding=2, groups=channels), generator
        )
        self.pw = _torch_default_conv(nn.Conv2d(channels, channels, 1), generator)

    def forward(self, x):
        return self.pw(self.dw(x))


class GridHead(nn.Module):
    """Pooled 14x14 features -> (tower features, fused features)."""

    def __init__(
        self,
        in_channels: int,
        grid_points: int = 9,
        roi_feat_size: int = 14,
        num_convs: int = 8,
        point_feat_channels: int = 64,
        scales: Sequence[float] = (0.25, 0.125, 0.0625, 0.03125),
        sampling_ratio: int = 2,
        fused_on: bool = True,
        generator: torch.Generator = None,
    ):
        super().__init__()
        P, c = grid_points, point_feat_channels
        cout = c * P
        self.point_feat_channels = c
        self.fused_on = fused_on
        self.pooler = Pooler((roi_feat_size, roi_feat_size), scales, sampling_ratio)
        self.convs = nn.ModuleList(
            _torch_default_conv(
                nn.Conv2d(in_channels if i == 0 else cout, cout, 3,
                          stride=2 if i == 0 else 1, padding=1),
                generator,
            )
            for i in range(num_convs)
        )
        self.gns = nn.ModuleList(GroupNorm(cout, num_groups=4 * P) for _ in range(num_convs))
        if fused_on:
            self.neighbors = get_neighbor_points(int(math.isqrt(P)))
            pairs = [f"{i}_{j}" for i, pts in enumerate(self.neighbors) for j in range(len(pts))]
            self.forder = nn.ModuleDict({k: TransitionConv(c, generator) for k in pairs})
            self.sorder = nn.ModuleDict({k: TransitionConv(c, generator) for k in pairs})

    def forward(self, features=None, rois=None, roi_mask=None, *, pooled=None):
        """Returns (x [R, s/2, s/2, P*c], x_so or None, None), NHWC; point p
        owns channels [p*c, (p+1)*c). `pooled` [R, s, s, C] skips pooling."""
        if pooled is None:
            pooled = self.pooler(features, rois, roi_mask)
        x = pooled.permute(0, 3, 1, 2)
        for conv, gn in zip(self.convs, self.gns):
            x = F.relu(gn(conv(x)))
        if not self.fused_on:
            return x.permute(0, 2, 3, 1), None, None

        c = self.point_feat_channels

        def point(feat, p):
            return feat[:, p * c:(p + 1) * c]

        x_fo = []
        for i, pts in enumerate(self.neighbors):
            acc = point(x, i)
            for j, p_idx in enumerate(pts):
                acc = acc + self.forder[f"{i}_{j}"](point(x, p_idx))
            x_fo.append(acc)
        x_so = []
        for i, pts in enumerate(self.neighbors):
            acc = point(x, i)
            for j, p_idx in enumerate(pts):
                acc = acc + self.sorder[f"{i}_{j}"](x_fo[p_idx])
            x_so.append(acc)
        x_so = torch.cat(x_so, dim=1)
        return x.permute(0, 2, 3, 1), x_so.permute(0, 2, 3, 1), None


class GridOutput(nn.Module):
    """Two grouped deconvs to heatmaps, plus the optional ISM IoU branch."""

    def __init__(
        self,
        grid_points: int = 9,
        point_feat_channels: int = 64,
        roi_feat_size: int = 14,
        iou_helper: bool = False,
        fused_on: bool = True,
        generator: torch.Generator = None,
    ):
        super().__init__()
        P, c = grid_points, point_feat_channels
        cout = c * P
        self.fused_on = fused_on
        self.iou_helper = iou_helper
        g = generator
        self.deconv1 = _torch_default_conv(
            nn.ConvTranspose2d(cout, cout, 4, stride=2, padding=1, groups=P), g
        )
        # flax's GroupNorm default epsilon, which the JAX module keeps here
        self.norm1 = GroupNorm(cout, num_groups=P, eps=1e-6)
        self.deconv2 = _torch_default_conv(
            nn.ConvTranspose2d(cout, P, 4, stride=2, padding=1, groups=P), g
        )
        if iou_helper:
            s = roi_feat_size // 2
            self.iou_fc1 = nn.Linear(s * s * cout, 1024)
            self.iou_fc2 = nn.Linear(1024, 1024)
            self.iou_pred = nn.Linear(1024, 2)
            for fc in (self.iou_fc1, self.iou_fc2):
                init.kaiming_uniform_a1(fc.weight, g)
                nn.init.zeros_(fc.bias)
            init.normal_(self.iou_pred.weight, 0.01, g)
            nn.init.zeros_(self.iou_pred.bias)

    def _decode_tower(self, h):
        h = F.relu(self.norm1(self.deconv1(h)))
        return self.deconv2(h)

    def forward(self, x, x_so=None, train: bool = False):
        """x, x_so: NHWC tower outputs. Returns ({'fused', 'unfused'}
        heatmap logits [R, P, H, W] in f32 (or None), iou logits [R, 2]
        f32 or None)."""
        fused = None
        if self.fused_on and x_so is not None:
            fused = self._decode_tower(x_so.permute(0, 3, 1, 2))
        if train or not self.fused_on:
            unfused = self._decode_tower(x.permute(0, 3, 1, 2))
        else:
            unfused = fused
        iou_logits = None
        if self.iou_helper:
            h = F.relu(self.iou_fc1(x.reshape(x.shape[0], -1)))
            h = F.relu(self.iou_fc2(h))
            iou_logits = self.iou_pred(h).float()
        return (
            dict(
                fused=None if fused is None else fused.float(),
                unfused=None if unfused is None else unfused.float(),
            ),
            iou_logits,
        )


class ClsHead(nn.Module):
    """7x7 RoIAlign -> flatten (h, w, c) -> 2 FC with ReLU."""

    def __init__(
        self,
        in_channels: int,
        resolution: Sequence[int] = (7, 7),
        scales: Sequence[float] = (0.25, 0.125, 0.0625, 0.03125),
        sampling_ratio: int = 2,
        mlp_dim: int = 1024,
        generator: torch.Generator = None,
    ):
        super().__init__()
        self.pooler = Pooler(tuple(resolution), scales, sampling_ratio)
        self.fc6 = nn.Linear(resolution[0] * resolution[1] * in_channels, mlp_dim)
        self.fc7 = nn.Linear(mlp_dim, mlp_dim)
        for fc in (self.fc6, self.fc7):
            init.kaiming_uniform_a1(fc.weight, generator)
            nn.init.zeros_(fc.bias)

    def forward(self, features, rois, roi_mask=None):
        x = self.pooler(features, rois, roi_mask)
        x = x.reshape(x.shape[0], -1)
        return F.relu(self.fc7(F.relu(self.fc6(x))))


class ClsOutput(nn.Module):
    """Linear classifier; logits in f32."""

    def __init__(self, in_features: int, num_classes: int, generator: torch.Generator = None):
        super().__init__()
        self.cls_score = nn.Linear(in_features, num_classes)
        init.normal_(self.cls_score.weight, 0.01, generator)
        nn.init.zeros_(self.cls_score.bias)

    def forward(self, x):
        return self.cls_score(x).float()
