"""Deformable convolution v1 / v2.

Port of cpm_tpu/ops/deform_conv.py. The same three steps:

1. a regular conv predicts per-tap offsets (and masks for v2);
2. a bilinear sampler reads the input at `p + k + offset_k` for all taps;
3. one contraction of the sampled columns with the weight.

Step 2 is `deform_sample`: on the CPU the plain version below
(`deform_sample_plain`, the port of `_window_parts` / `_bilinear_gather` and,
for maps of one row or one column, of `_bilinear_gather_corner4`), through
which autograd differentiates; on a CUDA device the hand-written kernels of
cpm_tpu_torch/ops/cuda/deform_sample.py, forward and backward. Step 3 is a
`torch.matmul` / `torch.bmm`, as the JAX package leaves it to XLA; a grouped
deform conv contracts per group and builds no block-diagonal dense weight
(that is a layout choice of the TPU's matrix unit).

Layouts at the functions are the JAX package's: maps NHWC `[B, H, W, C]`,
offsets `[B, Ho, Wo, 2*kh*kw]` ordered (dy0, dx0, dy1, dx1, ...) over taps
row-major, masks `[B, Ho, Wo, kh*kw]`. The weight is torch's OIHW
`[Cout, Cin/groups, kh, kw]`, the reference checkpoint's shape. The modules
(`DeformConvPack`, `ModulatedDeformConvPack`) take and return NCHW views of
channels_last memory like every conv of the port, so the NHWC views the
sampler reads are contiguous without a copy.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from cpm_tpu_torch.modeling import initializers as init


def _tent_axis(coord: torch.Tensor, size: int):
    """The two window cells of each coordinate on an axis of length `size`
    and their tent weights: start = clamp(floor(coord), 0, size - 2), cells
    start and start + 1, weight relu(1 - |coord - cell|), zero past the last
    cell. Returns (cells long [..., 2], clamped into the axis; weights
    f32 [..., 2])."""
    start = torch.clamp(torch.floor(coord), 0, max(size - 2, 0))
    cells = start[..., None] + torch.arange(2, dtype=coord.dtype, device=coord.device)
    weights = F.relu(1.0 - torch.abs(coord[..., None] - cells)) * (cells <= size - 1)
    return torch.clamp(cells, max=size - 1).long(), weights


def _sample_window(feat, ys, xs):
    """`_bilinear_gather`: the 2x2 window at the clamped start, tent weights."""
    b, h, w, c = feat.shape
    yi, wy = _tent_axis(ys, h)   # [B, P, 2]
    xi, wx = _tent_axis(xs, w)
    flat = feat.reshape(b, h * w, c)
    out = None
    for i in (0, 1):
        for j in (0, 1):
            idx = yi[..., i] * w + xi[..., j]                       # [B, P]
            cell = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
            term = cell * (wy[..., i] * wx[..., j]).to(feat.dtype)[..., None]
            out = term if out is None else out + term
    return out


def _sample_corner4(feat, ys, xs):
    """`_bilinear_gather_corner4`: four corner gathers around floor(coord),
    a corner outside the map contributing zero."""
    b, h, w, c = feat.shape
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy1, wx1 = ys - y0, xs - x0
    wy0, wx0 = 1.0 - wy1, 1.0 - wx1
    flat = feat.reshape(b, h * w, c)

    def corner(yi, xi, weight):
        inb = (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)
        idx = torch.clamp(yi, 0, h - 1).long() * w + torch.clamp(xi, 0, w - 1).long()
        cell = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
        return cell * (weight * inb).to(feat.dtype)[..., None]

    return (corner(y0, x0, wy0 * wx0) + corner(y0, x0 + 1, wy0 * wx1)
            + corner(y0 + 1, x0, wy1 * wx0) + corner(y0 + 1, x0 + 1, wy1 * wx1))


def deform_sample_plain(feat: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of feat `[B, H, W, C]` at coordinates ys / xs `[B, P]`
    -> `[B, P, C]` in feat's dtype; the plain version of the CUDA sampler.

    Coordinates are taken in float32 whatever the map's dtype. A sample
    wholly outside the map gives zero and one on the border a partial sum
    (zero padding). Maps with H < 2 or W < 2 take the four-corner form, as
    the JAX package does; both forms give the same values, and autograd
    through either gives the gradients to the map and to the coordinates
    (the tent's derivative is zero at an integer coordinate)."""
    ys, xs = ys.float(), xs.float()
    if feat.shape[1] < 2 or feat.shape[2] < 2:
        return _sample_corner4(feat, ys, xs)
    return _sample_window(feat, ys, xs)


def deform_sample(feat: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """`deform_sample_plain` for CPU tensors; the CUDA kernels (forward, and
    backward under autograd) for tensors on a card."""
    if feat.device.type == "cpu":
        return deform_sample_plain(feat, ys, xs)
    from cpm_tpu_torch.ops.cuda.deform_sample import deform_sample_cuda

    return deform_sample_cuda(feat, ys, xs)


def sampling_grid(offset: torch.Tensor, kernel_hw, stride: int, padding: int, dilation: int):
    """(ys, xs) `[B, Ho*Wo*K]` f32: output position * stride - padding +
    tap * dilation + the tap's offset. `offset` is `[B, Ho, Wo, 2*K]`; it is
    cast to f32 first: bf16 would quantize positions past 128 cells to whole
    cells and lose the sub-cell offsets."""
    kh, kw = kernel_hw
    b, ho, wo, _ = offset.shape
    k = kh * kw
    dev = offset.device
    oy = torch.arange(ho, dtype=torch.float32, device=dev) * stride - padding
    ox = torch.arange(wo, dtype=torch.float32, device=dev) * stride - padding
    ky = torch.arange(kh, dtype=torch.float32, device=dev) * dilation
    kx = torch.arange(kw, dtype=torch.float32, device=dev) * dilation
    base_y = (oy[:, None, None, None] + ky[None, None, :, None]).expand(ho, wo, kh, kw)
    base_x = (ox[None, :, None, None] + kx[None, None, None, :]).expand(ho, wo, kh, kw)
    off = offset.float().reshape(b, ho, wo, k, 2)
    ys = base_y.reshape(ho, wo, k)[None] + off[..., 0]
    xs = base_x.reshape(ho, wo, k)[None] + off[..., 1]
    return ys.reshape(b, ho * wo * k), xs.reshape(b, ho * wo * k)


def window_tiles(ys: torch.Tensor, xs: torch.Tensor, size_hw, tile_hw):
    """The samples binned by the tile of their window start: the plain
    version of the binning kernels of the sampler's backward
    (ops/cuda/deform_sample.py::DeformSampleKernel.bin_samples), whose map
    kernel's blocks each own one tile of the map's gradient.

    ys / xs `[B, P]` f32 on a map of `size_hw` = (H, W); tiles of `tile_hw` =
    (TH, TW) cells, T = ceil(H/TH) x ceil(W/TW) of them per image, numbered
    row-major. A sample's window starts at (clamp(floor(y), 0, H-2),
    clamp(floor(x), 0, W-2)), as in `_tent_axis` (a NaN coordinate starts at
    0, +-inf at the ends). A sample whose four weights are all zero (wholly
    outside the map, or NaN) goes in no tile: key T of its image.

    Returns (order int32 `[B*P]`: flat sample indices sorted stably by (image,
    key), so image b's samples fill order[b*P : (b+1)*P] with those of no
    tile last; offsets int32 `[B*(T+1) + 1]`: the samples of key k of image b
    are order[offsets[b*(T+1) + k] : offsets[b*(T+1) + k + 1]]). Torch ops
    only, with no host sync."""
    b, p = ys.shape
    h, w = size_hw
    th, tw = tile_hw
    tiles_x = -(-w // tw)
    tiles = -(-h // th) * tiles_x

    def start_and_live(coord, size):
        last = float(max(size - 2, 0))
        f = torch.floor(coord)
        # written as comparisons so that NaN starts at 0 and +-inf at the ends
        start = torch.where(f >= last, last, torch.where(f > 0, f, 0.0))
        # a window cell weighs relu(1 - |coord - cell|), zero past the last cell
        live = (coord - start).abs() < 1
        if size >= 2:
            live |= (coord - (start + 1)).abs() < 1
        return start.long(), live

    sy, live_y = start_and_live(ys.float(), h)
    sx, live_x = start_and_live(xs.float(), w)
    image = torch.arange(b, device=ys.device)[:, None]
    key = torch.where(live_y & live_x, (sy // th) * tiles_x + sx // tw, tiles)
    key = (image * (tiles + 1) + key).reshape(-1).to(torch.int32)
    sorted_keys, order = torch.sort(key, stable=True)
    bins = torch.arange(b * (tiles + 1) + 1, device=ys.device, dtype=torch.int32)
    offsets = torch.searchsorted(sorted_keys, bins, out_int32=True)
    return order.to(torch.int32), offsets


def deform_conv2d(
    x: torch.Tensor,
    weight: torch.Tensor,
    offset: torch.Tensor,
    mask: torch.Tensor = None,
    stride: int = 1,
    padding: int = 1,
    dilation: int = 1,
    groups: int = 1,
) -> torch.Tensor:
    """Deformable conv core.

    Args:
      x: `[B, H, W, Cin]` input (NHWC).
      weight: `[Cout, Cin // groups, kh, kw]` (OIHW; output channels
        groups-major, as a grouped `nn.Conv2d` has them).
      offset: `[B, Ho, Wo, 2*kh*kw]` per-tap (dy, dx) pairs.
      mask: optional `[B, Ho, Wo, kh*kw]` modulation (v2); None = v1.
      groups: channel groups of the contraction (the ResNeXt cardinality);
        the offsets are shared by all groups.
    Returns: `[B, Ho, Wo, Cout]` in x's dtype.
    """
    b, h, w, cin = x.shape
    cout, cg, kh, kw = weight.shape
    if cg * groups != cin or cout % groups:
        raise ValueError(f"weight {tuple(weight.shape)} does not fit Cin={cin}, groups={groups}")
    k = kh * kw
    ho = (h + 2 * padding - dilation * (kh - 1) - 1) // stride + 1
    wo = (w + 2 * padding - dilation * (kw - 1) - 1) // stride + 1
    if tuple(offset.shape) != (b, ho, wo, 2 * k):
        raise ValueError(f"offset {tuple(offset.shape)}, want {(b, ho, wo, 2 * k)}")
    ys, xs = sampling_grid(offset, (kh, kw), stride, padding, dilation)
    sampled = deform_sample(x, ys, xs).reshape(b, ho, wo, k, cin)
    if mask is not None:
        sampled = sampled * mask[..., None].to(sampled.dtype)
    n = b * ho * wo
    if groups == 1:
        # [N, K*Cin] x [K*Cin, Cout]
        w2 = weight.permute(2, 3, 1, 0).reshape(k * cin, cout)
        out = sampled.reshape(n, k * cin) @ w2.to(sampled.dtype)
    else:
        # per group: [G, N, K*Cg] x [G, K*Cg, Cout/G]; the columns are
        # regrouped in one copy, after which `sampled` itself is dropped
        cog = cout // groups
        cols = sampled.reshape(n, k, groups, cg).permute(2, 0, 1, 3).reshape(groups, n, k * cg)
        wg = weight.reshape(groups, cog, cg, k).permute(0, 3, 2, 1).reshape(groups, k * cg, cog)
        out = torch.bmm(cols, wg.to(cols.dtype)).permute(1, 0, 2)
    return out.reshape(b, ho, wo, cout)


class _DeformPack(nn.Module):
    """What the two packs share: the offset conv (zero-initialised, with a
    bias), the main weight `[Cout, Cin/groups, k, k]` named `weight`, an
    optional bias."""

    offset_channels_per_tap = 2
    offset_conv_name = "conv_offset"

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3, stride: int = 1,
                 dilation: int = 1, groups: int = 1, use_bias: bool = False,
                 generator: torch.Generator = None):
        super().__init__()
        k = kernel_size
        self.stride, self.dilation, self.groups = stride, dilation, groups
        self.padding = dilation * (k - 1) // 2
        self.taps = k * k
        conv = nn.Conv2d(in_channels, self.offset_channels_per_tap * k * k, k, stride=stride,
                         padding=self.padding, dilation=dilation, bias=True)
        nn.init.zeros_(conv.weight)
        nn.init.zeros_(conv.bias)
        self.add_module(self.offset_conv_name, conv)
        self.weight = nn.Parameter(torch.empty(features, in_channels // groups, k, k))
        # he_normal over fan_in, as the JAX package draws it
        init.normal_(self.weight, math.sqrt(2.0 / (in_channels // groups * k * k)), generator)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def _deform(self, x, offset, mask):
        """x NCHW, offset / mask NCHW -> NCHW, all views of NHWC memory."""
        out = deform_conv2d(
            x.permute(0, 2, 3, 1), self.weight, offset.permute(0, 2, 3, 1),
            None if mask is None else mask.permute(0, 2, 3, 1),
            self.stride, self.padding, self.dilation, self.groups,
        )
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)
        return out.permute(0, 3, 1, 2)


class DeformConvPack(_DeformPack):
    """Deformable conv v1 that predicts its own offsets."""

    def forward(self, x):
        return self._deform(x, self.conv_offset(x), None)


class ModulatedDeformConvPack(_DeformPack):
    """Deformable conv v2: its own offsets and a sigmoid mask, from one conv
    of 3*k*k channels (offsets first, masks after)."""

    offset_channels_per_tap = 3
    offset_conv_name = "conv_offset_mask"

    def forward(self, x):
        om = self.conv_offset_mask(x)
        offset, mask = om[:, : 2 * self.taps], om[:, 2 * self.taps:]
        return self._deform(x, offset, torch.sigmoid(mask))
