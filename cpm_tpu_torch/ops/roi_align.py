"""RoIAlign in plain PyTorch: the gather formulation.

Port of cpm_tpu/ops/roi_align.py (`roi_align`, `multilevel_roi_align`):
sample-point gathers plus bilinear weights, with the reference CUDA
kernel's boundary rules (a sample with y < -1 or y > H, or x likewise,
reads zero; otherwise its coordinate is clamped into [0, H-1]) and the
JAX package's static 2 samples per bin for `sampling_ratio == 0`.

This is the plain version of the hand-written CUDA kernel
(cpm_tpu_torch/ops/cuda/multilevel_roi_align.py): the CPU path runs it, and
the kernel is held against it on the card. Layouts are the JAX package's:
features are NHWC `[B, H, W, C]`, outputs `[R, ph, pw, C]`.
"""

from typing import Sequence

import torch


def _bilinear_weights_1d(coord: torch.Tensor, size: torch.Tensor):
    """Source cells and weights of sample positions `coord` on an axis of
    length `size` (broadcastable against coord)."""
    oob = (coord < -1.0) | (coord > size)
    c = torch.minimum(torch.clamp(coord, min=0.0), size - 1.0)
    lo = torch.floor(c)
    hi = torch.minimum(lo + 1.0, size - 1.0)
    w_hi = c - lo
    w_lo = 1.0 - w_hi
    return lo.long(), hi.long(), w_lo, w_hi, oob


def multilevel_roi_align(
    features: Sequence[torch.Tensor],
    rois: torch.Tensor,
    levels: torch.Tensor,
    output_size,
    spatial_scales: Sequence[float],
    sampling_ratio: int = 0,
    aligned: bool = False,
) -> torch.Tensor:
    """RoIAlign over FPN levels, each roi gathering from its own level.

    Args:
      features: list of `[B, H_l, W_l, C]` maps, finest first.
      rois: `[R, 5]` (batch_index, x1, y1, x2, y2) in image coordinates.
      levels: `[R]` integer level ids in `[0, L)`.
      output_size: (ph, pw).
      spatial_scales: per-level 1/stride.

    Returns: `[R, ph, pw, C]` in the feature dtype.
    """
    ph, pw = output_size
    sr = sampling_ratio if sampling_ratio > 0 else 2
    if len(features) != len(spatial_scales):
        raise ValueError(
            f"{len(features)} feature levels but {len(spatial_scales)} scales"
        )
    dev = rois.device
    b = features[0].shape[0]
    c = features[0].shape[-1]
    r = rois.shape[0]

    hs = [int(f.shape[1]) for f in features]
    ws = [int(f.shape[2]) for f in features]
    offs, total = [], 0
    for h, w in zip(hs, ws):
        offs.append(total)
        total += b * h * w
    flat = torch.cat([f.reshape(b * h * w, c) for f, h, w in zip(features, hs, ws)])

    lvl = levels.long()
    hi_l = torch.tensor(hs, dtype=torch.long, device=dev)[lvl]
    wi_l = torch.tensor(ws, dtype=torch.long, device=dev)[lvl]
    h_l = hi_l.float()
    w_l = wi_l.float()
    off_l = torch.tensor(offs, dtype=torch.long, device=dev)[lvl]
    scale = torch.tensor(list(spatial_scales), dtype=torch.float32, device=dev)[lvl]

    offset = 0.5 if aligned else 0.0
    batch_idx = rois[:, 0].long()
    # coordinates always in f32: bf16 would quantize image-scale coordinates
    rois = rois.float()
    x1 = rois[:, 1] * scale - offset
    y1 = rois[:, 2] * scale - offset
    x2 = rois[:, 3] * scale - offset
    y2 = rois[:, 4] * scale - offset
    roi_w = x2 - x1
    roi_h = y2 - y1
    if not aligned:
        roi_w = torch.clamp(roi_w, min=1.0)
        roi_h = torch.clamp(roi_h, min=1.0)
    # divide by tensors: CUDA turns a division by a Python number into a
    # multiplication by its reciprocal, which rounds differently from the
    # true division that the JAX package and the CUDA kernel take
    bin_w = roi_w / torch.full_like(roi_w, pw)
    bin_h = roi_h / torch.full_like(roi_h, ph)

    ix = torch.arange(pw * sr, dtype=torch.float32, device=dev) + 0.5
    iy = torch.arange(ph * sr, dtype=torch.float32, device=dev) + 0.5
    ix = ix / torch.full_like(ix, sr)
    iy = iy / torch.full_like(iy, sr)
    xs = x1[:, None] + ix[None, :] * bin_w[:, None]  # [R, pw*sr]
    ys = y1[:, None] + iy[None, :] * bin_h[:, None]  # [R, ph*sr]

    # flat index of (b, y, x) at the roi's level: off + (b*H_l + y)*W_l + x
    base = off_l + batch_idx * hi_l * wi_l
    x_lo, x_hi, wx_lo, wx_hi, x_oob = _bilinear_weights_1d(xs, w_l[:, None])
    y_lo, y_hi, wy_lo, wy_hi, y_oob = _bilinear_weights_1d(ys, h_l[:, None])

    def gather(yi, xi):
        idx = base[:, None, None] + yi[:, :, None] * wi_l[:, None, None] + xi[:, None, :]
        return flat[idx.reshape(-1)].reshape(r, ph * sr, pw * sr, c)

    fd = flat.dtype
    wyl = wy_lo.to(fd)[:, :, None, None]
    wyh = wy_hi.to(fd)[:, :, None, None]
    wxl = wx_lo.to(fd)[:, None, :, None]
    wxh = wx_hi.to(fd)[:, None, :, None]
    vals = (
        gather(y_lo, x_lo) * wyl * wxl
        + gather(y_lo, x_hi) * wyl * wxh
        + gather(y_hi, x_lo) * wyh * wxl
        + gather(y_hi, x_hi) * wyh * wxh
    )
    oob = y_oob[:, :, None] | x_oob[:, None, :]
    vals = torch.where(oob[..., None], torch.zeros((), dtype=fd, device=dev), vals)
    return vals.reshape(r, ph, sr, pw, sr, c).mean(dim=(2, 4))


def roi_align(
    features: torch.Tensor,
    rois: torch.Tensor,
    output_size,
    spatial_scale: float,
    sampling_ratio: int = 0,
    aligned: bool = False,
) -> torch.Tensor:
    """RoIAlign over one `[B, H, W, C]` map: the one-level case of
    `multilevel_roi_align`, which computes the same samples."""
    levels = torch.zeros(rois.shape[0], dtype=torch.long, device=rois.device)
    return multilevel_roi_align(
        [features], rois, levels, output_size, (spatial_scale,),
        sampling_ratio, aligned,
    )
