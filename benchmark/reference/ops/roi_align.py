"""RoIAlign in plain PyTorch: the plain version of the port's CUDA kernels.

Port of cpm_tpu/ops/roi_align.py (`roi_align`, `multilevel_roi_align`):
sample-point gathers plus bilinear weights, with the reference CUDA
kernel's boundary rules (a sample with y < -1 or y > H, or x likewise,
reads zero; otherwise its coordinate is clamped into [0, H-1]) and the
JAX package's static 2 samples per bin for `sampling_ratio == 0`. Each roi
gathers from its own level map (the kernels of
cpm_tpu_torch/ops/cuda/multilevel_roi_align.py); `roi_align` is its
one-level case. Layouts are the JAX package's: features are NHWC
`[B, H, W, C]`, outputs `[R, ph, pw, C]`.
"""

from typing import NamedTuple, Sequence

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


class _Axis(NamedTuple):
    """One axis of every roi's samples, `[R, bins * sr]` each: the two
    source cells, their weights, and whether the sample reads zero."""
    lo: torch.Tensor
    hi: torch.Tensor
    w_lo: torch.Tensor
    w_hi: torch.Tensor
    oob: torch.Tensor


def _roi_coords(rois, scale, output_size, sr, aligned):
    """The sample coordinates of rois `[R, 5]` on maps of per-roi scale
    (`[R]`): (ys `[R, ph*sr]`, xs `[R, pw*sr]`) in cells."""
    ph, pw = output_size
    dev = rois.device
    offset = 0.5 if aligned else 0.0
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
    # true division that the JAX package and the CUDA kernels take
    bin_w = roi_w / torch.full_like(roi_w, pw)
    bin_h = roi_h / torch.full_like(roi_h, ph)

    ix = torch.arange(pw * sr, dtype=torch.float32, device=dev) + 0.5
    iy = torch.arange(ph * sr, dtype=torch.float32, device=dev) + 0.5
    ix = ix / torch.full_like(ix, sr)
    iy = iy / torch.full_like(iy, sr)
    xs = x1[:, None] + ix[None, :] * bin_w[:, None]  # [R, pw*sr]
    ys = y1[:, None] + iy[None, :] * bin_h[:, None]  # [R, ph*sr]
    return ys, xs


def _roi_samples(rois, scale, h_l, w_l, output_size, sr, aligned):
    """The samples of rois `[R, 5]` on maps of per-roi scale, height and
    width (`[R]` float tensors): (y axis, x axis)."""
    ys, xs = _roi_coords(rois, scale, output_size, sr, aligned)
    return (_Axis(*_bilinear_weights_1d(ys, h_l[:, None])),
            _Axis(*_bilinear_weights_1d(xs, w_l[:, None])))


def _pool_samples(gather, ys: _Axis, xs: _Axis, output_size, sr, fd):
    """Bilinear interpolation and bin mean. gather(yi [R, Sy], xi [R, Sx])
    returns the cells' values `[R, Sy, Sx, C]` of dtype fd."""
    ph, pw = output_size
    wyl = ys.w_lo.to(fd)[:, :, None, None]
    wyh = ys.w_hi.to(fd)[:, :, None, None]
    wxl = xs.w_lo.to(fd)[:, None, :, None]
    wxh = xs.w_hi.to(fd)[:, None, :, None]
    vals = (
        gather(ys.lo, xs.lo) * wyl * wxl
        + gather(ys.lo, xs.hi) * wyl * wxh
        + gather(ys.hi, xs.lo) * wyh * wxl
        + gather(ys.hi, xs.hi) * wyh * wxh
    )
    oob = ys.oob[:, :, None] | xs.oob[:, None, :]
    vals = torch.where(oob[..., None], torch.zeros((), dtype=fd, device=vals.device), vals)
    r, c = vals.shape[0], vals.shape[-1]
    return vals.reshape(r, ph, sr, pw, sr, c).mean(dim=(2, 4))


class _Levels(NamedTuple):
    """Per-roi columns of the level table (`[R]` each) and, for the flat
    `[sum(B*H_l*W_l), C]` buffer of all maps, each roi's first row."""
    height: torch.Tensor      # long
    width: torch.Tensor       # long
    scale: torch.Tensor       # float32
    flat_offset: torch.Tensor  # long: start of the roi's level in the flat buffer


def _level_columns(level_hw, batch, levels, spatial_scales, dev) -> _Levels:
    if len(level_hw) != len(spatial_scales):
        raise ValueError(
            f"{len(level_hw)} feature levels but {len(spatial_scales)} scales"
        )
    offs, total = [], 0
    for h, w in level_hw:
        offs.append(total)
        total += batch * h * w
    lvl = levels.long()
    return _Levels(
        torch.tensor([h for h, _ in level_hw], dtype=torch.long, device=dev)[lvl],
        torch.tensor([w for _, w in level_hw], dtype=torch.long, device=dev)[lvl],
        torch.tensor(list(spatial_scales), dtype=torch.float32, device=dev)[lvl],
        torch.tensor(offs, dtype=torch.long, device=dev)[lvl],
    )


def _hw(features):
    return [(int(f.shape[1]), int(f.shape[2])) for f in features]


def _flatten(features):
    c = features[0].shape[-1]
    return torch.cat([f.reshape(-1, c) for f in features])


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
    sr = sampling_ratio if sampling_ratio > 0 else 2
    b, c = features[0].shape[0], features[0].shape[-1]
    r = rois.shape[0]
    lv = _level_columns(_hw(features), b, levels, spatial_scales, rois.device)
    flat = _flatten(features)
    ys, xs = _roi_samples(rois, lv.scale, lv.height.float(), lv.width.float(),
                          output_size, sr, aligned)
    # flat index of (b, y, x) at the roi's level: off + (b*H_l + y)*W_l + x
    base = lv.flat_offset + rois[:, 0].long() * lv.height * lv.width

    def gather(yi, xi):
        idx = base[:, None, None] + yi[:, :, None] * lv.width[:, None, None] + xi[:, None, :]
        return flat[idx.reshape(-1)].reshape(r, yi.shape[1], xi.shape[1], c)

    return _pool_samples(gather, ys, xs, output_size, sr, flat.dtype)


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


