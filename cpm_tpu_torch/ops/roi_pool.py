"""RoIPool (max pooling) and bilinear point-feature sampling.

Port of cpm_tpu/ops/roi_pool.py, itself the replacement of the reference's
ROIPool and PoolPointsInterp CUDA ops. Plain PyTorch on both devices: no
model path runs them, and the JAX package runs them as XLA ops, not as
Pallas kernels. Layouts are the JAX package's: features NHWC `[B, H, W, C]`.

`roi_pool` keeps the JAX rule as it is: each bin reads a fixed lattice of
`max_cells_per_bin` x `max_cells_per_bin` cells from its start, masked to the
bin, and takes their max. The reference's kernel iterates over every cell
of a bin, so the two agree on bins of up to `max_cells_per_bin` cells a
side; past that both the JAX package and this port read only the first
cells of a bin and deviate from the reference alike. The lattice
materialises `[R, ph, pw, M, M, C]`, so the rois are pooled in chunks that
keep it under `CHUNK_BYTES`. The max's gradient is shared among tied
cells, as JAX's is (`torch.amax`).
"""

from typing import Tuple

import torch

CHUNK_BYTES = 2**30  # the largest lattice that roi_pool materialises at once


def _roi_pool_chunk(flat, rois, H, W, ph, pw, M, spatial_scale):
    C = flat.shape[1]
    R = rois.shape[0]
    dt = flat.dtype
    batch_idx = rois[:, 0].long()
    x1, y1, x2, y2 = (torch.round(rois[:, i] * spatial_scale) for i in range(1, 5))
    # divided by tensors on the rois' device: CUDA turns a division by a
    # number into a product with its reciprocal, which moves a bin bound that
    # falls on a whole cell
    bin_w = torch.clamp(x2 - x1 + 1, min=1.0) / rois.new_tensor(float(pw))
    bin_h = torch.clamp(y2 - y1 + 1, min=1.0) / rois.new_tensor(float(ph))
    py = torch.arange(ph, dtype=dt, device=flat.device)
    px = torch.arange(pw, dtype=dt, device=flat.device)
    # bin bounds, the reference kernel's floor / ceil and clamps
    hstart = torch.clamp(torch.floor(py[None, :] * bin_h[:, None]) + y1[:, None], 0, H - 1)
    hend = torch.clamp(torch.ceil((py[None, :] + 1) * bin_h[:, None]) + y1[:, None], 0, H)
    wstart = torch.clamp(torch.floor(px[None, :] * bin_w[:, None]) + x1[:, None], 0, W - 1)
    wend = torch.clamp(torch.ceil((px[None, :] + 1) * bin_w[:, None]) + x1[:, None], 0, W)

    cells = torch.arange(M, dtype=dt, device=flat.device)
    ys = hstart[:, :, None] + cells  # [R, ph, M]
    xs = wstart[:, :, None] + cells  # [R, pw, M]
    y_valid = ys < hend[:, :, None]
    x_valid = xs < wend[:, :, None]
    yi = torch.clamp(ys, 0, H - 1).long()
    xi = torch.clamp(xs, 0, W - 1).long()
    idx = ((batch_idx * H * W)[:, None, None, None, None]
           + yi[:, :, None, :, None] * W + xi[:, None, :, None, :])  # [R, ph, pw, M, M]
    vals = flat[idx.reshape(-1)].reshape(R, ph, pw, M, M, C)
    valid = (y_valid[:, :, None, :, None] & x_valid[:, None, :, None, :])[..., None]
    vals = torch.where(valid, vals, torch.finfo(dt).min)
    out = torch.amax(vals, dim=(3, 4))
    return torch.where(valid.any(dim=4).any(dim=3), out, out.new_zeros(()))


def roi_pool(
    features: torch.Tensor,
    rois: torch.Tensor,
    output_size: Tuple[int, int],
    spatial_scale: float,
    max_cells_per_bin: int = 8,
) -> torch.Tensor:
    """Max-pool RoI features: features [B, H, W, C], rois [R, 5] (batch
    index, x1, y1, x2, y2) -> [R, ph, pw, C]. Integer bin bounds by
    rounding, as the reference's kernel; an empty bin gives 0."""
    ph, pw = output_size
    B, H, W, C = features.shape
    M = max_cells_per_bin
    flat = features.reshape(B * H * W, C)
    per_roi = ph * pw * M * M * C * features.element_size()
    step = max(1, CHUNK_BYTES // per_roi)
    outs = [_roi_pool_chunk(flat, rois[i:i + step], H, W, ph, pw, M, spatial_scale)
            for i in range(0, rois.shape[0], step)]
    return torch.cat(outs) if outs else features.new_zeros((0, ph, pw, C))


def bilinear_gather(flat: torch.Tensor, base: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                    H: int, W: int) -> torch.Tensor:
    """Bilinear samples of the rows `flat` [B*H*W, C] at map coordinates
    (x, y) of images starting at row `base` (all of one shape S) -> [*S, C],
    with the reference kernels' rules: a sample with x < -1 or x > W (y
    likewise) reads zero, others are clamped into the map."""
    oob = (x < -1.0) | (x > W) | (y < -1.0) | (y > H)
    xc = torch.clamp(x, 0.0, W - 1.0)
    yc = torch.clamp(y, 0.0, H - 1.0)
    x0, y0 = torch.floor(xc), torch.floor(yc)
    x1 = torch.clamp(x0 + 1, max=W - 1.0)
    y1 = torch.clamp(y0 + 1, max=H - 1.0)
    wx1, wy1 = xc - x0, yc - y0
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1

    def g(yi, xi):
        idx = base + yi.long() * W + xi.long()
        return flat[idx.reshape(-1)].reshape(*idx.shape, flat.shape[1])

    out = (g(y0, x0) * (wy0 * wx0)[..., None] + g(y0, x1) * (wy0 * wx1)[..., None]
           + g(y1, x0) * (wy1 * wx0)[..., None] + g(y1, x1) * (wy1 * wx1)[..., None])
    return torch.where(oob[..., None], out.new_zeros(()), out)


def pool_points_interp(features: torch.Tensor, points: torch.Tensor,
                       spatial_scale: float) -> torch.Tensor:
    """Bilinear point features (DensePose's PoolPointsInterp): features [B,
    H, W, C], points [P, 3] (batch index, x, y) in image coordinates ->
    [P, C]; out-of-range points give zeros."""
    B, H, W, C = features.shape
    base = points[:, 0].long() * H * W
    return bilinear_gather(features.reshape(B * H * W, C), base, points[:, 1] * spatial_scale,
                           points[:, 2] * spatial_scale, H, W)
