"""Roi-set helpers of the RoI heads.

Port of cpm_tpu/modeling/roi_heads/targets.py (`compact_by_mask`,
`rois_with_batch_index`), with the same slot ordering so detections come in
the JAX package's order, and `gather_rows`, the `take_along_axis` of a
per-image roi set.
"""

import torch


def compact_by_mask(select: torch.Tensor, out_size: int):
    """Indices that move `select`-True slots to the front, truncated to
    out_size, and their validity. Stable: selected slots keep their order.

    Returns (idx [..., out_size] int64, valid [..., out_size] bool).
    """
    order = torch.argsort((~select).to(torch.uint8), dim=-1, stable=True)
    idx = order[..., :out_size]
    valid = torch.gather(select, -1, order)[..., :out_size]
    return idx, valid


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, ...] indexed along dim 1 by idx [B, M] -> [B, M, ...]."""
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(*idx.shape, *x.shape[2:])
    return torch.gather(x, 1, idx)


def rois_with_batch_index(boxes: torch.Tensor) -> torch.Tensor:
    """[B, S, 4] -> [B*S, 5] (batch_idx, x1, y1, x2, y2) for the pooler."""
    B, S = boxes.shape[:2]
    bidx = torch.arange(B, dtype=boxes.dtype, device=boxes.device)
    bidx = bidx[:, None].expand(B, S).reshape(-1, 1)
    return torch.cat([bidx, boxes.reshape(B * S, 4)], dim=1)
