"""Loss functions on padded, masked inputs.

Port of cpm_tpu/ops/losses.py, the losses that the two configurations'
heads compute (`smooth_l1_loss`, `ism_l2_loss`, `softmax_cross_entropy`,
`bce_with_logits_elementwise`), in one process. A masked loss divides by
the true count, at least 1 (`global_count`).
"""

from typing import Optional

import torch


def global_count(count: torch.Tensor) -> torch.Tensor:
    """The normaliser of a loss: `count`, at least 1. A head whose losses share a count totals it once
    and passes it on as their `normalizer`."""
    return torch.clamp(count, min=1.0)


def smooth_l1_loss(
    pred: torch.Tensor,
    target: torch.Tensor,
    beta: float = 1.0 / 9,
    weights: Optional[torch.Tensor] = None,
    normalizer=1.0,
) -> torch.Tensor:
    """Huber loss summed over (optionally weighted) elements, over
    max(normalizer, 1); `normalizer` is a count over the global batch, from
    `global_count`."""
    diff = torch.abs(pred - target)
    loss = torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)
    if weights is not None:
        loss = loss * weights
    normalizer = torch.as_tensor(normalizer, dtype=loss.dtype, device=loss.device)
    return loss.sum() / torch.clamp(normalizer, min=1.0)


def ism_l2_loss(pred: torch.Tensor, target: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The ISM IoU branch's L2 loss with the reference's indexing quirk.

    The reference gathers `x[pos_inds]` with pos_inds the [K, 2] result of
    nonzero(target > 0) on the [N, 2] (bg, fg) target. A 2-D index tensor
    indexes dim 0 elementwise, so entry (k, 0) gathers the intended row and
    entry (k, 1) gathers the COLUMN index (0 or 1) reused as a row index:

        loss = [sum_i c_i * e_i + n0 * e_{v0} + n1 * e_{v1}] / K

    with e_i = 0.5 * ||x_i - t_i||^2, c_i = #{j : t[i, j] > 0},
    n_j = #{i : t[i, j] > 0}, K = n0 + n1, and v0 / v1 the first two valid
    rows in flat order; with fewer than two valid rows their terms are zero.

    pred / target: [N, 2]; valid: [N] bool.
    """
    v = valid.to(pred.dtype)
    posf = ((target > 0) & valid[:, None]).to(pred.dtype)
    c = posf.sum(dim=-1)
    row_err = 0.5 * ((pred - target) ** 2).sum(dim=-1) * v
    vi = torch.cumsum(valid.to(torch.int32), dim=0)
    n0, n1 = posf[:, 0].sum().float().to(pred.dtype), posf[:, 1].sum().float().to(pred.dtype)
    nvalid = vi[-1]
    zero = row_err.new_zeros(())
    # the j-th valid row; argmax of an int tensor returns the first maximal
    # index, as jnp.argmax
    e0, e1 = (
        torch.where(nvalid >= j, row_err[torch.argmax((vi == j).to(torch.int32))], zero)
        for j in (1, 2))
    total = (row_err * c).sum() + n0 * e0 + n1 * e1
    return total / torch.clamp(n0 + n1, min=1.0)


def softmax_cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, mask: Optional[torch.Tensor] = None,
    normalizer: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean cross entropy over valid entries; labels are int class ids.
    Labels are clipped into [0, C) (padding rows carry -1) and masked
    entries are neutralized with `where`, so an infinite nll in a masked row
    cannot poison the sum. `normalizer`, where the caller has it, is the
    mask's `global_count`."""
    labels = torch.clamp(labels.long(), 0, logits.shape[-1] - 1)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    if mask is None:
        return _global_mean(nll)
    nll = torch.where(mask, nll, nll.new_zeros(()))
    if normalizer is None:
        normalizer = global_count(mask.to(nll.dtype).sum())
    return nll.sum() / normalizer


def bce_with_logits_elementwise(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Stable elementwise BCE: max(x, 0) - x*t + log(1 + exp(-|x|))."""
    return (
        torch.clamp(logits, min=0.0) - logits * targets
        + torch.log1p(torch.exp(-torch.abs(logits)))
    )


