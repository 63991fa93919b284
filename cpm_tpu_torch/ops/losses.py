"""Loss functions on padded, masked inputs.

Port of cpm_tpu/ops/losses.py: the detection losses (`smooth_l1_loss`,
`l2_loss`, `ism_l2_loss`, `softmax_cross_entropy`,
`binary_cross_entropy_with_logits`) and the loss zoo that no model path
selects (focal, IoU, bounded IoU, label smoothing, dice, Lovasz hinge and
softmax, Detectron's weighted smooth L1, mask IoU, equalization). A masked
loss divides by the true count, at least 1.

The count is the global batch's: under data parallelism (parallel/mesh.py)
each rank sums over its own images and divides by the count over every
rank's, so that its loss is its share of the global loss, and the shares sum
to what one process over the global batch computes. With no group the count
is this process's. This module holds that policy: every count that divides
a loss, here or in a head, is totalled by `global_count` (one all-reduce a
count, no host read), and the ISM quirk's rows are found across the ranks in
`ism_l2_loss`.
"""

from typing import Optional

import math

import torch

from cpm_tpu_torch.parallel.mesh import batch_total, concat_ranks, rank_and_world
from cpm_tpu_torch.utils.spans import sync


def global_count(count: torch.Tensor) -> torch.Tensor:
    """The normaliser of a loss: `count`, a count over this rank's images,
    totalled over every rank (the global batch's count; `count` itself with
    no group), at least 1. A head whose losses share a count totals it once
    and passes it on as their `normalizer`."""
    return torch.clamp(batch_total(count), min=1.0)


def _global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the global batch's elements: this rank's sum over every
    rank's element count."""
    return x.sum() / batch_total(x.new_tensor(float(x.numel())))


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


def l2_loss(
    pred: torch.Tensor, target: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """0.5 * (pred - target)^2 averaged over valid entries."""
    err = 0.5 * (pred - target) ** 2
    if mask is None:
        return _global_mean(err)
    m = mask.to(err.dtype)
    return (err * m).sum() / global_count(m.sum())


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

    Over ranks the flat order is the global batch's (rank order), and n0,
    n1 and K are global counts: the rank that holds v0 (v1) adds its term.

    pred / target: [N, 2]; valid: [N] bool.
    """
    v = valid.to(pred.dtype)
    posf = ((target > 0) & valid[:, None]).to(pred.dtype)
    c = posf.sum(dim=-1)
    row_err = 0.5 * ((pred - target) ** 2).sum(dim=-1) * v
    vi = torch.cumsum(valid.to(torch.int32), dim=0)
    # every rank's (n0, n1, valid rows) in f32, in rank order: the global
    # counts, and the valid rows that the ranks before this one hold
    every = concat_ranks(torch.stack(
        [posf[:, 0].sum().float(), posf[:, 1].sum().float(), vi[-1].float()])[None])
    n0, n1 = every[:, :2].sum(dim=0).to(pred.dtype).unbind()
    before = every[:rank_and_world()[0], 2].sum()
    nvalid = vi[-1]
    zero = row_err.new_zeros(())

    def row(j):
        # a 0-d index tensor is read on the host
        with sync("ism_row"):
            return row_err[torch.argmax((vi == j).to(torch.int32))]

    # the j-th valid row of the global batch is this rank's (j - before)-th;
    # argmax of an int tensor returns the first maximal index, as jnp.argmax
    e0, e1 = (torch.where((j >= 1) & (nvalid >= j), row(j), zero)
              for j in (1 - before, 2 - before))
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


def binary_cross_entropy_with_logits(
    logits: torch.Tensor, targets: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Mean BCE-with-logits over valid entries (grid heatmap loss)."""
    loss = bce_with_logits_elementwise(logits, targets)
    if mask is None:
        return _global_mean(loss)
    m = torch.broadcast_to(mask, loss.shape).to(loss.dtype)
    return (loss * m).sum() / global_count(m.sum())


def _masked_mean(loss: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return _global_mean(loss)
    m = mask.to(loss.dtype)
    return (loss * m).sum() / global_count(m.sum())


def sigmoid_focal_loss(logits: torch.Tensor, labels: torch.Tensor, num_classes: int,
                       gamma: float = 2.0, alpha: float = 0.25) -> torch.Tensor:
    """RetinaNet's focal loss, summed, as the reference's CUDA kernel: the
    logits [N, C-1] cover classes 1..C-1 (no background column), label 0 is
    background (the negative term only), labels < 0 are ignored."""
    class_ids = torch.arange(1, num_classes, device=logits.device)[None, :]
    t = labels[:, None]
    p = torch.sigmoid(logits)
    pos = (t == class_ids).to(logits.dtype)
    neg = ((t != class_ids) & (t >= 0)).to(logits.dtype)
    term_pos = (1.0 - p) ** gamma * torch.log(p.clamp(min=1e-14))
    term_neg = p ** gamma * torch.log((1.0 - p).clamp(min=1e-14))
    return (-pos * term_pos * alpha - neg * term_neg * (1.0 - alpha)).sum()


def iou_loss(pred: torch.Tensor, target: torch.Tensor, mask: Optional[torch.Tensor] = None,
             loss_type: str = "iou", legacy_plus1: bool = False) -> torch.Tensor:
    """IoU ('iou': -log IoU), 'linear_iou' (1 - IoU) or 'giou' losses over
    xyxy boxes [..., 4], the mean over valid entries."""
    px1, py1, px2, py2 = pred.unbind(-1)
    tx1, ty1, tx2, ty2 = target.unbind(-1)
    off = 1.0 if legacy_plus1 else 0.0
    pa = (px2 - px1 + off) * (py2 - py1 + off)
    ta = (tx2 - tx1 + off) * (ty2 - ty1 + off)
    iw = (torch.minimum(px2, tx2) - torch.maximum(px1, tx1) + off).clamp(min=0.0)
    ih = (torch.minimum(py2, ty2) - torch.maximum(py1, ty1) + off).clamp(min=0.0)
    inter = iw * ih
    union = pa + ta - inter
    iou = inter / union.clamp(min=1e-7)
    if loss_type == "iou":
        loss = -torch.log(iou.clamp(min=1e-7))
    elif loss_type == "linear_iou":
        loss = 1.0 - iou
    elif loss_type == "giou":
        cw = torch.maximum(px2, tx2) - torch.minimum(px1, tx1) + off
        ch = torch.maximum(py2, ty2) - torch.minimum(py1, ty1) + off
        enclose = (cw * ch).clamp(min=1e-7)
        loss = 1.0 - (iou - (enclose - union) / enclose)
    else:
        raise ValueError(loss_type)
    return _masked_mean(loss, mask)


def iou_loss_lrtb(pred: torch.Tensor, target: torch.Tensor, weight: Optional[torch.Tensor] = None,
                  loss_type: str = "iou") -> torch.Tensor:
    """FCOS's IoU losses over (l, t, r, b) distances: iou, liou, giou, diou
    and ciou with the reference's formulas, its (inter+1)/(union+1)
    smoothing and its centre-offset terms. The weighted sum when `weight`
    is given and sums above 0, else the plain sum."""
    pl, pt, pr, pb = pred.unbind(-1)
    tl, tt, tr, tb = target.unbind(-1)
    ta = (tl + tr) * (tt + tb)
    pa = (pl + pr) * (pt + pb)
    w_i = torch.minimum(pl, tl) + torch.minimum(pr, tr)
    h_i = torch.minimum(pb, tb) + torch.minimum(pt, tt)
    g_w = torch.maximum(pl, tl) + torch.maximum(pr, tr)
    g_h = torch.maximum(pb, tb) + torch.maximum(pt, tt)
    inter = w_i * h_i
    union = ta + pa - inter
    ac_union = g_w * g_h + 1e-7
    ious = (inter.clamp(min=0.0) + 1.0) / (union + 1.0)
    if loss_type == "iou":
        losses = -torch.log(ious)
    elif loss_type == "liou":
        losses = 1.0 - ious
    elif loss_type == "giou":
        losses = 1.0 - (ious - (ac_union - union) / ac_union)
    elif loss_type in ("diou", "ciou"):
        inter_diag = ((tr - tl) / 2 - (pr - pl) / 2) ** 2 + ((tt - tb) / 2 - (pt - pb) / 2) ** 2
        u = inter_diag / (g_w ** 2 + g_h ** 2)
        if loss_type == "diou":
            losses = 1.0 - (ious - u)
        else:
            v = (4.0 / math.pi ** 2) * (torch.atan((tl + tr) / (tt + tb + 1e-7))
                                        - torch.atan((pl + pr) / (pt + pb + 1e-7))) ** 2
            alpha = v / ((1.0 - ious) + v)
            losses = 1.0 - (ious - (u + alpha * v))
    else:
        raise ValueError(loss_type)
    if weight is None:
        return losses.sum()
    return torch.where(weight.sum() > 0, (losses * weight).sum(), losses.sum())


def _huber(x: torch.Tensor, beta: float) -> torch.Tensor:
    return torch.where(x < beta, 0.5 * x * x / beta, x - 0.5 * beta)


def bounded_iou_loss(pred: torch.Tensor, target: torch.Tensor, mask: Optional[torch.Tensor] = None,
                     beta: float = 0.2, eps: float = 1e-3) -> torch.Tensor:
    """Bounded IoU loss (Tychsen-Smith & Petersson 2018) over xyxy boxes, the
    mean over valid entries."""
    pcx, pcy = (pred[..., 0] + pred[..., 2]) * 0.5, (pred[..., 1] + pred[..., 3]) * 0.5
    pw, ph = pred[..., 2] - pred[..., 0], pred[..., 3] - pred[..., 1]
    tcx, tcy = (target[..., 0] + target[..., 2]) * 0.5, (target[..., 1] + target[..., 3]) * 0.5
    tw, th = target[..., 2] - target[..., 0], target[..., 3] - target[..., 1]
    dx, dy = (tcx - pcx).abs(), (tcy - pcy).abs()
    loss_dx = 1.0 - ((tw - 2 * dx) / (tw + 2 * dx + eps)).clamp(min=0.0)
    loss_dy = 1.0 - ((th - 2 * dy) / (th + 2 * dy + eps)).clamp(min=0.0)
    loss_dw = 1.0 - torch.minimum(tw / (pw + eps), pw / (tw + eps))
    loss_dh = 1.0 - torch.minimum(th / (ph + eps), ph / (th + eps))
    comb = torch.stack([loss_dx, loss_dy, loss_dw, loss_dh], dim=-1)
    return _masked_mean(_huber(comb, beta).sum(dim=-1), mask)


def label_smoothing_ce(logits: torch.Tensor, labels: torch.Tensor, smoothing: float = 0.1,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Label-smoothed cross entropy over the last axis; labels below 0 count
    as class 0 (mask them out)."""
    c = logits.shape[-1]
    logp = torch.log_softmax(logits, dim=-1)
    onehot = torch.nn.functional.one_hot(labels.long().clamp(min=0), c).to(logits.dtype)
    soft = onehot * (1.0 - smoothing) + smoothing / c
    return _masked_mean(-(soft * logp).sum(dim=-1), mask)


def dice_loss(logits: torch.Tensor, targets: torch.Tensor, eps: float = 1.0) -> torch.Tensor:
    """DICE loss over sigmoid probabilities, each batch row flattened."""
    p = torch.sigmoid(logits).reshape(logits.shape[0], -1)
    t = targets.reshape(targets.shape[0], -1).to(p.dtype)
    inter = (p * t).sum(dim=1)
    denom = p.sum(dim=1) + t.sum(dim=1)
    return _global_mean(1.0 - (2 * inter + eps) / (denom + eps))


def _lovasz_grad(fg_sorted: torch.Tensor, union_step: torch.Tensor) -> torch.Tensor:
    """The Lovasz extension's weights along the sorted last axis: the steps
    of 1 - intersection / union as the prefix grows."""
    gts = fg_sorted.sum(dim=-1, keepdim=True)
    intersection = gts - fg_sorted.cumsum(dim=-1)
    union = gts + union_step.cumsum(dim=-1)
    jaccard = 1.0 - intersection / union.clamp(min=1e-7)
    return torch.cat([jaccard[..., :1], jaccard[..., 1:] - jaccard[..., :-1]], dim=-1)


def lovasz_hinge(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Lovasz hinge for binary segmentation: each batch row flattened,
    labels in {0, 1}, the mean over rows."""
    lg = logits.reshape(logits.shape[0], -1)
    lb = labels.reshape(labels.shape[0], -1).to(lg.dtype)
    errors = 1.0 - lg * (2.0 * lb - 1.0)
    errors_sorted, order = torch.sort(errors, dim=-1, descending=True, stable=True)
    lb_sorted = torch.gather(lb, -1, order)
    grad = _lovasz_grad(lb_sorted, 1.0 - lb_sorted)
    return _global_mean((torch.relu(errors_sorted) * grad).sum(dim=-1))


def smooth_l1_loss_LW(pred: torch.Tensor, targets: torch.Tensor, inside_weights: torch.Tensor,
                      outside_weights: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """Detectron's weighted smooth L1: sum(outside_w * Huber(inside_w *
    (pred - target))) over the batch, N = pred's leading dim."""
    per_elem = _huber((inside_weights * (pred - targets)).abs(), beta)
    return (outside_weights * per_elem).sum() / batch_total(pred.new_tensor(float(pred.shape[0])))


def lovasz_softmax(logits: torch.Tensor, labels: torch.Tensor, ignore_index: Optional[int] = None,
                   only_present: bool = True) -> torch.Tensor:
    """Multi-class Lovasz-softmax over logits [B, C, H, W] (NCHW, as the
    reference's) and int labels [B, H, W] in [0, C), the mean over images.

    As in the JAX package, `ignore_index` pixels are masked rather than
    dropped: their errors sort last with zero weight, so the prefix sums
    over the valid pixels are the reference's. Every class of an image is
    sorted at once. An image with no present class (reachable only through
    out-of-range labels) gives 0, where the reference divides by zero."""
    B, C = logits.shape[:2]
    prb = torch.softmax(logits, dim=1).reshape(B, C, -1)  # [B, C, P]
    lbl = labels.reshape(B, 1, -1)
    valid = (torch.ones_like(lbl, dtype=prb.dtype) if ignore_index is None
             else (lbl != ignore_index).to(prb.dtype))
    fg = (lbl == torch.arange(C, device=lbl.device)[None, :, None]).to(prb.dtype) * valid
    errors = torch.where(valid > 0, (fg - prb).abs(), prb.new_tensor(-math.inf))
    err_s, order = torch.sort(errors, dim=-1, descending=True, stable=True)
    fg_s = torch.gather(fg, -1, order)
    val_s = torch.gather(valid.expand_as(fg), -1, order)
    grad = _lovasz_grad(fg_s, (1.0 - fg_s) * val_s)
    losses = (torch.where(val_s > 0, err_s, err_s.new_zeros(())) * grad).sum(dim=-1)  # [B, C]
    if only_present:
        w = (fg_s.sum(dim=-1) > 0).to(prb.dtype)
    else:
        w = torch.ones_like(losses)
    cnt = w.sum(dim=-1)
    any_valid = valid.reshape(B, -1).sum(dim=-1) > 0
    per_image = torch.where(any_valid & (cnt > 0), (losses * w).sum(dim=-1) / cnt.clamp(min=1.0),
                            losses.new_zeros(()))
    return _global_mean(per_image)


def mask_iou_loss(pred: torch.Tensor, target: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """PolarMask's mask IoU loss over per-ray distances [N, K]:
    log(sum max / sum min) a row, weighted and summed."""
    l_max, l_min = torch.maximum(pred, target), torch.minimum(pred, target)
    loss = torch.log(l_max.sum(dim=1) / l_min.sum(dim=1))
    return (loss * weight).sum()


def equalization_loss(logits: torch.Tensor, labels: torch.Tensor, class_freq: torch.Tensor,
                      lambda_thresh: float = 1.76e-3,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Equalization loss (Tan et al.): sigmoid BCE in which a foreground
    sample's negative term for a rare class (frequency below
    `lambda_thresh`) is dropped; the mean over valid rows."""
    c = logits.shape[-1]
    onehot = torch.nn.functional.one_hot(labels.long().clamp(min=0), c).to(logits.dtype)
    rare = (class_freq < lambda_thresh).to(logits.dtype)[None, :]
    is_fg = (labels > 0).to(logits.dtype)[:, None]
    w = 1.0 - is_fg * rare * (1.0 - onehot)
    return _masked_mean((w * bce_with_logits_elementwise(logits, onehot)).sum(dim=-1), mask)
