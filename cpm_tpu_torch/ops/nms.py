"""Fixed-shape NMS: hard, soft, and box voting.

Port of cpm_tpu/ops/nms.py (`nms`, `batched_nms`, `multiclass_nms`,
`soft_nms`, `ml_soft_nms`, `box_voting`, `box_ml_voting`, `matrix_nms`) and of the
filter both the box head and the TTA merge run (`filter_results`). Every
function takes padded `[..., N]` inputs with a validity mask and returns a
fixed number of output slots with a validity mask; leading dims are a batch.

The keep mask is the JAX package's fixed point: keep[i] is recomputed as
"no kept, higher-scored box overlaps me" until it stops changing, which is
exactly sequential greedy NMS. The JAX `while_loop` becomes a Python loop
whose convergence test reads one flag from the device per iteration (a
`cpm/sync/nms` span); the iteration count is the longest suppression chain. Soft-NMS is the JAX
`scan`: a fixed number of steps of device ops, with no read to the host.

IoU convention: standard (x2-x1)*(y2-y1) with no +1 (`legacy_plus1=False`),
as the reference's NMS kernels use.
"""

import torch

from cpm_tpu_torch.structures.boxes import box_iou
from cpm_tpu_torch.utils.spans import sync


def topk(x: torch.Tensor, k: int):
    """Exact top-k along the last dim; equal values keep index order, as
    `lax.top_k` orders them (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _sorted_keep_mask(iou: torch.Tensor, valid: torch.Tensor, thresh: float):
    """Greedy-NMS keep mask for boxes sorted by descending score.

    iou: [..., N, N]; valid: [..., N] bool. Returns keep [..., N] bool.
    """
    n = iou.shape[-1]
    row = torch.arange(n, device=iou.device)
    earlier = row[:, None] < row[None, :]  # j before i (higher score)
    over = (iou > thresh) & earlier & valid[..., :, None] & valid[..., None, :]
    keep = valid
    while True:
        new_keep = ~torch.any(over & keep[..., :, None], dim=-2) & valid
        with sync("nms"):
            converged = torch.equal(new_keep, keep)
        if converged:
            return keep
        keep = new_keep


def nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    max_output: int,
    mask: torch.Tensor = None,
    legacy_plus1: bool = False,
):
    """Class-agnostic hard NMS over the last box axis.

    Args:
      boxes: [..., N, 4] xyxy; scores: [..., N]; mask: [..., N] validity.
      max_output: number of output slots.

    Returns (indices [..., max_output] int64 into the inputs, keep
    [..., max_output] bool). Kept boxes come in descending score order;
    empty slots hold index 0 and keep False.
    """
    return greedy_nms(boxes, scores, iou_threshold, max_output, mask,
                      lambda a, b: box_iou(a, b, legacy_plus1=legacy_plus1))


def greedy_nms(boxes, scores, iou_threshold: float, max_output: int, mask, pairwise_iou):
    """`nms` over boxes [..., N, D] of any parametrisation, with
    `pairwise_iou(a, b)` -> [..., N, M] (ops/rotated.py runs it on rotated
    boxes and quadrilaterals)."""
    if mask is None:
        mask = torch.ones(scores.shape, dtype=torch.bool, device=scores.device)
    neg_inf = torch.finfo(scores.dtype).min
    s = torch.where(mask, scores, torch.full_like(scores, neg_inf))
    order = torch.argsort(-s, dim=-1, stable=True)
    b_sorted = torch.gather(boxes, -2, order[..., None].expand(*order.shape, boxes.shape[-1]))
    valid_sorted = torch.gather(mask, -1, order)
    keep_sorted = _sorted_keep_mask(pairwise_iou(b_sorted, b_sorted), valid_sorted, iou_threshold)

    # compact kept entries to the front; slot max_output collects overflow
    kept_rank = torch.cumsum(keep_sorted.long(), dim=-1) - 1
    slot = torch.where(keep_sorted & (kept_rank < max_output), kept_rank, max_output)
    lead = order.shape[:-1]
    out_idx = torch.zeros(*lead, max_output + 1, dtype=torch.long, device=order.device)
    out_valid = torch.zeros(*lead, max_output + 1, dtype=torch.bool, device=order.device)
    out_idx.scatter_(-1, slot, order)
    out_valid.scatter_(-1, slot, keep_sorted)
    return out_idx[..., :max_output], out_valid[..., :max_output]


def batched_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    idxs: torch.Tensor,
    iou_threshold: float,
    max_output: int,
    mask: torch.Tensor = None,
    legacy_plus1: bool = False,
):
    """Category-aware NMS by the coordinate-offset trick: boxes of
    different `idxs` never suppress each other."""
    max_coord = torch.amax(boxes, dim=(-2, -1), keepdim=True) + 1.0  # [..., 1, 1]
    shifted = boxes + idxs.to(boxes.dtype)[..., None] * max_coord
    return nms(shifted, scores, iou_threshold, max_output, mask, legacy_plus1)


def multiclass_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    labels: torch.Tensor,
    iou_threshold: float,
    max_output: int,
    mask: torch.Tensor = None,
    legacy_plus1: bool = False,
):
    """ml_nms equivalent: label-aware hard NMS."""
    return batched_nms(
        boxes, scores, labels, iou_threshold, max_output, mask, legacy_plus1
    )


def soft_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    max_output: int,
    sigma: float = 0.5,
    overlap_thresh: float = 0.3,
    score_thresh: float = 0.001,
    method: str = "linear",
    mask: torch.Tensor = None,
    legacy_plus1: bool = False,
):
    """Soft-NMS (the reference's csrc/NMS/soft_nms.cpp) over the last box axis.

    `max_output` times: pick the highest remaining score (the first of equal
    ones), then decay the scores of the boxes that overlap it (linear,
    gaussian or hard). The steps are device ops with no read to the host.
    Returns (indices [..., max_output], their scores when picked, valid).
    """
    if method not in ("linear", "gaussian", "hard"):
        raise ValueError(method)
    if mask is None:
        mask = torch.ones(scores.shape, dtype=torch.bool, device=scores.device)
    neg_inf = torch.finfo(scores.dtype).min
    s = torch.where(mask, scores, torch.full_like(scores, neg_inf))
    iou = box_iou(boxes, boxes, legacy_plus1=legacy_plus1)  # [..., N, N]
    # a tensor divisor: CUDA turns a division by a Python number into a
    # multiplication by its reciprocal, which rounds otherwise
    sigma_t = torch.tensor(sigma, dtype=iou.dtype, device=iou.device)
    row = (*s.shape[:-1], 1, s.shape[-1])
    picked, picked_scores, picked_ok = [], [], []
    for _ in range(max_output):
        i = torch.argmax(s, dim=-1, keepdim=True)
        si = torch.gather(s, -1, i)
        ok = si > score_thresh
        ov = torch.gather(iou, -2, i[..., None].expand(row)).squeeze(-2)
        if method == "linear":
            decay = torch.where(ov > overlap_thresh, 1.0 - ov, 1.0)
        elif method == "gaussian":
            decay = torch.exp(-(ov * ov) / sigma_t)
        else:
            decay = torch.where(ov > overlap_thresh, 0.0, 1.0)
        s_new = torch.where(s > neg_inf / 2, s * decay, s)
        s_new = s_new.scatter(-1, i, neg_inf)  # the picked box leaves the pool
        s = torch.where(ok, s_new, s)
        picked.append(i)
        picked_scores.append(si)
        picked_ok.append(ok)
    idx = torch.cat(picked, -1)
    out_scores = torch.cat(picked_scores, -1)
    valid = torch.cat(picked_ok, -1) & (out_scores > score_thresh)
    return idx, out_scores, valid


def ml_soft_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    labels: torch.Tensor,
    max_output: int,
    sigma: float = 0.5,
    overlap_thresh: float = 0.3,
    score_thresh: float = 0.001,
    method: str = "linear",
    mask: torch.Tensor = None,
    legacy_plus1: bool = False,
):
    """Label-aware soft-NMS (csrc/NMS/ml_soft_nms.cpp) by the
    coordinate-offset trick: boxes of different labels never decay each
    other. The shifted coordinates round as the JAX package's do."""
    if mask is None:
        mask = torch.ones(scores.shape, dtype=torch.bool, device=scores.device)
    max_coord = torch.amax(torch.where(mask[..., None], boxes, 0.0), dim=(-2, -1),
                           keepdim=True) + 1.0
    shifted = boxes + labels.to(boxes.dtype)[..., None] * max_coord
    return soft_nms(shifted, scores, max_output, sigma, overlap_thresh, score_thresh,
                    method, mask, legacy_plus1)


def _temp_scores(pool_scores: torch.Tensor, beta: float) -> torch.Tensor:
    """TEMP_AVG's per-neighbour score (box_voting.cu:105-112): s -> 1 / (1 +
    (1/s - 1)^(1/beta)), sigmoid(logit(s) / beta), with s == 0 passed through."""
    s = torch.clamp(pool_scores, 0.0, 1.0)  # a negative base to a power is nan
    pos = s > 0.0
    base = torch.where(pos, 1.0 / torch.where(pos, s, 1.0) - 1.0, 0.0)
    t = 1.0 / (1.0 + base ** (1.0 / beta))
    return torch.where(pos, t, pool_scores)


def box_voting(
    top_boxes: torch.Tensor,
    top_scores: torch.Tensor,
    pool_boxes: torch.Tensor,
    pool_scores: torch.Tensor,
    thresh: float,
    scoring_method: str = "ID",
    beta: float = 1.0,
    top_mask: torch.Tensor = None,
    pool_mask: torch.Tensor = None,
    legacy_plus1: bool = False,
):
    """Box voting (csrc/Box_ops/box_voting.cu): each kept box becomes the
    score-weighted mean of the pool boxes that overlap it by at least
    `thresh`, and its score is set by `scoring_method`. Returns
    (voted boxes [..., K, 4], voted scores [..., K])."""
    return _box_ml_voting_impl(top_boxes, top_scores, pool_boxes, pool_scores, True, thresh,
                               scoring_method, beta, top_mask, pool_mask, legacy_plus1)


def box_ml_voting(
    top_boxes: torch.Tensor,
    top_scores: torch.Tensor,
    top_labels: torch.Tensor,
    pool_boxes: torch.Tensor,
    pool_scores: torch.Tensor,
    pool_labels: torch.Tensor,
    thresh: float,
    scoring_method: str = "ID",
    beta: float = 1.0,
    top_mask: torch.Tensor = None,
    pool_mask: torch.Tensor = None,
    legacy_plus1: bool = False,
):
    """Label-aware box voting (csrc/Box_ops/box_ml_voting.cu): only pool
    boxes of the kept box's label vote."""
    same = top_labels[..., :, None] == pool_labels[..., None, :]
    return _box_ml_voting_impl(top_boxes, top_scores, pool_boxes, pool_scores, same, thresh,
                               scoring_method, beta, top_mask, pool_mask, legacy_plus1)


def _box_ml_voting_impl(
    top_boxes, top_scores, pool_boxes, pool_scores, same, thresh,
    scoring_method, beta, top_mask, pool_mask, legacy_plus1,
):
    if top_mask is None:
        top_mask = torch.ones(top_boxes.shape[:-1], dtype=torch.bool, device=top_boxes.device)
    if pool_mask is None:
        pool_mask = torch.ones(pool_boxes.shape[:-1], dtype=torch.bool, device=pool_boxes.device)
    iou = box_iou(top_boxes, pool_boxes, legacy_plus1=legacy_plus1)  # [..., K, P]
    w = (iou >= thresh) & top_mask[..., :, None] & pool_mask[..., None, :] & same
    pool = pool_scores[..., None, :]
    wf = w.to(top_boxes.dtype) * torch.clamp(pool, min=0.0)
    wsum = torch.clamp(wf.sum(-1, keepdim=True), min=1e-12)
    voted = (wf @ pool_boxes) / wsum
    nvote = torch.clamp(w.sum(-1), min=1)
    if scoring_method == "ID":
        scores = top_scores
    elif scoring_method == "TEMP_AVG":
        scores = torch.where(w, _temp_scores(pool_scores, beta)[..., None, :], 0.0).sum(-1) / nvote
    elif scoring_method == "AVG":
        scores = torch.where(w, pool, 0.0).sum(-1) / nvote
    elif scoring_method == "IOU_AVG":
        wi = torch.where(w, iou, 0.0)
        scores = (wi * pool).sum(-1) / torch.clamp(wi.sum(-1), min=1e-12)
    elif scoring_method == "GENERALIZED_AVG":
        p = torch.where(w, torch.clamp(pool, min=1e-12) ** beta, 0.0)
        scores = (p.sum(-1) / nvote) ** (1.0 / beta)
    elif scoring_method == "QUASI_SUM":
        scores = torch.where(w, pool, 0.0).sum(-1) / nvote.to(top_boxes.dtype) ** beta
    else:
        raise ValueError(scoring_method)
    return voted, scores


def filter_results(
    boxes, scores, labels, mask, *,
    score_thresh, nms_thresh, detections_per_img,
    use_soft_nms=False, soft_nms_sigma=0.5, soft_nms_method="linear",
    use_box_voting=False, vote_thresh=0.8, vote_scoring_method="ID", vote_beta=1.0,
):
    """The reference's filter_results (core/test.py:433-509) over one
    labelled set a row: boxes [..., N, 4], scores, labels (1..C-1) and mask
    [..., N]. Label-aware hard NMS, or soft-NMS (score floor 1e-4), then
    optionally box voting against the whole set. Returns (boxes, scores,
    labels, valid) of detections_per_img; under soft-NMS without voting the
    scores of invalid slots are left as the NMS returned them. The TTA merge
    (engine/test.py) and the box head's filter (filter_detections) run it."""
    valid = mask & (scores > score_thresh)
    if use_soft_nms:
        idx, out_scores, keep = ml_soft_nms(
            boxes, scores, labels, detections_per_img, sigma=soft_nms_sigma,
            overlap_thresh=nms_thresh, score_thresh=1e-4, method=soft_nms_method, mask=valid)
    else:
        idx, keep = multiclass_nms(boxes, scores, labels, nms_thresh, detections_per_img,
                                   mask=valid)
        out_scores = torch.where(keep, torch.gather(scores, -1, idx), 0.0)
    out_boxes = torch.gather(boxes, -2, idx[..., None].expand(*idx.shape, 4))
    out_labels = torch.gather(labels, -1, idx)
    if use_box_voting:
        voted, vscores = box_ml_voting(
            out_boxes, out_scores, out_labels, boxes, scores, labels, vote_thresh,
            scoring_method=vote_scoring_method, beta=vote_beta, top_mask=keep, pool_mask=valid)
        out_boxes = torch.where(keep[..., None], voted, out_boxes)
        out_scores = torch.where(keep, vscores, 0.0)
    return out_boxes, out_scores, out_labels, keep


def matrix_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    labels: torch.Tensor,
    mask: torch.Tensor = None,
    method: str = "gauss",
    sigma: float = 0.5,
    legacy_plus1: bool = False,
):
    """Matrix NMS (SOLOv2): each valid box's score decayed by its overlaps
    with the higher-scored boxes of its label, 'gauss' or 'linear'. Returns
    the decayed scores [N]; no box is removed (the caller thresholds).

    As in the JAX package, a pair is compensated with the suppressed box's
    own worst overlap, where SOLOv2 takes the suppressor's; every factor is
    then at least 1 and no score decays (ROADMAP Queue 3, item 34)."""
    n = boxes.shape[0]
    if mask is None:
        mask = torch.ones(n, dtype=torch.bool, device=boxes.device)
    iou = box_iou(boxes, boxes, legacy_plus1=legacy_plus1)
    # row j suppresses column i
    valid_pair = (mask[:, None] & mask[None, :] & (labels[:, None] == labels[None, :])
                  & (scores[:, None] >= scores[None, :])
                  & ~torch.eye(n, dtype=torch.bool, device=boxes.device))
    decay_iou = torch.where(valid_pair, iou, iou.new_zeros(()))
    comp_iou = decay_iou.amax(dim=0)  # the worst overlap of each suppressor
    if method == "gauss":
        decay = torch.exp(-(decay_iou ** 2 - comp_iou[None, :] ** 2) / sigma)
    else:
        decay = (1.0 - decay_iou) / (1.0 - comp_iou[None, :]).clamp(min=1e-12)
    decay = torch.where(valid_pair, decay, decay.new_ones(())).amin(dim=0)
    return torch.where(mask, scores * decay, scores)
