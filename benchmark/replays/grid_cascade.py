"""The replay of the grid-cascade head (CMM stages, ISM, RSM): the port's
five pooler calls a request or step, in order: the classifier at the
proposals, the grid stages (three in CPM), the rescoring at the served
boxes.

Serving, per checked request, the reference in float32 on its own features
of the same JPEG pools the port's rois at each call and computes what the
port computed there. Compared:

  score_gap    the widest |served score - the reference's|: its class's
               probability at the detection's proposal, times ISM's IoU at
               the last stage's roi, to the 0.8, times RSM's probability at
               the served box to the 0.2
  box_p25      the served boxes against the reference's decode: for each
               grid stage, the first quartile over the detections of every
               checked request of the widest coordinate distance between
               the stage's output (the next stage's roi; after the last
               stage, the served box read back) and the reference's decode
               of its own heatmaps at the port's roi, over the box's longer
               side; the largest over the stages. A quartile, not the
               widest: an argmax that bfloat16's rounding flips moves a box
               anywhere in its roi (`decode_miss` counts those, a third of
               them, more in a request whose detections crowd one object);
               most boxes take the same argmax and agree to round-off
  count_gap    |served count - the count that the reference's own per-class
               NMS keeps over its probabilities at the port's proposals|
  decode_stage widest coordinate difference (px) between the port's
               `grid_decode` and the reference's, on the reference's
               heatmaps at the port's rois, over the stages

A request that serves nothing reads infinite on each. Read and printed, not
compared (argmax flips and near-ties make them swing between two sound runs
as far as the control does): `select_miss`, the share of the served
(proposal, label) pairs that the reference's own selection does not pick;
`decode_miss`, the share of stage outputs farther than BOX_TOL_REL of the
box's longer side from the reference's decode; `proposal_gap`.

Training: each step's grid-stage rois and rescoring rois are the port's
(the points marked "the benchmark's replay" in the reference's
grid_cascade_head.py), their targets worked out again, and `decode_stage`
as above on the reference's heatmaps of the step.
"""

import numpy as np
import torch

from benchmark import replay

BOX_TOL_REL = 0.05
INFINITE = ("score_gap", "box_p25", "count_gap", "decode_stage", "proposal_stage")


def decode_fn(control: bool):
    """The grid decode checked: the port's, or the control's (the
    reference's on heatmaps in the control's precision)."""
    if control:
        from benchmark.reference.modeling.roi_heads.grid_ops import grid_decode
        from benchmark.reference.precision import to_fp8

        return lambda boxes, hm, *a, **k: grid_decode(boxes, to_fp8(hm.bfloat16()).float(), *a, **k)
    from cpm_tpu_torch.modeling.roi_heads.grid_ops import grid_decode

    return grid_decode


def _row_key(box, label):
    return tuple(np.round(box, 3)), int(label)


def combine(rows) -> dict:
    """The numbers of the checked requests from each request's
    `serve_numbers`: the worst of each, and `box_p25` (with `box_p25_<s>`
    for each stage) over every request's detections together."""
    out = {}
    for row in rows:
        for name, v in row.items():
            if name != "box_dist":
                out[name] = max(out.get(name, 0.0), v)
    if rows and all("box_dist" in row for row in rows):
        quartiles = []
        for s in range(len(rows[0]["box_dist"])):
            dist = torch.cat([row["box_dist"][s] for row in rows])
            quartiles.append(float(torch.quantile(dist, 0.25)) if len(dist) else float("inf"))
            out[f"box_p25_{s}"] = quartiles[-1]
        out["box_p25"] = max(quartiles)
    return out


def serve_numbers(model, images, sizes, calls, served, fns: replay.StageFns) -> dict:
    """The numbers of one request (`combine` puts the requests' together):
    `calls` are its pooler calls, `served` its detections [S, 7] on the
    host (box, score, label, mask), `fns` the stage functions checked (the
    port's, or the control's)."""
    from benchmark.reference.modeling.roi_heads.box_head import filter_detections
    from benchmark.reference.modeling.roi_heads.grid_ops import grid_decode

    head, g = model.roi_head, model.cfg.GRID_RCNN
    stages = head.test_stage
    if len(calls) != stages + 2:
        raise RuntimeError(f"{len(calls)} pooler calls a request, expected {stages + 2}")
    dev = images.device
    served_t = torch.as_tensor(served, device=dev)
    mask = served_t[:, 6] > 0
    if not bool(mask.any()):
        return {k: float("inf") for k in INFINITE}
    nc = model.cfg.MODEL.NUM_CLASSES
    in_range = (served_t[:, 5] >= 0) & (served_t[:, 5] < nc)
    labels = served_t[:, 5].long().clamp(0, nc - 1)
    feats, levels = replay.features(model, images, sizes)
    roi_feats = levels[: head.num_levels]
    out = dict(zip(("proposal_stage", "proposal_gap"), replay.proposal_check(
        model, feats, sizes, calls[0]["rois"][:, 1:], calls[0]["mask"], fns)))

    # the classifier at the port's proposals, and its own selection there
    r0, m0 = calls[0]["rois"], calls[0]["mask"]
    probs0 = torch.softmax(head.cls_output(head.cls_head(roi_feats, r0, m0)), dim=-1)
    props = r0[:, 1:][None]
    mine = filter_detections(props[:, :, None, :].expand(1, props.shape[1], nc, 4), probs0[None],
                             m0[None], score_thresh=g.SCORE_THRESH, nms_thresh=g.NMS,
                             detections_per_img=g.TEST_MAX_DETECTIONS)
    out["count_gap"] = float(abs(int(mask.sum()) - int(mine.mask[0].sum())))
    chosen = {_row_key(b, lab) for b, lab, v in zip(
        mine.boxes[0].cpu().numpy(), mine.labels[0].cpu().numpy(), mine.mask[0].cpu().numpy()) if v}
    r1 = calls[1]["rois"][:, 1:]
    pairs = [_row_key(b, lab) for b, lab, v in zip(
        r1.cpu().numpy(), served[:, 5].astype(int), mask.cpu().numpy()) if v]
    out["select_miss"] = sum(p not in chosen for p in pairs) / max(len(pairs), 1)

    # the served score, recomputed at the port's rois; each stage's output
    # against the reference's decode at the stage's roi
    p1 = torch.softmax(head.cls_output(head.cls_head(roi_feats, calls[1]["rois"], mask)), dim=-1)
    p = torch.gather(p1, 1, labels[:, None])[:, 0]
    k = int(mask.sum())
    valid = mask[:k]
    misses, decoded, stage_gap, dists = 0, 0, 0.0, []
    iou = torch.zeros_like(p)
    sizes_k = sizes.repeat_interleave(k, dim=0)
    decode = decode_fn(fns.control)
    for s in range(stages):
        gh, go = head.grid_heads[s], head.grid_outputs[s]
        rois = calls[1 + s]["rois"]
        pooled = gh.pool(roi_feats, rois, mask)[:k]
        x, x_so, x_off = gh(pooled=pooled)
        heat, iou_logits = go(x, x_so, x_off, train=False)
        hm = heat["fused"] if g.FUSED_ON else heat["unfused"]
        kw = dict(mapping_ratio=head.mapping_ratios[s], grid_points=head.grid_nums[s],
                  roi_feat_size=g.ROI_FEAT_SIZE)
        box = grid_decode(rois[:k, 1:], hm, sizes_k, **kw)
        stage_gap = max(stage_gap, replay.widest(
            torch.where(valid[:, None], box, 0.0),
            torch.where(valid[:, None], decode(rois[:k, 1:], hm, sizes_k, **kw), 0.0)))
        # the port's output of this stage: the next stage's rois; after the
        # last, the served boxes as read back
        nxt = calls[2 + s]["rois"][:k, 1:] if s + 1 < stages else served_t[:k, :4]
        side = torch.maximum(box[:, 2] - box[:, 0], box[:, 3] - box[:, 1]).clamp_min(1.0)
        dist = ((nxt - box).abs().max(dim=1).values / side)[valid]
        dists.append(dist.cpu())
        misses += int((dist > BOX_TOL_REL).sum())
        decoded += len(dist)
        if go.iou_helper:
            iou[:k] = iou_logits[:, 1]
    out["box_dist"] = dists
    out["decode_miss"] = misses / max(decoded, 1)
    out["decode_stage"] = stage_gap
    r4 = calls[1 + stages]["rois"]
    pr = torch.softmax(head.rescore_output(head.rescore_head(roi_feats, r4, mask)), dim=-1)
    rescore = torch.gather(pr, 1, labels[:, None])[:, 0]
    fused = p * iou if g.IOU_HELPER_MERGE else iou
    want = torch.clamp(fused, min=0.0) ** 0.8 * torch.clamp(rescore, min=1e-12) ** 0.2
    gap = torch.where(in_range, (want - served_t[:, 4]).abs(), float("inf"))[mask]
    out["score_gap"] = float(gap.max())
    return out


class TrainReplay(replay.TrainReplay):
    """The grid-cascade head's points: each grid stage's rois, the grid
    decode's stage check, the rescoring rois labelled again."""

    def __init__(self, capture, fns: replay.StageFns, seed: int):
        super().__init__(capture, fns, seed)
        self.decode = decode_fn(fns.control)
        self.decode_stage = 0.0

    def stage(self, stage, boxes, stage_mask):
        rois, mask = self.call(1 + stage, stage_mask.shape)
        return rois.to(boxes.dtype), mask

    def decoded(self, rois, hm, sizes, mask, kw, refined):
        theirs = self.decode(rois, hm, sizes, **kw)
        valid = mask[:, None]
        self.decode_stage = max(self.decode_stage, replay.widest(
            torch.where(valid, refined, 0.0), torch.where(valid, theirs, 0.0)))

    def rescore(self, head, sampled, gt):
        from benchmark.reference.modeling.roi_heads.targets import assign_targets

        g = head.cfg.GRID_RCNN
        boxes, mask = self.call(1 + head.stage_num, sampled.mask.shape)
        labels = assign_targets(boxes, mask, gt["boxes"], gt["labels"], gt["mask"],
                                fg_iou_threshold=g.FG_IOU_THRESHOLD,
                                bg_iou_threshold=g.BG_IOU_THRESHOLD,
                                box_coder=head.box_coder)["labels"]
        mask = mask & (labels >= 0)
        return sampled._replace(boxes=boxes.to(sampled.boxes.dtype), mask=mask,
                                labels=torch.where(mask, labels, -1))

    def numbers(self, device) -> dict:
        return dict(super().numbers(device), decode_stage=self.decode_stage)
