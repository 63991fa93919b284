"""COCO-style bbox AP evaluation, implemented from the metric definition.

The port's copy of cpm_tpu/evaluation/coco_eval.py. pycocotools is no
dependency of the port, so this module implements
the standard COCO evaluation protocol directly (greedy score-ordered
matching per image/category at IoU thresholds 0.50:0.05:0.95, 101-point
interpolated precision, area ranges, maxDets 1/10/100), plus the four
extra summary stats (AP60/70/80/90) the reference adds in its vendored
COCOeval (pet/rcnn/datasets/mycocoeval.py:476-479, feeding
the extended metric list of evaluation.py:329).

Matching semantics follow the published COCO protocol:
  * detections sorted by score (desc), gts with ignore flags sorted last;
  * each det greedily matches the best unmatched gt with IoU >= t, but may
    switch to an ignored gt only if no real gt matches;
  * crowd gts can match multiple dets (IoU computed with crowd denominator
    = det area) and matched dets are ignored;
  * unmatched dets outside the area range are ignored.
"""

from typing import Dict, List, Optional, Sequence

import numpy as np

IOU_THRS = np.round(np.arange(0.5, 1.0, 0.05), 2)  # 10 thresholds
REC_THRS = np.round(np.linspace(0.0, 1.0, 101), 2)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
MAX_DETS = (1, 10, 100)


def bbox_iou_xywh(dt: np.ndarray, gt: np.ndarray, iscrowd: np.ndarray):
    """IoU between dt [D,4] and gt [G,4] xywh; crowd gt uses det-area
    denominator (the pycocotools `iou` spec)."""
    D, G = len(dt), len(gt)
    out = np.zeros((D, G), np.float64)
    if D == 0 or G == 0:
        return out
    dx1, dy1 = dt[:, 0], dt[:, 1]
    dx2, dy2 = dt[:, 0] + dt[:, 2], dt[:, 1] + dt[:, 3]
    gx1, gy1 = gt[:, 0], gt[:, 1]
    gx2, gy2 = gt[:, 0] + gt[:, 2], gt[:, 1] + gt[:, 3]
    da = dt[:, 2] * dt[:, 3]
    ga = gt[:, 2] * gt[:, 3]
    iw = np.minimum(dx2[:, None], gx2[None, :]) - np.maximum(
        dx1[:, None], gx1[None, :]
    )
    ih = np.minimum(dy2[:, None], gy2[None, :]) - np.maximum(
        dy1[:, None], gy1[None, :]
    )
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    union = np.where(
        iscrowd[None, :].astype(bool),
        da[:, None],
        da[:, None] + ga[None, :] - inter,
    )
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.where(union > 0, inter / union, 0.0)
    return out


def _evaluate_img(dts, gts, area_rng, max_det):
    """Per (image, category, area) matching. dts: list of dicts with
    'bbox', 'score'; gts with 'bbox', 'iscrowd', 'area', 'ignore'.
    Returns dict with dtm/gtm/dtIg/gtIg/scores over IOU_THRS."""
    if len(dts) == 0 and len(gts) == 0:
        return None
    for g in gts:
        out_of_range = g["area"] < area_rng[0] or g["area"] > area_rng[1]
        g["_ignore"] = 1 if (g.get("ignore", 0) or g.get("iscrowd", 0) or out_of_range) else 0
    gt_order = np.argsort([g["_ignore"] for g in gts], kind="mergesort")
    gts = [gts[i] for i in gt_order]
    dt_order = np.argsort([-d["score"] for d in dts], kind="mergesort")
    dts = [dts[i] for i in dt_order[:max_det]]

    gt_boxes = np.array([g["bbox"] for g in gts], np.float64).reshape(-1, 4)
    dt_boxes = np.array([d["bbox"] for d in dts], np.float64).reshape(-1, 4)
    iscrowd = np.array([g.get("iscrowd", 0) for g in gts], np.int32)
    ious = bbox_iou_xywh(dt_boxes, gt_boxes, iscrowd)

    T = len(IOU_THRS)
    D, G = len(dts), len(gts)
    gtIg = np.array([g["_ignore"] for g in gts])
    dtm = np.zeros((T, D))
    gtm = np.zeros((T, G))
    dtIg = np.zeros((T, D))
    for ti, t in enumerate(IOU_THRS):
        for di in range(D):
            iou = min(t, 1 - 1e-10)
            m = -1
            for gi in range(G):
                if gtm[ti, gi] > 0 and not iscrowd[gi]:
                    continue
                if m > -1 and gtIg[m] == 0 and gtIg[gi] == 1:
                    break  # real matches exhausted; stop at ignored gts
                if ious[di, gi] < iou:
                    continue
                iou = ious[di, gi]
                m = gi
            if m == -1:
                continue
            dtIg[ti, di] = gtIg[m]
            dtm[ti, di] = 1 + m
            gtm[ti, m] = 1 + di
    # unmatched dets outside the area range are ignored
    a = np.array(
        [
            d["bbox"][2] * d["bbox"][3] < area_rng[0]
            or d["bbox"][2] * d["bbox"][3] > area_rng[1]
            for d in dts
        ]
    ).reshape(1, -1)
    dtIg = np.logical_or(
        dtIg, np.logical_and(dtm == 0, np.repeat(a, T, axis=0))
    )
    return dict(
        dtm=dtm,
        dtIg=dtIg,
        gtIg=gtIg,
        scores=np.array([d["score"] for d in dts]),
        num_gt=int(np.count_nonzero(gtIg == 0)),
    )


class COCOEvaluator:
    """Evaluate COCO-format detection results against a CocoIndex."""

    def __init__(self, coco_gt, use_cats: Optional[Sequence[int]] = None):
        self.coco_gt = coco_gt
        self.cat_ids = (
            list(use_cats) if use_cats is not None else coco_gt.getCatIds()
        )

    def evaluate(self, results: List[dict], img_ids=None) -> Dict[str, float]:
        """results: list of {image_id, category_id, bbox xywh, score}."""
        if img_ids is None:
            img_ids = self.coco_gt.getImgIds()
        img_ids = list(img_ids)
        img_set = set(img_ids)

        # bucket dts and gts by (img, cat)
        dt_by = {}
        for r in results:
            if r["image_id"] in img_set:
                dt_by.setdefault(
                    (r["image_id"], r["category_id"]), []
                ).append(r)
        gt_by = {}
        for img_id in img_ids:
            for ann in self.coco_gt.annotations_for_image(img_id):
                gt_by.setdefault(
                    (img_id, ann["category_id"]), []
                ).append(ann)

        T = len(IOU_THRS)
        R = len(REC_THRS)
        K = len(self.cat_ids)
        A = len(AREA_RANGES)
        M = len(MAX_DETS)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))

        max_det_global = max(MAX_DETS)
        area_items = list(AREA_RANGES.items())
        for ki, cat in enumerate(self.cat_ids):
            for ai, (_, rng) in enumerate(area_items):
                evals = []
                for img_id in img_ids:
                    dts = [
                        dict(bbox=d["bbox"], score=d["score"])
                        for d in dt_by.get((img_id, cat), [])
                    ]
                    gts = [
                        dict(
                            bbox=g["bbox"],
                            iscrowd=g.get("iscrowd", 0),
                            area=g.get(
                                "area", g["bbox"][2] * g["bbox"][3]
                            ),
                            ignore=g.get("ignore", 0),
                        )
                        for g in gt_by.get((img_id, cat), [])
                    ]
                    e = _evaluate_img(dts, gts, rng, max_det_global)
                    if e is not None:
                        evals.append(e)
                if not evals:
                    continue
                for mi, max_det in enumerate(MAX_DETS):
                    scores = np.concatenate(
                        [e["scores"][:max_det] for e in evals]
                    )
                    order = np.argsort(-scores, kind="mergesort")
                    dtm = np.concatenate(
                        [e["dtm"][:, :max_det] for e in evals], axis=1
                    )[:, order]
                    dtIg = np.concatenate(
                        [e["dtIg"][:, :max_det] for e in evals], axis=1
                    )[:, order]
                    n_gt = sum(e["num_gt"] for e in evals)
                    if n_gt == 0:
                        continue
                    tps = np.logical_and(dtm > 0, ~dtIg.astype(bool))
                    fps = np.logical_and(dtm == 0, ~dtIg.astype(bool))
                    tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
                    fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
                    for ti in range(T):
                        tp = tp_sum[ti]
                        fp = fp_sum[ti]
                        rc = tp / n_gt
                        pr = tp / np.maximum(tp + fp, np.spacing(1))
                        recall[ti, ki, ai, mi] = rc[-1] if len(rc) else 0
                        # precision envelope (monotone decreasing)
                        pr = pr.tolist()
                        for i in range(len(pr) - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds = np.searchsorted(rc, REC_THRS, side="left")
                        q = np.zeros(R)
                        for ri, pi in enumerate(inds):
                            if pi < len(pr):
                                q[ri] = pr[pi]
                        precision[ti, :, ki, ai, mi] = q

        self.precision = precision
        self.recall = recall
        return self.summarize()

    def _ap(self, iou=None, area="all", max_det=100):
        ai = list(AREA_RANGES.keys()).index(area)
        mi = MAX_DETS.index(max_det)
        p = self.precision
        if iou is not None:
            ti = int(np.where(np.isclose(IOU_THRS, iou))[0][0])
            p = p[ti : ti + 1]
        p = p[:, :, :, ai, mi]
        valid = p[p > -1]
        return float(np.mean(valid)) if valid.size else -1.0

    def _ar(self, area="all", max_det=100):
        ai = list(AREA_RANGES.keys()).index(area)
        mi = MAX_DETS.index(max_det)
        r = self.recall[:, :, ai, mi]
        valid = r[r > -1]
        return float(np.mean(valid)) if valid.size else -1.0

    def summarize(self) -> Dict[str, float]:
        """Standard 12 stats + reference extras AP60/70/80/90
        (mycocoeval.py:476-479)."""
        s = {
            "AP": self._ap(),
            "AP50": self._ap(iou=0.5),
            "AP75": self._ap(iou=0.75),
            "APs": self._ap(area="small"),
            "APm": self._ap(area="medium"),
            "APl": self._ap(area="large"),
            "AR1": self._ar(max_det=1),
            "AR10": self._ar(max_det=10),
            "AR100": self._ar(max_det=100),
            "ARs": self._ar(area="small"),
            "ARm": self._ar(area="medium"),
            "ARl": self._ar(area="large"),
            "AP60": self._ap(iou=0.6),
            "AP70": self._ap(iou=0.7),
            "AP80": self._ap(iou=0.8),
            "AP90": self._ap(iou=0.9),
        }
        return s


def check_expected_results(stats, expected_results, sigma_tol, log=print):
    """Eval regression guard (reference evaluation.py:386-405).

    The reference ships this dormant (``expected_results = ()`` hard-coded at
    evaluation.py:57); here it is driven by ``TEST.EXPECTED_RESULTS`` /
    ``TEST.EXPECTED_RESULTS_SIGMA_TOL``. Each entry is (metric, mean, std)
    over the keys of :meth:`COCOEvaluator.summarize` (the reference's
    3-tuples carry a task name too; we have one task, bbox). Returns the
    list of failure messages (empty = all inside mean ± sigma_tol·std) so
    callers can raise or just log, matching the reference's log-only
    behavior by default.
    """
    failures = []
    if not expected_results:
        return failures
    for entry in expected_results:
        metric, mean, std = entry[0], float(entry[1]), float(entry[2])
        if metric not in stats:
            msg = f"FAIL: expected-results metric {metric!r} not in eval stats"
            failures.append(msg)
            log(msg)
            continue
        actual = float(stats[metric])
        lo = mean - sigma_tol * std
        hi = mean + sigma_tol * std
        ok = lo < actual < hi
        msg = (
            f"bbox > {metric} sanity check (actual vs. expected): "
            f"{actual:.3f} vs. mean={mean:.4f}, std={std:.4}, "
            f"range=({lo:.4f}, {hi:.4f})"
        )
        if ok:
            log("PASS: " + msg)
        else:
            failures.append("FAIL: " + msg)
            log("FAIL: " + msg)
    return failures
