"""Inference engine: the eval forward, the dataset loop and COCO evaluation.

Port of cpm_tpu/engine/test.py (`make_forward_fn`, `detections_to_coco`,
`run_inference_on_dataset` with its TTA merge, `shard_ranges`,
`evaluate_results`), after the reference's pet/rcnn/core/test_engine.py,
core/test.py and rcnn/datasets/evaluation.py: per image, the forward at
TEST.SCALE, boxes rescaled to the original image, COCO xywh results with
json category ids, then the in-repo COCOEvaluator.

TTA (TEST.BBOX_AUG): each pass's detections are mapped to the original
image, concatenated and filtered once by the reference's filter_results
(core/test.py:44-48, 433-509): label-aware hard NMS, or soft-NMS with
TEST.SOFT_NMS, then box voting with TEST.BBOX_VOTE, capped at
FAST_RCNN.DETECTIONS_PER_IMG. The merged set has a fixed size (passes x K
detections), and the merge runs on the model's device.
"""

import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from cpm_tpu_torch.data.loader import TestLoader, describe_decode_path
from cpm_tpu_torch.modeling.roi_heads.box_head import detection_filter_kwargs
from cpm_tpu_torch.ops.nms import filter_results
from cpm_tpu_torch.utils.amp import cast_floating_to, compute_dtype
from cpm_tpu_torch.utils.spans import span, sync


def detections_to_coco(
    dets_np: Dict[str, np.ndarray],
    image_id: int,
    scale_hw,
    contiguous_to_json: Dict[int, int],
) -> List[dict]:
    """One image's detections (numpy fields) -> COCO result dicts: boxes
    unscaled to original image coordinates, xyxy -> xywh with TO_REMOVE = 1;
    labels the dataset does not define are dropped."""
    sh, sw = scale_hw
    out = []
    for box, score, label, valid in zip(
        dets_np["boxes"], dets_np["scores"], dets_np["labels"], dets_np["mask"]
    ):
        if not valid or int(label) not in contiguous_to_json:
            continue
        x1, y1, x2, y2 = box
        x1, x2 = x1 / sw, x2 / sw
        y1, y2 = y1 / sh, y2 / sh
        out.append(dict(
            image_id=int(image_id),
            category_id=int(contiguous_to_json[int(label)]),
            bbox=[float(x1), float(y1), float(max(x2 - x1 + 1.0, 0.0)),
                  float(max(y2 - y1 + 1.0, 0.0))],
            score=float(score),
        ))
    return out


def make_forward_fn(cfg, model: torch.nn.Module):
    """The eval forward in TPU.COMPUTE_DTYPE: `forward(images, image_sizes)`
    moves numpy or tensor inputs to the model's device and runs without
    autograd.

    The model's own parameters are left as they are (a model that trains
    keeps f32 masters): the forward runs, through
    `torch.func.functional_call`, on casts of them made once, here. Call
    `make_forward_fn` again after further training to evaluate the new
    weights in a compute dtype other than float32."""
    state = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    with torch.no_grad():
        state = cast_floating_to(state, compute_dtype(cfg))
    device = next(model.parameters()).device

    def forward(images, image_sizes):
        with span("cpm/forward"):
            with sync("inputs"):
                images = torch.as_tensor(images, device=device)
            with sync("inputs"):
                image_sizes = torch.as_tensor(image_sizes, device=device)
            with torch.inference_mode():
                return torch.func.functional_call(model, state, (images, image_sizes))

    return forward


def merge_tta_detections(cfg, per_pass_dets: List[Dict[str, torch.Tensor]]):
    """Concatenate the passes' detections (tensors [..., K] in one
    coordinate frame) and filter them once (core/test.py:46-48), on their
    device. As in the reference, the filter reads FAST_RCNN's thresholds."""
    cat = {f: torch.cat([d[f] for d in per_pass_dets], dim=-1 if f != "boxes" else -2)
           for f in ("boxes", "scores", "labels", "mask")}
    boxes, scores, labels, keep = filter_results(
        cat["boxes"], cat["scores"], cat["labels"], cat["mask"], **detection_filter_kwargs(cfg))
    return dict(boxes=boxes, scores=scores, labels=labels, mask=keep)


def _unflip_boxes(boxes: torch.Tensor, resized_w: torch.Tensor) -> torch.Tensor:
    """Map boxes [B, K, 4] of h-flipped images of widths resized_w [B] back
    (BoxList.transpose, TO_REMOVE = 1)."""
    w = resized_w[:, None]
    x1 = w - boxes[..., 2] - 1
    x2 = w - boxes[..., 0] - 1
    return torch.stack([x1, boxes[..., 1], x2, boxes[..., 3]], dim=-1)


def tta_passes(cfg) -> List[dict]:
    """The eval passes (core/test.py:34-48): the base pass, then with
    TEST.BBOX_AUG its flip, then each scale and its flip."""
    passes = [dict(scale=None, max_size=None, hflip=False)]
    aug = cfg.TEST.BBOX_AUG
    if aug.ENABLED:
        if aug.H_FLIP:
            passes.append(dict(scale=None, max_size=None, hflip=True))
        for s in aug.SCALES:
            passes.append(dict(scale=s, max_size=aug.MAX_SIZE, hflip=False))
            if aug.H_FLIP:
                passes.append(dict(scale=s, max_size=aug.MAX_SIZE, hflip=True))
    return passes


def run_inference_on_dataset(
    cfg,
    model: torch.nn.Module,
    dataset,
    *,
    start: int = 0,
    end: Optional[int] = None,
    progress_every: int = 100,
    logger=print,
    batch_seconds: Optional[list] = None,
) -> List[dict]:
    """COCO-format result dicts for the images [start, end) of the dataset.

    One pass at TEST.SCALE, or with TEST.BBOX_AUG the passes of
    `tta_passes`, whose detections are mapped to the original image and
    merged on the model's device. The loop is pipelined: a batch's forwards
    (and its merge) are queued on the device before the previous batch's
    detections are read, in one device-to-host copy a batch. With
    cfg.VIS.ENABLED each image is drawn with its detections under
    $CKPT/vis/ (the reference's test_engine.py:171-187). `batch_seconds`,
    when given, receives for each batch the wall time of the loop's turn
    that loads and queues it and reads the previous batch's detections; the
    last batch's also holds the read of its own. They sum to the loop's time.
    Unless `progress_every` is 0, `logger` gets the loaders' decode path
    first (`describe_decode_path`)."""
    forward = make_forward_fn(cfg, model)
    device = next(model.parameters()).device
    passes = tta_passes(cfg)
    tta = len(passes) > 1
    loaders = [TestLoader(cfg, dataset, start=start, end=end, scale=p["scale"],
                          max_size=p["max_size"], hflip=p["hflip"]) for p in passes]
    if progress_every:
        logger(f"decode path: {describe_decode_path(loaders)}")
    c2j = dataset.contiguous_category_id_to_json_id

    vis_dir = class_names = None
    if cfg.VIS.ENABLED:
        vis_dir = os.path.join(cfg.CKPT, "vis")
        os.makedirs(vis_dir, exist_ok=True)
        class_names = [""] * (max(c2j, default=0) + 1)
        for cont, jid in c2j.items():
            cat = getattr(dataset.coco, "cats", {}).get(jid, {})
            class_names[cont] = cat.get("name", str(jid))

    def vis_one(dets_np, meta, scale_hw):
        """Draw the detections, unscaled to the original image, over the raw
        image and write $CKPT/vis/<file_name>."""
        from cpm_tpu_torch.utils.vis import save_vis

        sh, sw = scale_hw
        boxes = dets_np["boxes"] / np.array([sw, sh, sw, sh], np.float32)
        keep = dets_np["mask"].astype(bool)
        file_name = os.path.basename(dataset.get_img_info(meta["index"]).get(
            "file_name", f"{meta['image_id']}.jpg"))
        save_vis(
            dataset.load_image(meta["index"]), boxes[keep], dets_np["scores"][keep],
            dets_np["labels"][keep], os.path.join(vis_dir, file_name),
            class_names=class_names, score_thresh=cfg.VIS.VIS_TH,
            num_classes=cfg.MODEL.NUM_CLASSES,
        )

    def dispatch(items):
        """Queue every pass's forward of one batch, and under TTA the mapping
        to original coordinates and the merge; returns the detections packed
        as one [B, K, 7] float32 tensor (box, score, label, mask) and the
        batch's first item."""
        def upload(array):
            # a blocking copy would wait for the forwards queued before it
            return torch.as_tensor(array).to(device, non_blocking=True)

        per_pass = []
        for p, item in zip(passes, items):
            dets = forward(item["images"], item["image_sizes"])
            d = dict(boxes=dets.boxes.float(), scores=dets.scores.float(),
                     labels=dets.labels, mask=dets.mask)
            if p["hflip"]:
                d["boxes"] = _unflip_boxes(d["boxes"], upload(item["image_sizes"][:, 1]))
            if tta:
                # every pass to the original image's frame; a padded slot
                # repeats the batch's last image
                metas = item["meta"] + item["meta"][-1:] * (len(d["boxes"]) - item["count"])
                scale = upload(np.array([[m["scale_hw"][1], m["scale_hw"][0]] * 2 for m in metas],
                                        np.float32))
                d["boxes"] = d["boxes"] / scale[:, None, :]
            per_pass.append(d)
        d = merge_tta_detections(cfg, per_pass) if tta else per_pass[0]
        packed = torch.cat([d["boxes"], d["scores"][..., None], d["labels"].float()[..., None],
                            d["mask"].float()[..., None]], dim=-1)
        return packed, items[0]

    def collect(pending):
        packed, item = pending
        host = packed.cpu().numpy()  # the batch's one device-to-host copy
        for j, meta in enumerate(item["meta"]):
            dets_np = dict(boxes=host[j, :, :4], scores=host[j, :, 4],
                           labels=host[j, :, 5].astype(np.int32), mask=host[j, :, 6] > 0)
            scale_hw = (1.0, 1.0) if tta else meta["scale_hw"]
            results.extend(detections_to_coco(dets_np, meta["image_id"], scale_hw, c2j))
            if vis_dir is not None:
                vis_one(dets_np, meta, scale_hw)
        return item["count"]

    results: List[dict] = []
    n_done = 0
    pending = None
    t_last = time.perf_counter()
    for items in zip(*loaders):
        dispatched = dispatch(items)
        if pending is not None:
            n_done += collect(pending)
            if progress_every and n_done % progress_every < pending[1]["count"]:
                logger(f"inference: {n_done}/{len(loaders[0])} images")
        pending = dispatched
        if batch_seconds is not None:
            now = time.perf_counter()
            batch_seconds.append(now - t_last)
            t_last = now
    if pending is not None:
        collect(pending)
        if batch_seconds is not None:
            batch_seconds[-1] += time.perf_counter() - t_last
    return results


def shard_ranges(n_images: int, n_shards: int) -> List[tuple]:
    """Split [0, n_images) into at most n_shards contiguous ranges
    (multi_gpu_test_net_on_dataset, test_engine.py:60-100)."""
    n_shards = max(1, min(n_shards, n_images)) if n_images else 1
    per = (n_images + n_shards - 1) // n_shards
    return [(i * per, min((i + 1) * per, n_images))
            for i in range(n_shards) if i * per < n_images]


def evaluate_results(cfg, dataset, results, output_dir: Optional[str] = None):
    """COCO-evaluate `results` and, with an output_dir, write them there as
    bbox.json (the reference's evaluation.py:95-106). Returns the stats."""
    from cpm_tpu_torch.evaluation.coco_eval import COCOEvaluator, check_expected_results

    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, "bbox.json"), "w") as f:
            json.dump(results, f)
    stats = COCOEvaluator(dataset.coco).evaluate(
        results, img_ids=[dataset.id_to_img_map[i] for i in range(len(dataset))]
    )
    # the regression guard (reference evaluation.py:104, dormant there;
    # driven by TEST.EXPECTED_RESULTS here), log-only like the reference
    check_expected_results(stats, cfg.TEST.EXPECTED_RESULTS, cfg.TEST.EXPECTED_RESULTS_SIGMA_TOL)
    return stats
