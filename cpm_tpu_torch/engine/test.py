"""Inference engine: the eval forward, the dataset loop and COCO evaluation.

Port of cpm_tpu/engine/test.py (`make_forward_fn`, `detections_to_coco`,
`run_inference_on_dataset`, `evaluate_results`), after the reference's
pet/rcnn/core/test_engine.py and rcnn/datasets/evaluation.py: per image,
the forward at TEST.SCALE, boxes rescaled to the original image, COCO xywh
results with json category ids, then the in-repo COCOEvaluator. Test-time
augmentation (TEST.BBOX_AUG) is not ported yet and raises.
"""

import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from cpm_tpu_torch.data.loader import TestLoader
from cpm_tpu_torch.utils.amp import cast_floating_to, compute_dtype


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
        images = torch.as_tensor(images, device=device)
        image_sizes = torch.as_tensor(image_sizes, device=device)
        with torch.inference_mode():
            return torch.func.functional_call(model, state, (images, image_sizes))

    return forward


def run_inference_on_dataset(
    cfg,
    model: torch.nn.Module,
    dataset,
    *,
    progress_every: int = 100,
    logger=print,
    batch_seconds: Optional[list] = None,
) -> List[dict]:
    """COCO-format result dicts for the dataset's images, one pass at
    TEST.SCALE. With cfg.VIS.ENABLED each image is drawn with its
    detections under $CKPT/vis/ (the reference's test_engine.py:171-187).
    `batch_seconds`, when given, receives each batch's wall time: loading,
    the forward and the conversion, ending with the detections on the host."""
    if cfg.TEST.BBOX_AUG.ENABLED:
        raise NotImplementedError("TEST.BBOX_AUG (test-time augmentation) is not ported yet")
    forward = make_forward_fn(cfg, model)
    loader = TestLoader(cfg, dataset)
    c2j = dataset.contiguous_category_id_to_json_id

    vis_dir = class_names = None
    if cfg.VIS.ENABLED:
        vis_dir = os.path.join(cfg.CKPT, "vis")
        os.makedirs(vis_dir, exist_ok=True)
        class_names = [""] * (max(c2j, default=0) + 1)
        for cont, jid in c2j.items():
            cat = getattr(dataset.coco, "cats", {}).get(jid, {})
            class_names[cont] = cat.get("name", str(jid))

    def vis_one(dets_np, meta):
        """Draw the detections, unscaled to the original image, over the raw
        image and write $CKPT/vis/<file_name>."""
        from cpm_tpu_torch.utils.vis import save_vis

        sh, sw = meta["scale_hw"]
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

    results: List[dict] = []
    n_done = 0
    batches = iter(loader)
    while True:
        t0 = time.perf_counter()
        item = next(batches, None)
        if item is None:
            break
        dets = forward(item["images"], item["image_sizes"])
        fetched = dict(boxes=dets.boxes.float().cpu().numpy(),
                       scores=dets.scores.float().cpu().numpy(),
                       labels=dets.labels.cpu().numpy(), mask=dets.mask.cpu().numpy())
        for j, meta in enumerate(item["meta"]):
            dets_np = {f: v[j] for f, v in fetched.items()}
            results.extend(detections_to_coco(dets_np, meta["image_id"], meta["scale_hw"], c2j))
            if vis_dir is not None:
                vis_one(dets_np, meta)
        if batch_seconds is not None:
            batch_seconds.append(time.perf_counter() - t0)
        n_done += item["count"]
        if progress_every and n_done % progress_every < item["count"]:
            logger(f"inference: {n_done}/{len(loader)} images")
    return results


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
