"""Inference entry points: the eval forward and COCO result conversion.

Port of cpm_tpu/engine/test.py (`make_forward_fn`, `detections_to_coco`).
The dataset loop, TTA and the CLI are not ported yet.
"""

from typing import Dict, List

import numpy as np
import torch

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
