"""Detection visualization.

The port's copy of cpm_tpu/utils/vis.py, after the reference's
pet/utils/vis.py (vis_one_image_opencv) and its colormap, driven by
cfg.VIS during eval (test_engine.py:171-187). Implemented with PIL (no
OpenCV dependency needed): class-colored boxes, score-labeled captions,
optional score threshold.
"""

import colorsys
import os
from typing import Optional, Sequence

import numpy as np
from PIL import Image, ImageDraw


def distinct_colors(n: int) -> list:
    """Evenly-spaced hues (replaces pet/utils/colormap.py)."""
    out = []
    for i in range(n):
        r, g, b = colorsys.hsv_to_rgb((i * 0.61803398875) % 1.0, 0.75, 0.95)
        out.append((int(r * 255), int(g * 255), int(b * 255)))
    return out


def vis_one_image(
    image: np.ndarray,
    boxes: np.ndarray,
    scores: np.ndarray,
    labels: np.ndarray,
    class_names: Optional[Sequence[str]] = None,
    score_thresh: float = 0.5,
    num_classes: int = 81,
) -> Image.Image:
    """Draw detections on an RGB uint8 image. boxes xyxy in image coords."""
    img = Image.fromarray(image).convert("RGB")
    draw = ImageDraw.Draw(img)
    colors = distinct_colors(num_classes)
    order = np.argsort(scores)  # draw high scores last (on top)
    for i in order:
        if scores[i] < score_thresh:
            continue
        x1, y1, x2, y2 = [float(v) for v in boxes[i]]
        if x2 < x1 or y2 < y1:
            continue  # an inverted box has no extent to draw (its COCO w or h is 0)
        cls = int(labels[i])
        color = colors[cls % len(colors)]
        draw.rectangle([x1, y1, x2, y2], outline=color, width=2)
        name = (
            class_names[cls]
            if class_names is not None and cls < len(class_names)
            else str(cls)
        )
        caption = f"{name} {scores[i]:.2f}"
        tw = draw.textlength(caption)
        draw.rectangle([x1, max(y1 - 12, 0), x1 + tw + 4, y1], fill=color)
        draw.text((x1 + 2, max(y1 - 12, 0)), caption, fill=(0, 0, 0))
    return img


def save_vis(
    image: np.ndarray,
    boxes: np.ndarray,
    scores: np.ndarray,
    labels: np.ndarray,
    out_path: str,
    **kw,
):
    img = vis_one_image(image, boxes, scores, labels, **kw)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    img.save(out_path)
