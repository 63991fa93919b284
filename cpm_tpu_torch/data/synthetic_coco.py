"""On-disk synthetic COCO dataset for smoke tests and CLI bring-up.

The port's copy of cpm_tpu/data/synthetic_coco.py (the same images and
annotations from the same seed). The reference assumes a real COCO tree
under DATA_DIR; the catalog name ``coco_debug_synthetic`` instead names a
tiny deterministic dataset (colored rectangles on black, JPEG +
instances.json) under DATA_DIR/synthetic_debug, written on first use, so

    python -m cpm_tpu_torch.tools.train_net --cfg cfgs/debug/tiny_cpm.yaml --device cpu
    python -m cpm_tpu_torch.tools.test_net  --cfg cfgs/debug/tiny_cpm.yaml --device cpu

run end to end on a machine with no COCO download. The repository carries
it as data/synthetic_debug. Deterministic per (n_images, seed): nothing is
written when the annotation file already exists.
"""

import json
import os
from typing import Tuple

import numpy as np

SYNTHETIC_NAME = "coco_debug_synthetic"
_N_IMAGES = 16
_N_CLASSES = 8
_SEED = 0


def materialize(
    root: str,
    n_images: int = _N_IMAGES,
    n_classes: int = _N_CLASSES,
    seed: int = _SEED,
) -> Tuple[str, str]:
    """Write the dataset under `root`; returns (image_dir, ann_file).

    Images are HxW colored rectangles on black, sizes varied around
    60-96 px, 1-4 objects each, class-colored so a trained model can
    actually fit them.
    """
    from PIL import Image

    img_dir = os.path.join(root, "images")
    ann_file = os.path.join(root, "instances.json")
    if os.path.exists(ann_file):
        return img_dir, ann_file
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    images, annotations = [], []
    ann_id = 1
    for i in range(n_images):
        h = 60 + 4 * (i % 5)
        w = 96 - 4 * (i % 3)
        arr = np.zeros((h, w, 3), np.uint8)
        for _ in range(int(rng.randint(1, 5))):
            x1 = int(rng.randint(0, w - 24))
            y1 = int(rng.randint(0, h - 24))
            bw = int(rng.randint(12, min(24, w - x1)))
            bh = int(rng.randint(12, min(24, h - y1)))
            cat = int(rng.randint(1, n_classes + 1))
            color = [
                (37 * cat) % 200 + 55,
                (91 * cat) % 200 + 55,
                (151 * cat) % 200 + 55,
            ]
            arr[y1:y1 + bh, x1:x1 + bw] = color
            annotations.append(dict(
                id=ann_id, image_id=i + 1, category_id=cat,
                bbox=[float(x1), float(y1), float(bw), float(bh)],
                area=float(bw * bh), iscrowd=0,
            ))
            ann_id += 1
        fname = f"{i:06d}.jpg"
        Image.fromarray(arr).save(os.path.join(img_dir, fname), quality=95)
        images.append(dict(id=i + 1, file_name=fname, width=w, height=h))
    with open(ann_file, "w") as f:
        json.dump(dict(
            images=images,
            annotations=annotations,
            categories=[
                dict(id=c, name=f"class_{c}")
                for c in range(1, n_classes + 1)
            ],
        ), f)
    return img_dir, ann_file


def ensure_registered(data_dir: str) -> None:
    """Materialize under <data_dir>/synthetic_debug (nothing is written when
    it is there) and register that directory in the catalog, so that the
    name always resolves to the DATA_DIR of the latest config."""
    from cpm_tpu_torch.data import catalog

    # absolute paths: os.path.join(data_dir, abs) returns abs, so the
    # catalog's entries resolve whatever DATA_DIR is, relative ones too
    root = os.path.abspath(os.path.join(data_dir or "data", "synthetic_debug"))
    img_dir, ann_file = materialize(root)
    catalog.register(
        SYNTHETIC_NAME, image_directory=img_dir, annotation_file=ann_file
    )
