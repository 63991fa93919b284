"""The one traffic generator: a seeded COCO-format image tree from a mix file.

A mix (`benchmark/traffic/<name>.json`) gives the parameters; this module
turns them and a seed into JPEGs and an `instances` JSON that the port's
`COCODataset` reads. Every seed gets the same work: the counts of each
aspect, of instances and of each area class are fixed by the mix (their
quantiles), and the seed only orders them, places them and paints them.

Keys of a mix that this module reads:
  images           how many distinct images the tree holds
  aspects          [[width, height, share], ...] at the source scale
  instances        {"mean": m, "min": a, "max": b}: instances per image,
                   geometric quantiles with mean m, clipped to [a, b]
  area_split       {"small": s, "medium": m, "large": l}: COCO's area classes
                   (under 32^2, 32^2-96^2, over 96^2 px at the source scale)
  classes          number of categories (labels uniform over them)
  jpeg_quality     the encoder's quality

The boxes and labels are drawn in order from the seed; each image is then
painted from a seed of its own and encoded on a few threads, so that the
tree is the same whatever order the threads finish in.
"""

import json
import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np

SMALL, MEDIUM = 32.0 ** 2, 96.0 ** 2
WRITERS = 4  # threads that paint and encode


def exact_counts(shares: List[float], n: int) -> List[int]:
    """`n` split by `shares` (normalised) into whole counts, largest
    remainders first: the same counts for every seed."""
    total = float(sum(shares))
    raw = [s / total * n for s in shares]
    counts = [int(math.floor(r)) for r in raw]
    order = sorted(range(len(raw)), key=lambda i: counts[i] - raw[i])
    for i in order[: n - sum(counts)]:
        counts[i] += 1
    return counts


def instance_counts(spec: Dict, n: int) -> np.ndarray:
    """Instances of each of `n` images: the quantiles (i + 1/2) / n of a
    geometric law on 1, 2, ... with the mix's mean, clipped to its range.
    The multiset is fixed; the seed orders it."""
    p = 1.0 / float(spec["mean"])
    u = (np.arange(n) + 0.5) / n
    k = np.ceil(np.log1p(-u) / np.log1p(-p))
    return np.clip(k, spec["min"], spec["max"]).astype(np.int64)


def area_classes(split: Dict[str, float], n: int) -> np.ndarray:
    """0 (small), 1 (medium), 2 (large) for `n` instances, in the mix's
    shares, unordered."""
    counts = exact_counts([split["small"], split["medium"], split["large"]], n)
    return np.repeat(np.arange(3), counts)


def _box(rng, area_class: int, w: int, h: int):
    """An xywh box of the area class inside a w x h image, aspect ratio
    log-uniform in [1/2, 2]."""
    top = min(w, h) ** 2 * 0.6
    lo, hi = {0: (8.0 ** 2, SMALL), 1: (SMALL, MEDIUM), 2: (MEDIUM, max(top, MEDIUM * 1.5))}[area_class]
    area = math.exp(rng.uniform(math.log(lo), math.log(hi)))
    aspect = math.exp(rng.uniform(math.log(0.5), math.log(2.0)))
    bw = min(max(math.sqrt(area * aspect), 2.0), w - 1.0)
    bh = min(max(math.sqrt(area / aspect), 2.0), h - 1.0)
    x = rng.uniform(0, w - bw)
    y = rng.uniform(0, h - bh)
    return [float(x), float(y), float(bw), float(bh)]


def _paint(rng, w: int, h: int, boxes) -> np.ndarray:
    """An RGB uint8 image: a smooth seeded background, each instance a filled
    ellipse or rectangle of its own colour, and a fine texture so that a
    JPEG of it is photo-sized rather than flat."""
    yy = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None, None]
    xx = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :, None]
    a, b, c = (rng.uniform(-80, 80, (1, 1, 3)).astype(np.float32) for _ in range(3))
    f = rng.uniform(1.0, 4.0, 2).astype(np.float32)
    img = 128.0 + a * yy + b * xx + c * np.sin(2 * np.pi * (f[0] * yy + f[1] * xx))
    for x, y, bw, bh in boxes:
        x0, y0, x1, y1 = int(x), int(y), int(math.ceil(x + bw)), int(math.ceil(y + bh))
        color = rng.uniform(0, 255, 3).astype(np.float32)
        if rng.rand() < 0.5:
            img[y0:y1, x0:x1] = color
        else:
            cy, cx = (y0 + y1) / 2.0, (x0 + x1) / 2.0
            ry, rx = max((y1 - y0) / 2.0, 1.0), max((x1 - x0) / 2.0, 1.0)
            gy = ((np.arange(y0, y1, dtype=np.float32) - cy) / ry) ** 2
            gx = ((np.arange(x0, x1, dtype=np.float32) - cx) / rx) ** 2
            inside = (gy[:, None] + gx[None, :]) <= 1.0
            img[y0:y1, x0:x1][inside] = color
    tile = rng.normal(0.0, 18.0, (64, 64, 3)).astype(np.float32)
    reps = (h // 64 + 1, w // 64 + 1, 1)
    img += np.tile(tile, reps)[:h, :w]
    return np.clip(img, 0, 255).astype(np.uint8)


def write_coco_tree(mix: Dict, seed: int, root: str) -> Dict[str, str]:
    """Write the mix's images and `annotations.json` under `root` from
    `seed`; returns {"images": dir, "annotations": file}."""
    from PIL import Image

    rng = np.random.RandomState(seed % (2 ** 32))
    n = int(mix["images"])
    aspects = mix["aspects"]
    sizes = np.repeat(np.arange(len(aspects)), exact_counts([a[2] for a in aspects], n))
    rng.shuffle(sizes)
    counts = instance_counts(mix["instances"], n)
    rng.shuffle(counts)
    classes = area_classes(mix["area_split"], int(counts.sum()))
    rng.shuffle(classes)
    image_dir = os.path.join(root, "images")
    os.makedirs(image_dir, exist_ok=True)
    n_classes = int(mix["classes"])
    images, annotations, plan = [], [], []
    used = 0
    for i in range(n):
        w, h = int(aspects[sizes[i]][0]), int(aspects[sizes[i]][1])
        boxes = [_box(rng, int(k), w, h) for k in classes[used: used + counts[i]]]
        used += int(counts[i])
        labels = rng.randint(1, n_classes + 1, len(boxes))
        name = f"{i:06d}.jpg"
        plan.append((name, w, h, boxes, int(rng.randint(2 ** 31))))
        images.append(dict(id=i + 1, file_name=name, width=w, height=h))
        for box, label in zip(boxes, labels):
            annotations.append(dict(id=len(annotations) + 1, image_id=i + 1,
                                    category_id=int(label), bbox=box,
                                    area=box[2] * box[3], iscrowd=0))

    def write(item):
        name, w, h, boxes, paint_seed = item
        Image.fromarray(_paint(np.random.RandomState(paint_seed), w, h, boxes)).save(
            os.path.join(image_dir, name), quality=int(mix["jpeg_quality"]))

    with ThreadPoolExecutor(WRITERS) as pool:
        list(pool.map(write, plan))
    categories = [dict(id=k, name=f"class_{k}") for k in range(1, n_classes + 1)]
    ann_file = os.path.join(root, "annotations.json")
    with open(ann_file, "w") as f:
        json.dump(dict(images=images, annotations=annotations, categories=categories), f)
    return {"images": image_dir, "annotations": ann_file}
