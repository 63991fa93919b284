"""Deterministic synthetic detection batches for tests and smoke runs.

Port of cpm_tpu/data/synthetic.py (numpy only; the same draws from the same
seed). Batches come in the canonical layout:
  images [B, H, W, 3] float32 (already normalized) or uint8 (raw pixels),
  image_sizes [B, 2] int32 (h, w),
  gt_boxes [B, G, 4] xyxy, gt_labels [B, G] int32 (1-based),
  gt_mask [B, G] bool.
"""

import numpy as np


def synthetic_batch(
    batch_size: int = 2,
    height: int = 512,
    width: int = 512,
    max_gt: int = 16,
    num_classes: int = 81,
    seed: int = 0,
    uint8: bool = False,
):
    """One batch from `seed`. With `uint8` the images are raw pixels for the
    model's on-device normalization (drawn after everything else, so the
    boxes and labels are those of the float batch of the same seed)."""
    rng = np.random.RandomState(seed)
    images = rng.randn(batch_size, height, width, 3).astype(np.float32)
    sizes = np.tile(np.array([[height, width]], np.int32), (batch_size, 1))
    n_gt = rng.randint(1, max_gt + 1, size=batch_size)
    boxes = np.zeros((batch_size, max_gt, 4), np.float32)
    labels = np.zeros((batch_size, max_gt), np.int32)
    mask = np.zeros((batch_size, max_gt), bool)
    for b in range(batch_size):
        k = n_gt[b]
        x1 = rng.uniform(0, width * 0.7, k)
        y1 = rng.uniform(0, height * 0.7, k)
        w = rng.uniform(8, width * 0.3, k)
        h = rng.uniform(8, height * 0.3, k)
        boxes[b, :k, 0] = x1
        boxes[b, :k, 1] = y1
        boxes[b, :k, 2] = np.minimum(x1 + w, width - 1)
        boxes[b, :k, 3] = np.minimum(y1 + h, height - 1)
        labels[b, :k] = rng.randint(1, num_classes, k)
        mask[b, :k] = True
    if uint8:
        images = rng.randint(0, 256, images.shape, dtype=np.uint8)
    return dict(
        images=images,
        image_sizes=sizes,
        gt_boxes=boxes,
        gt_labels=labels,
        gt_mask=mask,
    )
