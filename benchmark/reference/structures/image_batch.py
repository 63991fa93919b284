"""Padded image batches.

Port of cpm_tpu/structures/image_batch.py: one NHWC float batch, padded with
zeros, with each image's true (height, width) beside it. The loaders pad on
the host to a bucket shape with `round_up`; `pad_to_divisibility` does it for
a list of images. This module imports torch only where it makes tensors, so
that the numpy loaders can use `round_up`.
"""

import dataclasses
from typing import TYPE_CHECKING, Tuple

import numpy as np

if TYPE_CHECKING:
    import torch


@dataclasses.dataclass
class ImageBatch:
    """images: [B, H, W, C] float tensor (NHWC, zero padding);
    sizes: [B, 2] int32 tensor of true (height, width)."""

    images: "torch.Tensor"
    sizes: "torch.Tensor"

    @property
    def padded_hw(self) -> Tuple[int, int]:
        return self.images.shape[1], self.images.shape[2]


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_to_divisibility(images, divisibility: int = 32, target_hw=None,
                        device="cuda") -> ImageBatch:
    """A list of HWC numpy images as one zero-padded NHWC batch on
    `device`: padded to `target_hw` (a bucket shape) when given, else to the
    largest size rounded up to `divisibility`."""
    import torch

    sizes = np.array([im.shape[:2] for im in images], dtype=np.int32)
    if target_hw is None:
        h = round_up(int(sizes[:, 0].max()), divisibility)
        w = round_up(int(sizes[:, 1].max()), divisibility)
    else:
        h, w = target_hw
    out = np.zeros((len(images), h, w, images[0].shape[2]), dtype=np.float32)
    for i, im in enumerate(images):
        out[i, : im.shape[0], : im.shape[1]] = im
    return ImageBatch(images=torch.from_numpy(out).to(device),
                      sizes=torch.from_numpy(sizes).to(device))
