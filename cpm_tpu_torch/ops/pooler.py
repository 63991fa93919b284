"""Multi-level FPN RoI pooling.

Port of cpm_tpu/ops/pooler.py. Level assignment is the Detectron rule
`k = floor(k0 + log2(sqrt(area)/s0 + eps))` clamped to [k_min, k_max],
with the degenerate-box clamp.

The pooling backend is set from `cfg.TPU.POOLER_KERNEL` by `build_model`
(`set_pooler_backend`), with the JAX package's five names. Each names a
formulation of the same function, with its own hand-written CUDA kernels on
the card and its own plain PyTorch version on the CPU:

| name | on a CUDA device | on the CPU |
| --- | --- | --- |
| `auto`, `pallas`, `gather` | ops/cuda/multilevel_roi_align.py: forward and backward kernels | `ops/roi_align.py::multilevel_roi_align` |
| `stacked` | ops/cuda/stacked_roi_align.py: forward and backward over one stacked buffer | `multilevel_roi_align_stacked_plain` |
| `clustered` | ops/cuda/clustered_roi_align.py: grouped forward, multilevel backward | `multilevel_roi_align_clustered_plain` |

(`pallas` is the JAX package's name for its default TPU kernel, whose
counterpart here is the multilevel kernel; `gather` names its XLA path, which
on the card has no kernel of its own and keeps the multilevel kernels.) A
pooler over ONE level (`len(features) == 1`) goes to the single-level op,
ops/cuda/roi_align.py, whatever the backend, as the JAX pooler's one-level
branch does.

None of the port's kernels reads a fixed window of cells, so they are exact
for every roi shape: the JAX pooler's `pallas_supported` shape check,
`window_overflow_mask` and tiered overflow patch have no counterpart.
"""

import contextlib
import contextvars
import math
from typing import Sequence

import torch

from cpm_tpu_torch.ops.cuda import clustered_roi_align as clustered_op
from cpm_tpu_torch.ops.cuda import multilevel_roi_align as roi_align_op
from cpm_tpu_torch.ops.cuda import roi_align as single_level_op
from cpm_tpu_torch.ops.cuda import stacked_roi_align as stacked_op
from cpm_tpu_torch.structures.boxes import box_area

POOLER_BACKENDS = ("auto", "pallas", "stacked", "clustered", "gather")
_BACKEND = "auto"


def set_pooler_backend(name: str):
    """Select the pooling formulation for every Pooler of the process, as
    cpm_tpu/ops/pooler.py::set_pooler_backend does."""
    global _BACKEND
    if name not in POOLER_BACKENDS:
        raise ValueError(f"pooler backend must be one of {POOLER_BACKENDS}, got {name!r}")
    _BACKEND = name


def get_pooler_backend() -> str:
    return _BACKEND


def _resolve_backend() -> str:
    """The formulation that pools under the current backend: 'stacked',
    'clustered' or, for auto, pallas and gather, 'multilevel'."""
    return _BACKEND if _BACKEND in ("stacked", "clustered") else "multilevel"


# When True (scoped by GeneralizedRCNN.forward under
# TPU.EVAL_POOLER_DTYPE='float32'), pooling runs in f32 whatever the
# feature dtype and casts back. A ContextVar, so that a forward on another
# thread sees its own setting.
_FORCE_F32 = contextvars.ContextVar("cpm_torch_pooler_force_f32", default=False)


@contextlib.contextmanager
def pooler_force_f32_scope(flag: bool):
    """Pin (or unpin) f32 pooling within the scope."""
    token = _FORCE_F32.set(bool(flag))
    try:
        yield
    finally:
        _FORCE_F32.reset(token)


def one_stack_per_forward():
    """Within the scope (GeneralizedRCNN.forward), the stacked backend's
    pooler calls on one set of FPN maps share one stack
    (ops/cuda/stacked_roi_align.py::STACKS); nothing is kept after it."""
    return stacked_op.STACKS.scope()


def assign_fpn_levels(
    boxes: torch.Tensor,
    k_min: int,
    k_max: int,
    canonical_scale: int = 224,
    canonical_level: int = 4,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Per-roi FPN level in [k_min, k_max] (int32) for xyxy boxes [..., 4].

    Degenerate boxes (x2 < x1, e.g. from grid decode of untrained heatmaps)
    have a negative plus-one area; the clamp pins them to k_min instead of
    taking the square root of a negative number.
    """
    scale = torch.sqrt(torch.clamp(box_area(boxes, legacy_plus1=True), min=0.0))
    lvl = torch.floor(canonical_level + torch.log2(scale / canonical_scale + eps))
    return torch.clamp(lvl, k_min, k_max).to(torch.int32)


class Pooler:
    """RoIAlign across FPN levels with on-device level selection.

    Args:
      output_size: (ph, pw).
      scales: per-level spatial scales, e.g. (1/4, 1/8, 1/16, 1/32).
      sampling_ratio: samples per bin per axis; 0 means a static 2.
    """

    def __init__(
        self,
        output_size,
        scales: Sequence[float],
        sampling_ratio: int = 0,
        canonical_scale: int = 224,
        canonical_level: int = 4,
    ):
        self.output_size = tuple(output_size)
        self.scales = tuple(scales)
        self.sampling_ratio = sampling_ratio
        self.k_min = int(-math.log2(self.scales[0]))
        self.k_max = int(-math.log2(self.scales[-1]))
        self.canonical_scale = canonical_scale
        self.canonical_level = canonical_level

    def __call__(
        self,
        features: Sequence[torch.Tensor],
        rois: torch.Tensor,
        roi_mask: torch.Tensor = None,
    ) -> torch.Tensor:
        """Pool per-roi features.

        Args:
          features: list of [B, H_l, W_l, C], finest first (P2..P5).
          rois: [R, 5] (batch_index, x1, y1, x2, y2).
          roi_mask: [R] validity; invalid rois produce zeros.

        Returns: [R, ph, pw, C] in the feature dtype.
        """
        if len(features) != len(self.scales):
            raise ValueError(f"{len(features)} levels for {len(self.scales)} scales")
        out_dtype = features[0].dtype
        if _FORCE_F32.get() and out_dtype != torch.float32:
            # f32 accumulation and output; the caller gets its dtype back
            features = [f.float() for f in features]
            return self(features, rois, roi_mask).to(out_dtype)
        rois = rois.float().contiguous()
        if roi_mask is None:
            roi_mask = torch.ones(rois.shape[0], dtype=torch.bool, device=rois.device)
        roi_mask = roi_mask.bool()
        if len(features) == 1:
            out = single_level_op.roi_align_cuda(
                features[0], rois, self.output_size, self.scales[0], self.sampling_ratio,
                roi_mask=roi_mask,
            ).to(out_dtype)
            # the one-level forward kernel has no mask: where, not a product,
            # so that a masked roi's garbage box cannot leave a NaN behind;
            # its backward takes the mask
            return torch.where(roi_mask[:, None, None, None], out, torch.zeros_like(out))
        levels = assign_fpn_levels(
            rois[:, 1:5], self.k_min, self.k_max,
            self.canonical_scale, self.canonical_level,
        ) - self.k_min
        op = {
            "multilevel": roi_align_op.multilevel_roi_align,
            "stacked": stacked_op.multilevel_roi_align_stacked,
            "clustered": clustered_op.multilevel_roi_align_clustered,
        }[_resolve_backend()]
        return op(
            list(features), rois, levels, roi_mask, self.output_size,
            self.scales, self.sampling_ratio,
        )
