"""The RPN's pre-NMS candidates on the card: the CUDA kernel and its wrapper.

Replaces no TPU kernel: in the JAX package XLA fuses each level's decode,
clip and size mask (cpm_tpu/modeling/rpn.py::select_proposals). In the
port's plain version, modeling/rpn.py::level_candidates_plain, each level
runs its own top-k, gathers, `BoxCoder.decode`, clip and mask, some fifty
PyTorch dispatches a level, with the card idle between them. Here
`rpn_candidates_cuda` sorts each level's scores (the plain version's own
sort, four dispatches a level) and one launch of the kernel,
cpm_tpu_torch/csrc/rpn_candidates.cu (CUDA C++ for sm_90a, a plain C entry
point, built into `build/cpm_tpu_torch/` at first use by ops/cuda/_build.py
and bound with ctypes), lays every level's top-k into a padded `[B, L, K]`
batch, decoded, clipped and masked as the plain version computes them,
operation by operation. It reads each level's sorted scores and indices,
deltas and anchors in place through a table of pointers: no concatenation.
What bounds it is latency: a few dozen bytes a slot.

`modeling/rpn.py::level_candidates` takes the plain version for CPU tensors
and this one for tensors on a card. `KERNEL.launches` counts launches.
"""

import ctypes

import numpy as np
import torch

from cpm_tpu_torch.ops.cuda import _build

SOURCE = _build.CSRC / "rpn_candidates.cu"
DELTA_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
SIZE_CODES = {torch.int32: 0, torch.int64: 1, torch.float32: 2}
MAX_LEVELS = 16


class RpnCandidatesKernel:
    """The built kernel library, its launch count and its build record."""

    def __init__(self):
        self.launches = 0
        self.built = None
        self._lib = None

    def build(self):
        """Compile the source unless a build of the same source and flags
        exists, then load it. Returns the ctypes library."""
        if self._lib is None:
            lib, self.built = _build.load_library(SOURCE)
            vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.cpm_rpn_candidates.argtypes = [
                vp, vp, vp, ci, vp, vp, vp, ci, vp, ci, ci, ci,
                cf, cf, cf, cf, cf, cf, vp, vp, vp, vp,
            ]
            lib.cpm_rpn_candidates.restype = ci
            self._lib = lib
        return self._lib

    def __call__(self, scores, order, deltas, anchors, image_sizes, level_k, box_coder,
                 min_size: float):
        """Launch the kernel. For each level: its scores sorted in descending
        order, ties in index order, `[B, N_l]` float32, their indices
        `[B, N_l]` int64, its deltas (the head's `[B, H, W, 4A]`, float32,
        bfloat16 or float64; N_l = H * W * A), its anchors `[N_l, 4]`
        float32 and its top-k size in level_k; image_sizes `[B, 2]` (h, w).
        Returns (boxes `[B, L, K, 4]` float32, scores `[B, L, K]` float32,
        valid `[B, L, K]` bool), K = max(level_k): slots past a level's k
        hold zeros and are invalid."""
        dev = image_sizes.device
        if dev.type != "cuda":
            raise ValueError(f"the kernel takes CUDA tensors, got {dev}")
        num_levels = len(anchors)
        if not 1 <= num_levels <= MAX_LEVELS or not (
                len(scores) == len(order) == len(deltas) == len(level_k) == num_levels):
            raise ValueError(f"1 to {MAX_LEVELS} levels, each with its scores, order, deltas, "
                             f"anchors and k")
        b = int(image_sizes.shape[0])
        level_anchors = [int(a.shape[0]) for a in anchors]
        if not all(1 <= k <= n for k, n in zip(level_k, level_anchors)):
            raise ValueError("each level's k must lie in [1, its anchors]")
        dtype = deltas[0].dtype
        if dtype not in DELTA_CODES:
            raise TypeError(f"deltas must be float32, bfloat16 or float64, got {dtype}")
        checks = [("image_sizes", image_sizes, tuple(SIZE_CODES), (b, 2))]
        for n, level_scores, level_order, level_deltas, level_anchors_t in zip(
                level_anchors, scores, order, deltas, anchors):
            checks += [("scores", level_scores, (torch.float32,), (b, n)),
                       ("order", level_order, (torch.int64,), (b, n)),
                       ("deltas", level_deltas, (dtype,), None),
                       ("anchors", level_anchors_t, (torch.float32,), (n, 4))]
            if level_deltas.shape[0] != b or level_deltas.numel() != 4 * b * n:
                raise ValueError(f"a level's deltas must hold [B, {n}, 4], got "
                                 f"{tuple(level_deltas.shape)}")
        for name, t, dtypes, shape in checks:
            if (t.dtype not in dtypes or (shape is not None and tuple(t.shape) != shape)
                    or t.device != dev or not t.is_contiguous()):
                raise ValueError(f"{name} must be contiguous {shape or ''} of {dtypes} on the "
                                 "card")
        k = max(level_k)
        boxes = torch.empty((b, num_levels, k, 4), dtype=torch.float32, device=dev)
        out_scores = torch.empty((b, num_levels, k), dtype=torch.float32, device=dev)
        valid = torch.empty((b, num_levels, k), dtype=torch.bool, device=dev)
        # PyTorch on CUDA divides by a Python number as a product with its
        # float32 reciprocal; BoxCoder.decode divides by its weights so
        inv = [float(np.float32(1.0) / np.float32(w)) for w in box_coder.weights]
        lib = self.build()
        ptrs = ctypes.c_void_p * num_levels
        ints = ctypes.c_int * num_levels
        with torch.cuda.device(dev):
            err = lib.cpm_rpn_candidates(
                ptrs(*(t.data_ptr() for t in scores)), ptrs(*(t.data_ptr() for t in order)),
                ptrs(*(t.data_ptr() for t in deltas)), DELTA_CODES[dtype],
                ptrs(*(t.data_ptr() for t in anchors)), ints(*level_anchors), ints(*level_k),
                num_levels, image_sizes.data_ptr(), SIZE_CODES[image_sizes.dtype], b, k, *inv,
                float(box_coder.bbox_xform_clip), float(min_size), boxes.data_ptr(),
                out_scores.data_ptr(), valid.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream,
            )
        if err != 0:
            raise RuntimeError(f"RPN candidates launch failed: cudaError {err}")
        self.launches += 1
        return boxes, out_scores, valid


KERNEL = RpnCandidatesKernel()


def rpn_candidates_cuda(anchors, objectness, box_regression, image_sizes, pre_nms_top_n: int,
                        min_size: float, box_coder):
    """`modeling/rpn.py::level_candidates` for tensors on a card: anchors a
    `[N_l, 4]` tensor a level, the per-level NHWC head outputs. Each level's
    scores are sorted as `ops/nms.py::topk` sorts them, then the kernel takes
    every level's first k in one launch."""
    b = image_sizes.shape[0]
    scores, order = [], []
    for obj in objectness:
        s = torch.sigmoid(obj.reshape(b, -1).float())
        vals, idx = torch.sort(s, dim=1, descending=True, stable=True)
        scores.append(vals)
        order.append(idx)
    if image_sizes.dtype not in SIZE_CODES:
        image_sizes = image_sizes.float()
    level_k = [min(pre_nms_top_n, int(a.shape[0])) for a in anchors]
    return KERNEL(scores, order, [r.contiguous() for r in box_regression], anchors,
                  image_sizes.contiguous(), level_k, box_coder, min_size)
