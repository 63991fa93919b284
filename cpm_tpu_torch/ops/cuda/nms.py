"""Greedy NMS on the card: the CUDA kernels and their wrapper.

Replaces no TPU kernel: the JAX package's NMS (cpm_tpu/ops/nms.py::nms) is
a fixed point inside a `lax.while_loop`, which stays on the TPU. Its plain
port, cpm_tpu_torch/ops/nms.py::greedy_nms, tests convergence from the host
after every round, so on a card each round was a round trip with the card
idle behind it: 32 of them in a flagship eval request and 31 in a batch-2
training step. The kernels, cpm_tpu_torch/csrc/nms.cu, are CUDA C++ for
sm_90a with a plain C entry point, built into `build/cpm_tpu_torch/` at
first use (ops/cuda/_build.py) and bound with ctypes. Over every row of a
batch of score-sorted boxes at once, one launch writes the overlap bitmask
(bit j of box i: iou(i, j) > threshold, for j after i, both valid; N^2/8
bytes a row) and one sweeps each row in order, one block a row, the
removed set in shared memory, writing the kept boxes' indices straight into
the output slots. What bounds it is latency: the sweep's chain of
ceil(N/64) steps a row; the mask is written once and read at most once.

The kernels' IoU is structures/boxes.py::box_iou operation for operation in
the boxes' dtype (float32, bfloat16 or float64), so that the kept set is
the fixed point's bit for bit, at an IoU one ulp either side of the
threshold too. `ops/nms.py::nms` sorts the boxes (`sort_by_score`, the
plain version's own sort) and calls `KERNEL` for tensors on a card; CPU
tensors take the plain version. `KERNEL.launches` counts the calls that
launched the kernels (two launches each).
"""

import ctypes
import functools
import math

import torch

from cpm_tpu_torch.ops.cuda import _build

SOURCE = _build.CSRC / "nms.cu"
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
CHUNK = 64  # boxes a mask word covers


@functools.lru_cache(maxsize=64)
def _in_dtype(x: float, dtype: torch.dtype) -> float:
    """x as a value of dtype: what PyTorch compares an IoU of that dtype
    with, when the threshold is a Python number."""
    return torch.tensor(x, dtype=dtype).item()


class NmsKernel:
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
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.cpm_nms.argtypes = [vp, vp, vp, ctypes.c_longlong, ci, ci, ctypes.c_double,
                                    ctypes.c_double, ci, ci, vp, vp, vp, vp]
            lib.cpm_nms.restype = ci
            self._lib = lib
        return self._lib

    def __call__(self, boxes: torch.Tensor, valid: torch.Tensor, order, iou_threshold: float,
                 max_output: int, legacy_plus1: bool = False):
        """Greedy NMS over rows of boxes `[..., N, 4]` sorted by descending
        score along N, with validity `[..., N]` bool and `order` `[..., N]`
        int64 (each sorted box's index in the caller's input; None for the
        identity), all on the card -> (indices `[..., max_output]` int64
        through `order`, keep `[..., max_output]` bool): kept boxes first in
        sorted order, then index 0 and keep False."""
        dev = boxes.device
        if dev.type != "cuda":
            raise ValueError(f"the kernels take CUDA tensors, got {dev}")
        if boxes.dtype not in DTYPE_CODES:
            raise TypeError(f"boxes must be float32, bfloat16 or float64, got {boxes.dtype}")
        if boxes.dim() < 2 or boxes.shape[-1] != 4 or not boxes.is_contiguous():
            raise ValueError("boxes must be contiguous [..., N, 4]")
        lead, n = boxes.shape[:-2], int(boxes.shape[-2])
        for name, t, dtype in (("valid", valid, torch.bool), ("order", order, torch.int64)):
            if t is None and name == "order":
                continue
            if (t is None or t.dtype != dtype or t.shape != boxes.shape[:-1] or t.device != dev
                    or not t.is_contiguous()):
                raise ValueError(f"{name} must be contiguous {dtype} {tuple(boxes.shape[:-1])} "
                                 "on the boxes' device")
        if max_output < 0:
            raise ValueError(f"max_output must be at least 0, got {max_output}")
        out_index = torch.empty((*lead, max_output), dtype=torch.int64, device=dev)
        out_keep = torch.empty((*lead, max_output), dtype=torch.bool, device=dev)
        rows = math.prod(lead)
        if rows == 0 or max_output == 0:
            return out_index, out_keep
        if n == 0:
            return out_index.zero_(), out_keep.zero_()
        mask = torch.empty(rows * n * -(-n // CHUNK), dtype=torch.int64, device=dev)
        lib = self.build()
        with torch.cuda.device(dev):
            err = lib.cpm_nms(
                boxes.data_ptr(), valid.data_ptr(), None if order is None else order.data_ptr(),
                rows, n, DTYPE_CODES[boxes.dtype], _in_dtype(float(iou_threshold), boxes.dtype),
                torch.finfo(boxes.dtype).tiny, int(bool(legacy_plus1)), int(max_output),
                mask.data_ptr(), out_index.data_ptr(), out_keep.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream,
            )
        if err != 0:
            raise RuntimeError(f"NMS launch failed: cudaError {err}")
        self.launches += 1
        return out_index, out_keep


KERNEL = NmsKernel()
