"""Cross-roi shared-window RoIAlign: the CUDA forward kernel and its wrapper.

Replaces the TPU kernel of tools/probe_pooler_crossroi.py (`make_probe`): a
single-level RoIAlign in which the G rois of step i all pool from the 64x64
window of roi i. The kernel, cpm_tpu_torch/csrc/crossroi_roi_align.cu, is a
gather through L1: a step's members are pooled bin by bin in the fewest
blocks that hold them, each block staging their axis samples once and
reading the leader's window cells straight from the map; what bounds it on
the H100 is the bytes of the map cells the members weigh and of its output. No model runs it: like the
probe, it measures what sharing a window across rois could save, through
cpm_tpu_torch/tools/probe_pooler_crossroi.py. It has no backward, as the
probe has none.

`crossroi_roi_align` dispatches on where the tensors lie: on the CPU it runs
the plain version (`ops/roi_align.py::crossroi_roi_align_plain`); on a CUDA
device it launches the kernel or raises. `KERNEL.launches` counts the
launches.
"""

import ctypes

import torch

from cpm_tpu_torch.ops.cuda import _build
from cpm_tpu_torch.ops.roi_align import (
    CROSSROI_WINDOW,
    WindowedRois,
    crossroi_prep_rois,
    crossroi_roi_align_plain,
)

SOURCE = _build.CSRC / "crossroi_roi_align.cu"
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# a step's staged axis samples, 16 bytes each, fit the 48 KB a block has
STAGED_BYTES = 48 * 1024


class CrossRoiKernel:
    """The built kernel library, its launch count and its build record."""

    def __init__(self):
        self.launches = 0
        self.built = None
        self._lib = None

    def build(self):
        """Compile the source unless a build of the same source, header and
        flags exists, then load it. Returns the ctypes library."""
        if self._lib is None:
            lib, self.built = _build.load_library(SOURCE)
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.cpm_crossroi_roi_align_fwd.argtypes = [
                vp, ci, ci, ci, ci, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, vp, vp,
            ]
            lib.cpm_crossroi_roi_align_fwd.restype = ci
            self._lib = lib
        return self._lib

    def __call__(self, features: torch.Tensor, prep: WindowedRois, group: int, output_size,
                 sampling_ratio: int = 2) -> torch.Tensor:
        """Launch the kernel: features `[B, H, W, C]` (f32 or bf16) and the
        prepared rois on the card -> `[R, ph, pw, C]` in the features' dtype."""
        ph, pw = (int(s) for s in output_size)
        sr, group, window = int(sampling_ratio), int(group), CROSSROI_WINDOW
        dev = features.device
        if dev.type != "cuda":
            raise ValueError(f"the kernel takes CUDA tensors, got {dev}")
        if features.dtype not in DTYPE_CODES:
            raise TypeError(f"features must be float32 or bfloat16, got {features.dtype}")
        if features.dim() != 4 or not features.is_contiguous() or features.data_ptr() % 16:
            raise ValueError("features must be contiguous NHWC [B, H, W, C], 16-byte aligned")
        b, h, w, c = (int(d) for d in features.shape)
        if c % (16 // features.element_size()):
            raise ValueError(f"C={c} must fill 16-byte vectors of {features.dtype}")
        if h < window or w < window:
            raise ValueError(f"the map {h}x{w} must hold a {window}x{window} window")
        if window * w * c >= 2**31:
            raise ValueError(f"a window's rows of a {w}x{c} map exceed 32-bit offsets")
        n = int(prep.batch.shape[0])
        if group < 1 or n % group:
            raise ValueError(f"{n} rois do not fill groups of {group}")
        if group * (ph + pw) * sr * 16 > STAGED_BYTES:
            raise ValueError(f"{group} members' {(ph + pw) * sr} axis samples each exceed "
                             f"{STAGED_BYTES} bytes of shared memory")
        for name, t, shape, dtype in (
            ("batch", prep.batch, (n,), torch.int32), ("y0", prep.y0, (n,), torch.int32),
            ("x0", prep.x0, (n,), torch.int32), ("ys", prep.ys, (n, ph * sr), torch.float32),
            ("xs", prep.xs, (n, pw * sr), torch.float32),
        ):
            if t.dtype != dtype or tuple(t.shape) != shape or t.device != dev or not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous {dtype} {shape} on the features' device")
        out = torch.empty((n, ph, pw, c), dtype=features.dtype, device=dev)
        if n == 0:
            return out
        lib = self.build()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.cpm_crossroi_roi_align_fwd(
                features.data_ptr(), b, h, w, c, prep.batch.data_ptr(), prep.y0.data_ptr(),
                prep.x0.data_ptr(), prep.ys.data_ptr(), prep.xs.data_ptr(), n, group, window,
                ph, pw, sr, DTYPE_CODES[features.dtype], out.data_ptr(), stream,
            )
        if err != 0:
            raise RuntimeError(f"cross-roi RoIAlign launch failed: cudaError {err}")
        self.launches += 1
        return out


KERNEL = CrossRoiKernel()


def crossroi_roi_align(features: torch.Tensor, rois: torch.Tensor, group: int, output_size,
                       spatial_scale: float, sampling_ratio: int = 2) -> torch.Tensor:
    """RoIAlign over one `[B, H, W, C]` map with `group` rois per shared
    window (see the module docstring): rois `[R, 5]` -> `[R, ph, pw, C]`. CPU
    tensors take the plain version, CUDA tensors the kernel."""
    prep = crossroi_prep_rois(rois, spatial_scale, features.shape[1:3], output_size,
                              sampling_ratio)
    if features.device.type == "cpu":
        return crossroi_roi_align_plain(features, prep, group, output_size, sampling_ratio)
    prep = WindowedRois(*(t.contiguous() for t in prep))
    return KERNEL(features.contiguous(), prep, group, output_size, sampling_ratio)
