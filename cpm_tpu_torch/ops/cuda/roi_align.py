"""Single-level RoIAlign: the CUDA forward kernel and its wrapper.

Replaces the TPU kernel of cpm_tpu/ops/pallas/roi_align_pallas.py:
`roi_align_pallas_fwd`, the forward of `roi_align_tpu`. The kernel,
cpm_tpu_torch/csrc/roi_align.cu, computes that function exactly (not
aligned, no mask, float32 in and out: a bf16 map is cast by this wrapper, as
the TPU wrapper does) and reads only the four cells of each sample; what
bounds it on the H100 is the bytes of its output. It is the multilevel
forward's loop (csrc/roi_align_forward.cuh) at one level, and gives the
multilevel forward's bits on a one-level map with every roi valid.

In the JAX package the backward of `roi_align_tpu` is XLA's autodiff of the
gather formulation. Here it is the multilevel backward kernel
(`ops/cuda/multilevel_roi_align.py::KERNEL.backward`) called with this one
level: it takes its cells and weights from the same device functions as this
forward, so it is the forward's exact transpose, and it stays on the card.
It is handed the caller's roi mask, so that a masked row adds nothing to
the map's gradient, whatever its box (a padding row's may be non-finite).

`roi_align_cuda` dispatches on where the tensors lie: on the CPU it runs the
plain version (`ops/roi_align.py::roi_align` on the float32 map), through
which autograd differentiates by itself; on a CUDA device it launches the
kernels or raises. `KERNEL.launches` counts the forward launches.
"""

import ctypes

import torch

from cpm_tpu_torch.ops.cuda import _build
from cpm_tpu_torch.ops.cuda import multilevel_roi_align as multilevel_op
from cpm_tpu_torch.ops.roi_align import roi_align as plain_roi_align

SOURCE = _build.CSRC / "roi_align.cu"


class RoIAlignKernel:
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
            lib.cpm_roi_align_fwd.argtypes = [
                vp, ci, ci, ci, ci, ctypes.c_float, vp, ci, ci, ci, ci, vp, vp,
            ]
            lib.cpm_roi_align_fwd.restype = ci
            self._lib = lib
        return self._lib

    def __call__(self, features: torch.Tensor, rois: torch.Tensor, output_size,
                 spatial_scale: float, sampling_ratio: int = 0) -> torch.Tensor:
        """Launch the forward kernel: features `[B, H, W, C]` float32 and
        rois `[R, 5]` float32 on the card -> `[R, ph, pw, C]` float32 (no
        autograd)."""
        ph, pw = (int(s) for s in output_size)
        sr = sampling_ratio if sampling_ratio > 0 else 2
        dev = rois.device
        if dev.type != "cuda":
            raise ValueError(f"the kernel takes CUDA tensors, got {dev}")
        num_rois = int(rois.shape[0])
        if rois.dtype != torch.float32 or rois.shape != (num_rois, 5) or not rois.is_contiguous():
            raise ValueError("rois must be contiguous float32 [R, 5]")
        if features.dtype != torch.float32:
            raise TypeError(f"features must be float32, got {features.dtype}")
        if features.dim() != 4 or features.device != dev:
            raise ValueError("features must be [B, H, W, C] on the rois' device")
        if not features.is_contiguous() or features.data_ptr() % 16:
            raise ValueError("features must be contiguous NHWC, 16-byte aligned")
        batch, height, width, channels = (int(d) for d in features.shape)
        if channels % 4:
            raise ValueError(f"C={channels} must be a multiple of 4")
        out = torch.empty((num_rois, ph, pw, channels), dtype=torch.float32, device=dev)
        if num_rois == 0:
            return out
        lib = self.build()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.cpm_roi_align_fwd(
                features.data_ptr(), batch, height, width, channels, float(spatial_scale),
                rois.data_ptr(), num_rois, ph, pw, sr, out.data_ptr(), stream,
            )
        if err != 0:
            raise RuntimeError(f"RoIAlign launch failed: cudaError {err}")
        self.launches += 1
        return out


KERNEL = RoIAlignKernel()


class _RoIAlign(torch.autograd.Function):
    """The single-level forward kernel and the multilevel backward kernel at
    one level as one differentiable op over the map."""

    @staticmethod
    def forward(ctx, features, rois, valid, output_size, spatial_scale, sampling_ratio):
        ctx.save_for_backward(rois, valid)
        ctx.shape = tuple(features.shape)
        ctx.args = ((float(spatial_scale),), sampling_ratio, False)
        return KERNEL(features, rois, output_size, spatial_scale, sampling_ratio)

    @staticmethod
    def backward(ctx, g):
        rois, valid = ctx.saved_tensors
        levels = torch.zeros(rois.shape[0], dtype=torch.int32, device=rois.device)
        (grad,) = multilevel_op.KERNEL.backward([ctx.shape], rois, levels, valid,
                                                g.contiguous(), *ctx.args)
        return grad, None, None, None, None, None


def roi_align_cuda(features: torch.Tensor, rois: torch.Tensor, output_size,
                   spatial_scale: float, sampling_ratio: int = 0,
                   roi_mask: torch.Tensor = None) -> torch.Tensor:
    """RoIAlign over one `[B, H, W, C]` map (f32 or bf16) -> `[R, ph, pw, C]`
    float32: not aligned; the forward pools every roi. CPU tensors take the
    plain version; CUDA tensors take the kernel, and the multilevel backward
    kernel when the map requires a gradient, where the rows `roi_mask` [R]
    clears (default none) add nothing."""
    features = features.float()
    rois = rois.float().contiguous()
    if rois.device.type == "cpu":
        return plain_roi_align(features, rois, output_size, spatial_scale, sampling_ratio)
    if rois.device.type != "cuda":
        raise ValueError(f"no RoIAlign for device {rois.device}")
    if torch.is_grad_enabled() and features.requires_grad:
        if roi_mask is None:
            roi_mask = torch.ones(rois.shape[0], dtype=torch.bool, device=rois.device)
        return _RoIAlign.apply(features.contiguous(), rois, roi_mask.bool().contiguous(),
                               tuple(output_size), spatial_scale, sampling_ratio)
    return KERNEL(features.contiguous(), rois, output_size, spatial_scale, sampling_ratio)
