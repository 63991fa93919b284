"""The deformable-conv sampler: the CUDA kernels and their wrapper.

Replaces the TPU kernel tools/probe_dcn_pallas_sampler.py::pallas_sample, the
per-sample formulation of cpm_tpu/ops/deform_conv.py::_bilinear_gather, and
that function's hand-written backward. The kernels,
cpm_tpu_torch/csrc/deform_sample.cu, are CUDA C++ for sm_90a with plain C
entry points, built into `build/cpm_tpu_torch/` at first use
(ops/cuda/_build.py) and bound with ctypes. A `torch.autograd.Function` pairs
them.

What bounds both on the H100 is bytes: the forward writes K*K = 9 times the
map's bytes and the backward reads as many, one multiply-add an element. The
forward reads only the cells of non-zero weight, a warp per sample with
16-byte loads along C. The backward adds into one zero-filled float32
accumulator of the map's shape through float4 atomics, cast to the map's
dtype once; the atomics' order changes from run to run, so two backward runs
agree to float32 rounding of each cell's sum, not to the bit. The coordinate
gradients come from a warp reduction over C per sample.

`deform_sample_cuda` launches the kernels or raises; the CPU path and the
plain version are cpm_tpu_torch/ops/deform_conv.py::deform_sample_plain.
`KERNEL.launches` counts forward launches, `KERNEL.backward_launches`
backward ones.
"""

import ctypes

import torch

from cpm_tpu_torch.ops.cuda import _build

SOURCE = _build.CSRC / "deform_sample.cu"
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check(feat, ys, xs):
    """Raise unless the tensors are what the kernels take. Returns
    (B, H, W, C, P)."""
    dev = feat.device
    if dev.type != "cuda":
        raise ValueError(f"the kernels take CUDA tensors, got {dev}")
    if feat.dtype not in DTYPE_CODES:
        raise TypeError(f"feat must be float32 or bfloat16, got {feat.dtype}")
    if feat.dim() != 4 or not feat.is_contiguous() or feat.data_ptr() % 16:
        raise ValueError("feat must be contiguous NHWC [B, H, W, C], 16-byte aligned")
    b, h, w, c = (int(d) for d in feat.shape)
    vec = 16 // feat.element_size()
    if c % vec:
        raise ValueError(f"C={c} must be a multiple of {vec} for {feat.dtype}")
    for name, t in (("ys", ys), ("xs", xs)):
        if t.dtype != torch.float32 or t.device != dev or t.dim() != 2 or t.shape[0] != b:
            raise ValueError(f"{name} must be float32 [B, P] on feat's device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if ys.shape != xs.shape:
        raise ValueError("ys and xs must have one shape")
    return b, h, w, c, int(ys.shape[1])


class DeformSampleKernel:
    """The built kernel library, its launch counts and its build record."""

    def __init__(self):
        self.launches = 0
        self.backward_launches = 0
        self.built = None
        self._lib = None

    def build(self):
        """Compile the source unless a build of the same source, header and
        flags exists, then load it. Returns the ctypes library."""
        if self._lib is None:
            lib, self.built = _build.load_library(SOURCE)
            vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.cpm_deform_sample_fwd.argtypes = [vp, ci, ci, ci, ci, vp, vp, cl, ci, vp, vp]
            lib.cpm_deform_sample_bwd.argtypes = [
                vp, ci, ci, ci, ci, vp, vp, vp, cl, ci, vp, vp, vp, vp,
            ]
            lib.cpm_deform_sample_fwd.restype = lib.cpm_deform_sample_bwd.restype = ci
            self._lib = lib
        return self._lib

    def __call__(self, feat: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
        """Launch the forward kernel: feat `[B, H, W, C]` (f32 or bf16), ys /
        xs `[B, P]` f32, all on the card -> `[B, P, C]` in feat's dtype (no
        autograd)."""
        b, h, w, c, p = _check(feat, ys, xs)
        out = torch.empty((b, p, c), dtype=feat.dtype, device=feat.device)
        if p == 0:
            return out
        lib = self.build()
        with torch.cuda.device(feat.device):
            stream = torch.cuda.current_stream(feat.device).cuda_stream
            err = lib.cpm_deform_sample_fwd(
                feat.data_ptr(), b, h, w, c, ys.data_ptr(), xs.data_ptr(), p,
                DTYPE_CODES[feat.dtype], out.data_ptr(), stream,
            )
        if err != 0:
            raise RuntimeError(f"deform sample forward launch failed: cudaError {err}")
        self.launches += 1
        return out

    def backward(self, feat: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor, g: torch.Tensor,
                 need_map: bool = True, need_coords: bool = True):
        """Launch the backward kernel: g `[B, P, C]` in feat's dtype ->
        (gradient to feat in its dtype or None, gys, gxs `[B, P]` f32 or
        None). The map's sums are taken in float32."""
        b, h, w, c, p = _check(feat, ys, xs)
        if g.dtype != feat.dtype or g.device != feat.device or tuple(g.shape) != (b, p, c):
            raise ValueError("g must be [B, P, C] of feat's dtype on its device")
        if not g.is_contiguous() or g.data_ptr() % 16:
            raise ValueError("g must be contiguous and 16-byte aligned")
        dev = feat.device
        acc = torch.zeros((b, h, w, c), dtype=torch.float32, device=dev) if need_map else None
        gys = torch.zeros((b, p), dtype=torch.float32, device=dev) if need_coords else None
        gxs = torch.zeros((b, p), dtype=torch.float32, device=dev) if need_coords else None
        if p > 0 and (need_map or need_coords):
            lib = self.build()
            with torch.cuda.device(dev):
                stream = torch.cuda.current_stream(dev).cuda_stream
                err = lib.cpm_deform_sample_bwd(
                    feat.data_ptr(), b, h, w, c, ys.data_ptr(), xs.data_ptr(), g.data_ptr(), p,
                    DTYPE_CODES[feat.dtype], acc.data_ptr() if need_map else None,
                    gys.data_ptr() if need_coords else None,
                    gxs.data_ptr() if need_coords else None, stream,
                )
            if err != 0:
                raise RuntimeError(f"deform sample backward launch failed: cudaError {err}")
            self.backward_launches += 1
        return (acc.to(feat.dtype) if need_map else None), gys, gxs


KERNEL = DeformSampleKernel()


class _DeformSample(torch.autograd.Function):
    """The forward and backward kernels as one differentiable op over the
    map and the coordinates."""

    @staticmethod
    def forward(ctx, feat, ys, xs):
        ctx.save_for_backward(feat, ys, xs)
        return KERNEL(feat, ys, xs)

    @staticmethod
    def backward(ctx, g):
        feat, ys, xs = ctx.saved_tensors
        need_map = ctx.needs_input_grad[0]
        need_coords = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        return KERNEL.backward(feat, ys, xs, g.contiguous(), need_map, need_coords)


def deform_sample_cuda(feat: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of feat `[B, H, W, C]` (f32 or bf16, on a card) at
    ys / xs `[B, P]` -> `[B, P, C]`: the forward kernel, and the backward
    kernel when the map or the coordinates require a gradient."""
    if feat.device.type != "cuda":
        raise ValueError(f"no deform sample kernel for device {feat.device}")
    feat = feat.contiguous()
    ys, xs = ys.float().contiguous(), xs.float().contiguous()
    if torch.is_grad_enabled() and (feat.requires_grad or ys.requires_grad or xs.requires_grad):
        return _DeformSample.apply(feat, ys, xs)
    return KERNEL(feat, ys, xs)
