"""Multilevel FPN RoIAlign: the hand-written CUDA kernels and their wrapper.

Replaces the TPU kernels of cpm_tpu/ops/pallas/multilevel_pallas.py:
`multilevel_roi_align_pallas` (forward, `_fwd`) and its custom_vjp backward
(`_bwd` / `_bwd_kernel_body`). The kernels,
cpm_tpu_torch/csrc/multilevel_roi_align.cu, are CUDA C++ for sm_90a with
plain C entry points, built by one nvcc call into `build/cpm_tpu_torch/` at
first use (ops/cuda/_build.py) and bound with ctypes. A `torch.autograd.Function` pairs them.

What bounds it on the H100 is the bytes its bilinear gathers read from
L2/HBM, not FLOPs: one multiply-add per element read. The design keeps each
gather a full coalesced row: one CTA per roi (and C tile), threads along C
loading 16 bytes each with read-only loads, f32 accumulation, one store of
the feature dtype per output element. Masked rois write zeros and read
nothing. It takes none of the TPU kernel's window, so it is exact for every
roi aspect ratio and the JAX pooler's window-overflow patch has no
counterpart here.

The backward is the transpose of that gather: per valid roi, bin and sample,
`g / sr^2` times each bilinear weight belongs to the cell the forward read.
What bounds it on the H100 is again bytes: the level gradients written once
and the valid rois' rows of `g` read. It runs as a gather owned by tiles of
the gradient maps: one block per (level, image, tile of cells, channel
chunk) scans the rois in index order, keeps those whose samples reach its
tile, sums their shares in float32 in shared memory and writes the tile once,
in `g`'s dtype, straight into the per-level gradients this wrapper returns.
So there is no float32 accumulator of the maps' size, no fill and no cast,
and no atomics: every cell's sum runs in one fixed order and two backward
runs on the same inputs give the same bits. The TPU kernel accumulates in the
feature dtype (bf16 in training) to halve its DMA traffic; float32
accumulation is closer to the true sum and within one bf16 rounding of it.

`multilevel_roi_align` dispatches on where the tensors lie: on the CPU it
runs the plain PyTorch version (cpm_tpu_torch/ops/roi_align.py), through
which autograd differentiates by itself, so the plain version of the
backward kernel is autograd of the plain forward
(`plain_multilevel_roi_align_backward`); on a CUDA device it launches the
kernels or raises. `KERNEL.launches` counts forward launches,
`KERNEL.backward_launches` backward ones.
"""

import ctypes
from typing import Sequence

import torch

from cpm_tpu_torch.ops.cuda import _build
from cpm_tpu_torch.ops.roi_align import multilevel_roi_align as plain_multilevel_roi_align

SOURCE = _build.CSRC / "multilevel_roi_align.cu"
MAX_LEVELS = 5
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_rois(rois, levels, valid):
    """Raise unless rois / levels / valid are what the port's RoIAlign
    kernels take; returns contiguous levels and valid."""
    num_rois = int(rois.shape[0])
    dev = rois.device
    if dev.type != "cuda":
        raise ValueError(f"the kernels take CUDA tensors, got {dev}")
    if rois.dtype != torch.float32 or rois.shape != (num_rois, 5) or not rois.is_contiguous():
        raise ValueError("rois must be contiguous float32 [R, 5]")
    if levels.dtype != torch.int32 or levels.shape != (num_rois,) or levels.device != dev:
        raise ValueError("levels must be int32 [R] on the rois' device")
    if valid.dtype != torch.bool or valid.shape != (num_rois,) or valid.device != dev:
        raise ValueError("valid must be bool [R] on the rois' device")
    return levels.contiguous(), valid.contiguous()


def check_level_maps(features, dev):
    """Raise unless the level maps are what the kernels read: contiguous,
    16-byte aligned `[B, H_l, W_l, C]` on `dev`, of one dtype (f32 or bf16),
    sharing B and C, C filling 16-byte vectors. Returns (dtype, B, C)."""
    f0 = features[0]
    dtype = f0.dtype
    if dtype not in DTYPE_CODES:
        raise TypeError(f"features must be float32 or bfloat16, got {dtype}")
    if f0.dim() != 4:
        raise ValueError(f"levels must be [B, H, W, C], got {tuple(f0.shape)}")
    batch, channels = int(f0.shape[0]), int(f0.shape[3])
    vec = 16 // f0.element_size()
    if channels % vec:
        raise ValueError(f"C={channels} must be a multiple of {vec} for {dtype}")
    for f in features:
        if f.device != dev or f.dtype != dtype or f.dim() != 4:
            raise ValueError("levels must share the rois' device and one dtype")
        if f.shape[0] != batch or f.shape[3] != channels:
            raise ValueError("levels must share B and C")
        if not f.is_contiguous():
            raise ValueError("levels must be contiguous NHWC ([B, H, W, C])")
        if f.data_ptr() % 16:
            raise ValueError("levels must be 16-byte aligned")
    return dtype, batch, channels


class MultilevelRoIAlignKernel:
    """The built kernel library, its launch count and its build record."""

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
            vp, ci = ctypes.c_void_p, ctypes.c_int
            for fn in (lib.cpm_multilevel_roi_align_fwd, lib.cpm_multilevel_roi_align_bwd):
                fn.argtypes = [
                    vp, vp, vp, ci, ci, ci, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp, vp,
                ]
                fn.restype = ci
            self._lib = lib
        return self._lib

    def _launch(self, entry, level_tensors, rois, levels, valid, output_size,
                spatial_scales, sampling_ratio, aligned, dtype, data):
        """One launch of `entry` ('fwd' or 'bwd') on the current stream.
        level_tensors: the per-level maps the kernel reads (fwd) or adds
        into (bwd); data: the output (fwd) or the incoming gradient (bwd),
        of `dtype`."""
        ph, pw = output_size
        sr = sampling_ratio if sampling_ratio > 0 else 2
        num_levels = len(level_tensors)
        lib = self.build()
        fn = getattr(lib, f"cpm_multilevel_roi_align_{entry}")
        ptrs = (ctypes.c_void_p * num_levels)(*[f.data_ptr() for f in level_tensors])
        hw = (ctypes.c_int * (2 * num_levels))(
            *[int(d) for f in level_tensors for d in f.shape[1:3]]
        )
        scales = (ctypes.c_float * num_levels)(*[float(s) for s in spatial_scales])
        f0 = level_tensors[0]
        dev = rois.device
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(
                ctypes.addressof(ptrs), ctypes.addressof(hw),
                ctypes.addressof(scales), num_levels, int(f0.shape[0]),
                int(f0.shape[3]), rois.data_ptr(), levels.data_ptr(),
                valid.data_ptr(), int(rois.shape[0]), ph, pw, sr,
                int(bool(aligned)), DTYPE_CODES[dtype], data.data_ptr(), stream,
            )
        if err != 0:
            raise RuntimeError(f"multilevel RoIAlign {entry} launch failed: cudaError {err}")

    def __call__(
        self,
        features: Sequence[torch.Tensor],
        rois: torch.Tensor,
        levels: torch.Tensor,
        valid: torch.Tensor,
        output_size,
        spatial_scales: Sequence[float],
        sampling_ratio: int = 0,
        aligned: bool = False,
    ) -> torch.Tensor:
        """Launch the forward kernel on CUDA tensors (no autograd); see
        `multilevel_roi_align`."""
        ph, pw = (int(s) for s in output_size)
        num_levels = len(features)
        if not 1 <= num_levels <= MAX_LEVELS:
            raise ValueError(f"1..{MAX_LEVELS} levels supported, got {num_levels}")
        if len(spatial_scales) != num_levels:
            raise ValueError("one spatial scale per level is required")
        dev = rois.device
        dtype, _, channels = check_level_maps(features, dev)
        levels, valid = check_rois(rois, levels, valid)
        out = torch.empty((int(rois.shape[0]), ph, pw, channels), dtype=dtype, device=dev)
        if rois.shape[0] == 0:
            return out
        self._launch("fwd", features, rois, levels, valid, (ph, pw), spatial_scales,
                     sampling_ratio, aligned, dtype, out)
        self.launches += 1
        return out

    def backward(
        self,
        feature_shapes: Sequence[Sequence[int]],
        rois: torch.Tensor,
        levels: torch.Tensor,
        valid: torch.Tensor,
        g: torch.Tensor,
        spatial_scales: Sequence[float],
        sampling_ratio: int = 0,
        aligned: bool = False,
    ):
        """Launch the backward kernel: `g` `[R, ph, pw, C]` (contiguous, f32
        or bf16, on the card) -> one gradient `[B, H_l, W_l, C]` per level
        in g's dtype. The sums are taken in float32, in a fixed order."""
        num_levels = len(feature_shapes)
        if not 1 <= num_levels <= MAX_LEVELS:
            raise ValueError(f"1..{MAX_LEVELS} levels supported, got {num_levels}")
        if len(spatial_scales) != num_levels:
            raise ValueError("one spatial scale per level is required")
        dev, dtype = rois.device, g.dtype
        if dtype not in DTYPE_CODES:
            raise TypeError(f"g must be float32 or bfloat16, got {dtype}")
        shapes = [tuple(int(d) for d in s) for s in feature_shapes]
        batch, channels = shapes[0][0], shapes[0][3]
        if any(len(s) != 4 or s[0] != batch or s[3] != channels for s in shapes):
            raise ValueError("level shapes must be [B, H, W, C] sharing B and C")
        if g.device != dev or g.dim() != 4 or g.shape[0] != rois.shape[0] or g.shape[3] != channels:
            raise ValueError("g must be [R, ph, pw, C] on the rois' device")
        if not g.is_contiguous() or g.data_ptr() % 16:
            raise ValueError("g must be contiguous and 16-byte aligned")
        if channels % (16 // g.element_size()):
            raise ValueError(f"C={channels} must fill 16-byte vectors of {dtype}")
        levels, valid = check_rois(rois, levels, valid)
        # one buffer for all levels, in g's dtype, written whole by the kernel
        sizes = [s[0] * s[1] * s[2] * s[3] for s in shapes]
        if rois.shape[0] == 0:
            return [torch.zeros(s, dtype=dtype, device=dev) for s in shapes]
        grads = [a.view(s) for a, s in zip(
            torch.empty(sum(sizes), dtype=dtype, device=dev).split(sizes), shapes)]
        self._launch("bwd", grads, rois, levels, valid, tuple(g.shape[1:3]),
                     spatial_scales, sampling_ratio, aligned, dtype, g)
        self.backward_launches += 1
        return grads


KERNEL = MultilevelRoIAlignKernel()


class _MultilevelRoIAlign(torch.autograd.Function):
    """Forward kernel and backward kernel as one differentiable op over the
    level maps; rois, level ids and the mask get no gradient."""

    @staticmethod
    def forward(ctx, rois, levels, valid, output_size, spatial_scales,
                sampling_ratio, aligned, *features):
        ctx.save_for_backward(rois, levels, valid)
        ctx.feature_shapes = [tuple(f.shape) for f in features]
        ctx.args = (tuple(spatial_scales), sampling_ratio, aligned)
        return KERNEL(features, rois, levels, valid, output_size, spatial_scales,
                      sampling_ratio, aligned)

    @staticmethod
    def backward(ctx, g):
        rois, levels, valid = ctx.saved_tensors
        # the heads hand back gradients with the strides of their own views
        # (NHWC -> NCHW permutes, reshapes); the kernel reads packed rows
        grads = KERNEL.backward(ctx.feature_shapes, rois, levels, valid,
                                g.contiguous(), *ctx.args)
        return (None,) * 7 + tuple(grads)


def plain_multilevel_roi_align_backward(
    feature_shapes: Sequence[Sequence[int]],
    rois: torch.Tensor,
    levels: torch.Tensor,
    valid: torch.Tensor,
    g: torch.Tensor,
    spatial_scales: Sequence[float],
    sampling_ratio: int = 0,
    aligned: bool = False,
):
    """The plain version of the backward kernel: autograd of the plain
    forward. Returns one gradient `[B, H_l, W_l, C]` per level in g's dtype;
    masked rois add nothing. The forward is linear in the maps, so its
    gradient does not depend on their values and zeros stand in for them."""
    feats = [
        torch.zeros(tuple(s), dtype=g.dtype, device=g.device, requires_grad=True)
        for s in feature_shapes
    ]
    out = plain_multilevel_roi_align(
        feats, rois, levels, tuple(g.shape[1:3]), spatial_scales, sampling_ratio, aligned,
    )
    out = out * valid.to(out.dtype)[:, None, None, None]
    return list(torch.autograd.grad(out, feats, g))


def multilevel_roi_align(
    features: Sequence[torch.Tensor],
    rois: torch.Tensor,
    levels: torch.Tensor,
    valid: torch.Tensor,
    output_size,
    spatial_scales: Sequence[float],
    sampling_ratio: int = 0,
    aligned: bool = False,
) -> torch.Tensor:
    """Multilevel RoIAlign: `[B, H_l, W_l, C]` levels -> `[R, ph, pw, C]`.

    rois `[R, 5]` f32 (batch index, x1, y1, x2, y2), levels `[R]` int32
    level ids, valid `[R]` bool; rows of masked rois are zeros. CPU tensors
    take the plain PyTorch version; CUDA tensors take the kernels, the
    backward one when a level map requires a gradient.
    """
    if rois.device.type == "cpu":
        out = plain_multilevel_roi_align(
            features, rois, levels, output_size, spatial_scales,
            sampling_ratio, aligned,
        )
        return out * valid.to(out.dtype)[:, None, None, None]
    if rois.device.type != "cuda":
        raise ValueError(f"no multilevel RoIAlign for device {rois.device}")
    if torch.is_grad_enabled() and any(f.requires_grad for f in features):
        return _MultilevelRoIAlign.apply(
            rois, levels, valid, tuple(output_size), tuple(spatial_scales),
            sampling_ratio, aligned, *features,
        )
    return KERNEL(
        features, rois, levels, valid, output_size, spatial_scales,
        sampling_ratio, aligned,
    )
