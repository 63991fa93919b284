"""Cluster-batched multilevel RoIAlign: the CUDA forward kernel and its wrapper.

Replaces the TPU kernel of cpm_tpu/ops/pallas/clustered_pallas.py:
`multilevel_roi_align_clustered` (`_cl_fwd`). Rois are grouped with torch
ops on the device (`ops/roi_align.py::cluster_rois`: no value is read on the
host), and the kernel, cpm_tpu_torch/csrc/clustered_roi_align.cu, reads each
group's shared rectangle of cells once into shared memory and pools the
group's rois from there, storing each result straight to its roi's row.
Shared memory per CTA: TILE x TILE cells x 128 bytes of channels = 73,728
bytes at TILE = 24. A singleton group whose rectangle exceeds the tile reads
device memory directly, so the result is exact for every roi shape, and
masked rois' rows are written as zeros by the kernel.

As in the JAX package (`_cl_bwd` reuses the windowed kernel's `_bwd`), the
gradient does not depend on the forward's grouping: the backward is the
multilevel backward kernel (`ops/cuda/multilevel_roi_align.py::KERNEL
.backward`, csrc/multilevel_roi_align.cu), which adds into exactly the cells
this forward read, with the same weights.

`multilevel_roi_align_clustered` dispatches on where the tensors lie: on the
CPU it runs the plain clustered formulation
(`ops/roi_align.py::multilevel_roi_align_clustered_plain`: the same
grouping, each group pooled from its copied tile), through which autograd
differentiates by itself; on a CUDA device it launches the kernels or
raises. `KERNEL.launches` counts the forward launches.
"""

import ctypes
from typing import Sequence

import torch

from cpm_tpu_torch.ops.cuda import _build
from cpm_tpu_torch.ops.cuda import multilevel_roi_align as multilevel_op
from cpm_tpu_torch.ops.cuda.multilevel_roi_align import (
    DTYPE_CODES,
    MAX_LEVELS,
    check_level_maps,
    check_rois,
)
from cpm_tpu_torch.ops.roi_align import (
    TILE,
    Grouping,
    cluster_rois,
    multilevel_roi_align_clustered_plain,
)

SOURCE = _build.CSRC / "clustered_roi_align.cu"


class ClusteredRoIAlignKernel:
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
            lib.cpm_clustered_roi_align_fwd.argtypes = [
                vp, vp, vp, ci, ci, ci, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, vp, vp,
            ]
            lib.cpm_clustered_roi_align_fwd.restype = ci
            self._lib = lib
        return self._lib

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
        grouping: Grouping = None,
    ) -> torch.Tensor:
        """Group the rois (unless `grouping` is given) and launch the forward
        kernel on CUDA tensors (no autograd); see
        `multilevel_roi_align_clustered`."""
        ph, pw = (int(s) for s in output_size)
        sr = sampling_ratio if sampling_ratio > 0 else 2
        num_levels = len(features)
        if not 1 <= num_levels <= MAX_LEVELS:
            raise ValueError(f"1..{MAX_LEVELS} levels supported, got {num_levels}")
        if len(spatial_scales) != num_levels:
            raise ValueError("one spatial scale per level is required")
        levels, valid = check_rois(rois, levels, valid)
        dev = rois.device
        dtype, batch, channels = check_level_maps(features, dev)
        num_rois = int(rois.shape[0])
        out = torch.empty((num_rois, ph, pw, channels), dtype=dtype, device=dev)
        if num_rois == 0:
            return out
        level_hw = [(int(f.shape[1]), int(f.shape[2])) for f in features]
        if grouping is None:
            grouping = cluster_rois(rois, levels, valid, level_hw, batch, (ph, pw),
                                    spatial_scales, sr, aligned)
        order, groups = grouping.order.contiguous(), grouping.groups.contiguous()
        if (order.dtype != torch.int32 or order.shape != (num_rois,)
                or groups.dtype != torch.int32 or groups.shape != (num_rois, 8)
                or order.device != dev or groups.device != dev):
            raise ValueError("grouping must hold int32 order [R] and groups [R, 8] on the device")
        lib = self.build()
        ptrs = (ctypes.c_void_p * num_levels)(*[f.data_ptr() for f in features])
        hw = (ctypes.c_int * (2 * num_levels))(*[d for s in level_hw for d in s])
        scales = (ctypes.c_float * num_levels)(*[float(s) for s in spatial_scales])
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.cpm_clustered_roi_align_fwd(
                ctypes.addressof(ptrs), ctypes.addressof(hw), ctypes.addressof(scales),
                num_levels, batch, channels, rois.data_ptr(), valid.data_ptr(),
                order.data_ptr(), groups.data_ptr(), num_rois, TILE, ph, pw, sr,
                int(bool(aligned)), DTYPE_CODES[dtype], out.data_ptr(), stream,
            )
        if err != 0:
            raise RuntimeError(f"clustered RoIAlign launch failed: cudaError {err}")
        self.launches += 1
        return out


KERNEL = ClusteredRoIAlignKernel()


class _ClusteredRoIAlign(torch.autograd.Function):
    """The clustered forward kernel and the multilevel backward kernel as
    one differentiable op over the level maps."""

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
        grads = multilevel_op.KERNEL.backward(ctx.feature_shapes, rois, levels, valid,
                                              g.contiguous(), *ctx.args)
        return (None,) * 7 + tuple(grads)


def multilevel_roi_align_clustered(
    features: Sequence[torch.Tensor],
    rois: torch.Tensor,
    levels: torch.Tensor,
    valid: torch.Tensor,
    output_size,
    spatial_scales: Sequence[float],
    sampling_ratio: int = 0,
    aligned: bool = False,
) -> torch.Tensor:
    """Multilevel RoIAlign with rois grouped by shared cells: `[B, H_l, W_l,
    C]` levels -> `[R, ph, pw, C]`; same contract as
    `ops/cuda/multilevel_roi_align.py::multilevel_roi_align`. CPU tensors
    take the plain clustered formulation; CUDA tensors take the clustered
    forward kernel and, when a level map requires a gradient, the multilevel
    backward kernel."""
    if rois.device.type == "cpu":
        return multilevel_roi_align_clustered_plain(
            features, rois, levels, valid, output_size, spatial_scales, sampling_ratio, aligned)
    if rois.device.type != "cuda":
        raise ValueError(f"no clustered RoIAlign for device {rois.device}")
    if torch.is_grad_enabled() and any(f.requires_grad for f in features):
        return _ClusteredRoIAlign.apply(
            rois, levels, valid, tuple(output_size), tuple(spatial_scales),
            sampling_ratio, aligned, *features,
        )
    return KERNEL(features, rois, levels, valid, output_size, spatial_scales,
                  sampling_ratio, aligned)
