"""Cluster-batched multilevel RoIAlign: the CUDA forward kernel and its wrapper.

Replaces the TPU kernel of cpm_tpu/ops/pallas/clustered_pallas.py:
`multilevel_roi_align_clustered` (`_cl_fwd`) and its grouping (`_cluster`).
The source, cpm_tpu_torch/csrc/clustered_roi_align.cu, holds two kernels. The
grouping kernel computes `ops/roi_align.py::cluster_rois`'s `Grouping`
integer for integer in one launch of one block, with no value read on the
host: a counting sort by key over the key space, made stable by ranking
each roi among its key's rois by index (`ops/roi_align.py::
counting_sort_groups` states the rule). The forward kernel walks (group,
slice of bins) items, as many as the grouping counted on the device, with
as many blocks as the card holds at once; each pools its slice's bins for
every member of the group, member by member within a bin, so that the
members' shared cells come from L1 after the first read (a rectangle staged
in shared memory by hand measured slower on the H100), and stores each
result straight to its roi's row. It reads cells directly, so the result is
exact for every roi shape, and masked rois' rows are written as zeros by
the kernel.

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
raises. `KERNEL.launches` counts the forward launches,
`KERNEL.grouping_launches` the grouping's.
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
    on_device,
)
from cpm_tpu_torch.ops.roi_align import (
    LATTICE_Q,
    TILE,
    Grouping,
    group_cap,
    multilevel_roi_align_clustered_plain,
)

SOURCE = _build.CSRC / "clustered_roi_align.cu"


def grouping_scratch_ints(level_hw, batch: int, num_rois: int) -> int:
    """int32s of scratch the grouping kernel takes: three per key of its key
    space (batch x levels x lattice blocks of the largest level), one more,
    and nine per roi."""
    lattice = (max(h for h, _ in level_hw) // LATTICE_Q + 1) * (max(w for _, w in level_hw)
                                                              // LATTICE_Q + 1)
    return 3 * batch * len(level_hw) * lattice + 1 + 9 * num_rois


class ClusteredRoIAlignKernel:
    """The built kernel library, its launch counts (`launches`: the forward;
    `grouping_launches`: the grouping) and its build record."""

    def __init__(self):
        self.launches = 0
        self.grouping_launches = 0
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
            lib.cpm_cluster_rois.argtypes = [
                vp, vp, ci, ci, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, vp,
                ctypes.c_longlong, vp, vp, vp, vp, vp,
            ]
            lib.cpm_cluster_rois.restype = ci
            self._lib = lib
        return self._lib

    def group(self, rois, levels, valid, level_hw, batch: int, output_size,
              spatial_scales: Sequence[float], sampling_ratio: int = 0,
              aligned: bool = False) -> Grouping:
        """Launch the grouping kernel on CUDA tensors: the `Grouping` that
        `cluster_rois` (its plain version) gives for the same arguments,
        integer for integer, at the group cap `group_cap(output_size)`."""
        ph, pw = (int(s) for s in output_size)
        sr = sampling_ratio if sampling_ratio > 0 else 2
        num_levels = len(level_hw)
        if not 1 <= num_levels <= MAX_LEVELS:
            raise ValueError(f"1..{MAX_LEVELS} levels supported, got {num_levels}")
        if len(spatial_scales) != num_levels:
            raise ValueError("one spatial scale per level is required")
        levels, valid = check_rois(rois, levels, valid)
        dev, n = rois.device, int(rois.shape[0])
        # every output is written whole by the kernel
        order = torch.empty(n, dtype=torch.int32, device=dev)
        groups = torch.empty((n, 8), dtype=torch.int32, device=dev)
        slot_group = torch.empty(n, dtype=torch.int64, device=dev)
        if n == 0:
            return Grouping(order, groups, slot_group,
                            torch.zeros((), dtype=torch.int64, device=dev))
        n_groups = torch.empty((), dtype=torch.int64, device=dev)
        level_hw = [(int(h), int(w)) for h, w in level_hw]
        ints = grouping_scratch_ints(level_hw, batch, n)
        scratch = torch.empty(ints, dtype=torch.int32, device=dev)
        lib = self.build()
        hw, scales = multilevel_op.KERNEL.level_tables(level_hw, spatial_scales)
        with on_device(dev):
            err = lib.cpm_cluster_rois(
                ctypes.addressof(hw), ctypes.addressof(scales), num_levels, batch,
                rois.data_ptr(), levels.data_ptr(), valid.data_ptr(), n, ph, pw, sr,
                int(bool(aligned)), group_cap((ph, pw)), TILE, LATTICE_Q, scratch.data_ptr(),
                ints, order.data_ptr(), groups.data_ptr(), slot_group.data_ptr(),
                n_groups.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
            )
        if err != 0:
            raise RuntimeError(f"RoI grouping launch failed: cudaError {err}")
        self.grouping_launches += 1
        return Grouping(order, groups, slot_group, n_groups)

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
        """Group the rois with the grouping kernel (unless `grouping` is
        given) and launch the forward kernel on CUDA tensors (no autograd);
        see `multilevel_roi_align_clustered`."""
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
            grouping = self.group(rois, levels, valid, level_hw, batch, (ph, pw),
                                  spatial_scales, sr, aligned)
        order, groups = grouping.order.contiguous(), grouping.groups.contiguous()
        n_groups = grouping.n_groups
        if (order.dtype != torch.int32 or order.shape != (num_rois,)
                or groups.dtype != torch.int32 or groups.shape != (num_rois, 8)
                or n_groups.dtype != torch.int64 or n_groups.numel() != 1
                or any(t.device != dev for t in (order, groups, n_groups))):
            raise ValueError("grouping must hold int32 order [R], int32 groups [R, 8] and an "
                             "int64 group count on the device")
        lib = self.build()
        ptrs = (ctypes.c_void_p * num_levels)(*[f.data_ptr() for f in features])
        hw, scales = multilevel_op.KERNEL.level_tables(level_hw, spatial_scales)
        with on_device(dev):
            err = lib.cpm_clustered_roi_align_fwd(
                ctypes.addressof(ptrs), ctypes.addressof(hw), ctypes.addressof(scales),
                num_levels, batch, channels, rois.data_ptr(), order.data_ptr(),
                groups.data_ptr(), n_groups.data_ptr(), num_rois, group_cap((ph, pw)),
                ph, pw, sr, int(bool(aligned)), DTYPE_CODES[dtype], out.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream,
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
