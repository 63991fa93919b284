"""Stacked-levels multilevel RoIAlign: the CUDA kernels and their wrapper.

Replaces the TPU kernels of cpm_tpu/ops/pallas/stacked_pallas.py:
`multilevel_roi_align_stacked` (forward, `_fwd`) and its custom_vjp backward
(`_bwd`). The kernels, cpm_tpu_torch/csrc/stacked_roi_align.cu, read and
write ONE buffer `[B, sum(H_l), max(W_l), C]` that holds all FPN levels one
below the other, through a by-value table of row offsets and level sizes:
one base pointer, one row stride, no per-level pointer. The stack itself is
made with torch ops, as the JAX package leaves it to XLA: on the card in one
pass over the bytes (`ops/roi_align.py::stack_levels_in_one_pass`: each level
copied into its rows, only the padding columns zeroed), once for each set of
level maps within a forward (`STACKS`): the five pooler calls of a forward
(cls, three grid stages, rescore) pool from the same FPN maps, as they do in
the one jitted JAX forward, so they share one stack. On the CPU it is the
differentiable pad and cat (`stack_levels`) of every call.

What bounds both kernels on the H100 is bytes (csrc/stacked_roi_align.cu
and csrc/roi_align_forward.cuh say how each is laid out). The forward is the
multilevel forward's own loop (csrc/roi_align_forward.cuh) over the stacked
buffer, and gives its bits. The backward produces the gradient of the
stacked buffer, as the TPU kernel's `_bwd` does, in the dtype of `g`: it runs
the multilevel backward's tile-owned gather (csrc/roi_align_tiles.cuh) over
each level's valid region of that buffer, sums in float32 in a fixed order
and writes every such cell once. The wrapper allocates the buffer with
`torch.empty` (the padding columns are never written or read) and returns
the per-level views of it (`unstack_levels`), with no float32 accumulator,
fill, cast or copy; autograd takes gradients with these strides. Two
backward runs on the same inputs give the same bits, and the same bits as
the multilevel backward.

`multilevel_roi_align_stacked` dispatches on where the tensors lie: on the
CPU it runs the plain stacked formulation
(`ops/roi_align.py::multilevel_roi_align_stacked_plain` on the stack of
`stack_levels`), through which autograd differentiates by itself; on a CUDA
device it launches the kernels
or raises. `KERNEL.launches` counts forward launches,
`KERNEL.backward_launches` backward ones, `STACKS.builds` the stacks made.
"""

import contextlib
import contextvars
import ctypes
import weakref
from typing import Sequence

import torch

from cpm_tpu_torch.ops.cuda import _build
from cpm_tpu_torch.ops.cuda.multilevel_roi_align import DTYPE_CODES, check_rois
from cpm_tpu_torch.ops.roi_align import (
    multilevel_roi_align_stacked_plain,
    roi_align_from_stack,
    stack_geometry,
    stack_levels_in_one_pass,
    unstack_levels,
)

SOURCE = _build.CSRC / "stacked_roi_align.cu"
MAX_LEVELS = 5


class StackedRoIAlignKernel:
    """The built kernel library, its launch counts and its build record.
    `defines` build the source in a measured form
    (csrc/roi_align_forward.cuh); the port uses the default."""

    def __init__(self, defines=()):
        self.defines = tuple(defines)
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
            for fn in (lib.cpm_stacked_roi_align_fwd, lib.cpm_stacked_roi_align_bwd):
                fn.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci, vp, vp, vp, ci, ci, ci, ci, ci,
                               ci, vp, vp]
                fn.restype = ci
            self._lib = lib
        return self._lib

    def _launch(self, entry, stack, level_hw, rois, levels, valid, output_size,
                spatial_scales, sampling_ratio, aligned, dtype, data):
        """One launch of `entry` ('fwd' or 'bwd') on the current stream.
        stack: the buffer the kernel reads (fwd) or writes (bwd); data:
        the output (fwd) or the incoming gradient (bwd), of `dtype`."""
        num_levels = len(level_hw)
        if not 1 <= num_levels <= MAX_LEVELS:
            raise ValueError(f"1..{MAX_LEVELS} levels supported, got {num_levels}")
        if len(spatial_scales) != num_levels:
            raise ValueError("one spatial scale per level is required")
        offs, total_rows, wmax = stack_geometry(level_hw)
        if stack.dim() != 4 or tuple(stack.shape[1:3]) != (total_rows, wmax):
            raise ValueError(f"stack {tuple(stack.shape)} does not hold levels {list(level_hw)}")
        if not stack.is_contiguous() or stack.data_ptr() % 16 or stack.device != rois.device:
            raise ValueError("the stack must be contiguous, 16-byte aligned, on the rois' device")
        ph, pw = output_size
        sr = sampling_ratio if sampling_ratio > 0 else 2
        fn = getattr(self.build(), f"cpm_stacked_roi_align_{entry}")
        table = (ctypes.c_int * (3 * num_levels))(
            *[int(v) for off, (h, w) in zip(offs, level_hw) for v in (off, h, w)]
        )
        scales = (ctypes.c_float * num_levels)(*[float(s) for s in spatial_scales])
        dev = rois.device
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(
                stack.data_ptr(), ctypes.addressof(table), ctypes.addressof(scales),
                num_levels, int(stack.shape[0]), total_rows, wmax, int(stack.shape[3]),
                rois.data_ptr(), levels.data_ptr(), valid.data_ptr(), int(rois.shape[0]),
                ph, pw, sr, int(bool(aligned)), DTYPE_CODES[dtype], data.data_ptr(), stream,
            )
        if err != 0:
            raise RuntimeError(f"stacked RoIAlign {entry} launch failed: cudaError {err}")

    def __call__(self, stack, level_hw, rois, levels, valid, output_size, spatial_scales,
                 sampling_ratio: int = 0, aligned: bool = False) -> torch.Tensor:
        """Launch the forward kernel on a stacked buffer `[B, rows, width, C]`
        that holds levels of sizes `level_hw` (no autograd); see
        `multilevel_roi_align_stacked`."""
        ph, pw = (int(s) for s in output_size)
        levels, valid = check_rois(rois, levels, valid)
        dtype = stack.dtype
        if dtype not in DTYPE_CODES:
            raise TypeError(f"features must be float32 or bfloat16, got {dtype}")
        channels = int(stack.shape[-1])
        vec = 16 // stack.element_size()
        if channels % vec:
            raise ValueError(f"C={channels} must be a multiple of {vec} for {dtype}")
        out = torch.empty((int(rois.shape[0]), ph, pw, channels), dtype=dtype, device=rois.device)
        if rois.shape[0] == 0:
            return out
        self._launch("fwd", stack, level_hw, rois, levels, valid, (ph, pw), spatial_scales,
                     sampling_ratio, aligned, dtype, out)
        self.launches += 1
        return out

    def backward(self, feature_shapes, rois, levels, valid, g, spatial_scales,
                 sampling_ratio: int = 0, aligned: bool = False):
        """Launch the backward kernel: `g` `[R, ph, pw, C]` (contiguous, f32
        or bf16, on the card) -> one gradient `[B, H_l, W_l, C]` per level
        in g's dtype: views of the stacked buffer's gradient, which the
        kernel writes in its levels' regions. The sums are taken in float32,
        in a fixed order."""
        levels, valid = check_rois(rois, levels, valid)
        dtype = g.dtype
        if dtype not in DTYPE_CODES:
            raise TypeError(f"g must be float32 or bfloat16, got {dtype}")
        shapes = [tuple(int(d) for d in s) for s in feature_shapes]
        batch, channels = shapes[0][0], shapes[0][3]
        if any(len(s) != 4 or s[0] != batch or s[3] != channels for s in shapes):
            raise ValueError("level shapes must be [B, H, W, C] sharing B and C")
        if (g.device != rois.device or g.dim() != 4 or g.shape[0] != rois.shape[0]
                or g.shape[3] != channels):
            raise ValueError("g must be [R, ph, pw, C] on the rois' device")
        if not g.is_contiguous() or g.data_ptr() % 16:
            raise ValueError("g must be contiguous and 16-byte aligned")
        if channels % (16 // g.element_size()):
            raise ValueError(f"C={channels} must fill 16-byte vectors of {dtype}")
        level_hw = [s[1:3] for s in shapes]
        _, total_rows, wmax = stack_geometry(level_hw)
        alloc = torch.empty if rois.shape[0] > 0 else torch.zeros   # the kernel writes the levels
        grad = alloc((batch, total_rows, wmax, channels), dtype=dtype, device=rois.device)
        if rois.shape[0] > 0:
            self._launch("bwd", grad, level_hw, rois, levels, valid, tuple(g.shape[1:3]),
                         spatial_scales, sampling_ratio, aligned, dtype, g)
            self.backward_launches += 1
        return unstack_levels(grad, level_hw)


KERNEL = StackedRoIAlignKernel()


class StackMemo:
    """The stacked buffer of the last set of level maps it was asked for.

    Keyed on the maps' identity, through weak references (a new map may
    reuse a freed one's memory, so its `data_ptr` proves nothing), and on
    their `_version`s, so that an in-place change makes a new stack; the
    inference tensors of an eval forward under `torch.inference_mode` keep no
    version counter and are keyed on their identity alone, which holds
    within one forward, the memo's life under `STACKS.scope()`. The entry is
    dropped when any of its maps dies. It is one attribute, read and
    replaced whole. `builds` counts the stacks made."""

    def __init__(self):
        self.builds = 0
        self._entry = None   # (weak references to the maps, their versions, the stack)

    def _drop(self, ref):
        entry = self._entry
        if entry is not None and any(r is ref for r in entry[0]):
            self._entry = None

    def __call__(self, features, build):
        """The stack of `features`, made by `build(features)` unless the
        last one made is theirs."""
        versions = tuple(None if f.is_inference() else f._version for f in features)
        entry = self._entry
        if (entry is not None and len(entry[0]) == len(features) and entry[1] == versions
                and all(r() is f for r, f in zip(entry[0], features))):
            return entry[2]
        self._entry = None
        stack = build(features)
        self._entry = (tuple(weakref.ref(f, self._drop) for f in features), versions, stack)
        self.builds += 1
        return stack


class ForwardStacks:
    """The card's stacks (`stack_levels_in_one_pass`), one for each set of
    maps within a forward.

    Within `scope()`, which `GeneralizedRCNN.forward` opens through
    `ops/pooler.py::one_stack_per_forward`, a `StackMemo` of the scope's own
    lets the forward's pooler calls share one stack; it dies when the scope
    ends, so nothing is kept from one forward to the next, and a context
    variable gives each thread its own. Outside a scope every call makes its
    own stack. `builds` counts the stacks made."""

    def __init__(self):
        self.builds = 0
        self._memo = contextvars.ContextVar("cpm_torch_stack_memo", default=None)

    @contextlib.contextmanager
    def scope(self):
        token = self._memo.set(StackMemo())
        try:
            yield
        finally:
            self._memo.reset(token)

    def __call__(self, features):
        memo = self._memo.get()
        if memo is None:
            self.builds += 1
            return stack_levels_in_one_pass(features)
        before = memo.builds
        stack = memo(features, stack_levels_in_one_pass)
        self.builds += memo.builds - before
        return stack


STACKS = ForwardStacks()


class _StackedRoIAlign(torch.autograd.Function):
    """Stack, forward kernel and backward kernel as one differentiable op
    over the level maps; rois, level ids and the mask get no gradient."""

    @staticmethod
    def forward(ctx, rois, levels, valid, output_size, spatial_scales,
                sampling_ratio, aligned, *features):
        ctx.save_for_backward(rois, levels, valid)
        ctx.feature_shapes = [tuple(f.shape) for f in features]
        ctx.args = (tuple(spatial_scales), sampling_ratio, aligned)
        level_hw = [tuple(f.shape[1:3]) for f in features]
        return KERNEL(STACKS(features), level_hw, rois, levels,
                      valid, output_size, spatial_scales, sampling_ratio, aligned)

    @staticmethod
    def backward(ctx, g):
        rois, levels, valid = ctx.saved_tensors
        # the heads hand back gradients with the strides of their own views
        grads = KERNEL.backward(ctx.feature_shapes, rois, levels, valid,
                                g.contiguous(), *ctx.args)
        return (None,) * 7 + tuple(grads)


def plain_stacked_roi_align_backward(feature_shapes, rois, levels, valid, g, spatial_scales,
                                     sampling_ratio: int = 0, aligned: bool = False):
    """The plain version of the backward kernel: autograd of the plain
    forward with respect to the stacked buffer, sliced back per level.
    Masked rois add nothing. The forward is linear in the buffer, so zeros
    stand in for its values."""
    shapes = [tuple(int(d) for d in s) for s in feature_shapes]
    level_hw = [s[1:3] for s in shapes]
    _, total_rows, wmax = stack_geometry(level_hw)
    stack = torch.zeros((shapes[0][0], total_rows, wmax, shapes[0][3]), dtype=g.dtype,
                        device=g.device, requires_grad=True)
    out = roi_align_from_stack(stack, level_hw, rois, levels, tuple(g.shape[1:3]),
                               spatial_scales, sampling_ratio, aligned)
    out = out * valid.to(out.dtype)[:, None, None, None]
    (grad,) = torch.autograd.grad(out, stack, g)
    return [part.contiguous() for part in unstack_levels(grad, level_hw)]


def multilevel_roi_align_stacked(
    features: Sequence[torch.Tensor],
    rois: torch.Tensor,
    levels: torch.Tensor,
    valid: torch.Tensor,
    output_size,
    spatial_scales: Sequence[float],
    sampling_ratio: int = 0,
    aligned: bool = False,
) -> torch.Tensor:
    """Multilevel RoIAlign through one stacked buffer: `[B, H_l, W_l, C]`
    levels -> `[R, ph, pw, C]`; same contract as
    `ops/cuda/multilevel_roi_align.py::multilevel_roi_align`. CPU tensors
    take the plain stacked formulation; CUDA tensors take the kernels, the
    backward one when a level map requires a gradient, and pool from the
    stack of `STACKS`, made once for each set of maps within a forward."""
    if rois.device.type == "cpu":
        out = multilevel_roi_align_stacked_plain(
            features, rois, levels, output_size, spatial_scales, sampling_ratio, aligned)
        return out * valid.to(out.dtype)[:, None, None, None]
    if rois.device.type != "cuda":
        raise ValueError(f"no stacked RoIAlign for device {rois.device}")
    features = list(features)
    f0 = features[0]
    for f in features:
        if f.dim() != 4 or f.device != rois.device or f.dtype != f0.dtype:
            raise ValueError("levels must be [B, H, W, C] on the rois' device, of one dtype")
        if f.shape[0] != f0.shape[0] or f.shape[3] != f0.shape[3]:
            raise ValueError("levels must share B and C")
    if torch.is_grad_enabled() and any(f.requires_grad for f in features):
        return _StackedRoIAlign.apply(
            rois, levels, valid, tuple(output_size), tuple(spatial_scales),
            sampling_ratio, aligned, *features,
        )
    return KERNEL(STACKS(features),
                  [tuple(f.shape[1:3]) for f in features], rois, levels, valid, output_size,
                  spatial_scales, sampling_ratio, aligned)
