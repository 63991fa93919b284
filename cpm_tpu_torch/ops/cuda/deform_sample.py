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
16-byte loads along C. The backward's map gradient is a gather owned by tiles
of the map: binning kernels sort the samples stably by the tile of their
window start (a counting sort on the card with no host sync; its plain
version is ops/deform_conv.py::window_tiles), and each block of the map
kernel sums what falls into its tile in shared memory and writes the tile
once in the map's dtype: no float32 map, no fill, no cast, no atomics. The
coordinate gradients come from a warp reduction over C per sample. Every sum
runs in a fixed order, so two backward runs on the same inputs give the same
bits.

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
        self.tile = None
        self.bin_chunk = None
        self._lib = None

    def build(self):
        """Compile the source unless a build of the same source, header and
        flags exists, then load it. Returns the ctypes library."""
        if self._lib is None:
            lib, self.built = _build.load_library(SOURCE)
            vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.cpm_deform_sample_fwd.argtypes = [vp, ci, ci, ci, ci, vp, vp, cl, ci, vp, vp]
            lib.cpm_deform_sample_bwd.argtypes = [
                vp, ci, ci, ci, ci, vp, vp, vp, cl, ci, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp,
            ]
            lib.cpm_deform_sample_bin.argtypes = [vp, vp, ci, ci, ci, cl, vp, vp, vp, vp, vp, vp, vp]
            for fn in (lib.cpm_deform_sample_fwd, lib.cpm_deform_sample_bwd,
                       lib.cpm_deform_sample_bin):
                fn.restype = ci
            layout = [ctypes.c_int() for _ in range(3)]
            lib.cpm_deform_sample_layout(*[ctypes.byref(v) for v in layout])
            self.tile = (layout[0].value, layout[1].value)
            self.bin_chunk = layout[2].value
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

    def _bin_buffers(self, b, h, w, p, dev):
        """One int32 buffer, split: weights [n, 4] f32 first (16-byte
        aligned), order, starts, offsets, and the sort's scratch (per-key
        totals, per-chunk counts), n = b * p; an image has a key per tile
        and one more."""
        th, tw = self.tile
        n = b * p
        keys = b * ((-(-h // th)) * (-(-w // tw)) + 1)
        sizes = (4 * n, n, n, keys + 1, keys, -(-p // self.bin_chunk) * keys)
        weights, order, starts, offsets, totals, counts = torch.empty(
            sum(sizes), dtype=torch.int32, device=dev).split(sizes)
        return weights.view(torch.float32).view(n, 4), order, starts, offsets, totals, counts

    def bin_samples(self, feat: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor):
        """The binning kernels alone (the backward launches them itself): the
        samples sorted stably by the tile of their window start, for the
        tiles the backward kernel's blocks own -> (order, offsets) as
        `ops/deform_conv.py::window_tiles` returns them, and each sample's
        window start (int32, row << 16 | column) and weights (f32 [N, 4]:
        wy0, wy1, wx0, wx1) in that order."""
        b, h, w, _, p = _check(feat, ys, xs)
        lib = self.build()
        dev = feat.device
        weights, order, starts, offsets, totals, counts = self._bin_buffers(b, h, w, p, dev)
        with torch.cuda.device(dev):
            err = lib.cpm_deform_sample_bin(
                ys.data_ptr(), xs.data_ptr(), b, h, w, p, counts.data_ptr(), totals.data_ptr(),
                order.data_ptr(), starts.data_ptr(), weights.data_ptr(), offsets.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream,
            )
        if err != 0:
            raise RuntimeError(f"deform sample binning launch failed: cudaError {err}")
        return order, offsets, starts, weights

    def backward(self, feat: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor, g: torch.Tensor,
                 need_map: bool = True, need_coords: bool = True):
        """Launch the backward kernels (the binning's first when the map needs
        a gradient): g `[B, P, C]` in feat's dtype -> (gradient to feat in
        its dtype or None, gys, gxs `[B, P]` f32 or None). The map's sums are
        taken in float32, in a fixed order."""
        b, h, w, c, p = _check(feat, ys, xs)
        if g.dtype != feat.dtype or g.device != feat.device or tuple(g.shape) != (b, p, c):
            raise ValueError("g must be [B, P, C] of feat's dtype on its device")
        if not g.is_contiguous() or g.data_ptr() % 16:
            raise ValueError("g must be contiguous and 16-byte aligned")
        dev = feat.device
        alloc = torch.empty if p > 0 else torch.zeros   # the kernels write every element
        grad = alloc(feat.shape, dtype=feat.dtype, device=dev) if need_map else None
        gys, gxs = alloc((2, b, p), dtype=torch.float32, device=dev) if need_coords else (None, None)
        if p > 0 and (need_map or need_coords):
            lib = self.build()
            bins = self._bin_buffers(b, h, w, p, dev) if need_map else (None,) * 6
            weights, order, starts, offsets, totals, counts = (
                None if t is None else t.data_ptr() for t in bins)
            with torch.cuda.device(dev):
                err = lib.cpm_deform_sample_bwd(
                    feat.data_ptr(), b, h, w, c, ys.data_ptr(), xs.data_ptr(), g.data_ptr(), p,
                    DTYPE_CODES[feat.dtype], counts, totals, order, starts, weights, offsets,
                    grad.data_ptr() if need_map else None,
                    gys.data_ptr() if need_coords else None,
                    gxs.data_ptr() if need_coords else None,
                    torch.cuda.current_stream(dev).cuda_stream,
                )
            if err != 0:
                raise RuntimeError(f"deform sample backward launch failed: cudaError {err}")
            self.backward_launches += 1
        return grad, gys, gxs


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
