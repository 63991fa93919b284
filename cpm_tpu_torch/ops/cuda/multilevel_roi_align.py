"""Multilevel FPN RoIAlign: the hand-written CUDA kernel and its wrapper.

Replaces the TPU kernel
cpm_tpu/ops/pallas/multilevel_pallas.py::multilevel_roi_align_pallas
(forward). The kernel, cpm_tpu_torch/csrc/multilevel_roi_align.cu, is CUDA
C++ for sm_90a with a plain C entry point, built by nvcc into
`build/cpm_tpu_torch/` at first use (keyed by a hash of the source and the
flags) and bound with ctypes.

What bounds it on the H100 is the bytes its bilinear gathers read from
L2/HBM, not FLOPs: one multiply-add per element read. The design keeps each
gather a full coalesced row: one CTA per roi (and C tile), threads along C
loading 16 bytes each with read-only loads, f32 accumulation, one store of
the feature dtype per output element. Masked rois write zeros and read
nothing. It takes none of the TPU kernel's window, so it is exact for every
roi aspect ratio and the JAX pooler's window-overflow patch has no
counterpart here.

`multilevel_roi_align` dispatches on where the tensors lie: on the CPU it
runs the plain PyTorch version (cpm_tpu_torch/ops/roi_align.py); on a CUDA
device it launches the kernel or raises. `KERNEL.launches` counts launches.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Sequence

import torch

from cpm_tpu_torch.ops.roi_align import multilevel_roi_align as plain_multilevel_roi_align

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "multilevel_roi_align.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "cpm_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
MAX_LEVELS = 5
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [
        os.path.join(cuda_home, "bin", "nvcc") if cuda_home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


class MultilevelRoIAlignKernel:
    """The built kernel library, its launch count and its build record."""

    def __init__(self):
        self.launches = 0
        self.build_seconds = None
        self.build_log = ""
        self.library_path = None
        self._lib = None

    def build(self):
        """Compile the source with nvcc unless a build of the same source
        and flags exists, then load it. Returns the ctypes library."""
        if self._lib is not None:
            return self._lib
        src = SOURCE.read_bytes()
        key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        lib_path = BUILD_DIR / f"multilevel_roi_align-{key}.so"
        t0 = time.perf_counter()
        if not lib_path.exists():
            tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{self.build_log}"
                )
            os.replace(tmp, lib_path)
        lib = ctypes.CDLL(str(lib_path))
        fn = lib.cpm_multilevel_roi_align_fwd
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [
            vp, vp, vp, ci, ci, ci, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp, vp,
        ]
        fn.restype = ci
        self.build_seconds = time.perf_counter() - t0
        self.library_path = lib_path
        self._lib = lib
        return lib

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
        """Launch the kernel on CUDA tensors; see `multilevel_roi_align`."""
        ph, pw = (int(s) for s in output_size)
        sr = sampling_ratio if sampling_ratio > 0 else 2
        num_levels = len(features)
        if not 1 <= num_levels <= MAX_LEVELS:
            raise ValueError(f"1..{MAX_LEVELS} levels supported, got {num_levels}")
        if len(spatial_scales) != num_levels:
            raise ValueError("one spatial scale per level is required")
        dev = rois.device
        f0 = features[0]
        dtype = f0.dtype
        if dtype not in _DTYPE_CODES:
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
        num_rois = int(rois.shape[0])
        if rois.dtype != torch.float32 or rois.shape != (num_rois, 5) or not rois.is_contiguous():
            raise ValueError("rois must be contiguous float32 [R, 5]")
        if levels.dtype != torch.int32 or levels.shape != (num_rois,) or levels.device != dev:
            raise ValueError("levels must be int32 [R] on the rois' device")
        if valid.dtype != torch.bool or valid.shape != (num_rois,) or valid.device != dev:
            raise ValueError("valid must be bool [R] on the rois' device")
        levels = levels.contiguous()
        valid = valid.contiguous()
        out = torch.empty((num_rois, ph, pw, channels), dtype=dtype, device=dev)
        if num_rois == 0:
            return out

        lib = self.build()
        ptrs = (ctypes.c_void_p * num_levels)(*[f.data_ptr() for f in features])
        hw = (ctypes.c_int * (2 * num_levels))(
            *[int(d) for f in features for d in f.shape[1:3]]
        )
        scales = (ctypes.c_float * num_levels)(*[float(s) for s in spatial_scales])
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.cpm_multilevel_roi_align_fwd(
                ctypes.addressof(ptrs), ctypes.addressof(hw),
                ctypes.addressof(scales), num_levels, batch, channels,
                rois.data_ptr(), levels.data_ptr(), valid.data_ptr(),
                num_rois, ph, pw, sr, int(bool(aligned)), _DTYPE_CODES[dtype],
                out.data_ptr(), stream,
            )
        if err != 0:
            raise RuntimeError(f"multilevel RoIAlign launch failed: cudaError {err}")
        self.launches += 1
        return out


KERNEL = MultilevelRoIAlignKernel()


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
    take the plain PyTorch version; CUDA tensors take the kernel.
    """
    if rois.device.type == "cpu":
        out = plain_multilevel_roi_align(
            features, rois, levels, output_size, spatial_scales,
            sampling_ratio, aligned,
        )
        return out * valid.to(out.dtype)[:, None, None, None]
    if rois.device.type != "cuda":
        raise ValueError(f"no multilevel RoIAlign for device {rois.device}")
    return KERNEL(
        features, rois, levels, valid, output_size, spatial_scales,
        sampling_ratio, aligned,
    )
