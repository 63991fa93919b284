"""Builds the port's CUDA sources with nvcc and loads them with ctypes.

Every kernel source under cpm_tpu_torch/csrc has a plain C interface. A
source is compiled for sm_90a into `build/cpm_tpu_torch/` at first use; the
library's name carries a hash of the source, of the shared headers and of
the flags, so a changed file is rebuilt and an unchanged one is found again.
`compile_sources` starts one nvcc per missing library, all together, and
waits for them: a caller that will need several kernels builds them in the
time of the slowest.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parents[2] / "csrc"
HEADERS = (CSRC / "roi_align_common.cuh", CSRC / "roi_align_tiles.cuh",
           CSRC / "roi_align_forward.cuh")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "cpm_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
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


class Built:
    """One compiled source: where its library lies, what nvcc printed (empty
    when the library was found already built) and how long the call that
    built it took."""

    def __init__(self, library_path: Path, log: str, seconds: float):
        self.library_path = library_path
        self.log = log
        self.seconds = seconds


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in (source, *HEADERS):
        digest.update(path.read_bytes())
    return BUILD_DIR / f"{source.stem}-{digest.hexdigest()[:16]}.so"


def compile_sources(sources: Sequence[Path]) -> Dict[Path, Built]:
    """Compile each of `sources` whose library does not exist yet, one nvcc
    each, all running at once. Raises with nvcc's output if one fails."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running, built = {}, {}
    for source in sources:
        lib = library_path(source)
        if lib.exists():
            built[source] = Built(lib, "", 0.0)
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
        running[source] = (lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failures = []
    for source, (lib, tmp, proc) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed ({proc.returncode}) on {source.name}:\n{log}")
            continue
        os.replace(tmp, lib)
        built[source] = Built(lib, log, time.perf_counter() - t0)
    if failures:
        raise RuntimeError("\n".join(failures))
    return built


def load_library(source: Path):
    """(ctypes library, Built) of one source, compiled if need be."""
    built = compile_sources([source])[source]
    return ctypes.CDLL(str(built.library_path)), built
