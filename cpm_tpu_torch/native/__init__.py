"""The native host decode pool: its build and its ctypes bindings.

The port's copy of cpm_tpu/native. g++ compiles `imageops.cpp` (libjpeg,
libpng, pthreads) at first use into `build/cpm_tpu_torch/`, beside the CUDA
libraries, never into the package's own tree. It links one of two ways
(`route`):

  * "system": the host's libjpeg and libpng, where g++ finds jpeglib.h
    and png.h (the JAX package's build, so the two libraries decode the
    same bits on such a host);
  * "pillow": where it does not, the libjpeg (ABI 62) and libpng16 that
    Pillow's wheels carry in their `pillow.libs` folder, through the
    headers kept in `include/` (libjpeg-turbo 2.1.5's, ABI 62, and libpng
    1.6.39's; a library that does not fit them fails at its first decode,
    as libjpeg checks the struct sizes and libpng the version).

The library's name carries a digest of the source, of the flags (the
route's among them) and of the host's CPU (the flags hold `-march=native`,
so a library built on another machine is not taken), and it is written
under a per-process temporary name and renamed into place, so that
processes that build at once do not race. It exposes:

  * decode_resize_normalize(bytes, ...) -> (padded float32 image,
    (orig_h, orig_w)): the fused host-side image op;
  * decode_resize_u8(bytes, ...): the same, rounded to uint8 and not
    normalised (TPU.DEVICE_NORMALIZE: the model applies the input affine);
  * ImagePool: a pthread worker pool (submit paths, collect the finished
    padded images), the reference's DataLoader worker processes.

`load()` is the loaders' entry: the library, or None when it does not build
here, after one warning that quotes the compiler's first lines; `status()`
says which, and how long the build took. Imports nothing of torch.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
import warnings
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "imageops.cpp"
INCLUDE_DIR = Path(__file__).resolve().parent / "include"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cpm_tpu_torch"
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
LINK_FLAGS = ("-ljpeg", "-lpng", "-lpthread")
ERROR_LINES = 8  # of the compiler's output, quoted by the warning

_lib = None
_status = None
_lock = threading.Lock()


class NativeBuildError(RuntimeError):
    """g++ failed, or is missing; the message holds what it printed."""


class Status:
    """Whether the library built (or was found built) and loaded, the
    seconds that g++ took (0.0 when it was found), its path, the route it
    linked by, and why not."""

    def __init__(self, built: bool, seconds: float = 0.0, path: Optional[Path] = None,
                 route: str = "", error: str = ""):
        self.built = built
        self.seconds = seconds
        self.path = path
        self.route = route
        self.error = error

    def __repr__(self):
        if self.built:
            return f"Status(built, {self.route}, {self.seconds:.2f} s, {self.path})"
        return f"Status(not built: {self.error.splitlines()[0] if self.error else '?'})"


def _host_tag() -> bytes:
    """The CPU's model name and feature flags (what -march=native reads)."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
        keep = [ln for ln in lines if ln.startswith((b"model name", b"flags"))]
        return b"\n".join(keep[:2])
    except OSError:
        import platform

        return platform.machine().encode()


class Route:
    """How the library links: `name` ("system" or "pillow"), the flags
    that g++ takes before the source and those it takes after it."""

    def __init__(self, name: str, compile_flags=(), link_flags=LINK_FLAGS):
        self.name = name
        self.compile_flags = tuple(compile_flags)
        self.link_flags = tuple(link_flags)


def _system_headers_missing() -> Optional[str]:
    """The first of jpeglib.h / png.h that g++ does not find, or None."""
    for header in ("jpeglib.h", "png.h"):
        probe = subprocess.run([CXX, "-E", "-x", "c++", "-"], input=f"#include <{header}>\n",
                               capture_output=True, text=True)
        if probe.returncode != 0:
            return header
    return None


def pillow_libraries():
    """(libjpeg, libpng16) as Pillow's wheel carries them, in the
    `pillow.libs` folder beside `PIL`, or None when it carries no such
    pair (a Pillow built against the system's libraries)."""
    try:
        import PIL
    except ImportError:
        return None
    libs = Path(PIL.__file__).resolve().parent.parent / "pillow.libs"
    jpeg = sorted(libs.glob("libjpeg-*.so.62*"))
    png = sorted(libs.glob("libpng16-*.so.16*"))
    return (jpeg[0], png[0]) if jpeg and png else None


def route() -> Route:
    """The system's libraries where g++ finds their headers, else Pillow's
    with the headers of `include/`. Raises NativeBuildError saying why
    neither is there."""
    if shutil.which(CXX) is None:
        raise NativeBuildError(f"{CXX} not found")
    missing = _system_headers_missing()
    if missing is None:
        return Route("system")
    libs = pillow_libraries()
    if libs is None:
        raise NativeBuildError(f"{missing} not found by {CXX}, and Pillow carries no "
                               f"libjpeg / libpng16 of its own")
    jpeg, png = libs
    return Route("pillow", ("-I", str(INCLUDE_DIR)),
                 (str(jpeg), str(png), "-lpthread", f"-Wl,-rpath,{jpeg.parent}"))


def library_path(r: Route) -> Path:
    flags = (CXX,) + CXX_FLAGS + r.compile_flags + r.link_flags
    digest = hashlib.sha256(" ".join(flags).encode())
    digest.update(SOURCE.read_bytes())
    digest.update(_host_tag())
    return BUILD_DIR / f"imageops-{digest.hexdigest()[:16]}.so"


def missing_prerequisites() -> Optional[str]:
    """Why the library cannot build here (no g++, or neither the system's
    jpeglib.h / png.h nor Pillow's own libjpeg / libpng16), or None when
    one route is there."""
    try:
        route()
    except NativeBuildError as e:
        return str(e)
    return None


def build() -> Status:
    """Compile the library unless it is there already. Raises
    NativeBuildError with g++'s output when it fails."""
    r = route()
    lib = library_path(r)
    if lib.exists():
        return Status(True, 0.0, lib, r.name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([CXX, *CXX_FLAGS, *r.compile_flags, str(SOURCE), "-o", str(tmp),
                           *r.link_flags], capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        if tmp.exists():
            tmp.unlink()
        output = proc.stderr or proc.stdout
        first = next((ln for ln in output.splitlines() if "error" in ln), "")
        raise NativeBuildError(f"{CXX} failed ({proc.returncode}) on {SOURCE.name}: "
                               f"{first.strip()}\n{output}")
    os.replace(tmp, lib)
    return Status(True, seconds, lib, r.name)


def _bind(lib):
    c_int, c_i64, c_dbl, c_str = ctypes.c_int, ctypes.c_int64, ctypes.c_double, ctypes.c_char_p
    f32p, u8p, intp = (ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
                       ctypes.POINTER(ctypes.c_int))
    lib.imgops_decode_resize_normalize.restype = c_int
    lib.imgops_decode_resize_normalize.argtypes = [
        c_str, c_i64, c_int, c_int, c_int, c_int, f32p, f32p, c_int, c_int, c_dbl, c_dbl,
        f32p, intp, intp]
    lib.imgops_decode_resize_u8.restype = c_int
    lib.imgops_decode_resize_u8.argtypes = [
        c_str, c_i64, c_int, c_int, c_int, c_int, c_int, c_int, c_dbl, c_dbl, u8p, intp, intp]
    lib.pool_create.restype = ctypes.c_void_p
    lib.pool_create.argtypes = [c_int]
    lib.pool_submit.restype = None
    lib.pool_submit.argtypes = [
        ctypes.c_void_p, c_i64, c_str, c_int, c_int, c_int, c_int, f32p, f32p, c_int, c_int,
        c_dbl, c_dbl]
    lib.pool_submit_u8.restype = None
    lib.pool_submit_u8.argtypes = [
        ctypes.c_void_p, c_i64, c_str, c_int, c_int, c_int, c_int, c_int, c_int, c_dbl, c_dbl]
    lib.pool_wait_any.restype = c_i64
    lib.pool_wait_any.argtypes = [ctypes.c_void_p, f32p, intp, intp, intp]
    lib.pool_wait_any_u8.restype = c_i64
    lib.pool_wait_any_u8.argtypes = [ctypes.c_void_p, u8p, intp, intp, intp]
    lib.pool_destroy.restype = None
    lib.pool_destroy.argtypes = [ctypes.c_void_p]
    return lib


def get_lib():
    """The loaded library, built first if need be. Raises when it cannot
    be built or loaded (`load` is the variant that falls back)."""
    global _lib, _status
    with _lock:
        if _lib is None:
            status = build()
            _lib = _bind(ctypes.CDLL(str(status.path)))
            _status = status
        return _lib


def load():
    """The library, or None when it does not build or load here. The first
    failure warns once, quoting the compiler's first lines; later calls
    return None at once."""
    global _status
    if _lib is not None:
        return _lib
    if _status is not None and not _status.built:
        return None
    try:
        return get_lib()
    except (NativeBuildError, OSError) as e:
        _status = Status(False, error=str(e))
        head = "\n".join(str(e).splitlines()[:ERROR_LINES])
        warnings.warn(f"the native decode library did not build; the loaders decode with PIL:"
                      f"\n{head}", RuntimeWarning, stacklevel=2)
        return None


def status() -> Optional[Status]:
    """What the last `load` / `get_lib` found (None before the first)."""
    return _status


def _fptr(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u8ptr(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _interp_code(interp: str) -> int:
    """'pil' (triangle / antialias, the train resize) -> 0; 'cv2'
    (INTER_LINEAR, the reference's eval resize, test.py:353-354) -> 1."""
    if interp == "pil":
        return 0
    if interp == "cv2":
        return 1
    raise ValueError(f"unknown interp {interp!r}")


def decode_resize_normalize(data: bytes, resized_hw, padded_hw, pixel_means,
                            pixel_stds=(1.0, 1.0, 1.0), to_bgr255: bool = True,
                            interp: str = "pil", scale_xy=(1.0, 1.0)):
    """Fused decode + resize + normalize + pad. Returns (image [ph, pw, 3]
    f32, (orig_h, orig_w)); raises RuntimeError when the bytes do not
    decode. interp='cv2' maps as the reference's eval cv2 INTER_LINEAR
    does, through scale_xy = (fx, fy), the resize factors (cv2 maps dst ->
    src through 1/f, which is not exactly dsize/ssize)."""
    lib = get_lib()
    rh, rw = resized_hw
    ph, pw = padded_hw
    out = np.zeros((ph, pw, 3), np.float32)
    mean = np.asarray(pixel_means, np.float32)
    std = np.asarray(pixel_stds, np.float32)
    oh, ow = ctypes.c_int(0), ctypes.c_int(0)
    fx, fy = scale_xy
    rc = lib.imgops_decode_resize_normalize(
        data, len(data), rh, rw, ph, pw, _fptr(mean), _fptr(std), 1 if to_bgr255 else 0,
        _interp_code(interp), 1.0 / float(fx), 1.0 / float(fy), _fptr(out), ctypes.byref(oh),
        ctypes.byref(ow))
    if rc != 0:
        raise RuntimeError(f"native image decode failed (rc={rc})")
    return out, (oh.value, ow.value)


def decode_resize_u8(data: bytes, resized_hw, padded_hw, to_bgr255: bool = True,
                     interp: str = "pil", scale_xy=(1.0, 1.0)):
    """Fused decode + resize + pad to uint8 in the model's channel order
    (no normalisation: the model applies the input affine on the device).
    Returns (image [ph, pw, 3] u8, (orig_h, orig_w))."""
    lib = get_lib()
    rh, rw = resized_hw
    ph, pw = padded_hw
    out = np.zeros((ph, pw, 3), np.uint8)
    oh, ow = ctypes.c_int(0), ctypes.c_int(0)
    fx, fy = scale_xy
    rc = lib.imgops_decode_resize_u8(
        data, len(data), rh, rw, ph, pw, 1 if to_bgr255 else 0, _interp_code(interp),
        1.0 / float(fx), 1.0 / float(fy), _u8ptr(out), ctypes.byref(oh), ctypes.byref(ow))
    if rc != 0:
        raise RuntimeError(f"native image decode failed (rc={rc})")
    return out, (oh.value, ow.value)


class ImagePool:
    """A pool of `n_workers` native threads that read, decode, resize and
    pad images. One pool carries one task mode: submit / wait_any (float32,
    normalised on the host) or submit_u8 / wait_any_u8 (uint8). wait_any
    returns the tasks in the order they finish; a task that failed (an
    unreadable or undecodable file) raises RuntimeError there."""

    def __init__(self, n_workers: int = 4):
        self.lib = get_lib()
        self.pool = self.lib.pool_create(n_workers)

    def submit(self, task_id: int, path: str, resized_hw, padded_hw, pixel_means,
               pixel_stds=(1.0, 1.0, 1.0), to_bgr255: bool = True, interp: str = "pil",
               scale_xy=(1.0, 1.0)):
        mean = np.asarray(pixel_means, np.float32)
        std = np.asarray(pixel_stds, np.float32)
        rh, rw = resized_hw
        ph, pw = padded_hw
        fx, fy = scale_xy
        self.lib.pool_submit(
            self.pool, task_id, path.encode(), rh, rw, ph, pw, _fptr(mean), _fptr(std),
            1 if to_bgr255 else 0, _interp_code(interp), 1.0 / float(fx), 1.0 / float(fy))

    def submit_u8(self, task_id: int, path: str, resized_hw, padded_hw,
                  to_bgr255: bool = True, interp: str = "pil", scale_xy=(1.0, 1.0)):
        rh, rw = resized_hw
        ph, pw = padded_hw
        fx, fy = scale_xy
        self.lib.pool_submit_u8(
            self.pool, task_id, path.encode(), rh, rw, ph, pw, 1 if to_bgr255 else 0,
            _interp_code(interp), 1.0 / float(fx), 1.0 / float(fy))

    def _wait(self, wait, out, ptr):
        status, oh, ow = ctypes.c_int(-1), ctypes.c_int(0), ctypes.c_int(0)
        task_id = wait(self.pool, ptr, ctypes.byref(status), ctypes.byref(oh), ctypes.byref(ow))
        if status.value != 0:
            raise RuntimeError(f"native prefetch failed for task {task_id} "
                               f"(status={status.value})")
        return task_id, out, (oh.value, ow.value)

    def wait_any(self, padded_hw):
        """(task id, image [ph, pw, 3] f32, (orig_h, orig_w)) of the next
        finished task."""
        out = np.zeros((*padded_hw, 3), np.float32)
        return self._wait(self.lib.pool_wait_any, out, _fptr(out))

    def wait_any_u8(self, padded_hw):
        out = np.zeros((*padded_hw, 3), np.uint8)
        return self._wait(self.lib.pool_wait_any_u8, out, _u8ptr(out))

    def close(self):
        """Stop and join the workers (idempotent)."""
        if self.pool:
            self.lib.pool_destroy(self.pool)
            self.pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
