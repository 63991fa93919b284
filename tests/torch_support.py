"""What the port's CPU tests (tests/test_torch_*.py) share to keep their cost
down under pytest-xdist.

* `one_torch_thread`: torch's intra-op pool at one thread. The tests run
  tiny models, hundreds of small convs; several workers to the cores, each
  with a pool of every core, spin against one another and slow such a test
  tens of times. `_one_torch_thread` is that pin as a module-scoped autouse
  fixture: a test file imports it (`from tests.torch_support import
  _one_torch_thread`), and pytest applies it to every test of the file.
* `shared`: a module fixture's JAX side computed once a session, not once a
  worker that runs one of its tests (pytest-xdist's documented pattern: a
  file lock in the directory that the session's workers share; the first
  worker computes and pickles the numpy results, the others wait on the
  lock and read them). Without xdist it just computes.
* `memo`: a module fixture's value kept for the rest of the process. A
  worker of `--dist load` may run a module's tests in several runs with
  other modules' between them, and pytest sets a module fixture up again
  for each run.

torch is imported inside the functions, so that importing this module loads
no torch into a test worker.
"""

import contextlib
import fcntl
import os
import pickle

import pytest


@contextlib.contextmanager
def one_torch_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the importing file's tests."""
    with one_torch_thread():
        yield


_MEMO = {}


def memo(name: str, compute):
    """compute() once a process."""
    if name not in _MEMO:
        _MEMO[name] = compute()
    return _MEMO[name]


def shared(tmp_path_factory, name: str, compute):
    """compute(), or what another worker of this session computed under
    `name`; the value must pickle (numpy arrays, dicts, tuples)."""
    return memo(f"shared {name}", lambda: _shared(tmp_path_factory, name, compute))


def _shared(tmp_path_factory, name, compute):
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        return compute()
    root = tmp_path_factory.getbasetemp().parent
    path = root / f"shared_{name}.pkl"
    with open(root / f"shared_{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if path.exists():
                with open(path, "rb") as f:
                    return pickle.load(f)
            value = compute()
            tmp = path.with_suffix(".tmp")
            with open(tmp, "wb") as f:
                pickle.dump(value, f)
            os.replace(tmp, path)
            return value
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


@pytest.fixture(scope="session")
def jax_native(tmp_path_factory):
    """The JAX package's native decode library (cpm_tpu/native), compiled by
    that package's own build command from its own source into the session's
    temporary directory (once a session, under a file lock that the xdist
    workers share), and put in place of the tracked `_imageops.so` for the
    session: `_SO` points at it, the loaded `_lib` and the JAX loader's
    cache are reset. So no test rewrites the tracked library, and none
    depends on its age. Yields the `cpm_tpu.native` module."""
    import cpm_tpu.data.loader as jax_loader
    import cpm_tpu.native as native

    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    so = root / "jax_imageops.so"
    mp = pytest.MonkeyPatch()
    try:
        with open(root / "jax_imageops.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                if not so.exists():
                    tmp = root / f"jax_imageops.{os.getpid()}.so"
                    mp.setattr(native, "_SO", str(tmp))
                    native._build()
                    os.replace(tmp, so)
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)
        mp.setattr(native, "_SO", str(so))
        mp.setattr(native, "_lib", None)
        mp.setattr(jax_loader, "_NATIVE", None)
        native.get_lib()
        yield native
    finally:
        mp.undo()
