"""The port's native host decode pool (cpm_tpu_torch/native) against the JAX
package's (cpm_tpu/native), bit for bit, on the CPU.

The JAX package's library is built from its own source into the session's
temporary directory (`tests/torch_support.py::jax_native`), so that no test
rewrites its tracked `_imageops.so`; the port's builds into
`build/cpm_tpu_torch/`. Held equal:

* `decode_resize_normalize` and `decode_resize_u8` on PNG and JPEG bytes,
  under PIL's taps and cv2's INTER_LINEAR mapping, at sizes that take cv2's
  2x INTER_AREA switch and sizes that do not, both channel orders;
* `ImagePool` with 4 workers: every task once, each image the single
  call's, and an undecodable file raising as it does in the JAX package;
* `TrainLoader` over data/synthetic_debug under tiny_cpm.yaml, 10 batches
  with TPU.DEVICE_NORMALIZE on and off; a batch with an image that only
  PIL decodes (the pool's batch falls back, that image to PIL) and the
  batch after it (no task of the failed batch is left in the pool);
* `TestLoader` under both eval resizes, a batch of 3, a 2x scale and a
  flipped TTA pass (which takes the PIL path);
* the JAX native path's dropped color jitter (ROADMAP Queue 3, item 35): on
  the native path TRAIN.BRIGHTNESS etc. change nothing, on the PIL path
  they do.

The library's second link route (Pillow's own libjpeg and libpng16, where
the system has no headers) decodes the same bits, and two iterations of
one loader keep pools of their own. A build that fails warns once, and the
loaders take the PIL path.

torch is never imported here: the loaders are numpy, PIL and ctypes.
"""

import io
import os
import shutil
import sys
import types
import warnings

import numpy as np
import pytest
from PIL import Image

import cpm_tpu.data.loader as jax_loader_mod
from cpm_tpu.config import get_default_cfg as jax_default_cfg
from cpm_tpu.config import merge_cfg_from_file as jax_merge_file
from cpm_tpu.config import merge_cfg_from_list as jax_merge_list
from tests.torch_support import _one_torch_thread  # noqa: F401  (autouse)
from tests.torch_support import jax_native  # noqa: F401  (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "cfgs", "debug", "tiny_cpm.yaml")
DATA_DIR = os.path.join(REPO, "data")
MEANS = (102.9801, 115.9465, 122.7717)
BATCH_FIELDS = ("images", "image_sizes", "gt_boxes", "gt_labels", "gt_mask")


@pytest.fixture(scope="module", autouse=True)
def _drop_stub_modules_that_answer_every_name():
    """tests/test_weight_parity.py leaves stub modules in `sys.modules` whose
    `__getattr__` answers every name, `__file__` included, with a function
    (tests/test_torch_data.py says why they go)."""
    for name, mod in list(sys.modules.items()):
        if isinstance(mod, types.ModuleType) and callable(getattr(mod, "__file__", None)):
            del sys.modules[name]


def _image(h=61, w=93, seed=0):
    """A smooth gradient with noise: JPEG's blocks and the resizes' taps
    both have something to round."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 / w, yy * 255 / h, (xx + yy) * 127 / (h + w)], -1)
    return np.clip(base + rng.randint(-20, 21, (h, w, 3)), 0, 255).astype(np.uint8)


def _encoded(arr, fmt):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format=fmt, **({"quality": 90} if fmt == "JPEG" else {}))
    return buf.getvalue()


def _cfgs(*opts):
    """(JAX cfg, port cfg) from tiny_cpm.yaml over the repository's data."""
    from cpm_tpu_torch.config import get_default_cfg, merge_cfg_from_file, merge_cfg_from_list

    opts = ["DATA_DIR", DATA_DIR, *opts]
    want = jax_default_cfg()
    jax_merge_file(TINY, want)
    jax_merge_list(opts, want)
    got = get_default_cfg()
    merge_cfg_from_file(TINY, got)
    merge_cfg_from_list(opts, got)
    return want, got


def _datasets(want_cfg, got_cfg, is_train=True):
    from cpm_tpu.data.coco import build_dataset as jax_build_dataset

    from cpm_tpu_torch.data.coco import build_dataset

    (want,) = jax_build_dataset(want_cfg, want_cfg.TRAIN.DATASETS, is_train=is_train)
    (got,) = build_dataset(got_cfg, got_cfg.TRAIN.DATASETS, is_train=is_train)
    return want, got


def _batches(loader, n):
    it = iter(loader)
    try:
        return [next(it) for _ in range(n)]
    finally:
        if hasattr(it, "close"):
            it.close()


def _assert_same(got, want, fields):
    for f in fields:
        assert got[f].dtype == want[f].dtype and got[f].shape == want[f].shape, f
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


DECODE_CASES = [
    # (interp, resized (h, w), scale_xy): PIL's taps down and up; cv2 at an
    # exact 2x (its INTER_AREA switch), at 1.7x and at unequal factors
    ("pil", (30, 47), (1.0, 1.0)),
    ("pil", (90, 140), (1.0, 1.0)),
    ("cv2", (31, 47), (0.5, 0.5)),
    ("cv2", (104, 158), (1.7, 1.7)),
    ("cv2", (25, 38), (0.41, 0.41)),
]


@pytest.mark.parametrize("fmt", ["PNG", "JPEG"])
def test_decode_ops_are_bit_equal_to_the_jax_packages(jax_native, fmt):  # noqa: F811
    from cpm_tpu_torch import native

    data = _encoded(_image(), fmt)
    for interp, resized, scale_xy in DECODE_CASES:
        padded = (resized[0] + 3, resized[1] + 5)
        for to_bgr in (True, False):
            stds = (1.0, 1.0, 1.0) if to_bgr else (0.229, 0.224, 0.225)
            means = MEANS if to_bgr else (0.485, 0.456, 0.406)
            got = native.decode_resize_normalize(data, resized, padded, means, stds, to_bgr,
                                                 interp=interp, scale_xy=scale_xy)
            want = jax_native.decode_resize_normalize(data, resized, padded, means, stds,
                                                      to_bgr, interp=interp, scale_xy=scale_xy)
            assert got[1] == want[1] == (61, 93)
            assert got[0].dtype == np.float32
            np.testing.assert_array_equal(got[0], want[0], err_msg=f"{interp} {resized}")
            got = native.decode_resize_u8(data, resized, padded, to_bgr, interp, scale_xy)
            want = jax_native.decode_resize_u8(data, resized, padded, to_bgr, interp, scale_xy)
            assert got[1] == want[1] and got[0].dtype == np.uint8
            np.testing.assert_array_equal(got[0], want[0], err_msg=f"u8 {interp} {resized}")
    with pytest.raises(RuntimeError, match="native image decode failed"):
        native.decode_resize_normalize(b"not an image", (8, 8), (8, 8), MEANS)


def test_the_pillow_route_decodes_as_the_jax_packages_library(jax_native, monkeypatch,  # noqa: F811
                                                              tmp_path):
    """Where g++ finds no jpeglib.h / png.h, the library links Pillow's own
    libjpeg and libpng16 through the headers of cpm_tpu_torch/native/include.
    Forced here (the host has the system's headers too): it builds into
    BUILD_DIR alone, and its decodes are the JAX package's library's, built
    on the system's libraries, bit for bit."""
    from cpm_tpu_torch import native

    if native.pillow_libraries() is None:
        pytest.skip("this Pillow carries no libjpeg / libpng16 of its own")
    monkeypatch.setattr(native, "_system_headers_missing", lambda: "jpeglib.h")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_status", None)
    assert native.missing_prerequisites() is None and native.route().name == "pillow"
    assert native.load() is not None and native.status().route == "pillow"
    assert [p.name for p in (tmp_path / "build").iterdir()] == [native.status().path.name]
    for fmt in ("PNG", "JPEG"):
        data = _encoded(_image(seed=3), fmt)
        for interp, resized, scale_xy in DECODE_CASES[1:3]:
            padded = (resized[0] + 2, resized[1] + 1)
            got = native.decode_resize_u8(data, resized, padded, True, interp, scale_xy)
            want = jax_native.decode_resize_u8(data, resized, padded, True, interp, scale_xy)
            np.testing.assert_array_equal(got[0], want[0], err_msg=f"{fmt} {interp}")
            got = native.decode_resize_normalize(data, resized, padded, MEANS, interp=interp,
                                                 scale_xy=scale_xy)
            want = jax_native.decode_resize_normalize(data, resized, padded, MEANS,
                                                      interp=interp, scale_xy=scale_xy)
            np.testing.assert_array_equal(got[0], want[0], err_msg=f"{fmt} {interp}")
    monkeypatch.setattr(native, "pillow_libraries", lambda: None)
    assert "jpeglib.h not found" in native.missing_prerequisites()


def test_image_pool_collects_every_task_and_raises_as_the_jax_one(jax_native, tmp_path):  # noqa: F811
    from cpm_tpu_torch import native

    paths = []
    for t in range(8):
        arr = _image(40 + 3 * t, 70 - 2 * t, seed=t)
        paths.append(str(tmp_path / f"{t}.{'png' if t % 2 else 'jpg'}"))
        Image.fromarray(arr).save(paths[-1])
    plans = [(p, (20 + t, 30 + t)) for t, p in enumerate(paths)]
    padded = (40, 50)
    for u8 in (False, True):
        got_pool, want_pool = native.ImagePool(4), jax_native.ImagePool(4)
        try:
            for pool in (got_pool, want_pool):
                for t, (p, hw) in enumerate(plans):
                    if u8:
                        pool.submit_u8(t, p, hw, padded, True, "cv2", (0.5, 0.5))
                    else:
                        pool.submit(t, p, hw, padded, MEANS)
            got, want = {}, {}
            for pool, out in ((got_pool, got), (want_pool, want)):
                for _ in plans:
                    t, img, orig = (pool.wait_any_u8 if u8 else pool.wait_any)(padded)
                    assert t not in out
                    out[t] = (img, orig)
            assert set(got) == set(want) == set(range(len(plans)))
            for t, (p, hw) in enumerate(plans):
                with open(p, "rb") as f:
                    data = f.read()
                one = (native.decode_resize_u8(data, hw, padded, True, "cv2", (0.5, 0.5)) if u8
                       else native.decode_resize_normalize(data, hw, padded, MEANS))
                for img, orig in (got[t], want[t]):
                    np.testing.assert_array_equal(img, one[0])
                    assert orig == one[1]
        finally:
            got_pool.close()
            want_pool.close()
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"\xff\xd8 not a jpeg")
    messages = []
    for pool in (native.ImagePool(4), jax_native.ImagePool(4)):
        pool.submit(5, str(bad), (8, 8), (8, 8), MEANS)
        with pytest.raises(RuntimeError) as e:
            pool.wait_any((8, 8))
        messages.append(str(e.value))
        pool.close()
        pool.close()  # idempotent
    assert messages[0] == messages[1] == "native prefetch failed for task 5 (status=-1)"


@pytest.mark.parametrize("device_normalize", [True, False])
def test_train_loader_yields_the_jax_native_paths_batches(jax_native, device_normalize,  # noqa: F811
                                                          monkeypatch):
    from cpm_tpu_torch import native
    from cpm_tpu_torch.data.loader import TrainLoader

    opened = []

    class RecordedPool(native.ImagePool):
        def __init__(self, n_workers):
            super().__init__(n_workers)
            opened.append((self, n_workers))

    monkeypatch.setattr(native, "ImagePool", RecordedPool)
    want_cfg, got_cfg = _cfgs("TPU.DEVICE_NORMALIZE", str(device_normalize))
    jd, pd = _datasets(want_cfg, got_cfg)
    want_loader = jax_loader_mod.TrainLoader(want_cfg, jd, 2, seed=5)
    assert want_loader.pool is not None
    loader = TrainLoader(got_cfg, pd, 2, seed=5)
    assert loader.decode_path == "native"
    got, want = _batches(loader, 10), _batches(want_loader, 10)
    for g, w in zip(got, want):
        _assert_same(g, w, BATCH_FIELDS)
    assert got[0]["images"].dtype == (np.uint8 if device_normalize else np.float32)
    # the prefetch thread may have made a batch or two beyond the 10
    assert loader.decoded["native"] >= 20 and loader.decoded["pil"] == 0
    # one pool of 4 threads for the iteration, closed with the iterator
    assert [n for _, n in opened] == [4] and opened[0][0].pool is None


def test_two_iterations_of_one_loader_keep_their_own_pools(jax_native):  # noqa: F811
    """Each iteration opens and closes a pool of its own: closing one
    iterator leaves the other's batches as a lone iterator's."""
    from cpm_tpu_torch.data.loader import TrainLoader

    _, cfg = _cfgs()
    _, dataset = _datasets(*_cfgs())
    loader = TrainLoader(cfg, dataset, 2, seed=5, prefetch=0)
    alone = _batches(TrainLoader(cfg, dataset, 2, seed=5, prefetch=0), 3)
    first, second = iter(loader), iter(loader)
    got = [next(first), next(second)]
    first.close()
    got += [next(second), next(second)]
    second.close()
    for g, w in zip(got, [alone[0]] + alone[:3]):
        _assert_same(g, w, BATCH_FIELDS)


def test_an_image_only_pil_decodes_falls_back_as_in_the_jax_package(jax_native, tmp_path):  # noqa: F811
    from cpm_tpu_torch.data.loader import TrainLoader

    shutil.copytree(os.path.join(DATA_DIR, "synthetic_debug"), tmp_path / "synthetic_debug")
    # image 3 as BMP bytes under its .jpg name: PIL reads it, libjpeg and
    # libpng do not
    path = tmp_path / "synthetic_debug" / "images" / "000003.jpg"
    arr = np.asarray(Image.open(path).convert("RGB"))
    Image.fromarray(arr).save(path, format="BMP")
    want_cfg, got_cfg = _cfgs()
    # the datasets built on the copy directly: the JAX catalog keeps the
    # first root that registered the synthetic set's name
    from cpm_tpu.data.coco import COCODataset as JaxCOCODataset

    from cpm_tpu_torch.data.coco import COCODataset

    root = tmp_path / "synthetic_debug"
    kw = dict(ann_file=str(root / "instances.json"), root=str(root / "images"))
    jd, pd = JaxCOCODataset(**kw), COCODataset(**kw)
    assert jd.image_path(3) == pd.image_path(3) == str(path)
    want_loader = jax_loader_mod.TrainLoader(want_cfg, jd, 2, seed=5)
    loader = TrainLoader(got_cfg, pd, 2, seed=5)
    pool = loader._open_pool()
    try:
        for batch in ([3, 7], [4, 9]):
            rng_seed = 11 + batch[0]
            got = loader._make_batch(batch, np.random.RandomState(rng_seed), pool)
            # a fresh JAX pool a batch: the JAX loader leaves a failed
            # batch's other tasks in its pool
            want_loader.pool = jax_native.ImagePool(2)
            want = want_loader._make_batch(batch, np.random.RandomState(rng_seed))
            want_loader.pool.close()
            _assert_same(got, want, BATCH_FIELDS)
    finally:
        pool.close()
    assert loader.decoded == {"native": 3, "pil": 1}


@pytest.mark.parametrize("backend", ["cv2", "pil"])
def test_test_loader_equals_the_jax_native_path(jax_native, backend):  # noqa: F811
    from cpm_tpu_torch.data.loader import TestLoader

    for dn in ("True", "False"):
        want_cfg, got_cfg = _cfgs("TPU.EVAL_RESIZE", backend, "TPU.DEVICE_NORMALIZE", dn)
        jd, pd = _datasets(want_cfg, got_cfg, is_train=False)
        for kw in (dict(start=3, end=11, batch_size=3), dict(scale=30, max_size=48, end=6),
                   dict(hflip=True, scale=48, max_size=96, end=4)):
            loader = TestLoader(got_cfg, pd, **kw)
            assert loader.decode_path == ("pil" if kw.get("hflip") else "native")
            want = list(jax_loader_mod.TestLoader(want_cfg, jd, **kw))
            got = list(loader)
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                assert set(g) == set(w)
                for k in w:
                    if isinstance(w[k], np.ndarray):
                        assert g[k].dtype == w[k].dtype
                        np.testing.assert_array_equal(g[k], w[k])
                    else:
                        assert g[k] == w[k], k
            assert loader.decoded[loader.decode_path] == len(loader)


def test_the_native_train_path_drops_the_color_jitter(jax_native, monkeypatch):  # noqa: F811
    """ROADMAP Queue 3, item 35: the JAX native path never applies
    TrainTransform.color_jitter (cpm_tpu/data/transforms.py:313-314 runs on
    the PIL path only), and the port follows it."""
    import cpm_tpu_torch.data.loader as port_loader_mod
    from cpm_tpu_torch.data.loader import TrainLoader

    jitter = ("TRAIN.BRIGHTNESS", "0.4", "TRAIN.CONTRAST", "0.4", "TRAIN.SATURATION", "0.4",
              "TRAIN.HUE", "0.1")
    want_cfg, got_cfg = _cfgs(*jitter)
    _, plain_cfg = _cfgs()
    jd, pd = _datasets(want_cfg, got_cfg)
    jittered = _batches(TrainLoader(got_cfg, pd, 2, seed=5), 3)
    plain = _batches(TrainLoader(plain_cfg, pd, 2, seed=5), 3)
    want = _batches(jax_loader_mod.TrainLoader(want_cfg, jd, 2, seed=5), 3)
    for j, p, w in zip(jittered, plain, want):
        _assert_same(j, w, BATCH_FIELDS)
        _assert_same(j, p, BATCH_FIELDS)
    # on the PIL path the same keys jitter the images
    monkeypatch.setattr(port_loader_mod, "_native", lambda: None)
    pil_jittered = _batches(TrainLoader(got_cfg, pd, 2, seed=5), 1)[0]
    pil_plain = _batches(TrainLoader(plain_cfg, pd, 2, seed=5), 1)[0]
    assert not np.array_equal(pil_jittered["images"], pil_plain["images"])


def test_a_failed_build_warns_once_and_the_loaders_take_pil(monkeypatch, tmp_path):
    from cpm_tpu_torch import native
    from cpm_tpu_torch.data.loader import TestLoader, TrainLoader

    broken = tmp_path / "imageops.cpp"
    broken.write_text("int broken( {\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_status", None)
    _, cfg = _cfgs()
    _, dataset = _datasets(*_cfgs())
    with pytest.warns(RuntimeWarning, match="did not build") as record:
        loader = TrainLoader(cfg, dataset, 2, seed=1)
    assert "imageops.cpp" in str(record[0].message) and "error" in str(record[0].message)
    assert loader.decode_path == "pil" and not native.status().built
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the warning came once
        assert TestLoader(cfg, dataset, end=2).decode_path == "pil"
        batch = _batches(loader, 1)[0]
    assert batch["images"].shape == (2, 64, 128, 3)
    assert loader.decoded["native"] == 0 and loader.decoded["pil"] >= 2
    assert not list((tmp_path / "build").glob("*.so"))
