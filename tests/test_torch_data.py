"""The port's data pipeline against the JAX package's.

Both read the repository's synthetic COCO set (data/synthetic_debug: 16
JPEGs, 38 annotations) under cfgs/debug/tiny_cpm.yaml. The port's annotation
index, dataset, transforms and repeat-factor indices must equal the JAX
package's; its TrainLoader must yield the JAX TrainLoader's batches bit for
bit, on the PIL path (both packages' native libraries switched off in this
test) and on the native path (the default of both; the JAX package's
library built from its own source by `tests/torch_support.py::jax_native`,
and tests/test_torch_native.py holds the rest of that path); a loader
resumed at start_iter must continue the uninterrupted stream; its
TestLoader must equal the JAX one (PIL path, both eval resize backends).
The TestLoader's prefetch thread must hand over its synchronous path's
items bit for bit and in order, pass an error on to the consumer and end
with the iterator, also where zip stops at a shorter loader.

torch is never imported here: the loaders are numpy and PIL.
"""

import os
import sys
import types

import numpy as np
import pytest

import cpm_tpu.data.loader as jax_loader_mod
from cpm_tpu.config import get_default_cfg as jax_default_cfg
from cpm_tpu.config import merge_cfg_from_file as jax_merge_file
from cpm_tpu.config import merge_cfg_from_list as jax_merge_list
from tests.torch_support import _one_torch_thread  # noqa: F401  (autouse)
from tests.torch_support import jax_native  # noqa: F401  (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "cfgs", "debug", "tiny_cpm.yaml")
DATA_DIR = os.path.join(REPO, "data")
BATCH_FIELDS = ("images", "image_sizes", "gt_boxes", "gt_labels", "gt_mask")


@pytest.fixture(scope="module", autouse=True)
def _drop_stub_modules_that_answer_every_name():
    """tests/test_weight_parity.py leaves stub modules in `sys.modules` whose
    `__getattr__` answers every name, `__file__` included, with a function.
    torch registers custom ops at the first backward or optimizer of a process
    and looks its caller up with `inspect.getmodule`, which walks
    `sys.modules` and fails on such a `__file__`. Whether that file ran
    earlier in this worker depends on the scheduling, so the stubs go before
    this file's first torch call; that file installs them again when it needs
    them."""
    for name, mod in list(sys.modules.items()):
        if isinstance(mod, types.ModuleType) and callable(getattr(mod, "__file__", None)):
            del sys.modules[name]


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


@pytest.fixture
def pil_paths(monkeypatch):
    """Both packages' loaders on their PIL path."""
    import cpm_tpu_torch.data.loader as port_loader_mod

    monkeypatch.setattr(jax_loader_mod, "_native", lambda: None)
    monkeypatch.setattr(port_loader_mod, "_native", lambda: None)


def test_coco_index_and_dataset_equal_the_jax_packages():
    from cpm_tpu.data.coco_io import CocoIndex as JaxIndex

    from cpm_tpu_torch.data.coco_io import CocoIndex

    ann = os.path.join(DATA_DIR, "synthetic_debug", "instances.json")
    want, got = JaxIndex(ann), CocoIndex(ann)
    assert got.imgs == want.imgs and got.cats == want.cats and got.anns == want.anns
    assert got.getImgIds() == want.getImgIds() and got.getCatIds() == want.getCatIds()
    for img_id in want.getImgIds():
        assert got.getAnnIds(imgIds=img_id) == want.getAnnIds(imgIds=img_id)
        assert got.getAnnIds(imgIds=[img_id], iscrowd=0) == want.getAnnIds(imgIds=[img_id], iscrowd=0)
    results = [dict(image_id=1, category_id=2, bbox=[1.0, 2.0, 3.0, 4.0], score=0.5)]
    assert got.loadRes(results).dataset == want.loadRes(results).dataset
    assert len(want.getImgIds()) == 16 and len(want.anns) == 38

    for is_train in (True, False):
        jd, pd = _datasets(*_cfgs(), is_train=is_train)
        assert pd.ids == jd.ids and len(pd) == len(jd) == 16
        assert pd.json_category_id_to_contiguous_id == jd.json_category_id_to_contiguous_id
        assert pd.contiguous_category_id_to_json_id == jd.contiguous_category_id_to_json_id
        np.testing.assert_array_equal(pd.aspect_ratios(), jd.aspect_ratios())
        for i in range(len(jd)):
            for a, b in zip(pd.load_annotations(i), jd.load_annotations(i)):
                np.testing.assert_array_equal(a, b)
                assert a.dtype == b.dtype
        np.testing.assert_array_equal(pd.load_image(3), jd.load_image(3))


def test_synthetic_set_is_not_rewritten_when_it_is_there(tmp_path):
    from cpm_tpu.data.synthetic_coco import materialize as jax_materialize

    from cpm_tpu_torch.data.synthetic_coco import materialize

    root = os.path.join(DATA_DIR, "synthetic_debug")
    stamps = {f: os.stat(os.path.join(root, "images", f)).st_mtime_ns
              for f in os.listdir(os.path.join(root, "images"))}
    assert materialize(root) == (os.path.join(root, "images"), os.path.join(root, "instances.json"))
    assert stamps == {f: os.stat(os.path.join(root, "images", f)).st_mtime_ns for f in stamps}
    # written afresh elsewhere, the same set as the JAX package writes
    jax_materialize(str(tmp_path / "jax"))
    materialize(str(tmp_path / "port"))
    for name in ["instances.json"] + [os.path.join("images", f) for f in sorted(stamps)]:
        with open(tmp_path / "jax" / name, "rb") as f, open(tmp_path / "port" / name, "rb") as g:
            assert f.read() == g.read(), name


def test_transforms_equal_the_jax_packages():
    from cpm_tpu.data import transforms as jt

    from cpm_tpu_torch.data import transforms as pt

    for hw in [(60, 96), (96, 60), (480, 640), (427, 640), (800, 800), (333, 1000)]:
        for shortest, max_size in [(800, 1333), (64, 128), (600, 1000), (640, 640)]:
            assert pt.get_resize_size(hw, shortest, max_size) == jt.get_resize_size(hw, shortest, max_size)
            assert (pt.get_blob_scale_size(hw, shortest, max_size)
                    == jt.get_blob_scale_size(hw, shortest, max_size))
    rng = np.random.RandomState(0)
    image = rng.randint(0, 256, (61, 93, 3)).astype(np.uint8)
    boxes = np.array([[1.0, 2.0, 30.0, 40.0], [10.0, 5.0, 92.0, 60.0]], np.float32)
    for fx, fy in [(1.7, 1.7), (0.5, 0.5), (13.3, 13.3), (0.37, 0.41)]:
        np.testing.assert_array_equal(pt.cv2_linear_resize(image, fx, fy),
                                      jt.cv2_linear_resize(image, fx, fy))
    for a, b in zip(pt.resize_image_and_boxes(image, boxes, 800, 1333),
                    jt.resize_image_and_boxes(image, boxes, 800, 1333)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(pt.hflip_image_and_boxes(image, boxes), jt.hflip_image_and_boxes(image, boxes)):
        np.testing.assert_array_equal(a, b)
    jitter = (0.4, 0.4, 0.4, 0.1)
    np.testing.assert_array_equal(pt.ColorJitter(*jitter)(image, np.random.RandomState(3)),
                                  jt.ColorJitter(*jitter)(image, np.random.RandomState(3)))

    for opts in ([], ["TRAIN.BRIGHTNESS", "0.3", "TRAIN.HUE", "0.05", "TO_BGR255", "True"]):
        want_cfg, got_cfg = _cfgs(*opts)
        for normalize in (True, False):
            a = pt.TrainTransform(got_cfg, normalize)(image, boxes, np.random.RandomState(7))
            b = jt.TrainTransform(want_cfg, normalize)(image, boxes, np.random.RandomState(7))
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
            for backend in ("cv2", "pil"):
                a = pt.TestTransform(got_cfg, normalize=normalize, backend=backend)(image)
                b = jt.TestTransform(want_cfg, normalize=normalize, backend=backend)(image)
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(x, y)


def test_repeat_factor_indices_equal_the_jax_packages():
    from cpm_tpu.data import samplers as js

    from cpm_tpu_torch.data import samplers as ps

    jd, pd = _datasets(*_cfgs())
    want = js.repeat_factors_from_category_frequency(jd, repeat_thresh=0.3, pow_=1.0)
    got = ps.repeat_factors_from_category_frequency(pd, repeat_thresh=0.3, pow_=1.0)
    np.testing.assert_array_equal(got, want)
    assert (want > 1).any() and (want == 1).any()
    for epoch_seed in range(4):
        np.testing.assert_array_equal(ps.repeat_factor_indices(got, epoch_seed),
                                      js.repeat_factor_indices(want, epoch_seed))


def _batches(loader, n):
    it = iter(loader)
    try:
        return [next(it) for _ in range(n)]
    finally:
        if hasattr(it, "close"):
            it.close()


def _assert_same_batches(got, want, image_levels=0):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(BATCH_FIELDS)
        for f in BATCH_FIELDS:
            assert g[f].dtype == w[f].dtype and g[f].shape == w[f].shape, (i, f)
            if f == "images" and image_levels:
                diff = np.abs(g[f].astype(np.int32) - w[f].astype(np.int32)).max()
                assert diff <= image_levels, (i, diff)
            else:
                np.testing.assert_array_equal(g[f], w[f], err_msg=f"batch {i} {f}")


@pytest.mark.parametrize("sampler", ["DistributedSampler", "RepeatFactorTrainingSampler"])
def test_train_loader_yields_the_jax_pil_paths_batches(pil_paths, sampler):
    from cpm_tpu_torch.data.loader import TrainLoader

    want_cfg, got_cfg = _cfgs("DATALOADER.SAMPLER_TRAIN", sampler,
                              "DATALOADER.RFTSAMPLER.REPEAT_THRESHOLD", "0.3")
    jd, pd = _datasets(want_cfg, got_cfg)
    want_loader = jax_loader_mod.TrainLoader(want_cfg, jd, 2, seed=5)
    assert want_loader.pool is None
    # 16 images, all landscape, 2 a batch: 8 batches an epoch (fewer or more
    # under repeat factors), so 10 cross an epoch boundary
    want = _batches(want_loader, 10)
    loader = TrainLoader(got_cfg, pd, 2, seed=5)
    assert loader.decode_path == "pil"
    got = _batches(loader, 10)
    _assert_same_batches(got, want)
    assert want[0]["images"].dtype == np.uint8 and want[0]["images"].shape == (2, 64, 128, 3)


def test_train_loader_is_within_one_level_of_the_jax_native_path(jax_native):  # noqa: F811
    """Both loaders on their default, native path: bit for bit (0 levels)."""
    from cpm_tpu_torch.data.loader import TrainLoader

    want_cfg, got_cfg = _cfgs()
    jd, pd = _datasets(want_cfg, got_cfg)
    want_loader = jax_loader_mod.TrainLoader(want_cfg, jd, 2, seed=5)
    assert want_loader.pool is not None
    loader = TrainLoader(got_cfg, pd, 2, seed=5)
    assert loader.decode_path == "native"
    _assert_same_batches(_batches(loader, 10), _batches(want_loader, 10), image_levels=0)


def test_start_iter_continues_the_uninterrupted_stream():
    from cpm_tpu_torch.data.loader import TrainLoader

    _, cfg = _cfgs()
    _, dataset = _datasets(*_cfgs())
    straight = _batches(TrainLoader(cfg, dataset, 2, seed=1, prefetch=0), 11)
    resumed = _batches(TrainLoader(cfg, dataset, 2, seed=1, start_iter=3), 8)
    _assert_same_batches(resumed, straight[3:])


def test_train_loader_thread_ends_with_the_iterator_and_hands_on_errors():
    import threading

    from cpm_tpu_torch.data.loader import TrainLoader

    _, cfg = _cfgs()
    _, dataset = _datasets(*_cfgs())
    from cpm_tpu_torch.data.loader import PREFETCH_THREAD

    def prefetching():
        return sum(t.name == PREFETCH_THREAD for t in threading.enumerate())

    before = prefetching()
    it = iter(TrainLoader(cfg, dataset, 2, seed=1, prefetch=1))
    next(it)
    assert prefetching() == before + 1
    it.close()
    assert prefetching() == before

    class Broken(TrainLoader):
        def _make_batch(self, batch_indices, rng, pool=None):
            raise OSError("unreadable image")

    with pytest.raises(OSError, match="unreadable image"):
        next(iter(Broken(cfg, dataset, 2)))
    assert prefetching() == before


@pytest.mark.parametrize("backend", ["cv2", "pil"])
def test_test_loader_equals_the_jax_one(pil_paths, backend):
    from cpm_tpu_torch.data.loader import TestLoader

    want_cfg, got_cfg = _cfgs("TPU.EVAL_RESIZE", backend)
    jd, pd = _datasets(want_cfg, got_cfg, is_train=False)
    for kw in (dict(), dict(start=3, end=11, batch_size=3), dict(hflip=True, scale=48, max_size=96)):
        want = list(jax_loader_mod.TestLoader(want_cfg, jd, **kw))
        got = list(TestLoader(got_cfg, pd, **kw))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                if isinstance(w[k], np.ndarray):
                    assert g[k].dtype == w[k].dtype
                    np.testing.assert_array_equal(g[k], w[k])
                else:
                    assert g[k] == w[k], k


# the default loader against its synchronous path, over seeded JPEGs of
# both orientations: batch 1; a batch of 3, whose partial batches of each
# orientation are flushed at the end; a flip pass (the PIL path) at twice
# the eval scale
PREFETCH_CASES = {"batch_1": dict(), "batch_3": dict(start=1, end=9, batch_size=3),
                  "flip_2x": dict(hflip=True, scale=128, max_size=256, end=6)}
MIXED = {"images": 9, "aspects": [[80, 60, 0.5], [60, 80, 0.5]],
         "instances": {"mean": 2, "min": 1, "max": 4},
         "area_split": {"small": 0.5, "medium": 0.5, "large": 0.0}, "classes": 8,
         "jpeg_quality": 90}


def _mixed_dataset(root):
    from benchmark.traffic import write_coco_tree
    from cpm_tpu_torch.data.coco import COCODataset

    tree = write_coco_tree(MIXED, 7, str(root))
    return COCODataset(tree["annotations"], tree["images"])


def _prefetching_threads():
    import threading

    from cpm_tpu_torch.data.loader import TEST_PREFETCH_THREAD

    return [t for t in threading.enumerate() if t.name == TEST_PREFETCH_THREAD]


def _no_prefetching_thread_within(seconds):
    import time

    deadline = time.monotonic() + seconds
    while _prefetching_threads() and time.monotonic() < deadline:
        time.sleep(0.01)
    return not _prefetching_threads()


@pytest.mark.parametrize("case", sorted(PREFETCH_CASES))
def test_prefetching_test_loader_yields_the_synchronous_items(case, tmp_path):
    from cpm_tpu_torch.data.loader import TestLoader

    _, cfg = _cfgs()
    dataset = _mixed_dataset(tmp_path)
    kw = PREFETCH_CASES[case]
    alone = TestLoader(cfg, dataset, prefetch=0, **kw)
    ahead = TestLoader(cfg, dataset, **kw)
    assert ahead.prefetch == 2
    want, got = list(alone), list(ahead)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])
            else:
                assert g[k] == w[k], k
    assert ahead.decode_path == alone.decode_path
    assert ahead.decode_path == "pil" or not kw.get("hflip")
    assert ahead.decoded == alone.decoded and sum(ahead.decoded.values()) == len(ahead)
    assert ahead.decoded_s > 0 and alone.decoded_s > 0
    assert sum(ahead.prefetched.values()) == len(got)
    assert alone.prefetched == {"ready": 0, "waited": 0}
    portrait = {w["images"].shape[1] > w["images"].shape[2] for w in want}
    assert portrait == {True, False}
    if case == "batch_3":
        assert sorted(w["count"] for w in want) == [1, 1, 3, 3]
    assert _no_prefetching_thread_within(1.0)


def test_a_slow_consumer_finds_the_test_items_ready():
    import time

    from cpm_tpu_torch.data.loader import TestLoader

    _, cfg = _cfgs()
    _, dataset = _datasets(*_cfgs(), is_train=False)
    loader = TestLoader(cfg, dataset, end=6)
    n = 0
    for _ in loader:
        n += 1
        time.sleep(0.1)  # the forward the items are made beside
    assert n == 6 and sum(loader.prefetched.values()) == n
    assert loader.prefetched["ready"] >= n - 1


def test_each_test_loaders_thread_starts_at_iter():
    """zip(*loaders) calls iter() on every TTA pass's loader first: each
    thread makes its first item before any is asked for."""
    import time

    from cpm_tpu_torch.data.loader import TestLoader

    _, cfg = _cfgs()
    _, dataset = _datasets(*_cfgs(), is_train=False)
    assert _no_prefetching_thread_within(1.0)
    loaders = [TestLoader(cfg, dataset, end=3, hflip=flip) for flip in (False, True, False)]
    its = [iter(x) for x in loaders]
    assert len(_prefetching_threads()) == 3
    deadline = time.monotonic() + 10
    # a second image begun means the first one's item is in the queue
    while min(sum(x.decoded.values()) for x in loaders) < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert [next(it)["index"] for it in its] == [0, 0, 0]
    assert [x.prefetched for x in loaders] == [{"ready": 1, "waited": 0}] * 3
    del its
    assert _no_prefetching_thread_within(1.0)
    # an iterator dropped before its first item
    it = iter(TestLoader(cfg, dataset))
    assert len(_prefetching_threads()) == 1
    del it
    assert _no_prefetching_thread_within(1.0)


def test_test_loader_errors_reach_the_consumer_and_its_threads_end():
    from cpm_tpu_torch.data.loader import TestLoader

    _, cfg = _cfgs()
    _, dataset = _datasets(*_cfgs(), is_train=False)
    assert _no_prefetching_thread_within(1.0)

    class Broken(TestLoader):
        def _load_one_test(self, i):
            if i == 2:
                raise OSError("unreadable image")
            return super()._load_one_test(i)

    it = iter(Broken(cfg, dataset, end=5))
    assert [next(it)["index"] for _ in range(2)] == [0, 1]
    with pytest.raises(OSError, match="unreadable image"):
        next(it)
    assert _no_prefetching_thread_within(1.0)

    # zip stops at the shortest loader; the others are closed with it
    pairs = list(zip(TestLoader(cfg, dataset, end=2), TestLoader(cfg, dataset, end=6),
                     TestLoader(cfg, dataset, end=6, hflip=True)))
    assert [a["index"] for a, _, _ in pairs] == [0, 1]
    assert _no_prefetching_thread_within(1.0)
    # an iterator dropped after its first item
    assert next(iter(TestLoader(cfg, dataset, start=4)))["index"] == 4
    assert _no_prefetching_thread_within(1.0)
