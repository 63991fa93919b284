"""The traffic generator: deterministic per seed, the mix's counts exact,
the same work for every seed."""

import json
from collections import Counter

import numpy as np

from benchmark.registry import HERE
from benchmark.traffic import area_classes, exact_counts, instance_counts, write_coco_tree


def _mix(name):
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def _small(mix, images):
    """The mix at a tenth of its image sizes, `images` images (fast here)."""
    m = dict(mix, images=images)
    m["aspects"] = [[w // 10, h // 10, s] for w, h, s in mix["aspects"]]
    return m


def test_exact_counts_follow_the_shares():
    assert exact_counts([0.6, 0.2, 0.1, 0.1], 64) == [38, 13, 7, 6]
    assert sum(exact_counts([0.41, 0.34, 0.24], 1869)) == 1869


def test_instances_have_cocos_mean_and_range():
    spec = _mix("train_b4")["instances"]
    k = instance_counts(spec, 256)
    assert 6.8 <= k.mean() <= 7.8 and k.min() >= 1 and k.max() <= 50
    split = Counter(area_classes(_mix("train_b4")["area_split"], int(k.sum())).tolist())
    total = sum(split.values())
    assert abs(split[0] / total - 0.41 / 0.99) < 0.01 and abs(split[2] / total - 0.24 / 0.99) < 0.01


def _tree(tmp_path, mix, seed, tag):
    out = write_coco_tree(mix, seed, str(tmp_path / tag))
    ann = json.loads(open(out["annotations"]).read())
    files = {im["file_name"]: open(f"{out['images']}/{im['file_name']}", "rb").read()
             for im in ann["images"]}
    return ann, files


def test_same_seed_same_tree_and_every_seed_the_same_work(tmp_path):
    mix = _small(_mix("serve_b1"), 20)
    a, fa = _tree(tmp_path, mix, 2 ** 31 + 7, "a")
    b, fb = _tree(tmp_path, mix, 2 ** 31 + 7, "b")
    c, _ = _tree(tmp_path, mix, 5, "c")
    assert a == b and fa == fb
    assert a != c
    sizes = lambda t: Counter((im["width"], im["height"]) for im in t["images"])
    per_image = lambda t: sorted(Counter(x["image_id"] for x in t["annotations"]).values())
    assert sizes(a) == sizes(c) == Counter({(64, 48): 12, (48, 64): 4, (64, 36): 2, (64, 64): 2})
    assert per_image(a) == per_image(c)
    for t in (a, c):
        assert {x["category_id"] for x in t["annotations"]} <= set(range(1, 81))
        for x in t["annotations"]:
            im = t["images"][x["image_id"] - 1]
            x0, y0, w, h = x["bbox"]
            assert 0 <= x0 and 0 <= y0 and x0 + w <= im["width"] and y0 + h <= im["height"]


def test_images_are_photo_sized_jpegs(tmp_path):
    mix = dict(_mix("serve_b1"), images=3)
    _, files = _tree(tmp_path, mix, 1, "full")
    sizes = [len(v) for v in files.values()]
    assert all(v[:2] == b"\xff\xd8" for v in files.values())
    assert all(20_000 <= s <= 250_000 for s in sizes), sizes
    assert np.isfinite(sizes).all()
