"""The port's COCO evaluation, dataset loop and eval CLI on the CPU.

The port's COCOEvaluator gives the JAX one's stats (the 12 standard ones and
AP60-AP90) on the same results to 1e-12. `run_inference_on_dataset` on the
tiny CPM model of cfgs/debug/tiny_cpm.yaml in f32, with the JAX package's
params bridged into the port, gives the JAX package's results over the 16
images of the repository's synthetic COCO set (the JAX loader on its PIL
path): per image, category ids exactly, boxes to 1e-2 px and scores to 1e-5
(the tolerances of tests/test_torch_model.py), and every COCO stat to 1e-3.
`test_net.main` writes bbox.json and the VIS images, and follows the JAX
CLI's weight precedence (tests/test_torch_weight_import.py imports a real
TEST.WEIGHTS file; tests/test_torch_tta.py runs TEST.BBOX_AUG).

torch and the port's modules are imported inside the tests, so that
collecting this file loads no torch into a test worker.
"""

import json
import os
import sys
import types

import jax
import numpy as np
import pytest

import cpm_tpu.data.loader as jax_loader_mod
from cpm_tpu.config import assert_and_infer_cfg as jax_infer_cfg
from cpm_tpu.config import get_default_cfg as jax_default_cfg
from cpm_tpu.config import merge_cfg_from_file as jax_merge_file
from cpm_tpu.config import merge_cfg_from_list as jax_merge_list

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "cfgs", "debug", "tiny_cpm.yaml")
DATA_DIR = os.path.join(REPO, "data")


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


def _gt_index():
    """Ground truth over three 640x480 images: every area range, a crowd box,
    an ignored box, and a category with no ground truth."""
    rng = np.random.RandomState(0)
    images = [dict(id=i, width=640, height=480, file_name=f"{i}.jpg") for i in (1, 2, 3)]
    anns, k = [], 1
    for img in (1, 2, 3):
        for side in (12, 20, 40, 60, 150, 200):
            x, y = rng.uniform(0, 400), rng.uniform(0, 250)
            w, h = side * rng.uniform(0.8, 1.2), side * rng.uniform(0.8, 1.2)
            anns.append(dict(id=k, image_id=img, category_id=int(rng.randint(1, 4)),
                             bbox=[x, y, w, h], area=w * h, iscrowd=0))
            k += 1
    anns.append(dict(id=k, image_id=1, category_id=1, bbox=[0.0, 0.0, 300.0, 300.0],
                     area=90000.0, iscrowd=1))
    anns.append(dict(id=k + 1, image_id=2, category_id=2, bbox=[10.0, 10.0, 50.0, 50.0],
                     area=2500.0, iscrowd=0, ignore=1))
    cats = [dict(id=c, name=f"c{c}") for c in (1, 2, 3, 4)]
    return dict(images=images, annotations=anns, categories=cats)


def _results(gt):
    """Jittered copies of the ground truth, misses, duplicates and false
    positives with random scores."""
    rng = np.random.RandomState(1)
    out = []
    for a in gt["annotations"]:
        for _ in range(int(rng.randint(0, 3))):
            x, y, w, h = a["bbox"]
            j = rng.normal(0, 0.08 * max(w, h), 4)
            out.append(dict(image_id=a["image_id"], category_id=a["category_id"],
                            bbox=[x + j[0], y + j[1], max(w + j[2], 1.0), max(h + j[3], 1.0)],
                            score=float(rng.uniform())))
    for _ in range(40):
        out.append(dict(image_id=int(rng.randint(1, 4)), category_id=int(rng.randint(1, 5)),
                        bbox=list(rng.uniform(0, 300, 2)) + list(rng.uniform(5, 200, 2)),
                        score=float(rng.uniform())))
    return out


def test_coco_evaluator_equals_the_jax_one():
    from cpm_tpu.data.coco_io import CocoIndex as JaxIndex
    from cpm_tpu.evaluation import coco_eval as jax_eval

    from cpm_tpu_torch.data.coco_io import CocoIndex
    from cpm_tpu_torch.evaluation import coco_eval

    gt = _gt_index()
    results = _results(gt)
    for img_ids in (None, [1, 3]):
        want = jax_eval.COCOEvaluator(JaxIndex(gt)).evaluate(results, img_ids=img_ids)
        got = coco_eval.COCOEvaluator(CocoIndex(gt)).evaluate(results, img_ids=img_ids)
        assert list(got) == list(want) and len(want) == 16
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-12, k
        assert 0.0 < want["AP"] < 1.0 and want["APs"] > -1 and want["APl"] > -1
    expected = [("AP", 0.3, 0.01), ("AP50", got["AP50"], 0.01), ("AR99", 0.1, 0.1)]
    assert (coco_eval.check_expected_results(got, expected, 4.0, log=lambda m: None)
            == jax_eval.check_expected_results(want, expected, 4.0, log=lambda m: None))


def _cfgs(*opts):
    from cpm_tpu_torch.config import (
        assert_and_infer_cfg,
        get_default_cfg,
        merge_cfg_from_file,
        merge_cfg_from_list,
    )

    opts = ["DATA_DIR", DATA_DIR, *opts]
    want = jax_default_cfg()
    jax_merge_file(TINY, want)
    jax_merge_list(opts, want)
    got = get_default_cfg()
    merge_cfg_from_file(TINY, got)
    merge_cfg_from_list(opts, got)
    return (jax_infer_cfg(want, make_immutable=False), assert_and_infer_cfg(got, make_immutable=False))


def _by_image(results):
    out = {}
    for r in results:
        out.setdefault(r["image_id"], []).append([r["category_id"], *r["bbox"], r["score"]])
    return {k: np.array(v, np.float64) for k, v in out.items()}


def _assert_same_results(got, want, box_atol=1e-2, score_atol=1e-5):
    got, want = _by_image(got), _by_image(want)
    assert set(got) == set(want)
    for img_id, w_rows in want.items():
        g_rows = got[img_id]
        assert len(g_rows) == len(w_rows), img_id
        unused = list(range(len(g_rows)))
        for w in w_rows:
            for j in unused:
                g = g_rows[j]
                if (g[0] == w[0] and np.abs(g[1:5] - w[1:5]).max() <= box_atol
                        and abs(g[5] - w[5]) <= score_atol):
                    unused.remove(j)
                    break
            else:
                raise AssertionError(f"image {img_id}: no result matches {w}")


def test_inference_over_the_dataset_matches_jax(monkeypatch, tmp_path):
    from cpm_tpu.data.coco import build_dataset as jax_build_dataset
    from cpm_tpu.engine.test import evaluate_results as jax_evaluate_results
    from cpm_tpu.engine.test import run_inference_on_dataset as jax_run_inference
    from cpm_tpu.modeling.model import build_model as jax_build_model

    from cpm_tpu_torch.data.coco import build_dataset
    from cpm_tpu_torch.engine.test import evaluate_results, run_inference_on_dataset
    from cpm_tpu_torch.modeling.model import build_model
    from cpm_tpu_torch.utils.param_bridge import load_flax_params

    monkeypatch.setattr(jax_loader_mod, "_native", lambda: None)  # the JAX PIL path
    want_cfg, got_cfg = _cfgs("TPU.COMPUTE_DTYPE", "float32", "CKPT", str(tmp_path))
    (jd,) = jax_build_dataset(want_cfg, want_cfg.TEST.DATASETS, is_train=False)
    (pd,) = build_dataset(got_cfg, got_cfg.TEST.DATASETS, is_train=False)

    jm = jax_build_model(want_cfg)
    images = np.zeros((1, 64, 128, 3), np.uint8)
    sizes = np.array([[64, 128]], np.int32)
    params = jax.device_get(jax.jit(
        lambda i, s: jm.init({"params": jax.random.PRNGKey(0)}, i, s, train=False)["params"]
    )(images, sizes))
    want = jax_run_inference(want_cfg, jm, params, jd, progress_every=0)
    got = run_inference_on_dataset(
        got_cfg, load_flax_params(build_model(got_cfg, "cpu"), params), pd, progress_every=0)
    assert len(want) > 16 and len({r["image_id"] for r in want}) == 16
    _assert_same_results(got, want)

    want_stats = jax_evaluate_results(want_cfg, jd, want)
    got_stats = evaluate_results(got_cfg, pd, got, output_dir=str(tmp_path / "test"))
    assert list(got_stats) == list(want_stats)
    for k in want_stats:
        assert abs(got_stats[k] - want_stats[k]) <= 1e-3, k
    with open(tmp_path / "test" / "bbox.json") as f:
        assert json.load(f) == got


def test_test_net_writes_bbox_json_and_vis(tmp_path, capsys):
    from cpm_tpu_torch.tools import test_net, train_net

    ckpt = tmp_path / "ckpt"
    common = ["--cfg", TINY, "--device", "cpu", "CKPT", str(ckpt), "DATA_DIR", DATA_DIR]
    train_net.main(common + ["SOLVER.MAX_ITER", "1"])
    out = test_net.main(common + ["VIS.ENABLED", "True", "VIS.VIS_TH", "0.0"])
    assert "loaded checkpoint at iter 1" in capsys.readouterr().out
    with open(ckpt / "test" / "bbox.json") as f:
        assert json.load(f) == out["results"]
    assert len(out["results"]) > 0 and len(out["seconds"]) == 16
    assert sorted(out["stats"]) == sorted(["AP", "AP50", "AP75", "APs", "APm", "APl", "AR1", "AR10",
                                           "AR100", "ARs", "ARm", "ARl", "AP60", "AP70", "AP80",
                                           "AP90"])
    assert len(os.listdir(ckpt / "vis")) == 16


def test_test_net_weight_precedence(tmp_path, capsys, monkeypatch):
    import torch

    from cpm_tpu_torch.tools import test_net

    common = ["--cfg", TINY, "--device", "cpu", "CKPT", str(tmp_path / "ckpt"),
              "DATA_DIR", DATA_DIR]
    pth = tmp_path / "model.pth"
    pth.write_bytes(b"")  # an existing .pth is imported: this one is no torch checkpoint
    with pytest.raises(EOFError):
        test_net.main(common + ["TEST.WEIGHTS", str(pth)])
    with pytest.raises(ValueError, match="not an importable"):
        test_net.main(common + ["TEST.WEIGHTS", str(tmp_path)])
    out = test_net.main(common + ["TEST.WEIGHTS", str(tmp_path / "absent.pth")])
    printed = capsys.readouterr().out
    assert "TEST.WEIGHTS not found" in printed and "evaluating random init" in printed
    assert os.path.exists(tmp_path / "ckpt" / "test" / "bbox.json") and "AP" in out["stats"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        test_net.main(["--cfg", TINY, "CKPT", str(tmp_path / "ckpt")])
