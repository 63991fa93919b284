"""The port's evaluation loop under the `_ms` YAML's test-time augmentation
against the benchmark's plain reference (benchmark/reference/), on the CPU.

* `run_inference_on_dataset` with TEST.BBOX_AUG (the flip and three more
  scales: eight passes) and TEST.SOFT_NMS on the tiny ResNeXt-DCN
  (`x101_dcn_cfg(tiny=True)`, float32, both loaders on their PIL path) over
  a landscape and a portrait image: each pass's images and detections equal
  the reference's forward on its own loader's pass, exactly; then the merged
  set the loop serves equals the reference's unflip, rescale and soft-NMS
  merge of the port's per-pass detections, exactly (the same float32 ops
  on the same inputs). Two trunks: the tiny one's 2 groups, and the
  published cardinality 64 at width 1, so that the grouped deformable
  contraction runs at 64 groups of one channel;
* the reference's merge against the port's `merge_tta_detections` on seeded
  per-pass sets in clusters, under soft-NMS (linear, gaussian) and hard NMS;
* the loop's TTA spans, each pass's forward inside its pass and the
  soft-NMS inside the merge;
* the loop's results with each pass's loader prefetching (the default) and
  with none (`prefetch=0`);
* `benchmark/configs/cpm_x101_64x4d_dcn_ms.json` against its YAML through
  `tools/train_net.py::load_config`, key for key but the keys it reduces.

The weights are the benchmark's (one seeded draw, the offset convs spread,
ISM's predictors set, the trunk's affines folded) on the reference's model,
handed to both. FAST_RCNN.NMS is 0.2 in the loop's cases: at this size no
two candidates of one label overlap by the YAML's 0.5, and soft-NMS would
decay nothing.

torch and the port's modules are imported inside the tests, so that
collecting this file loads no torch into a test worker.
"""

import json
import os
import sys
import types

import numpy as np
import pytest

from tests.torch_support import _one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(REPO, "cfgs/rcnn/mscoco/grid_cascade/iou_helper/rescore/backbone/"
                          "e2e_grid_cascade@567_rcnn_X-101b-64x4d-FPN_2x_ms.yaml")
CONFIG = os.path.join(REPO, "benchmark/configs/cpm_x101_64x4d_dcn_ms.json")
TTA = {"GRID_RCNN.SCORE_THRESH": 0.0, "FAST_RCNN.SCORE_THRESH": 0.0, "FAST_RCNN.NMS": 0.2,
       "TEST.SCALE": 64, "TEST.MAX_SIZE": 96, "TEST.BBOX_AUG.ENABLED": True,
       "TEST.BBOX_AUG.H_FLIP": True, "TEST.BBOX_AUG.SCALES": [48, 80, 96],
       "TEST.BBOX_AUG.MAX_SIZE": 128, "TEST.SOFT_NMS.ENABLED": True,
       "TPU.COMPUTE_DTYPE": "float32"}
TRUNKS = {"c2": {}, "c64_width1": {"BACKBONE.RESNEXT.C": 64, "BACKBONE.RESNEXT.WIDTH": 1}}


@pytest.fixture(scope="module", autouse=True)
def _drop_stub_modules_that_answer_every_name():
    """tests/test_weight_parity.py leaves stub modules in `sys.modules` whose
    `__getattr__` answers every name, `__file__` included, with a function;
    torch's first custom-op registration of a process walks `sys.modules`
    and fails on such a `__file__` (tests/test_torch_tta.py says more)."""
    for name, mod in list(sys.modules.items()):
        if isinstance(mod, types.ModuleType) and callable(getattr(mod, "__file__", None)):
            del sys.modules[name]


MIX = {"images": 2, "aspects": [[80, 60, 0.5], [60, 80, 0.5]],
       "instances": {"mean": 3, "min": 1, "max": 6},
       "area_split": {"small": 0.5, "medium": 0.5, "large": 0.0}, "classes": 8, "jpeg_quality": 90}


def _setup(trunk, root):
    """Both configs, the port's and the reference's models holding the same
    weights, and the two-image tree."""
    import torch

    from benchmark import models, weights
    from benchmark.reference import config as ref_config
    from benchmark.traffic import write_coco_tree
    from cpm_tpu_torch import config as port_config

    spec = {"builder": "x101_dcn_cfg", "builder_args": {"tiny": True},
            "set": dict(TTA, **TRUNKS[trunk])}
    pcfg = models.make_config(spec, port_config)
    rcfg = models.make_config(spec, ref_config)
    meta = models.reference_meta(rcfg)
    ref = models.on_device(meta, weights.make_state(meta, 3, "cpu"), "cpu")
    weights.spread_offset_convs(ref, 4)
    weights.condition_iou_predictors(ref)
    images = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (2, 64, 96, 3), np.uint8))
    weights.fold_batch_statistics(ref, images)
    state = {k: v.detach().clone() for k, v in ref.state_dict().items()}
    return dict(pcfg=pcfg, rcfg=rcfg, port=models.program_model(pcfg, state, "cpu"), ref=ref,
                tree=write_coco_tree(MIX, 5, str(root)))


@pytest.mark.parametrize("trunk", sorted(TRUNKS))
def test_tta_loop_matches_the_reference_pass_by_pass_and_merged(trunk, tmp_path, monkeypatch):
    import torch

    import cpm_tpu_torch.data.loader as port_loader
    import cpm_tpu_torch.engine.test as engine
    from benchmark.reference.data.coco import COCODataset as RefDataset
    from benchmark.reference.data.loader import TestLoader as RefLoader
    from benchmark.reference.engine import test as ref_tta
    from cpm_tpu_torch.data.coco import COCODataset

    monkeypatch.setattr(port_loader, "_native", lambda: None)
    s = _setup(trunk, tmp_path)
    groups = [m.groups for m in s["port"].backbone.modules() if hasattr(m, "conv_offset")]
    assert len(groups) == 3 and set(groups) == {64 if trunk == "c64_width1" else 2}
    calls, served = [], {}
    make, coco = engine.make_forward_fn, engine.detections_to_coco

    def recording_make(cfg, model):
        forward = make(cfg, model)

        def recorded(images, image_sizes):
            dets = forward(images, image_sizes)
            calls.append((np.array(images), {f: getattr(dets, f).clone() for f in dets._fields}))
            return dets
        return recorded

    def recording_coco(dets_np, image_id, scale_hw, c2j):
        served[int(image_id)] = {k: np.array(v) for k, v in dets_np.items()}
        return coco(dets_np, image_id, scale_hw, c2j)

    monkeypatch.setattr(engine, "make_forward_fn", recording_make)
    monkeypatch.setattr(engine, "detections_to_coco", recording_coco)
    dataset = COCODataset(s["tree"]["annotations"], s["tree"]["images"])
    results = engine.run_inference_on_dataset(s["pcfg"], s["port"], dataset, progress_every=0)
    passes = ref_tta.tta_passes(s["rcfg"])
    assert passes == engine.tta_passes(s["pcfg"]) and len(passes) == 8
    assert len(calls) == 2 * len(passes) and len(served) == 2 and results

    rdata = RefDataset(s["tree"]["annotations"], s["tree"]["images"])
    with torch.no_grad():
        for i in range(2):
            mapped = []
            for p, spec in enumerate(passes):
                item = next(iter(RefLoader(s["rcfg"], rdata, start=i, end=i + 1, **spec)))
                image, dets = calls[i * len(passes) + p]
                np.testing.assert_array_equal(image, item["images"], err_msg=f"{i}, {spec}")
                want = s["ref"](torch.as_tensor(item["images"]),
                                torch.as_tensor(item["image_sizes"]))
                for f in dets:
                    assert torch.equal(dets[f], getattr(want, f)), (i, spec, f)
                mapped.append(ref_tta.to_original(dets, spec["hflip"], item["image_sizes"],
                                                  item["meta"][0]["scale_hw"]))
            merged = ref_tta.merge_tta_detections(s["rcfg"], mapped)
            got = served[rdata.id_to_img_map[i]]
            keep = merged["mask"][0].numpy()
            np.testing.assert_array_equal(got["mask"], keep)
            assert keep.sum() >= 10
            np.testing.assert_array_equal(got["labels"][keep], merged["labels"][0].numpy()[keep])
            np.testing.assert_array_equal(got["boxes"][keep], merged["boxes"][0].numpy()[keep])
            np.testing.assert_array_equal(got["scores"][keep], merged["scores"][0].numpy()[keep])


def _clustered_passes(seed, passes=5, k=40):
    """Per-pass sets [1, k] of boxes jittered around a few objects, scores
    on a grid of 0.05 (so that many tie), three labels, some masked."""
    import torch

    rng = np.random.RandomState(seed)
    centers = rng.uniform(20, 180, (6, 2))
    sizes = rng.uniform(10, 60, (6, 2))
    out = []
    for _ in range(passes):
        j = rng.randint(0, 6, k)
        c = centers[j] + rng.normal(0, 4, (k, 2))
        wh = sizes[j] * rng.uniform(0.8, 1.2, (k, 2))
        boxes = np.concatenate([c - wh / 2, c + wh / 2], 1).astype(np.float32)
        scores = (rng.randint(1, 20, k) * 0.05).astype(np.float32)
        out.append(dict(boxes=torch.from_numpy(boxes)[None], scores=torch.from_numpy(scores)[None],
                        labels=torch.from_numpy(rng.randint(1, 4, k))[None],
                        mask=torch.from_numpy(rng.uniform(size=k) > 0.2)[None]))
    return out


@pytest.mark.parametrize("method", ["linear", "gaussian", "hard_nms"])
def test_reference_merge_equals_the_ports(method):
    import torch

    from benchmark.reference import config as ref_config
    from benchmark.reference.engine import test as ref_tta
    from cpm_tpu_torch import config as port_config
    from cpm_tpu_torch.engine.test import merge_tta_detections

    cfgs = []
    for module in (port_config, ref_config):
        cfg = module.x101_dcn_cfg(tiny=True)
        cfg.FAST_RCNN.SCORE_THRESH = 0.0
        cfg.TEST.SOFT_NMS.ENABLED = method != "hard_nms"
        cfg.TEST.SOFT_NMS.METHOD = "linear" if method == "hard_nms" else method
        cfgs.append(cfg)
    for seed in range(3):
        per_pass = _clustered_passes(seed)
        got = merge_tta_detections(cfgs[0], per_pass)
        want = ref_tta.merge_tta_detections(cfgs[1], per_pass)
        assert int(want["mask"].sum()) >= 5
        for f in ("boxes", "scores", "labels", "mask"):
            assert torch.equal(got[f], want[f]), (seed, f)


def test_tta_loop_opens_its_spans_nested(tmp_path):
    import torch
    from torch.profiler import ProfilerActivity, profile

    import cpm_tpu_torch.engine.test as engine
    from cpm_tpu_torch.data.coco import COCODataset
    from tests.test_torch_spans import _parents, _spans

    s = _setup("c2", tmp_path)
    dataset = COCODataset(s["tree"]["annotations"], s["tree"]["images"])
    run = lambda: engine.run_inference_on_dataset(s["pcfg"], s["port"], dataset, end=1,
                                                  progress_every=0)
    run()  # outside the profiler: no span opens
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    spans = _spans(prof)
    names = [x[2] for x in spans]
    n = len(engine.tta_passes(s["pcfg"]))
    assert {k: names.count(k) for k in ("cpm/tta/pass", "cpm/forward", "cpm/data/load",
                                         "cpm/tta/merge", "cpm/tta/soft_nms",
                                         "cpm/sync/readback")} == {
        "cpm/tta/pass": n, "cpm/forward": n, "cpm/data/load": n, "cpm/tta/merge": 1,
        "cpm/tta/soft_nms": 1, "cpm/sync/readback": 1}
    parents, nested = _parents(spans)
    assert nested
    assert parents["cpm/forward"] == {"cpm/tta/pass"}
    assert parents["cpm/tta/soft_nms"] == {"cpm/tta/merge"}
    assert parents["cpm/tta/pass"] == parents["cpm/tta/merge"] == parents["cpm/data/load"] == {None}
    # a flip pass's width and every pass's scale go to the card
    assert names.count("cpm/sync/consts") >= n + n // 2
    assert not torch.autograd._profiler_enabled()


def test_tta_loop_serves_the_same_with_its_loaders_prefetching_or_not(tmp_path, monkeypatch):
    import cpm_tpu_torch.engine.test as engine
    from cpm_tpu_torch.data.coco import COCODataset
    from cpm_tpu_torch.data.loader import TestLoader

    s = _setup("c2", tmp_path)
    dataset = COCODataset(s["tree"]["annotations"], s["tree"]["images"])
    n = len(engine.tta_passes(s["pcfg"]))

    def run(prefetch):
        made = []

        def loader(*args, **kw):
            made.append(TestLoader(*args, prefetch=prefetch, **kw))
            return made[-1]

        monkeypatch.setattr(engine, "TestLoader", loader)
        results = engine.run_inference_on_dataset(s["pcfg"], s["port"], dataset,
                                                  progress_every=0)
        assert len(made) == n
        return results, [x.prefetched for x in made]

    ahead, counts = run(2)
    alone, alone_counts = run(0)
    assert ahead == alone and len(ahead) > 0
    assert all(sum(c.values()) == len(dataset) for c in counts)
    assert alone_counts == [{"ready": 0, "waited": 0}] * n


def test_the_configuration_file_is_its_yaml_but_the_reduced_keys():
    from benchmark import models
    from cpm_tpu_torch import config as port_config
    from cpm_tpu_torch.tools.train_net import load_config

    spec = json.load(open(CONFIG))
    got = port_config.assert_and_infer_cfg(models.make_config(spec, port_config),
                                           make_immutable=False)
    want = load_config(YAML, [])

    def flat(d, path=()):
        out = {}
        for k, v in d.items():
            out.update(flat(v, path + (k,)) if isinstance(v, dict) else {".".join(path + (k,)): v})
        return out

    got, want = flat(got), flat(want)
    assert set(got) == set(want)
    differ = {k for k in want if got[k] != want[k]}
    assert differ == set(spec["reduced"]) == {"GRID_RCNN.SCORE_THRESH", "FAST_RCNN.SCORE_THRESH"}
    assert all(want[k] == 0.03 and got[k] == 0.0 for k in differ)
    assert got["BACKBONE.RESNEXT.C"] == 64 and got["BACKBONE.RESNEXT.WIDTH"] == 4
    assert got["BACKBONE.RESNEXT.LAYERS"] == (3, 4, 23, 3)
    assert len(spec["why_reduced"]) == len(spec["reduced"])
    bench = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    entry = {c["name"]: c for c in bench["configs"]}[spec["name"]]
    assert (entry["source"], entry["reduced"]) == (spec["source"], spec["reduced"])
