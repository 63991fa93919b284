"""The plain reference against the port at a tiny width on the CPU, so that
the comparison that decides `correct` holds the port to something it
matches when sound."""

import numpy as np
import pytest
import torch

from benchmark import models, weights


def _pair(builder):
    from cpm_tpu_torch import config as port_config

    from benchmark.reference import config as ref_config

    spec = {"builder": builder, "builder_args": {"tiny": True}, "lr_batch": 16,
            "set": {"GRID_RCNN.SCORE_THRESH": 0.0, "TPU.COMPUTE_DTYPE": "float32"}}
    pcfg = models.make_config(spec, port_config, train_images=2)
    rcfg = models.make_config(spec, ref_config, train_images=2)
    meta = models.reference_meta(rcfg)
    ref = models.on_device(meta, weights.make_state(meta, 3, "cpu"), "cpu")
    weights.spread_offset_convs(ref, 4)
    weights.condition_iou_predictors(ref)
    images = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (2, 64, 96, 3), np.uint8))
    weights.fold_batch_statistics(ref, images)
    state = {k: v.detach().clone() for k, v in ref.state_dict().items()}
    return pcfg, rcfg, state, images


@pytest.mark.parametrize("builder", ["flagship_cfg", "x101_dcn_cfg"])
def test_reference_detections_equal_the_ports(builder):
    torch.manual_seed(0)
    pcfg, rcfg, state, images = _pair(builder)
    port = models.program_model(pcfg, state, "cpu")
    ref = models.on_device(models.reference_meta(rcfg), state, "cpu")
    sizes = torch.tensor([[64, 96], [60, 80]])
    with torch.no_grad():
        got, want = port(images, sizes), ref(images, sizes)
    for f in ("boxes", "scores", "labels", "mask"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("builder", ["flagship_cfg", "x101_dcn_cfg"])
def test_reference_step_equals_the_ports(builder):
    from cpm_tpu_torch.engine.train import TrainState, make_train_step
    from cpm_tpu_torch.solver.optimizer import build_optimizer
    from cpm_tpu_torch.utils.sampler import Draws

    from benchmark.reference.engine.train import TrainState as RState
    from benchmark.reference.engine.train import make_train_step as rmake
    from benchmark.reference.solver.optimizer import build_optimizer as rbuild
    from benchmark.reference.utils.sampler import Draws as RDraws

    pcfg, rcfg, state, images = _pair(builder)
    rng = np.random.RandomState(1)
    boxes = np.sort(rng.uniform(0, 60, (2, 4, 4)).astype(np.float32).reshape(2, 4, 2, 2), axis=2)
    batch = dict(images=images.numpy(), image_sizes=np.array([[64, 96], [64, 96]], np.int32),
                 gt_boxes=boxes.transpose(0, 1, 3, 2).reshape(2, 4, 4) + np.array([0, 0, 4, 4], np.float32),
                 gt_labels=rng.randint(1, 9, (2, 4)).astype(np.int32), gt_mask=np.ones((2, 4), bool))
    out = []
    for mk, build, st, dr, cfg, net in (
            (make_train_step, build_optimizer, TrainState, Draws, pcfg,
             models.program_model(pcfg, state, "cpu")),
            (rmake, rbuild, RState, RDraws, rcfg,
             models.on_device(models.reference_meta(rcfg), state, "cpu"))):
        opt = build(cfg, net)
        s = st(step=0, model=net, optimizer=opt, draws=dr(torch.Generator().manual_seed(5)))
        _, m = mk(cfg, net, opt)(s, batch)
        out.append(({k: float(v) for k, v in m.items()},
                    {k: p.detach().clone() for k, p in net.named_parameters()}))
    (mp, pp), (mr, pr) = out
    for k in mr:
        assert mp[k] == pytest.approx(mr[k], rel=1e-5, abs=1e-6), k
    for k in pr:
        torch.testing.assert_close(pp[k], pr[k], rtol=1e-5, atol=1e-6)
