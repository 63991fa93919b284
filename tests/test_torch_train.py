"""The whole training slice: the JAX package's CPM train step against the port.

The JAX tiny flagship config (`__graft_entry__._flagship_cfg(tiny=True)`) in
f32 is initialised in JAX, its params go through the bridge, and both sides
take the same synthetic batch. The samplers' seven uniform draws are made
equal without touching the JAX package: while the JAX functions are traced,
`jax.random.uniform` is patched with a function that, for calls from the JAX
package's sampler, hands out arrays from a numpy-seeded stream for the
requested shape (they become constants of the jitted program), and the port
consumes the recorded arrays in the same order. Calls from elsewhere (flax
re-evaluates the initializers abstractly to check parameter shapes) go to the
real function.

Tolerances (f32 on the CPU, two frameworks summing in different orders):
losses 1e-5 relative; gradients rtol 1e-3 / atol 1e-5; after two SGD steps
parameters rtol 1e-4 / atol 1e-6 and momentum buffers rtol 1e-3 / atol 1e-5;
lr to 1e-7.

torch and the port's modules are imported inside the tests, so that
collecting this file loads no torch into a test worker.
"""

import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from __graft_entry__ import _flagship_cfg
from cpm_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from cpm_tpu.engine.train import batch_gt as jax_batch_gt
from cpm_tpu.engine.train import create_train_state as jax_create_train_state
from cpm_tpu.engine.train import make_train_step as jax_make_train_step
from cpm_tpu.solver.lr_schedule import make_lr_fn as jax_make_lr_fn
from cpm_tpu.solver.optimizer import param_label_tree

LOSS_NAMES = (
    "loss_objectness", "loss_rpn_box_reg", "loss_classifier", "loss_grid_1",
    "loss_grid_2", "loss_grid_3", "loss_iou_3", "loss_rescore",
)
# [B, anchors] twice (RPN), [B, proposals + gt] twice (cls), [B, cls sample]
# (grid cap), [B, cls sample + refined + gt] twice (rescore)
DRAW_SHAPES = [(2, 1023)] * 2 + [(2, 52)] * 2 + [(2, 32)] + [(2, 48)] * 2


def _tiny_cfg():
    cfg = _flagship_cfg(tiny=True)
    cfg.TPU.COMPUTE_DTYPE = "float32"
    return cfg


_REAL_UNIFORM = jax.random.uniform


class RecordedUniform:
    """Stands in for jax.random.uniform: for the sampler's calls, the next
    array of a seeded numpy stream for the requested shape, recorded for the
    port."""

    def __init__(self, seed):
        self.rng = np.random.RandomState(seed)
        self.arrays = []

    def __call__(self, key, shape=(), *args, **kwargs):
        if sys._getframe(1).f_globals["__name__"] != "cpm_tpu.utils.sampler":
            return _REAL_UNIFORM(key, shape, *args, **kwargs)
        a = self.rng.rand(*shape).astype(np.float32)
        self.arrays.append(a)
        return jnp.asarray(a)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _momentum_tree(opt_state, params):
    """The optax momentum of every parameter as one tree of the params'
    structure (zeros for the frozen ones): multi_transform keeps one masked
    trace tree per label."""
    import optax

    traces = [
        s.trace for inner in opt_state.inner_states.values()
        for s in jax.tree_util.tree_leaves(
            inner.inner_state, is_leaf=lambda x: isinstance(x, optax.TraceState))
        if isinstance(s, optax.TraceState)
    ]
    merged = {}
    for trace in traces:
        for path, leaf in jax.tree_util.tree_flatten_with_path(trace)[0]:
            merged[tuple(str(p.key) for p in path)] = np.asarray(leaf)
    out = {}
    for path, leaf in _flat(params).items():
        node = out
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = merged.get(path, np.zeros(leaf.shape, np.float32))
    return out


@pytest.fixture(scope="module", autouse=True)
def _drop_stub_modules_that_answer_every_name():
    """tests/test_weight_parity.py leaves a stub module in `sys.modules` whose
    `__getattr__` answers every name, `__file__` included, with a function.
    torch registers custom ops when the first optimizer of a process is made
    and looks its caller up with `inspect.getmodule`, which walks
    `sys.modules` and fails on such a `__file__`. Whether that file ran
    before this one in a test worker depends on the scheduling, so the stubs
    go before the first optimizer is built; that file installs them again
    when it needs them."""
    for name, mod in list(sys.modules.items()):
        if isinstance(mod, types.ModuleType) and callable(getattr(mod, "__file__", None)):
            del sys.modules[name]


@pytest.fixture(scope="module")
def train_outputs():
    import torch

    from cpm_tpu_torch.data.synthetic import synthetic_batch
    from cpm_tpu_torch.engine.train import create_train_state, make_train_step
    from cpm_tpu_torch.utils.param_bridge import load_flax_params
    from cpm_tpu_torch.utils.sampler import Draws

    cfg = _tiny_cfg()
    batch = synthetic_batch(2, 64, 64, max_gt=4, num_classes=9)
    want_batch = jax_synthetic_batch(2, 64, 64, max_gt=4, num_classes=9)
    for k in batch:
        np.testing.assert_array_equal(batch[k], want_batch[k])

    jmodel, tx, jstate = jax_create_train_state(cfg, jax.random.PRNGKey(0), batch)
    params = jax.device_get(jstate.params)

    def loss_fn(p):
        losses = jmodel.apply(
            {"params": p}, batch["images"], batch["image_sizes"],
            gt=jax_batch_gt(batch), train=True, rngs={"sample": jax.random.PRNGKey(1)},
        )
        return sum(losses.values()), losses

    mp = pytest.MonkeyPatch()
    try:
        grad_draws = RecordedUniform(7)
        mp.setattr(jax.random, "uniform", grad_draws)
        (jtotal, jlosses), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            jstate.params)
        step_draws = RecordedUniform(7)
        mp.setattr(jax.random, "uniform", step_draws)
        jstep = jax.jit(jax_make_train_step(cfg, jmodel, tx))
        js1, jm1 = jstep(jstate, batch)
        js2, jm2 = jstep(js1, batch)
    finally:
        mp.undo()
    jax_side = dict(
        params=params, losses=jax.device_get(jlosses), total=float(jtotal),
        grads=jax.device_get(jgrads), metrics=[jax.device_get(jm1), jax.device_get(jm2)],
        params2=jax.device_get(js2.params),
        momentum2=_momentum_tree(jax.device_get(js2.opt_state), params),
        labels=param_label_tree(params, int(cfg.BACKBONE.RESNET.FREEZE_AT)),
        draws=(grad_draws.arrays, step_draws.arrays),
    )

    # the port: losses and gradients on the bridged parameters
    model, optimizer, state = create_train_state(cfg, "cpu", seed=0)
    load_flax_params(model, params)
    draws = Draws(grad_draws.arrays)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    losses = model(
        tb["images"], tb["image_sizes"], train=True, draws=draws,
        gt=dict(boxes=tb["gt_boxes"], labels=tb["gt_labels"], mask=tb["gt_mask"]),
    )
    total = sum(losses.values())
    total.backward()
    grads = {k: None if p.grad is None else p.grad.clone() for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)

    # two full steps
    step = make_train_step(cfg, model, optimizer)
    metrics = []
    for _ in range(2):
        state.draws = Draws(step_draws.arrays)
        state, m = step(state, batch)
        metrics.append(m)
    port_side = dict(
        losses={k: float(v.detach()) for k, v in losses.items()}, total=float(total.detach()),
        grads=grads,
        draw_shapes=draws.shapes, metrics=metrics, model=model, optimizer=optimizer,
        state=state,
    )
    return cfg, batch, jax_side, port_side


def test_both_sides_use_the_same_seven_draws(train_outputs):
    _, _, jx, pt = train_outputs
    for arrays in jx["draws"]:
        assert [a.shape for a in arrays] == DRAW_SHAPES
    assert pt["draw_shapes"] == DRAW_SHAPES
    assert pt["state"].draws.shapes == DRAW_SHAPES
    for a, b in zip(*jx["draws"]):
        np.testing.assert_array_equal(a, b)


def test_eight_losses_match_jax(train_outputs):
    _, _, jx, pt = train_outputs
    assert set(jx["losses"]) == set(LOSS_NAMES) == set(pt["losses"])
    for name in LOSS_NAMES:
        want = float(jx["losses"][name])
        assert np.isfinite(want) and want > 0
        assert pt["losses"][name] == pytest.approx(want, rel=1e-5), name
    assert pt["total"] == pytest.approx(jx["total"], rel=1e-5)


def test_gradients_match_jax_and_frozen_have_none(train_outputs):
    from cpm_tpu_torch.solver.optimizer import classify_params
    from cpm_tpu_torch.utils.param_bridge import flax_tree_to_named

    cfg, _, jx, pt = train_outputs
    model = pt["model"]
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    want = flax_tree_to_named(jx["grads"], shapes)
    labels = classify_params(model, int(cfg.BACKBONE.RESNET.FREEZE_AT))
    n_nonzero = 0
    for name, g in pt["grads"].items():
        if labels[name] == "frozen":
            assert g is None, name
            continue
        np.testing.assert_allclose(g.numpy(), want[name], rtol=1e-3, atol=1e-5, err_msg=name)
        n_nonzero += int(np.abs(want[name]).max() > 0)
    assert n_nonzero > 60


@pytest.mark.parametrize("name", ["stacked", "clustered"])
def test_losses_and_gradients_under_pooler_kernel(train_outputs, name):
    """The training forward and backward under TPU.POOLER_KERNEL stacked and
    clustered: on the CPU each runs the plain version of its own formulation,
    and losses and gradients equal the JAX package's and the `auto` path's."""
    import torch

    from cpm_tpu_torch.engine.train import create_train_state
    from cpm_tpu_torch.ops import pooler as pooler_mod
    from cpm_tpu_torch.utils.param_bridge import flax_tree_to_named, load_flax_params
    from cpm_tpu_torch.utils.sampler import Draws

    _, batch, jx, pt = train_outputs
    cfg = _tiny_cfg()
    cfg.TPU.POOLER_KERNEL = name
    try:
        model, _, _ = create_train_state(cfg, "cpu", seed=0)
        assert pooler_mod.get_pooler_backend() == name
        load_flax_params(model, jx["params"])
        tb = {k: torch.as_tensor(v) for k, v in batch.items()}
        losses = model(
            tb["images"], tb["image_sizes"], train=True, draws=Draws(jx["draws"][0]),
            gt=dict(boxes=tb["gt_boxes"], labels=tb["gt_labels"], mask=tb["gt_mask"]),
        )
        sum(losses.values()).backward()
    finally:
        pooler_mod.set_pooler_backend("auto")
    for k in LOSS_NAMES:
        assert float(losses[k].detach()) == pytest.approx(float(jx["losses"][k]), rel=1e-5), k
        assert float(losses[k].detach()) == pytest.approx(pt["losses"][k], rel=1e-5), k
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    want = flax_tree_to_named(jx["grads"], shapes)
    n = 0
    for k, p in model.named_parameters():
        if pt["grads"][k] is None:
            assert p.grad is None, k
            continue
        n += 1
        np.testing.assert_allclose(p.grad.numpy(), want[k], rtol=1e-3, atol=1e-5, err_msg=k)
        np.testing.assert_allclose(p.grad.numpy(), pt["grads"][k].numpy(), rtol=1e-3, atol=1e-5,
                                   err_msg=k)
    assert n > 60


def test_two_steps_match_jax(train_outputs):
    from cpm_tpu_torch.utils.param_bridge import flax_tree_to_named, state_dict_to_flax

    _, _, jx, pt = train_outputs
    for jm, m in zip(jx["metrics"], pt["metrics"]):
        assert m["lr"] == pytest.approx(float(jm["lr"]), abs=1e-7)
        for name in LOSS_NAMES + ("total_loss",):
            assert float(m[name]) == pytest.approx(float(jm[name]), rel=2e-5), name
    assert pt["state"].step == 2
    model, optimizer = pt["model"], pt["optimizer"]
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    # parameters, compared in the port's layout and in the flax layout
    want = flax_tree_to_named(jx["params2"], shapes)
    start = flax_tree_to_named(jx["params"], shapes)
    moved = 0
    for name, p in model.named_parameters():
        np.testing.assert_allclose(
            p.detach().numpy(), want[name], rtol=1e-4, atol=1e-6, err_msg=name)
        moved += int(not np.array_equal(want[name], start[name]))
    assert moved > 60
    back = _flat(state_dict_to_flax(model.state_dict(), jx["params2"]))
    for path, leaf in _flat(jx["params2"]).items():
        np.testing.assert_allclose(back[path], leaf, rtol=1e-4, atol=1e-6, err_msg=str(path))
    # momentum buffers
    want_m = flax_tree_to_named(jx["momentum2"], shapes)
    n = 0
    for name, p in model.named_parameters():
        buf = optimizer.state.get(p, {}).get("momentum_buffer")
        if buf is None:
            assert not p.requires_grad and not want_m[name].any(), name
            continue
        n += 1
        np.testing.assert_allclose(buf.numpy(), want_m[name], rtol=1e-3, atol=1e-5, err_msg=name)
    assert n > 60


def test_optimizer_labels_match_jax(train_outputs):
    from cpm_tpu_torch.solver.optimizer import classify_params
    from cpm_tpu_torch.utils.param_bridge import name_map

    cfg, _, jx, pt = train_outputs
    model = pt["model"]
    for freeze_at in (0, 1, 2, 3):
        want = _flat(param_label_tree(jx["params"], freeze_at))
        got = classify_params(model, freeze_at)
        names = name_map(jx["params"])
        assert set(names.values()) == set(got)
        for path, key in names.items():
            assert got[key] == want[path], (freeze_at, key)
    groups = {g["name"]: g for g in pt["optimizer"].param_groups}
    assert set(groups) == {"nonbias", "bias", "gn"}
    s = cfg.SOLVER
    assert groups["bias"]["lr_scale"] == 2.0 and groups["bias"]["weight_decay"] == 0.0
    assert groups["nonbias"]["weight_decay"] == s.WEIGHT_DECAY
    assert groups["gn"]["weight_decay"] == s.WEIGHT_DECAY_GN * s.WEIGHT_DECAY
    frozen = [k for k, p in model.named_parameters() if not p.requires_grad]
    assert frozen and all(classify_params(model, 2)[k] == "frozen" for k in frozen)


def test_bf16_step_keeps_f32_masters_and_make_forward_fn_leaves_them_alone(train_outputs):
    import torch

    from cpm_tpu_torch.engine.test import make_forward_fn
    from cpm_tpu_torch.engine.train import create_train_state, make_train_step

    _, batch, _, _ = train_outputs
    cfg = _flagship_cfg(tiny=True)  # TPU.COMPUTE_DTYPE stays bfloat16
    model, optimizer, state = create_train_state(cfg, "cpu", seed=3)
    start = {k: p.detach().clone() for k, p in model.named_parameters()}
    state, metrics = make_train_step(cfg, model, optimizer)(state, batch)
    assert set(metrics) == set(LOSS_NAMES) | {"total_loss", "lr"}
    for name in LOSS_NAMES:
        assert metrics[name].dtype == torch.float32 and torch.isfinite(metrics[name]), name
    for k, p in model.named_parameters():
        assert p.dtype == torch.float32, k
        if p.requires_grad:
            assert p.grad.dtype == torch.float32 and torch.isfinite(p.grad).all(), k
        else:
            assert p.grad is None and torch.equal(p, start[k]), k
    assert sum(int(not torch.equal(p, start[k])) for k, p in model.named_parameters()) > 60

    # evaluating the trained model must not touch the masters
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    images = np.random.RandomState(0).randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    dets = make_forward_fn(cfg, model)(images, batch["image_sizes"])
    assert torch.isfinite(dets.boxes).all() and torch.isfinite(dets.scores).all()
    for k, p in model.named_parameters():
        assert p.dtype == torch.float32, k
        assert torch.equal(p, before[k]), k


@pytest.mark.parametrize("policy", ["STEP", "COSINE", "STEP_COSINE", "POLY"])
@pytest.mark.parametrize("warmup", ["LINEAR", "CONSTANT"])
def test_lr_schedule_matches_jax(policy, warmup):
    from cpm_tpu_torch.solver.lr_schedule import make_lr_fn

    cfg = _tiny_cfg()
    s = cfg.SOLVER
    s.LR_POLICY, s.WARM_UP_METHOD = policy, warmup
    s.BASE_LR, s.MAX_ITER, s.WARM_UP_ITERS, s.STEPS = 0.02, 1000, 50, [600, 800]
    want_fn, got_fn = jax_make_lr_fn(s), make_lr_fn(s)
    for step in (0, 1, 10, 48, 49, 50, 51, 300, 598, 599, 600, 601, 799, 800, 801, 950, 998, 999):
        assert got_fn(step) == pytest.approx(float(want_fn(step)), abs=1e-7), step


def test_unported_training_options_raise(train_outputs):
    import torch

    from cpm_tpu_torch.modeling.model import build_model
    from cpm_tpu_torch.solver.optimizer import build_optimizer

    _, batch, jx, _ = train_outputs
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    for key in ("RANDOM_JITTER", "BETTER_ROI"):
        cfg = _tiny_cfg()
        cfg.GRID_RCNN[key] = True
        model = build_model(cfg, "cpu")
        with pytest.raises(NotImplementedError):
            model(tb["images"], tb["image_sizes"], train=True, draws=jx["draws"][0],
                  gt=dict(boxes=tb["gt_boxes"], labels=tb["gt_labels"], mask=tb["gt_mask"]))
    cfg = _tiny_cfg()
    cfg.SOLVER.OPTIMIZER = "ADAM"
    with pytest.raises(NotImplementedError):
        build_optimizer(cfg, build_model(cfg, "cpu"))
