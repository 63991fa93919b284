"""SOLVER.OPTIMIZER ADAM and RMSPROP: the port's against the JAX package's optax chains.

The tiny CPM model's seeded weights go through the bridge into the flax
tree; both optimizers, `cpm_tpu.solver.build_optimizer` and the port's
`build_optimizer`, take the same seeded gradients for two steps at the
learning rates of the schedule's first two steps, and the parameters and the
optimizers' moments are compared parameter by parameter (f32 on the CPU, the
same arithmetic in a different order: parameters rtol 1e-5 / atol 1e-7;
moments rtol 1e-5 / atol 1e-6, since RMSPROP's first update is about
sqrt(10) * sign(g), where one f32 step is 4.8e-7, and XLA's rsqrt and
torch's differ in the last bits). The frozen parameters stay where they
were on both sides.
Then a checkpoint written after the first step and restored into a fresh
model and optimizer takes the second step to the bit, as an uninterrupted
run does, and one train step under each optimizer moves the parameters.

torch and the port's modules are imported inside the tests, so that
collecting this file loads no torch into a test worker.
"""

import sys
import types

import jax
import numpy as np
import pytest

from __graft_entry__ import _flagship_cfg
from cpm_tpu.modeling.model import build_model as jax_build_model
from cpm_tpu.solver import make_lr_fn as jax_make_lr_fn
from cpm_tpu.solver.optimizer import build_optimizer as jax_build_optimizer
from cpm_tpu.solver.optimizer import param_label_tree
from tests.torch_support import _one_torch_thread  # noqa: F401  (autouse)

CASES = [("ADAM", 0.9), ("RMSPROP", 0.9), ("RMSPROP", 0.0)]


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


def _cfg(name, momentum):
    cfg = _flagship_cfg(tiny=True)
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.SOLVER.OPTIMIZER = name
    cfg.SOLVER.MOMENTUM = momentum
    cfg.SOLVER.BASE_LR = 0.01
    return cfg


@pytest.fixture(scope="module")
def flax_like():
    """The tiny model's flax params structure, from an abstract init."""
    cfg = _cfg("SGD", 0.9)
    images = np.zeros((1, 64, 64, 3), np.uint8)
    sizes = np.array([[64, 64]], np.int32)
    jm = jax_build_model(cfg)
    like = jax.eval_shape(
        lambda: jm.init({"params": jax.random.PRNGKey(0)}, images, sizes, train=False))["params"]
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), like)


def _seeded_grads(model, seed):
    rng = np.random.RandomState(seed)
    return {k: rng.standard_normal(p.shape).astype(np.float32) * 1e-2
            for k, p in model.named_parameters()}


def _port_step(model, optimizer, grads, lr):
    import torch

    for group in optimizer.param_groups:
        group["lr"] = group["lr_scale"] * lr
    for k, p in model.named_parameters():
        p.grad = torch.from_numpy(grads[k]).to(memory_format=torch.preserve_format) \
            if p.requires_grad else None
    optimizer.step()


def _port_state(model, optimizer):
    """{parameter name: {state name: numpy array}} of the port's optimizer."""
    names = {id(p): k for k, p in model.named_parameters()}
    return {names[id(p)]: {k: v.numpy().copy() for k, v in s.items() if v.dim()}
            for p, s in optimizer.state.items()}


@pytest.mark.parametrize("name,momentum", CASES)
def test_two_steps_match_optax(flax_like, name, momentum):
    import optax

    from cpm_tpu_torch.modeling.model import build_model
    from cpm_tpu_torch.solver.lr_schedule import make_lr_fn
    from cpm_tpu_torch.solver.optimizer import build_optimizer
    from cpm_tpu_torch.utils.param_bridge import flax_tree_to_named, state_dict_to_flax

    cfg = _cfg(name, momentum)
    model = build_model(cfg, "cpu", seed=0)
    params = state_dict_to_flax(model.state_dict(), flax_like)
    start = {k: p.detach().clone() for k, p in model.named_parameters()}
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    tx = jax_build_optimizer(cfg, params, jax_make_lr_fn(cfg.SOLVER))
    opt_state = tx.init(params)
    optimizer = build_optimizer(cfg, model)
    lr_fn = make_lr_fn(cfg.SOLVER)
    jax_params = params
    update = jax.jit(lambda g, s, p: tx.update(g, s, p))
    for step in range(2):
        grads = _seeded_grads(model, step)
        updates, opt_state = update(state_dict_to_flax(grads, flax_like), opt_state, jax_params)
        jax_params = optax.apply_updates(jax_params, updates)
        _port_step(model, optimizer, grads, lr_fn(step))
        assert lr_fn(step) == pytest.approx(float(jax_make_lr_fn(cfg.SOLVER)(step)), abs=1e-9)

    want = flax_tree_to_named(jax.device_get(jax_params), shapes)
    labels = flax_tree_to_named(
        param_label_tree(params, int(cfg.BACKBONE.RESNET.FREEZE_AT)), {k: () for k in shapes})
    moved = 0
    for k, p in model.named_parameters():
        got = p.detach().numpy()
        np.testing.assert_allclose(got, want[k], rtol=1e-5, atol=1e-7, err_msg=k)
        if labels[k] == "frozen":
            assert not p.requires_grad and np.array_equal(got, start[k].numpy()), k
        else:
            moved += int(not np.array_equal(got, start[k].numpy()))
    assert moved == sum(v != "frozen" for v in labels.values()) > 60

    # the moments: ADAM's mu and nu, RMSPROP's nu and momentum trace
    if name == "ADAM":
        fields = {"exp_avg": (optax.ScaleByAdamState, "mu"),
                  "exp_avg_sq": (optax.ScaleByAdamState, "nu")}
    else:
        fields = {"nu": (optax.ScaleByRmsState, "nu")}
        if momentum:
            fields["trace"] = (optax.TraceState, "trace")
    port = _port_state(model, optimizer)
    assert len(port) == moved and all(set(v) == set(fields) for v in port.values())
    for key, (cls, field) in fields.items():
        want = flax_tree_to_named(_state_tree(opt_state, cls, field, flax_like), shapes)
        for k, v in port.items():
            np.testing.assert_allclose(v[key], want[k], rtol=1e-5, atol=1e-6, err_msg=f"{key} {k}")


def _state_tree(opt_state, cls, field, like):
    """`field` of the `cls` states of multi_transform's chains as one tree of
    the params' structure (each label's chain holds its own parameters;
    zeros for the frozen ones)."""
    merged = {}
    for inner in opt_state.inner_states.values():
        for s in jax.tree_util.tree_leaves(inner.inner_state, is_leaf=lambda x: isinstance(x, cls)):
            if isinstance(s, cls):
                for path, leaf in jax.tree_util.tree_flatten_with_path(getattr(s, field))[0]:
                    merged[tuple(str(p.key) for p in path)] = np.asarray(leaf)

    def pick(path, leaf):
        return merged.get(tuple(str(p.key) for p in path), np.zeros(leaf.shape, np.float32))

    return jax.tree_util.tree_map_with_path(pick, like)


@pytest.mark.parametrize("name,momentum", CASES)
def test_checkpoint_resumes_the_optimizer_bit_for_bit(tmp_path, name, momentum):
    import torch

    from cpm_tpu_torch.engine.checkpoint import CheckPointer
    from cpm_tpu_torch.engine.train import create_train_state

    cfg = _cfg(name, momentum)
    runs = []
    for resumed in (False, True):
        model, optimizer, state = create_train_state(cfg, "cpu", seed=0)
        _port_step(model, optimizer, _seeded_grads(model, 0), 0.01)
        state.step = 1
        if resumed:
            CheckPointer(tmp_path).save(state, 1)
            model, optimizer, state = create_train_state(cfg, "cpu", seed=0)
            assert CheckPointer(tmp_path).load(state) is not None and state.step == 1
        _port_step(model, optimizer, _seeded_grads(model, 1), 0.02)
        runs.append((model, optimizer))
    (m0, o0), (m1, o1) = runs
    for (k, a), b in zip(m0.named_parameters(), m1.parameters()):
        assert torch.equal(a, b), k
    s0, s1 = _port_state(m0, o0), _port_state(m1, o1)
    assert s0.keys() == s1.keys() and len(s0) > 60
    for k in s0:
        assert s0[k].keys() == s1[k].keys(), k
        for key in s0[k]:
            assert np.array_equal(s0[k][key], s1[k][key]), (k, key)
    if name == "ADAM":
        assert all(float(s["step"]) == 2 for s in o1.state.values())


@pytest.mark.parametrize("name", ["ADAM", "RMSPROP"])
def test_train_step_under_optimizer(name):
    """One step of the tiny model under each optimizer: finite losses, every
    trainable parameter moved by at most the learning rate's scale, and no
    weight decay or doubled bias rate in any group."""
    import torch

    from cpm_tpu_torch.data.synthetic import synthetic_batch
    from cpm_tpu_torch.engine.train import create_train_state, make_train_step

    cfg = _cfg(name, 0.9)
    model, optimizer, state = create_train_state(cfg, "cpu", seed=0)
    assert {g["name"] for g in optimizer.param_groups} == {"nonbias", "bias", "gn"}
    assert all(g["weight_decay"] == 0 and g["lr_scale"] == 1.0 for g in optimizer.param_groups)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    state, metrics = make_train_step(cfg, model, optimizer)(
        state, synthetic_batch(2, 64, 64, max_gt=4, num_classes=cfg.MODEL.NUM_CLASSES))
    assert all(np.isfinite(float(v)) for v in metrics.values())
    lr = metrics["lr"]
    for k, p in model.named_parameters():
        step = (p.detach() - before[k]).abs().max().item()
        if p.requires_grad:
            # ADAM's first step is lr * g / (|g| + eps); RMSPROP's lr * g /
            # sqrt(0.1 g^2 + eps), at most lr * sqrt(10)
            assert step <= lr * (1 if name == "ADAM" else 10 ** 0.5) + 1e-6, k
        else:
            assert step == 0, k
    assert isinstance(optimizer, torch.optim.Optimizer)
