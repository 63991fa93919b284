"""The port's layer zoo (cpm_tpu_torch/modeling/layers.py) and the `tpu`
init scheme against the JAX package's, on the CPU.

* Each layer of cpm_tpu/modeling/layers.py is initialised by flax, its
  variables are perturbed from a seed and loaded into the port's module
  through `param_bridge.load_flax_layer`, and both run the same seeded NCHW
  input (NHWC on the JAX side): outputs, the gradients of <output,
  cotangent> with respect to the input and every parameter, and the batch
  statistics a training step updates. f32 rtol 1e-5 / atol 1e-6; atol 1e-5
  after a convolution, and for `MixtureNorm`, whose parameter gradients are
  sums over the whole map as a convolution's weight gradient is.
  `DropBlock2D` gets the JAX package's own uniforms: the test wraps
  `jax.random.bernoulli` to record them and hands them to the port through
  `Draws`. `SyncBatchNorm` over the two halves of a batch
  (`jax.vmap` with `axis_name='data'`) equals the port's over the whole
  batch with no group.
* `MODEL.INIT_SCHEME tpu`: the tiny CPM model built by the port matches the
  JAX model's `init` under `tpu` tensor by tensor, by distribution (mean,
  std, and whether the draw is truncated at two scaled standard
  deviations), with the prior and zero biases exact; the port's draws alone
  on a large tensor; an unknown scheme raises, as `set_scheme` does.

torch and the port's modules are imported inside the tests, so that
collecting this file loads no torch into a test worker.
"""

import math
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cpm_tpu.config import get_default_cfg as jax_default_cfg
from cpm_tpu.config import merge_cfg_from_file
from cpm_tpu.modeling import initializers as jax_init
from cpm_tpu.modeling import layers as jlay
from cpm_tpu.modeling.model import build_model as jax_build_model
from tests.torch_support import _one_torch_thread  # noqa: F401  (autouse)
from tests.torch_support import shared

F32 = dict(rtol=1e-5, atol=1e-6)
CONV = dict(rtol=1e-5, atol=1e-5)
FAST_COMPILE = {"xla_backend_optimization_level": 0}
TINY_CPM = "cfgs/debug/tiny_cpm.yaml"


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


def _jit(fn):
    return jax.jit(fn, compiler_options=FAST_COMPILE)


def _nhwc(x):
    return jnp.asarray(np.transpose(x, (0, 2, 3, 1)))


def _nchw(y):
    return np.transpose(np.asarray(y), (0, 3, 1, 2))


def _perturbed(variables, seed):
    """flax variables with seeded noise on every parameter, and batch
    statistics away from (0, 1), so that no parameter is at its init value."""
    rng = np.random.RandomState(seed)
    out = {}
    for coll, tree in jax.device_get(variables).items():
        def leaf(path, v, coll=coll):
            v = np.array(v)
            if coll == "batch_stats":
                return (0.5 + rng.rand(*v.shape) if path[-1].key == "var"
                        else rng.randn(*v.shape)).astype(v.dtype)
            return (v + 0.2 * rng.randn(*v.shape)).astype(v.dtype)
        out[coll] = jax.tree_util.tree_map_with_path(leaf, tree)
    return out


def _check_layer(jax_module, port_module, x, *, train=False, tol=F32, apply_kw=None,
                 init_kw=None, rngs=None, port_call=None, jit=True):
    """The JAX layer and the port's (loaded from the JAX variables) on x
    (NCHW numpy): outputs, the input's and the parameters' gradients, and,
    for a training step of a batch norm, the new batch statistics."""
    import torch

    from cpm_tpu_torch.utils.param_bridge import load_flax_layer

    wrap = _jit if jit else (lambda f: f)
    apply_kw, init_kw = apply_kw or {}, init_kw or {}
    xj = _nhwc(x)
    variables = _perturbed(_jit(lambda v: jax_module.init(jax.random.PRNGKey(0), v, **init_kw))(xj),
                           seed=1)
    params = variables.get("params", {})
    rest = {k: v for k, v in variables.items() if k != "params"}
    mutable = ["batch_stats"] if train and "batch_stats" in rest else False

    def run(p, xin):
        out = jax_module.apply({"params": p, **rest}, xin, rngs=rngs, mutable=mutable, **apply_kw)
        return out if mutable else (out, {})

    want, new_state = wrap(run)(params, xj)
    port = load_flax_layer(port_module, variables).train(train)
    xt = torch.tensor(x, requires_grad=True)
    got = port(xt) if port_call is None else port_call(port, xt)
    np.testing.assert_allclose(got.detach().numpy(), _nchw(want), **tol)

    cot = np.random.RandomState(2).randn(*got.shape).astype(np.float32)
    g_p, g_x = wrap(jax.grad(lambda p, xin: jnp.sum(run(p, xin)[0] * _nhwc(cot)),
                             argnums=(0, 1)))(params, xj)
    (got * torch.tensor(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), _nchw(g_x), **tol)
    if params:
        want_grads = load_flax_layer(_like(port), {**variables, "params": jax.device_get(g_p)})
        for name, p in port.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), dict(want_grads.named_parameters())[name]
                                       .detach().numpy(), **tol, err_msg=name)
    if mutable:
        stats = load_flax_layer(_like(port), {**variables, **jax.device_get(new_state)})
        for name, b in port.named_buffers():
            np.testing.assert_allclose(b.numpy(), dict(stats.named_buffers())[name].numpy(),
                                       **F32, err_msg=name)
    return got


def _like(module):
    import copy

    return copy.deepcopy(module)


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("name", ["mish", "swish", "h_swish", "h_sigmoid"])
def test_activations(name):
    import torch

    from cpm_tpu_torch.modeling import layers as tlay

    x = _x((3, 4, 5, 6)) * 4
    want = np.asarray(getattr(jlay, name)(jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    got = getattr(tlay, name)(xt)
    np.testing.assert_allclose(got.detach().numpy(), want, **F32)
    got.sum().backward()
    g = np.asarray(jax.grad(lambda v: jnp.sum(getattr(jlay, name)(v)))(jnp.asarray(x)))
    np.testing.assert_allclose(xt.grad.numpy(), g, **F32)


def test_swishx_scale_l2norm():
    from cpm_tpu_torch.modeling import layers as tlay

    x = _x((2, 5, 6, 7)) * 3
    _check_layer(jlay.SwishX(), tlay.SwishX(), x)
    _check_layer(jlay.Scale(1.5), tlay.Scale(1.5), x)
    _check_layer(jlay.L2Norm(5), tlay.L2Norm(5), x)


@pytest.mark.parametrize("kernel,strides,padding", [((3, 3), (2, 2), 1),
                                                    ((2, 3), (1, 1), ((0, 1), (1, 0)))])
def test_conv2d_ws(kernel, strides, padding):
    """Standardised with the biased std, as the JAX `layers.Conv2dWS`
    (modeling/ws.py takes the unbiased one)."""
    from cpm_tpu_torch.modeling import layers as tlay

    x = _x((2, 5, 9, 8))
    _check_layer(jlay.Conv2dWS(6, kernel, strides, padding),
                 tlay.Conv2dWS(5, 6, kernel, strides, padding), x, tol=CONV)


@pytest.mark.parametrize("kernel,strides,dilation,groups", [((3, 3), (2, 2), (1, 1), 1),
                                                            ((4, 4), (1, 2), (2, 1), 2)])
def test_conv2d_same_padding(kernel, strides, dilation, groups):
    """TF "SAME": the odd row and column of padding at the end (a 4x4
    kernel, a 9x8 map at stride 2)."""
    from cpm_tpu_torch.modeling import layers as tlay

    x = _x((2, 4, 9, 8))
    _check_layer(jlay.Conv2dSamePadding(6, kernel, strides, dilation, groups),
                 tlay.Conv2dSamePadding(4, 6, kernel, strides, dilation, groups), x, tol=CONV)


def test_dropblock_with_the_jax_draws(monkeypatch):
    import torch

    from cpm_tpu_torch.modeling import layers as tlay
    from cpm_tpu_torch.utils.sampler import Draws

    recorded = []

    def bernoulli(key, p, shape):  # jax.random.bernoulli's own rule
        u = jax.random.uniform(key, shape)
        recorded.append(np.asarray(u))
        return u < p

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    x = _x((2, 3, 10, 9))
    jm = jlay.DropBlock2D(drop_prob=0.3, block_size=3)
    want = jm.apply({}, _nhwc(x), deterministic=False, rngs={"dropout": jax.random.PRNGKey(4)})
    draws = Draws([np.ascontiguousarray(np.transpose(recorded[0], (0, 3, 1, 2)))])
    port = tlay.DropBlock2D(0.3, 3).train()
    got = port(torch.tensor(x), draws)
    assert 0.1 < float((got == 0).float().mean()) < 0.9
    np.testing.assert_allclose(got.numpy(), _nchw(want), **F32)
    assert port.eval()(torch.tensor(x)).numpy().tobytes() == x.tobytes()


def test_eca_nonlocal_splat():
    from cpm_tpu_torch.modeling import layers as tlay

    _check_layer(jlay.ECA(3), tlay.ECA(3), _x((2, 8, 5, 6)))
    _check_layer(jlay.NonLocal2d(4), tlay.NonLocal2d(6, 4), _x((2, 6, 5, 4)), tol=CONV)
    _check_layer(jlay.SplAtConv2d(8, radix=2, reduction=4, strides=2),
                 tlay.SplAtConv2d(6, 8, radix=2, reduction=4, strides=2), _x((2, 6, 7, 6)),
                 tol=CONV)


def test_sync_batch_norm():
    """Training: the JAX layer's statistics over two halves of the batch
    joined by `axis_name='data'` are the port's over the whole batch with no
    group, and so are the running averages (flax's momentum, the biased
    variance); eval reads the running averages."""
    from cpm_tpu_torch.modeling import layers as tlay

    x = _x((4, 5, 3, 4)) * 2 + 1
    _check_layer(jlay.SyncBatchNorm(5), tlay.SyncBatchNorm(5), x)  # eval
    jm = jlay.SyncBatchNorm(5)
    halves = jnp.asarray(np.transpose(x, (0, 2, 3, 1)).reshape(2, 2, 3, 4, 5))
    variables = _perturbed(jm.init(jax.random.PRNGKey(0), halves[0]), seed=1)
    apply = jax.vmap(lambda v: jm.apply(variables, v, use_running_average=False,
                                        mutable=["batch_stats"]), axis_name="data")
    want, state = _jit(apply)(halves)
    import torch

    from cpm_tpu_torch.utils.param_bridge import load_flax_layer

    port = load_flax_layer(tlay.SyncBatchNorm(5), variables).train()
    got = port(torch.tensor(x))
    np.testing.assert_allclose(got.detach().numpy(),
                               _nchw(np.asarray(want).reshape(4, 3, 4, 5)), **F32)
    stats = jax.tree_util.tree_map(lambda a: np.asarray(a)[0], jax.device_get(state))
    np.testing.assert_allclose(port.bn.running_mean.numpy(), stats["batch_stats"]["bn"]["mean"],
                               **F32)
    np.testing.assert_allclose(port.bn.running_var.numpy(), stats["batch_stats"]["bn"]["var"],
                               **F32)


@pytest.mark.parametrize("base,train", [("gn", False), ("bn", True), ("bn", False)])
def test_mixture_norm(base, train):
    from cpm_tpu_torch.modeling import layers as tlay

    x = _x((3, 8, 4, 5)) * 2 + 0.5
    _check_layer(jlay.MixtureNorm(8, k=3, base=base, num_groups=4),
                 tlay.MixtureNorm(8, k=3, base=base, num_groups=4), x, train=train,
                 apply_kw=dict(deterministic=not train), tol=CONV)


# ---------------------------------------------------------------- init schemes


def test_unknown_scheme_raises():
    from cpm_tpu_torch.config import get_default_cfg
    from cpm_tpu_torch.modeling import initializers as init
    from cpm_tpu_torch.modeling.model import build_model

    with pytest.raises(ValueError, match="INIT_SCHEME"):
        init.SchemeGenerator("caffe")
    cfg = get_default_cfg()
    cfg.MODEL.INIT_SCHEME = "caffe"
    with pytest.raises(ValueError, match="INIT_SCHEME"):
        build_model(cfg, "meta")
    with pytest.raises(ValueError):
        jax_init.set_scheme("caffe")


def test_lecun_normal_draws_are_flax_s():
    """The port's truncated draw against flax's lecun_normal on one large
    kernel: the std, the cut at 2 / 0.8796 standard deviations, the mean."""
    import torch

    from cpm_tpu_torch.modeling import initializers as init

    want = np.asarray(jax.nn.initializers.lecun_normal()(jax.random.PRNGKey(0), (3, 3, 64, 96)))
    w = torch.empty(96, 64, 3, 3)
    init.lecun_normal_(w, init.SchemeGenerator("tpu").manual_seed(0))
    std = math.sqrt(1.0 / (64 * 9))
    bound = 2 * std / init.TRUNCATED_STD
    for a in (want, w.numpy()):
        assert abs(a.std() / std - 1) < 0.01
        assert np.abs(a).max() <= bound * (1 + 1e-6) and np.abs(a).max() > 0.99 * bound
        assert abs(a.mean()) < 3 * std / math.sqrt(a.size)


def jax_tiny_tpu_params(tmp_path_factory):
    """The JAX tiny CPM model's flax init under MODEL.INIT_SCHEME tpu
    (numpy), once a test run: one compiled init, at XLA's backend
    optimisation level 0. tests/test_torch_aux.py counts its parameters."""
    def compute():
        cfg = jax_default_cfg()
        merge_cfg_from_file(TINY_CPM, cfg)
        cfg.MODEL.INIT_SCHEME = "tpu"
        prev = jax_init.get_scheme()
        try:
            jm = jax_build_model(cfg)  # sets the JAX package's scheme
            images = np.zeros((1, 64, 64, 3), np.uint8)
            sizes = np.array([[64, 64]], np.int32)
            init = _jit(lambda k: jm.init({"params": k}, images, sizes, train=False)["params"])
            return jax.device_get(init(jax.random.PRNGKey(0)))
        finally:
            jax_init.set_scheme(prev)
    return shared(tmp_path_factory, "tiny_cpm_tpu_init", compute)


def test_tiny_model_tpu_init_matches_jax(tmp_path_factory):
    """Tensor by tensor: the zero and constant (prior) tensors exactly; the
    drawn ones by mean and std (within 6 / sqrt(n) of each other) and by
    whether both are lecun_normal's truncated draw: within its cut at
    2 / 0.8796 standard deviations of 1 / sqrt(fan_in), and, with more than
    200 draws, reaching past 0.9 of it."""
    from cpm_tpu_torch.config import get_default_cfg as port_default_cfg
    from cpm_tpu_torch.config import merge_cfg_from_file as port_merge
    from cpm_tpu_torch.modeling import initializers as init
    from cpm_tpu_torch.modeling.model import build_model
    from cpm_tpu_torch.utils.param_bridge import flax_tree_to_named

    cfg = port_default_cfg()
    port_merge(TINY_CPM, cfg)
    cfg.MODEL.INIT_SCHEME = "tpu"
    model = build_model(cfg, "cpu", seed=0)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    want = flax_tree_to_named(jax_tiny_tpu_params(tmp_path_factory),
                              {k: v.shape for k, v in sd.items()})
    kinds = {"zero": 0, "prior": 0, "lecun": 0, "other": 0}
    for name, j in want.items():
        p = sd[name]
        if not j.any():
            np.testing.assert_array_equal(p, 0.0, err_msg=name)
            kinds["zero"] += 1
            continue
        if (j == j.flat[0]).all():
            np.testing.assert_array_equal(p, j, err_msg=name)
            kinds["prior" if np.isclose(j.flat[0], init.PRIOR_BIAS) else "zero"] += 1
            continue
        n = j.size
        assert abs(p.std() / j.std() - 1) < 6 / math.sqrt(n), name
        assert abs(p.mean() - j.mean()) < 6 * j.std() / math.sqrt(n), name
        if n > 200 and p.ndim > 1:
            fan_in = p[0].size
            bound = 2 / init.TRUNCATED_STD / math.sqrt(fan_in)

            def lecun(a):
                return 0.9 * bound < np.abs(a).max() <= bound * (1 + 1e-6)
            assert lecun(j) == lecun(p), name
            kinds["lecun" if lecun(j) else "other"] += 1
    # the three heatmap deconvs' prior biases, and the lecun kernels
    assert kinds["prior"] == 3 and kinds["lecun"] > 20, kinds
