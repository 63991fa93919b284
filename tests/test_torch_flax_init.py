"""flax's truncated draws at the port's flax-default init sites.

Where the JAX package takes flax's own initializer whatever MODEL.INIT_SCHEME
says, the port draws as flax does: `lecun_normal` (the nn.Conv and nn.Dense
default) and `he_normal` are variance scaling over fan_in with a normal
truncated at two standard deviations, its std raised by 1 / 0.87962566 so
that the variance is scale / fan_in. Four sites:

* the necks' convs (`necks_extra._flax_conv`, against the JAX `RefConv`);
* the SE and GC blocks' convs (`context.py`, against the JAX blocks);
* a deformable conv's main weight (`ops/deform_conv.py`, `he_normal`);
* the grid head's `offset_emb` (`GridOutput` under OFFSET_ON without the
  fused tower, an nn.Dense in the JAX package).

Each site's port module and its flax counterpart are built at a size with at
least 10^4 weights a tensor: both sets lie within the truncation bound
2 * sqrt(scale / fan_in) / 0.87962566 (10^4 untruncated draws of the same
variance reach past it almost surely), and each tensor's sample std is
within 3% of sqrt(scale / fan_in), the two packages' within 4% of each
other (the std of a sample std over 10^4 draws is 0.7% of it).

torch and the port are imported inside the tests, so that collecting this
file loads no torch into a test worker.
"""

import math
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.torch_support import _one_torch_thread  # noqa: F401  (autouse)

TRUNCATED_STD = 0.87962566103423978


@pytest.fixture(scope="module", autouse=True)
def _drop_stub_modules_that_answer_every_name():
    """tests/test_weight_parity.py leaves stub modules in `sys.modules` whose
    `__getattr__` answers every name, `__file__` included, with a function;
    torch's first backward in the worker fails on them (tests/test_torch_data.py
    says more). They go before this file's first torch call."""
    for name, mod in list(sys.modules.items()):
        if isinstance(mod, types.ModuleType) and callable(getattr(mod, "__file__", None)):
            del sys.modules[name]


def _flax_weights(module, x, *args, **kwargs):
    """{path: kernel array} of a flax module's init on `x`."""
    params = module.init(jax.random.PRNGKey(0), jnp.asarray(x), *args, **kwargs)["params"]
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v) for path, v in flat}


def _check_site(port_weights, jax_weights, scale):
    """port_weights: torch weights ([out, in, ...]); jax_weights: flax
    kernels ([..., in, out]); each pair drawn by the same initializer."""
    assert len(port_weights) == len(jax_weights) > 0
    for w, k in zip(port_weights, jax_weights):
        w = w.detach().double().numpy()
        fan_in = int(np.prod(k.shape[:-1]))
        assert w.size == k.size >= 10_000
        std = math.sqrt(scale / fan_in)
        bound = 2 * std / TRUNCATED_STD
        for name, a in (("port", w), ("jax", k)):
            assert np.abs(a).max() <= bound * (1 + 1e-6), (name, np.abs(a).max() / bound)
            assert a.std() == pytest.approx(std, rel=0.03), name
        assert w.std() == pytest.approx(float(k.std()), rel=0.04)


def test_the_necks_convs_draw_flax_lecun_normal():
    import torch

    from cpm_tpu.modeling.necks_extra import RefConv

    from cpm_tpu_torch.modeling.necks_extra import _flax_conv

    g = torch.Generator().manual_seed(0)
    port = [_flax_conv(64, 64, 3, g=g).weight, _flax_conv(256, 64, 1, g=g).weight]
    jax_w = [_flax_weights(RefConv(64, kernel=3), np.zeros((1, 8, 8, 64), np.float32)),
             _flax_weights(RefConv(64, kernel=1), np.zeros((1, 8, 8, 256), np.float32))]
    _check_site(port, [next(v for p, v in w.items() if p.endswith("kernel")) for w in jax_w], 1.0)


@pytest.mark.parametrize("block", ["se", "gcb"])
def test_the_context_blocks_draw_flax_lecun_normal(block):
    import torch

    from cpm_tpu.modeling.context import GlobalContextBlock as JaxGC
    from cpm_tpu.modeling.context import SeBlock as JaxSe

    from cpm_tpu_torch.modeling.context import GlobalContextBlock, SeBlock

    g = torch.Generator().manual_seed(0)
    if block == "se":
        port = SeBlock(256, 64, g)
        names = (("fc1", port.fc1), ("fc2", port.fc2))
        jax_w = _flax_weights(JaxSe(256, 64), np.zeros((1, 4, 4, 256), np.float32))
    else:
        port = GlobalContextBlock(256, 64, g)
        names = (("transform_reduce", port.transform_reduce),
                 ("transform_expand", port.transform_expand))
        jax_w = _flax_weights(JaxGC(256, 64), np.zeros((1, 4, 4, 256), np.float32))
    _check_site([conv.weight for _, conv in names],
                [jax_w[f"{name}/kernel"] for name, _ in names], 1.0)
    if block == "gcb":  # the attention conv: 256 draws, the bound alone
        bound = 2 * math.sqrt(1 / 256) / TRUNCATED_STD
        for a in (port.conv_mask.weight.detach().numpy(), jax_w["conv_mask/kernel"]):
            assert np.abs(a).max() <= bound * (1 + 1e-6)


def test_a_deformable_convs_weight_draws_flax_he_normal():
    import torch

    from cpm_tpu.ops.deform_conv import DeformConvPack as JaxPack

    from cpm_tpu_torch.ops.deform_conv import DeformConvPack

    port = DeformConvPack(64, 64, 3, generator=torch.Generator().manual_seed(0))
    jax_w = _flax_weights(JaxPack(64, 3), np.zeros((1, 6, 6, 64), np.float32))
    _check_site([port.weight], [jax_w["weight"]], 2.0)


def test_the_grid_heads_offset_emb_draws_flax_lecun_normal():
    import torch

    from cpm_tpu.modeling.roi_heads.grid_modules import GridOutput as JaxGridOutput

    from cpm_tpu_torch.modeling.roi_heads.grid_modules import GridOutput

    P, c = 9, 64
    port = GridOutput(P, c, fused_on=False, offset_on=True,
                      generator=torch.Generator().manual_seed(0))
    jax_w = _flax_weights(JaxGridOutput(P, c, fused_on=False, offset_on=True),
                          np.zeros((1, 2, 2, c * P), np.float32), None,
                          np.zeros((1, 4 * P), np.float32))
    _check_site([port.offset_emb.weight], [jax_w["offset_emb/kernel"]], 1.0)
