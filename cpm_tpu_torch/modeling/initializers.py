"""Fresh-init weight draws, from a `torch.Generator`.

Port of the 'reference' scheme of cpm_tpu/modeling/initializers.py: the
distributions the torch reference draws from scratch. The draws cannot
match JAX's bit for bit; a model built from the same seed is the same on
every device, because the draws are made on the CPU before the model moves.
Imported weights (utils/param_bridge.py) overwrite all of them.
"""

import math

import torch


def _fans(w: torch.Tensor):
    """(fan_in, fan_out) of a Linear [out, in] or Conv [out, in/g, kh, kw]."""
    rf = w[0][0].numel() if w.dim() > 2 else 1
    return w.shape[1] * rf, w.shape[0] * rf


@torch.no_grad()
def uniform_(w: torch.Tensor, bound: float, g: torch.Generator):
    w.copy_(torch.rand(w.shape, generator=g) * (2 * bound) - bound)


@torch.no_grad()
def normal_(w: torch.Tensor, std: float, g: torch.Generator):
    w.copy_(torch.randn(w.shape, generator=g) * std)


def kaiming_normal_fan_out(w, g):
    """Backbone convs: kaiming_normal(mode=fan_out, relu)."""
    normal_(w, math.sqrt(2.0 / _fans(w)[1]), g)


def kaiming_uniform_a1(w, g):
    """FPN convs and MLP layers: kaiming_uniform(a=1) = U(+-sqrt(3/fan_in))."""
    uniform_(w, math.sqrt(3.0 / _fans(w)[0]), g)


def torch_default(w, b, g):
    """torch's own Conv/Linear init: U(+-sqrt(1/fan_in)) for the weight and
    U(+-1/sqrt(fan_in)) for the bias. For a ConvTranspose2d weight
    [in, out/groups, kh, kw] torch's fan_in is (out/groups)*kh*kw, which
    `_fans` also yields."""
    fan_in = _fans(w)[0]
    uniform_(w, math.sqrt(1.0 / fan_in), g)
    if b is not None:
        uniform_(b, 1.0 / math.sqrt(fan_in), g)
