"""Fresh-init weight draws, from a `torch.Generator`.

Port of cpm_tpu/modeling/initializers.py, both schemes of
`MODEL.INIT_SCHEME`:

``reference``
    the distributions the torch reference draws from scratch (kaiming
    normal over fan_out in the trunk and towers, kaiming uniform a=1 in the
    FPN and MLPs, torch's own Conv defaults at raw `nn.Conv2d` sites);
``tpu``
    flax's defaults: `lecun_normal` (a normal truncated at two scaled
    standard deviations, of variance 1/fan_in) for every conv and dense
    weight, zero biases, and the grid deconvs' N(0, 0.001) kernels with
    zero / `-log(0.99/0.01)` biases.

The JAX package keeps the scheme in module state that `build_model` sets;
here `build_model` passes it down on the generator: a `SchemeGenerator` is a
`torch.Generator` that carries its scheme, and each scheme-aware draw below
(named as the JAX package's initializers) reads it. The frozen affines' scale
is ones under both schemes, as `norm.AffineChannel` draws it.
A plain generator, or None, draws the `reference` scheme. The layer zoo
(modeling/layers.py) draws flax's own defaults, `lecun_normal_` and
`he_normal_`; the earlier modules approximate them where flax draws them
whatever the scheme (the necks, the context blocks, the deformable convs'
weights, the grid head's offset embedding) with an untruncated normal of the
same variance (ROADMAP Queue 3).

The draws cannot match JAX's bit for bit; a model built from the same seed
is the same on every device, because the draws are made on the CPU before
the model moves. Imported weights (utils/param_bridge.py) overwrite all of
them.
"""

import math

import torch

SCHEMES = ("reference", "tpu")
# flax's truncated normal is cut at +-2 and rescaled to unit variance by
# this factor (the std of a standard normal truncated to [-2, 2])
TRUNCATED_STD = 0.87962566103423978
PRIOR_BIAS = -math.log(0.99 / 0.01)


def check_scheme(scheme: str) -> str:
    if scheme not in SCHEMES:
        raise ValueError(f"MODEL.INIT_SCHEME must be one of {SCHEMES}, got {scheme!r}")
    return scheme


class SchemeGenerator(torch.Generator):
    """A CPU `torch.Generator` that names the init scheme its draws follow."""

    def __new__(cls, scheme: str = "reference"):
        return super().__new__(cls)

    def __init__(self, scheme: str = "reference"):
        super().__init__()
        self.scheme = check_scheme(scheme)


def scheme_of(g) -> str:
    return getattr(g, "scheme", "reference")


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


@torch.no_grad()
def truncated_normal_(w: torch.Tensor, std: float, g: torch.Generator):
    """std * a standard normal truncated to [-2, 2], drawn as JAX draws it:
    the inverse CDF of a uniform over the cut interval."""
    lo, hi = (0.5 * (1 + math.erf(b / math.sqrt(2))) for b in (-2.0, 2.0))
    u = torch.rand(w.shape, generator=g, dtype=torch.float64) * (hi - lo) + lo
    z = (math.sqrt(2) * torch.erfinv(2 * u - 1)).clamp_(-2.0, 2.0)
    w.copy_(z * std)


def variance_scaling_(w, scale: float, g):
    """flax's variance_scaling(scale, 'fan_in', 'truncated_normal')."""
    truncated_normal_(w, math.sqrt(scale / _fans(w)[0]) / TRUNCATED_STD, g)


def lecun_normal_(w, g):
    """flax's default conv and dense kernel init."""
    variance_scaling_(w, 1.0, g)


def he_normal_(w, g):
    variance_scaling_(w, 2.0, g)


def kaiming_normal_fan_out(w, g):
    """kaiming_normal(mode=fan_out, relu): untruncated N(0, 2/fan_out)."""
    normal_(w, math.sqrt(2.0 / _fans(w)[1]), g)


def kaiming_uniform_a1(w, g):
    """kaiming_uniform(a=1) = U(+-sqrt(3/fan_in))."""
    uniform_(w, math.sqrt(3.0 / _fans(w)[0]), g)


def _by_scheme(reference):
    def draw(w, g):
        if scheme_of(g) == "reference":
            reference(w, g)
        else:
            lecun_normal_(w, g)
    draw.__doc__ = f"`{reference.__name__}` under reference, `lecun_normal_` under tpu."
    return draw


def _torch_default_kernel(w, g):
    """torch's Conv/Linear weight default, kaiming_uniform(a=sqrt(5)) =
    U(+-sqrt(1/fan_in)); for a ConvTranspose2d weight [in, out/groups, kh,
    kw] torch's fan_in is (out/groups)*kh*kw, which `_fans` also yields."""
    uniform_(w, math.sqrt(1.0 / _fans(w)[0]), g)


backbone_conv = _by_scheme(kaiming_normal_fan_out)  # trunk and C5-head convs
fpn_conv = _by_scheme(kaiming_uniform_a1)  # FPN lateral and output convs
mlp_fc = _by_scheme(kaiming_uniform_a1)  # make_fc MLP layers
tower_conv = _by_scheme(kaiming_normal_fan_out)  # make_conv sites
torch_conv_kernel = _by_scheme(_torch_default_kernel)  # raw nn.Conv2d sites


def torch_conv_bias(b, fan_in: int, g):
    """A raw `nn.Conv2d`'s bias: U(+-1/sqrt(fan_in)) under reference, zeros
    under tpu."""
    if scheme_of(g) == "reference":
        uniform_(b, 1.0 / math.sqrt(fan_in), g)
    else:
        with torch.no_grad():
            b.zero_()


def deconv_kernel_grouped(w, g):
    """A grid grouped deconv's ConvTranspose2d weight: torch's default over
    the transpose fan under reference, N(0, 0.001) under tpu."""
    if scheme_of(g) == "reference":
        _torch_default_kernel(w, g)
    else:
        normal_(w, 0.001, g)


def deconv_bias(b, fan_in: int, g, prior: bool = False):
    """A grid deconv's bias: U(+-1/sqrt(fan_in)) under reference; under tpu
    zeros, or the prior -log(0.99/0.01) for the heatmap deconv (`prior`)."""
    if scheme_of(g) == "reference":
        uniform_(b, 1.0 / math.sqrt(fan_in), g)
    else:
        with torch.no_grad():
            b.fill_(PRIOR_BIAS if prior else 0.0)
