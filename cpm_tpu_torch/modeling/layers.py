"""The conv / norm / activation layer zoo.

Port of cpm_tpu/modeling/layers.py (after the reference's pet/lib/ops layer
modules): activations, `SwishX`, `Scale`, `L2Norm`, weight-standardised and
TF-"SAME" convs, `DropBlock2D`, `ECA`, `NonLocal2d`, `SplAtConv2d`,
`SyncBatchNorm` and `MixtureNorm`. No config selects them. Modules take
NCHW tensors, as the rest of the port; parameters are drawn as flax draws
them (`lecun_normal_`, `he_normal_` for `Conv2dWS`) from an optional
`torch.Generator`, and `utils/param_bridge.py::load_flax_layer` loads a
flax layer's variables into them.

Where the JAX package and torch differ, the port copies the JAX package:

* `Conv2dWS` standardises with the *biased* std plus 1e-5 (`jnp.std`),
  unlike modeling/ws.py, which copies the reference's unbiased `.std()`.
* The batch norms are flax's: statistics in f32 with the fast variance
  E[x^2] - E[x]^2 (clipped at 0), running averages kept as
  `momentum * running + (1 - momentum) * batch` with flax's momentum (0.9
  for `SyncBatchNorm`, flax's default 0.99 for `MixtureNorm`'s base), and the
  *biased* batch variance kept in `running_var`, where torch keeps the
  unbiased one.
* `MixtureNorm`'s GroupNorm base has flax's epsilon, 1e-6.
* `DropBlock2D` draws its seeds as `jax.random.bernoulli` does, a uniform
  below gamma; the uniforms come from a `utils/sampler.py::Draws` (or from
  torch's global generator on the input's device), so that a test can hand
  it the JAX package's.

`SyncBatchNorm` takes its statistics over the torch.distributed group when
one is set up (parallel/mesh.py::sum_ranks, differentiable), and over the
local batch otherwise.
"""

from typing import Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from cpm_tpu_torch.modeling import initializers as init
from cpm_tpu_torch.parallel.mesh import sum_ranks


def mish(x):
    return x * torch.tanh(F.softplus(x))


def swish(x):
    return x * torch.sigmoid(x)


def h_swish(x):
    return x * F.relu6(x + 3.0) / 6.0


def h_sigmoid(x):
    return F.relu6(x + 3.0) / 6.0


class SwishX(nn.Module):
    """Swish clamped above a learnable maximum: min(x*sigmoid(x), maximal)."""

    def __init__(self, maxvalue: float = 2.72):
        super().__init__()
        self.maximal = nn.Parameter(torch.tensor([maxvalue]))

    def forward(self, x):
        return torch.clamp(x * torch.sigmoid(x) - self.maximal, max=0.0) + self.maximal


class Scale(nn.Module):
    """A learnable scalar multiplier (flax's `scale`, here `weight`, as the
    bridge names every flax scale)."""

    def __init__(self, init_value: float = 1.0):
        super().__init__()
        self.weight = nn.Parameter(torch.tensor(float(init_value)))

    def forward(self, x):
        return x * self.weight


class L2Norm(nn.Module):
    """Channel L2 normalisation with a learnable per-channel scale (SSD)."""

    def __init__(self, features: int, init_scale: float = 20.0):
        super().__init__()
        self.weight = nn.Parameter(torch.full((features,), float(init_scale)))

    def forward(self, x, eps: float = 1e-10):
        norm = torch.sqrt((x * x).sum(dim=1, keepdim=True) + eps)
        return self.weight[:, None, None] * x / norm


def _flax_conv(cin, cout, k, stride=1, padding=0, dilation=1, groups=1, bias=True, g=None):
    """An nn.Conv2d drawn as flax's nn.Conv: lecun_normal kernel, zero bias."""
    conv = nn.Conv2d(cin, cout, k, stride=stride, padding=padding, dilation=dilation,
                     groups=groups, bias=bias)
    init.lecun_normal_(conv.weight, g)
    if bias:
        nn.init.zeros_(conv.bias)
    return conv


def _flax_linear(cin, cout, g=None):
    fc = nn.Linear(cin, cout)
    init.lecun_normal_(fc.weight, g)
    nn.init.zeros_(fc.bias)
    return fc


def _pairs(padding):
    """An int or ((top, bottom), (left, right)) -> F.pad's (l, r, t, b)."""
    if isinstance(padding, int):
        return (padding,) * 4
    (t, b), (l, r) = padding
    return (l, r, t, b)


class Conv2dWS(nn.Module):
    """Conv with weight standardisation, as the JAX `layers.Conv2dWS`: each
    output channel's weight less its mean, over its biased std plus 1e-5."""

    def __init__(self, in_channels: int, features: int, kernel_size: Sequence[int] = (3, 3),
                 strides: Sequence[int] = (1, 1), padding: Union[int, Sequence] = 1,
                 use_bias: bool = True, generator: torch.Generator = None):
        super().__init__()
        self.stride, self.pad = tuple(strides), _pairs(padding)
        self.weight = nn.Parameter(torch.empty(features, in_channels, *kernel_size))
        init.he_normal_(self.weight, generator)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def standardized_weight(self):
        w = self.weight
        mean = w.mean(dim=(1, 2, 3), keepdim=True)
        std = w.std(dim=(1, 2, 3), keepdim=True, correction=0) + 1e-5
        return (w - mean) / std

    def forward(self, x):
        return F.conv2d(F.pad(x, self.pad), self.standardized_weight(), self.bias, self.stride)


def _same_padding(size: int, k: int, stride: int, dilation: int):
    """TF "SAME" padding of one axis, (before, after): out = ceil(size /
    stride), the odd pixel after."""
    total = max((-(-size // stride) - 1) * stride + (k - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


class Conv2dSamePadding(nn.Module):
    """TensorFlow-style "SAME" conv: an explicit F.pad (the extra row and
    column at the end) before a padding-0 conv."""

    def __init__(self, in_channels: int, features: int, kernel_size: Sequence[int] = (3, 3),
                 strides: Sequence[int] = (1, 1), kernel_dilation: Sequence[int] = (1, 1),
                 feature_group_count: int = 1, use_bias: bool = True,
                 generator: torch.Generator = None):
        super().__init__()
        self.conv = _flax_conv(in_channels, features, tuple(kernel_size), tuple(strides), 0,
                               tuple(kernel_dilation), feature_group_count, use_bias, generator)

    def forward(self, x):
        c = self.conv
        (t, b), (l, r) = (_same_padding(x.shape[2 + i], c.kernel_size[i], c.stride[i],
                                       c.dilation[i]) for i in range(2))
        return c(F.pad(x, (l, r, t, b)))


class DropBlock2D(nn.Module):
    """DropBlock: in training, seeds drawn with probability gamma spread to
    block_size squares (a stride-1 max pool, TF "SAME") and are dropped; the
    rest is rescaled by the kept share."""

    def __init__(self, drop_prob: float = 0.1, block_size: int = 7):
        super().__init__()
        self.drop_prob, self.block_size = drop_prob, block_size

    def forward(self, x, draws=None):
        if not self.training or self.drop_prob == 0.0:
            return x
        B, C, H, W = x.shape
        k = self.block_size
        gamma = self.drop_prob / k ** 2 * (H * W) / max((H - k + 1) * (W - k + 1), 1)
        u = draws((B, C, H, W), x.device) if draws is not None else torch.rand(
            (B, C, H, W), device=x.device)
        seeds = (u < gamma).to(x.dtype)
        lo = (k - 1) // 2
        mask = F.max_pool2d(F.pad(seeds, (lo, k - 1 - lo, lo, k - 1 - lo)), k, stride=1)
        keep = 1.0 - mask
        return x * keep / torch.clamp(keep.mean(), min=1e-6)


class ECA(nn.Module):
    """Efficient channel attention: a 1-D conv over the channels of the
    pooled map, then a sigmoid gate."""

    def __init__(self, kernel_size: int = 3, generator: torch.Generator = None):
        super().__init__()
        self.conv1d = nn.Conv1d(1, 1, kernel_size, padding=kernel_size // 2, bias=False)
        init.lecun_normal_(self.conv1d.weight, generator)

    def forward(self, x):
        s = x.mean(dim=(2, 3))[:, None, :]  # [B, 1, C]
        attn = torch.sigmoid(self.conv1d(s)[:, 0])
        return x * attn[:, :, None, None]


class NonLocal2d(nn.Module):
    """Non-local block (embedded Gaussian) with a residual."""

    def __init__(self, in_channels: int, inner: int, generator: torch.Generator = None):
        super().__init__()
        self.inner = inner
        g = generator
        self.theta = _flax_conv(in_channels, inner, 1, g=g)
        self.phi = _flax_conv(in_channels, inner, 1, g=g)
        self.g = _flax_conv(in_channels, inner, 1, g=g)
        self.out = _flax_conv(inner, in_channels, 1, g=g)

    def forward(self, x):
        B, C, H, W = x.shape
        theta, phi, g = (m(x).flatten(2).transpose(1, 2) for m in (self.theta, self.phi, self.g))
        attn = torch.softmax(theta @ phi.transpose(1, 2) / float(self.inner) ** 0.5, dim=-1)
        y = (attn @ g).transpose(1, 2).reshape(B, self.inner, H, W)
        return x + self.out(y)


class SplAtConv2d(nn.Module):
    """Split-attention conv (ResNeSt): a grouped conv into `radix` splits,
    mixed by a softmax over the splits of a squeezed attention."""

    def __init__(self, in_channels: int, features: int, radix: int = 2, reduction: int = 4,
                 kernel_size: int = 3, strides: int = 1, generator: torch.Generator = None):
        super().__init__()
        self.radix, self.features = radix, features
        g = generator
        self.conv = _flax_conv(in_channels, features * radix, kernel_size, strides,
                               kernel_size // 2, groups=radix, g=g)
        inner = max(features // reduction, 8)
        self.fc1 = _flax_linear(features, inner, g)
        self.fc2 = _flax_linear(inner, radix * features, g)

    def forward(self, x):
        conv = F.relu(self.conv(x))
        B, _, H, W = conv.shape
        splits = conv.view(B, self.radix, self.features, H, W)
        gap = splits.sum(dim=1).mean(dim=(2, 3))  # [B, F]
        att = self.fc2(F.relu(self.fc1(gap))).view(B, self.radix, self.features)
        att = torch.softmax(att, dim=1)
        return (splits * att[:, :, :, None, None]).sum(dim=1)


class _FlaxBatchNorm(nn.Module):
    """flax's nn.BatchNorm over the channels of an NCHW tensor; `sync` takes
    the statistics over the torch.distributed group."""

    def __init__(self, features: int, momentum: float, eps: float, affine: bool = True,
                 sync: bool = False):
        super().__init__()
        self.momentum, self.eps, self.sync = momentum, eps, sync
        self.weight = nn.Parameter(torch.ones(features)) if affine else None
        self.bias = nn.Parameter(torch.zeros(features)) if affine else None
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def batch_stats(self, x):
        """(mean, biased var) over the batch and the map, in f32."""
        x32 = x.float()
        n = x32.new_tensor(float(x.numel() // x.shape[1]))
        sums = torch.stack([x32.sum(dim=(0, 2, 3)), (x32 * x32).sum(dim=(0, 2, 3))])
        if self.sync:
            sums, n = sum_ranks(sums), sum_ranks(n)
        mean, mean2 = sums / n
        return mean, torch.clamp(mean2 - mean * mean, min=0.0)

    def forward(self, x):
        if self.training:
            mean, var = self.batch_stats(x)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1 - m) * mean)
                self.running_var.mul_(m).add_((1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps)
        if self.weight is not None:
            mul = mul * self.weight
        y = (x - mean[:, None, None].to(x.dtype)) * mul[:, None, None].to(x.dtype)
        return y + self.bias[:, None, None] if self.bias is not None else y


class SyncBatchNorm(nn.Module):
    """Cross-device batch norm: statistics over the torch.distributed group
    (one sum of (x, x^2, count) a forward) in training, the running averages
    in eval. `bn` holds flax's parameters and batch statistics."""

    def __init__(self, features: int, momentum: float = 0.9, epsilon: float = 1e-5):
        super().__init__()
        self.bn = _FlaxBatchNorm(features, momentum, epsilon, sync=True)

    def forward(self, x):
        return self.bn(x)


class MixtureNorm(nn.Module):
    """Attentive normalisation: an affine-free base norm ('gn' or 'bn'),
    then K affines mixed by a softmax attention over the pooled input."""

    def __init__(self, features: int, k: int = 10, base: str = "gn", num_groups: int = 32,
                 generator: torch.Generator = None):
        super().__init__()
        if base == "gn":
            self.base = nn.GroupNorm(min(num_groups, features), features, eps=1e-6, affine=False)
        else:
            self.base = _FlaxBatchNorm(features, 0.99, 1e-5, affine=False)
        self.gammas = nn.Parameter(torch.ones(k, features))
        self.betas = nn.Parameter(torch.zeros(k, features))
        self.att = _flax_linear(features, k, generator)

    def forward(self, x):
        h = self.base(x)
        att = torch.softmax(self.att(x.mean(dim=(2, 3))), dim=-1)  # [B, K]
        return h * (att @ self.gammas)[:, :, None, None] + (att @ self.betas)[:, :, None, None]

