"""Weight standardisation behind the USE_WS keys.

Port of cpm_tpu/modeling/ws.py (`ws_standardize_kernel`, `maybe_ws`). A
standardised conv subtracts each output channel's mean over (in, kh, kw)
from its weight and divides by the *unbiased* std of the centred weight
plus 1e-5, at every forward; the stored weight stays raw, so parameter
names, the bridge and checkpoints are those of the plain model.

`convert_to_ws` turns every `nn.Conv2d` of a module tree into a `WSConv2d`
that holds the same parameters, as the reference's
convert_conv2convws_model rewrites a gated module (and as torch's
`nn.SyncBatchNorm.convert_sync_batchnorm` converts norms). A deformable
conv's main weight is its own parameter, not an `nn.Conv2d`, and is not
standardised; its offset conv is, as in the JAX package. Linear layers are
not. The JAX package's flax init stores standardised kernels at a fresh
init; the port stores the raw draws, which give the same forward to float
tolerance (standardisation is idempotent to ~1e-5).
"""

import torch
from torch import nn


def ws_standardize(w: torch.Tensor) -> torch.Tensor:
    """Conv2dWS's weight transform on an OIHW weight, in f32, returned in
    the weight's dtype."""
    w32 = w.float()
    centred = w32 - w32.mean(dim=(1, 2, 3), keepdim=True)
    n = w.shape[1] * w.shape[2] * w.shape[3]
    # torch's .std() is unbiased (n - 1); a 1x1 conv on one input channel has n = 1
    var = (centred * centred).sum(dim=(1, 2, 3), keepdim=True) / max(n - 1, 1)
    return (centred / (var.sqrt() + 1e-5)).to(w.dtype)


class WSConv2d(nn.Conv2d):
    """An `nn.Conv2d` that convolves with its standardised weight."""

    def forward(self, x):
        return self._conv_forward(x, ws_standardize(self.weight), self.bias)


def convert_to_ws(module: nn.Module) -> nn.Module:
    """`module` with every `nn.Conv2d` in its tree replaced by a `WSConv2d`
    over the same parameters (the module itself if it is one)."""
    if type(module) is nn.Conv2d:
        m = module
        out = WSConv2d(m.in_channels, m.out_channels, m.kernel_size, m.stride, m.padding,
                       m.dilation, m.groups, m.bias is not None, m.padding_mode, device="meta")
        out.weight, out.bias = m.weight, m.bias
        return out.train(m.training)
    for name, child in module.named_children():
        new = convert_to_ws(child)
        if new is not child:
            setattr(module, name, new)
    return module


def maybe_ws(module: nn.Module, use_ws: bool) -> nn.Module:
    """`convert_to_ws(module)` under USE_WS, else `module`."""
    return convert_to_ws(module) if use_ws else module
