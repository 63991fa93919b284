"""The control's precision: the configuration's bfloat16, one step lower.

The port computes in `TPU.COMPUTE_DTYPE` bfloat16 (every convolution,
product and activation of the network) with float32 masters, boxes, logits
and losses. Within `fp8_compute()`, the reference runs in that same regime
(its config's COMPUTE_DTYPE set to bfloat16) and every bfloat16 value that
an operation produces, gradients included, is rounded further to float8
e4m3 at a per-tensor scale (the largest magnitude to 448): the nearest
precision below the one the configurations state, the step a faster path
would take. float32 values (boxes, logits, losses, the masters) are left
as they are.
"""

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

E4M3_MAX = 448.0


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """`x` on the float8 e4m3 grid at a per-tensor scale, in its own dtype."""
    scale = E4M3_MAX / x.abs().amax().float().clamp_min(1e-30)
    return (x.float() * scale).to(torch.float8_e4m3fn).float().div(scale).to(x.dtype)


class fp8_compute(TorchDispatchMode):
    """Every bfloat16 output of every operation on the float8 grid."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))

        def round_(t):
            if isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16 and t.numel():
                return to_fp8(t)
            return t

        return tree_map(round_, out)
