"""Model measurement: parameter counts and FLOPs.

Port of cpm_tpu/utils/measure.py (after the reference's pet/utils/measure.py).
Parameters come from the module; FLOPs from
`torch.utils.flop_counter.FlopCounterMode` over one eval forward. The two
packages count differently, so their totals differ:

* XLA's cost analysis, which the JAX package reads, counts every op of the
  compiled program: elementwise ops, reductions, the gathers' arithmetic;
  of a padded convolution it leaves out the taps that fall on the padding;
* `FlopCounterMode` counts matrix products and convolutions only (2 FLOPs
  a multiply-add, as XLA counts them), padded taps included;
* the port's CUDA RoIAlign kernels run outside torch's dispatcher, and the
  plain versions' gathers are not products: both count as zero.

On a lone unpadded convolution or dense layer the two counts are equal; on
the tiny CPM model the port's count was 1.0142 times XLA's
(tests/test_torch_aux.py bounds the ratio).
"""

from typing import Callable, Dict

import torch

# The JAX package's parameter count of the flagship CPM R-50-FPN (81 classes,
# full widths), from an abstract init on the CPU:
#   python -c "import jax, numpy as np; from __graft_entry__ import _flagship_cfg; \
#     from cpm_tpu.modeling.model import build_model; \
#     from cpm_tpu.utils.measure import count_params; m = build_model(_flagship_cfg()); \
#     print(count_params(jax.eval_shape(lambda: m.init({'params': jax.random.PRNGKey(0)}, \
#     np.zeros((1, 800, 1344, 3), np.uint8), np.array([[800, 1344]], np.int32), \
#     train=False))['params']))"
FLAGSHIP_JAX_PARAMS = 153888590


def count_params(module: torch.nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


def param_breakdown(module: torch.nn.Module) -> Dict[str, int]:
    """Top-level module -> parameter count. The port's top-level names are
    the flax ones (utils/param_bridge.py maps `backbone`, `fpn`,
    `rpn_head` and `roi_head` to themselves)."""
    return {name: count_params(child) for name, child in module.named_children()
            if count_params(child)}


def flops_of(fn: Callable, *args) -> float:
    """FLOPs of fn(*args): the matrix products and convolutions that it
    dispatches, as `FlopCounterMode` counts them."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return float(counter.get_total_flops())


def flops_and_params(cfg, model, images, image_sizes) -> Dict:
    """FLOPs and parameters of the eval forward of a built model
    (engine/test.py::make_forward_fn) on one batch (images [B, H, W, 3])."""
    from cpm_tpu_torch.engine.test import make_forward_fn

    return dict(
        input_hw=[int(images.shape[1]), int(images.shape[2])],
        params=count_params(model),
        params_by_module=param_breakdown(model),
        eval_forward_flops=flops_of(make_forward_fn(cfg, model), images, image_sizes),
    )
