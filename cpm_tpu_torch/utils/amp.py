"""Mixed precision: the compute dtype of the port.

Port of cpm_tpu/utils/amp.py::compute_dtype. Eval casts the float
parameters and the normalized images to `TPU.COMPUTE_DTYPE`; box
arithmetic (box coder, NMS IoU, grid decode) and the classifier and
heatmap logits stay in float32.
"""

import torch


def compute_dtype(cfg) -> torch.dtype:
    """Resolve TPU.COMPUTE_DTYPE ('bfloat16' | 'float32')."""
    name = getattr(getattr(cfg, "TPU", None), "COMPUTE_DTYPE", "float32")
    if name in ("bfloat16", "bf16"):
        return torch.bfloat16
    if name in ("float32", "f32"):
        return torch.float32
    raise ValueError(f"unsupported TPU.COMPUTE_DTYPE: {name}")
