"""Mixed precision: bf16 compute with f32 master parameters.

Port of cpm_tpu/utils/amp.py (`cast_floating_to`, `cast_images`,
`compute_dtype`). The train and eval steps run the model on casts of its
float parameters to `TPU.COMPUTE_DTYPE`, through
`torch.func.functional_call`: every conv and matmul then runs in bf16 while
the f32 masters stay untouched and, in training, receive f32 gradients
through the cast. `torch.autocast` was not chosen: it keeps GroupNorm and
softmax in f32, which the JAX package does not, so the two would disagree in
bf16. Box arithmetic (box coder, NMS IoU, grid decode), the classifier and
heatmap logits and the loss sums stay in float32.
"""

from typing import Dict

import torch


def compute_dtype(cfg) -> torch.dtype:
    """Resolve TPU.COMPUTE_DTYPE ('bfloat16' | 'float32')."""
    name = getattr(getattr(cfg, "TPU", None), "COMPUTE_DTYPE", "float32")
    if name in ("bfloat16", "bf16"):
        return torch.bfloat16
    if name in ("float32", "f32"):
        return torch.float32
    raise ValueError(f"unsupported TPU.COMPUTE_DTYPE: {name}")


def cast_floating_to(tensors: Dict[str, torch.Tensor], dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Float tensors of a name -> tensor dict cast to dtype (a no-op view of
    the same tensor where it already has it); others pass through. The cast
    is differentiable: gradients reach the originals in their own dtype."""
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in tensors.items()}


def cast_images(images: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An image batch in the compute dtype, except uint8 batches, which stay
    uint8 so that the model normalizes them on the device."""
    return images if images.dtype == torch.uint8 else images.to(dtype)
