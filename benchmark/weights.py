"""The benchmark's weights: drawn on the device from the seed, conditioned
like a trained model's, and handed as one state dict to the port and to the
reference.

`make_state` draws every weight of rank 2 and more in one call of a
`torch.Generator` on the device (normal, scaled by 1 / sqrt(fan-in)), sets
1-D weights to 1 and biases to 0. Two conditioning steps follow, copied
from the port's tools/profile_train.py (see benchmark/README.md): the
deformable convs' offset convs are spread over about +-2 cells
(`spread_offset_convs`), and the trunk's frozen affines are set from one
batch's statistics (`fold_batch_statistics`): a random trunk with unit
affines diverges within two SGD steps. A third step is the benchmark's
own: ISM's IoU predictors (`iou_pred`) are set to predict about 0.7 with a
small spread (`condition_iou_predictors`), as a trained model predicts the
IoU of its detections; with a random predictor half the scores are
negative and the heads clamp them to 0, which no trained model serves.
"""

import math

import torch

OFFSET_CELLS = 2.0        # offsets spread over about +-2 cells
OFFSET_INPUT_SHARE = 0.1  # the part of that spread that depends on the conv's input


def make_state(meta_model, seed: int, device) -> dict:
    """A state dict for `meta_model` (built on the meta device) on `device`,
    drawn from `seed` in one call."""
    sd = meta_model.state_dict()
    g = torch.Generator(device=device).manual_seed(seed)
    wide = [(k, t) for k, t in sd.items() if t.is_floating_point() and t.dim() >= 2]
    flat = torch.randn(sum(t.numel() for _, t in wide), generator=g, device=device)
    out, at = {}, 0
    for k, t in wide:
        n = t.numel()
        out[k] = flat[at: at + n].view(t.shape).mul_(1.0 / math.sqrt(n / t.shape[0]))
        at += n
    for k, t in sd.items():
        if k in out:
            continue
        if t.is_floating_point():
            fill = 1.0 if k.endswith("weight") else 0.0
            out[k] = torch.full(t.shape, fill, dtype=t.dtype, device=device)
        else:
            out[k] = torch.zeros(t.shape, dtype=t.dtype, device=device)
    return out


def spread_offset_convs(model, seed: int) -> int:
    """Every deformable conv's offset conv of the reference `model`, drawn
    from `seed` on its device so that its offsets spread over about
    +-OFFSET_CELLS cells: biases uniform in that range, weights normal with
    std OFFSET_INPUT_SHARE * OFFSET_CELLS * sqrt(2 / fan_in). A fresh offset
    conv is zero and the sampler only copies; weights of full share make a
    random 101-layer trunk diverge. Returns how many convs were drawn."""
    from benchmark.reference.ops.deform_conv import _DeformPack

    n = 0
    for mod in model.modules():
        if isinstance(mod, _DeformPack):
            conv = getattr(mod, mod.offset_conv_name)
            g = torch.Generator(device=conv.weight.device).manual_seed(seed + n)
            fan_in = conv.weight[0].numel()
            with torch.no_grad():
                conv.weight.copy_(torch.randn(conv.weight.shape, generator=g, device=g.device)
                                  * (OFFSET_INPUT_SHARE * OFFSET_CELLS * math.sqrt(2.0 / fan_in)))
                conv.bias.copy_((torch.rand(conv.bias.shape, generator=g, device=g.device)
                                 * 2.0 - 1.0) * OFFSET_CELLS)
            n += 1
    return n


IOU_PRIOR = 0.7   # the IoU an ISM predictor predicts before its input moves it
IOU_WEIGHT_STD = 0.01


def condition_iou_predictors(model) -> int:
    """Every ISM IoU predictor of the reference `model` (a linear layer to
    (1 - IoU, IoU) logits), in place: weights scaled to std IOU_WEIGHT_STD,
    biases (1 - IOU_PRIOR, IOU_PRIOR). Returns how many."""
    n = 0
    for mod in model.modules():
        pred = getattr(mod, "iou_pred", None)
        if isinstance(pred, torch.nn.Linear):
            with torch.no_grad():
                pred.weight.mul_(IOU_WEIGHT_STD * math.sqrt(pred.weight.shape[1]))
                pred.bias.copy_(torch.tensor([1.0 - IOU_PRIOR, IOU_PRIOR]))
            n += 1
    return n


def fold_batch_statistics(model, images) -> int:
    """Set the reference `model`'s frozen AffineChannels from the statistics
    of one uint8 batch `images` [B, H, W, 3], as a pretrained checkpoint's
    folded BatchNorm does: each becomes (x - mean) / std per channel of what
    it is fed, the last one of every residual block times 0.25. One f32
    forward of the trunk, each affine set just before it runs."""
    from benchmark.reference.modeling.backbone.resnet import (
        AlignedBottleneck,
        BasicBlock,
        Bottleneck,
    )
    from benchmark.reference.modeling.norm import AffineChannel

    def fold(module, args):
        x = args[0].float()
        mean, std = x.mean(dim=(0, 2, 3)), x.std(dim=(0, 2, 3)).clamp_min(1e-3)
        gamma = 0.25 if module in last_of_block else 1.0
        module.weight.copy_(gamma / std)
        module.bias.copy_(-mean * gamma / std)

    affines = [m for m in model.backbone.modules() if isinstance(m, AffineChannel)]
    last = {Bottleneck: "bn3", AlignedBottleneck: "bn", BasicBlock: "bn2"}
    last_of_block = {getattr(b, last[type(b)]) for b in model.backbone.modules() if type(b) in last}
    hooks = [m.register_forward_pre_hook(fold) for m in affines]
    try:
        with torch.no_grad():
            x = model._normalize_uint8(images)
            model.backbone(x.float().permute(0, 3, 1, 2))
    finally:
        for h in hooks:
            h.remove()
    return len(affines)
