"""Reference PyTorch checkpoints -> the port's state_dicts.

The port's own copy of cpm_tpu/utils/weight_import.py, after the
reference's pretrain loading (pet/utils/checkpointer.py:62-122 and
align_and_update_state_dicts:180-227): a torch ResNet / ResNeXt trunk
(caffe-style `resnet50_caffe.pth` or torchvision) or a whole CPM checkpoint
(`Conv_Body.*`, `Conv_Body_FPN.*`, `RPN.head.*`, `Grid_Cascade_RCNN.*`,
model_builder.py:32-57, grid_cascade_rcnn.py:24-48, rpn/rpn.py:26-66)
becomes a state_dict under the port's parameter names.

The importers build the JAX package's param tree, node for node, with
leaves in the reference's torch layouts, and `utils/param_bridge.py::
torch_key` names each leaf. The port keeps torch's layouts (OIHW convs,
[out, in] linears, ConvTranspose2d's [Cin, Cout/groups, kh, kw]), so a
leaf is the reference tensor itself, with three exceptions: BatchNorm is
folded into the frozen affine (`fold_bn`, in float64), conv1 can swap its
input channels RGB <-> BGR (cfg.MODEL.CONV1_RGB2BGR, checkpointer.py:74-80),
and a linear layer over a flattened pooled feature has its input columns
permuted from the reference's (C, H, W) flatten to the port's (H, W, C)
(`_fc_after_pool`). The name map is explicit, not suffix matching.
"""

import os
from typing import Dict

import torch

from cpm_tpu_torch.utils.param_bridge import torch_key


def vgg16_reducedfc_name_mapping() -> Dict[str, str]:
    """Donor-key rename map for SSD-style `vgg16_reducedfc.pth` pretrain
    checkpoints: the key set of the reference's VGG16_NAME_MAPPING
    (checkpointer.py:241-272), derived from the VGG16-D layout. The donor's
    bare `nn.Sequential` indices (convs at 0..28, the reduced fc at 31/33)
    go to `features1` (indices kept) up to conv4_3, `features2` (indices
    less 23) after it, and `conv6` / `conv7`."""
    mapping = {}
    for i in (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28):
        tgt = f"features1.{i}" if i <= 21 else f"features2.{i - 23}"
        for p in ("weight", "bias"):
            mapping[f"{i}.{p}"] = f"{tgt}.{p}"
    for i, tgt in ((31, "conv6"), (33, "conv7")):
        for p in ("weight", "bias"):
            mapping[f"{i}.{p}"] = f"{tgt}.{p}"
    return mapping


def apply_pretrain_name_mapping(sd: Dict[str, torch.Tensor], weights_path: str):
    """Rename donor keys of known pretrain formats (CheckPointer.weight_mapping,
    checkpointer.py:59-72): a file whose name holds `vgg16_reducedfc`, where
    every key must be in the map (KeyError otherwise), as in the reference."""
    if "vgg16_reducedfc" not in os.path.basename(str(weights_path)):
        return sd
    mapping = vgg16_reducedfc_name_mapping()
    return {mapping[k]: v for k, v in sd.items()}


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A checkpoint's tensors on the CPU: unwrapped from `model` or
    `state_dict`, `module.` prefixes stripped, known pretrain names mapped."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict):
        for key in ("model", "state_dict"):
            if key in sd and isinstance(sd[key], dict):
                sd = sd[key]
                break
    out = {k[len("module."):] if k.startswith("module.") else k: torch.as_tensor(v)
           for k, v in sd.items()}
    return apply_pretrain_name_mapping(out, path)


def fold_bn(sd: Dict[str, torch.Tensor], prefix: str, eps: float = 1e-5):
    """(scale, bias) float32 of the BatchNorm or affine module `prefix`:
    with running statistics folded in float64, as the reference's
    convert_bn2affine (net.py:114-125); a caffe export is already affine."""
    w = sd[f"{prefix}.weight"].to(torch.float64)
    b = sd[f"{prefix}.bias"].to(torch.float64)
    if f"{prefix}.running_mean" in sd:
        mean = sd[f"{prefix}.running_mean"].to(torch.float64)
        var = sd[f"{prefix}.running_var"].to(torch.float64)
        scale = w / torch.sqrt(var + eps)
        bias = b - mean * scale
    else:
        scale, bias = w, b
    return scale.to(torch.float32), bias.to(torch.float32)


def _named(tree, prefix=()) -> Dict[str, torch.Tensor]:
    """A param tree (nested dicts of the JAX package's names) -> {port name: tensor}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_named(v, prefix + (k,)))
        else:
            out[torch_key(prefix + (k,))] = v
    return out


def _conv(sd, name):
    out = {"kernel": sd[f"{name}.weight"]}
    if f"{name}.bias" in sd:
        out["bias"] = sd[f"{name}.bias"]
    return out


_fc = _conv  # a torch Linear's [out, in] is the port's layout too


def _fc_after_pool(sd, name, pool_hw):
    """A Linear over the NCHW-flattened pooled feature (fc6, iou_fc1: the
    reference's `x.view(R, -1)`) -> one over the port's (H, W, C) flatten:
    its input columns permuted (C, H, W) -> (H, W, C). Without it imported
    weights give garbage silently."""
    w = sd[f"{name}.weight"]  # [out, C*H*W]
    h, wd = pool_hw
    cin = w.shape[1] // (h * wd)
    if cin * h * wd != w.shape[1]:
        raise ValueError(f"{name}.weight {tuple(w.shape)} is no flatten of a {pool_hw} pool")
    out = {"kernel": w.reshape(w.shape[0], cin, h, wd).permute(0, 2, 3, 1)
           .reshape(w.shape[0], -1).contiguous()}
    if f"{name}.bias" in sd:
        out["bias"] = sd[f"{name}.bias"]
    return out


def _gn(sd, name):
    return {"scale": sd[f"{name}.weight"], "bias": sd[f"{name}.bias"]}


def _stage_conv(sd, name):
    """A bottleneck conv: plain, or a DeformConvPack / ModulatedDeformConvPack
    (reference deform_conv.py:472-558: the main `weight` and a `conv_offset`
    or `conv_offset_mask` child Conv2d)."""
    for off_name in ("conv_offset", "conv_offset_mask"):
        if f"{name}.{off_name}.weight" in sd:
            return {"weight": sd[f"{name}.weight"], off_name: _conv(sd, f"{name}.{off_name}")}
    return {"kernel": sd[f"{name}.weight"]}


def _resnet_tree(sd, layers, conv1_rgb2bgr, bn_eps):
    conv1 = sd["conv1.weight"]
    if conv1_rgb2bgr:
        conv1 = conv1.flip(1)  # OIHW: the input channels
    out = {"conv1": {"kernel": conv1}}
    s, b = fold_bn(sd, "bn1", bn_eps)
    out["AffineChannel_0"] = {"scale": s, "bias": b}
    for li, n_blocks in enumerate(layers):
        for bi in range(n_blocks):
            pref = f"layer{li + 1}.{bi}"
            blk = {}
            for ci in (1, 2, 3):
                if f"{pref}.conv{ci}.weight" not in sd:
                    continue
                blk[f"conv{ci}"] = _stage_conv(sd, f"{pref}.conv{ci}")
                s, b = fold_bn(sd, f"{pref}.bn{ci}", bn_eps)
                blk[f"AffineChannel_{ci - 1}"] = {"scale": s, "bias": b}
            if f"{pref}.downsample.0.weight" in sd:
                blk["downsample_conv"] = {"kernel": sd[f"{pref}.downsample.0.weight"]}
                s, b = fold_bn(sd, f"{pref}.downsample.1", bn_eps)
                blk["AffineChannel_3"] = {"scale": s, "bias": b}
            out[f"layer{li + 1}_{bi}"] = blk
    return out


def import_resnet_backbone_sd(sd, layers=(3, 4, 6, 3), conv1_rgb2bgr: bool = False,
                              bn_eps: float = 1e-5) -> Dict[str, torch.Tensor]:
    """A torch ResNet / ResNeXt trunk's state_dict -> the port's `backbone.*`
    parameters, BatchNorm folded into the frozen affines."""
    return _named({"backbone": _resnet_tree(sd, layers, conv1_rgb2bgr, bn_eps)})


def import_resnet_backbone(path: str, layers=(3, 4, 6, 3), conv1_rgb2bgr: bool = False,
                           bn_eps: float = 1e-5) -> Dict[str, torch.Tensor]:
    """`import_resnet_backbone_sd` of the checkpoint file at `path`."""
    return import_resnet_backbone_sd(load_torch_state_dict(path), layers, conv1_rgb2bgr, bn_eps)


def trunk_layers(cfg) -> tuple:
    """The blocks a stage of the configured trunk: a ResNeXt (X-101 YAMLs)
    keeps them under BACKBONE.RESNEXT; the torch keys are the same."""
    section = (cfg.BACKBONE.RESNEXT if "resnext" in str(cfg.BACKBONE.CONV_BODY)
               else cfg.BACKBONE.RESNET)
    return tuple(section.LAYERS)


def merge_backbone_into_model(model: torch.nn.Module, backbone: Dict[str, torch.Tensor]):
    """Load an imported trunk into `model` in place, strictly: a key the
    model lacks, a trunk parameter the import lacks, or a shape that differs
    raises, and nothing is loaded then."""
    own = {k: v for k, v in model.state_dict().items() if k.startswith("backbone.")}
    unknown = sorted(set(backbone) - set(own))
    missing = sorted(set(own) - set(backbone))
    if unknown or missing:
        raise KeyError(f"imported trunk against the model's: unknown {unknown[:5]}, "
                       f"missing {missing[:5]}")
    for k, v in backbone.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"shape of {k}: model {tuple(own[k].shape)}, import {tuple(v.shape)}")
    with torch.no_grad():
        for k, v in backbone.items():
            own[k].copy_(v)
    return model


def import_fpn(sd, prefix: str = "") -> dict:
    """fpn (FPN.py:14-111): p5_in / p5_out and fpn_in.{i} / fpn_out.{i}."""
    out = {"p5_in": _conv(sd, f"{prefix}p5_in"), "p5_out": _conv(sd, f"{prefix}p5_out")}
    i = 0
    while f"{prefix}fpn_in.{i}.weight" in sd:
        out[f"fpn_in_{i}"] = _conv(sd, f"{prefix}fpn_in.{i}")
        out[f"fpn_out_{i}"] = _conv(sd, f"{prefix}fpn_out.{i}")
        i += 1
    return out


def import_rpn_head(sd, prefix: str = "RPN.head.") -> dict:
    """RPNHead (rpn/rpn.py:26-28)."""
    return {name: _conv(sd, f"{prefix}{name}") for name in ("conv", "cls_logits", "bbox_pred")}


def import_cls_head(sd, prefix: str, pool_hw=(7, 7)) -> dict:
    """The 2-MLP head (cls_heads.py:34-35); fc6 reads the flattened pool."""
    return {"fc6": _fc_after_pool(sd, f"{prefix}fc6", pool_hw), "fc7": _fc(sd, f"{prefix}fc7")}


def import_cls_output(sd, prefix: str) -> dict:
    return {"cls_score": _fc(sd, f"{prefix}cls_score")}


def import_grid_head(sd, prefix: str) -> dict:
    """roi_grid_head (grid_heads.py:39-66): the tower convs.{i}.{0: conv,
    1: GN} and, with FUSED_ON, the forder / sorder transitions {i}.{j}.{0:
    depthwise, 1: pointwise}."""
    out = {}
    i = 0
    while f"{prefix}convs.{i}.0.weight" in sd:
        out[f"conv{i}"] = _conv(sd, f"{prefix}convs.{i}.0")
        out[f"gn{i}"] = _gn(sd, f"{prefix}convs.{i}.1")
        i += 1
    for order in ("forder", "sorder"):
        i = 0
        while f"{prefix}{order}_trans.{i}.0.0.weight" in sd:
            j = 0
            while f"{prefix}{order}_trans.{i}.{j}.0.weight" in sd:
                out[f"{order}_{i}_{j}"] = {
                    "dw": _conv(sd, f"{prefix}{order}_trans.{i}.{j}.0"),
                    "pw": _conv(sd, f"{prefix}{order}_trans.{i}.{j}.1"),
                }
                j += 1
            i += 1
    if f"{prefix}offset_conv.weight" in sd:
        out["offset_conv"] = _conv(sd, f"{prefix}offset_conv")
        # offset_fc reads the flattened 7x7x64 offset-conv output
        out["offset_fc"] = _fc_after_pool(sd, f"{prefix}offset_fc", (7, 7))
    return out


def import_grid_output(sd, prefix: str) -> dict:
    """Grid_output (outputs.py:23-45): the grouped deconvs (the port's
    ConvTranspose2d takes the reference's weight as it is), GN and the ISM
    linears; iou_fc1 reads the flattened 7x7 tower feature."""
    out = {
        "deconv1_kernel": sd[f"{prefix}deconv_1.weight"],
        "deconv1_bias": sd[f"{prefix}deconv_1.bias"],
        "deconv2_kernel": sd[f"{prefix}deconv_2.weight"],
        "deconv2_bias": sd[f"{prefix}deconv_2.bias"],
        "norm1": _gn(sd, f"{prefix}norm1"),
    }
    if f"{prefix}iou_fc1.weight" in sd:
        out["iou_fc1"] = _fc_after_pool(sd, f"{prefix}iou_fc1", (7, 7))
        out["iou_fc2"] = _fc(sd, f"{prefix}iou_fc2")
        out["iou_pred"] = _fc(sd, f"{prefix}iou_pred")
    return out


def import_cpm_checkpoint(path_or_sd, cfg) -> Dict[str, torch.Tensor]:
    """A whole reference CPM checkpoint (a path, or its state_dict) -> the
    port's state_dict for GeneralizedRCNN: trunk, FPN, RPN head and the
    grid-cascade head's branches."""
    sd = load_torch_state_dict(path_or_sd) if isinstance(path_or_sd, str) else path_or_sd
    trunk = {k[len("Conv_Body."):]: v for k, v in sd.items() if k.startswith("Conv_Body.")}
    tree = {
        "backbone": _resnet_tree(trunk, trunk_layers(cfg), cfg.MODEL.CONV1_RGB2BGR, 1e-5),
        "fpn": import_fpn(sd, "Conv_Body_FPN."),
        "rpn_head": import_rpn_head(sd, "RPN.head."),
    }
    g = "Grid_Cascade_RCNN."
    head = {
        "cls_head": import_cls_head(sd, f"{g}Head_cls."),
        "cls_output": import_cls_output(sd, f"{g}Output_cls."),
    }
    s = 0
    while f"{g}Head_grid_{s}.convs.0.0.weight" in sd:
        head[f"grid_head_{s}"] = import_grid_head(sd, f"{g}Head_grid_{s}.")
        head[f"grid_output_{s}"] = import_grid_output(sd, f"{g}Output_grid_{s}.")
        s += 1
    if f"{g}Head_rescore.fc6.weight" in sd:
        head["rescore_head"] = import_cls_head(sd, f"{g}Head_rescore.")
        head["rescore_output"] = import_cls_output(sd, f"{g}Output_rescore.")
    tree["roi_head"] = head
    return _named(tree)
