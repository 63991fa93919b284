"""Weights bridge between the JAX package's flax `params` tree and the
port's parameter names, in both directions.

The trees' leaves are numpy arrays (`jax.device_get` of the flax params);
this module imports no JAX. `name_map` is the map itself: flax path -> port
parameter name. `flax_tree_to_named` applies it, with the layout transforms,
to any tree of the params' structure (parameters, a gradient tree, a
momentum tree); `state_dict_to_flax` goes back. Layouts:

* Conv kernels HWIO -> OIHW (depthwise and grouped ones too: [5, 5, 1, C] ->
  [C, 1, 5, 5]; both packages keep a grouped conv's output channels
  groups-major).
* A deformable conv's main parameter is the leaf `weight` (not `kernel`) in
  HWIO `[k, k, Cin/groups, Cout]` -> `weight` in OIHW; its offset conv
  `conv2/conv_offset/{kernel,bias}` (`conv_offset_mask` for v2) maps like any
  conv, to `conv2.conv_offset.{weight,bias}`.
* Dense kernels [in, out] -> [out, in]. The flattened inputs of the dense
  layers are NHWC in both packages, so rows need no permutation.
* The grouped deconv kernel [4, 4, Cin/P, Cout], which flax applies flipped
  over a 2x-dilated input, is exactly a ConvTranspose2d(k=4, s=2, p=1,
  groups=P) with weight [Cin, Cout/P, 4, 4]:
  W[g*Cin/P + i, o, a, b] = kernel[a, b, i, g*Cout/P + o].
* AffineChannel and GroupNorm `scale` -> `weight`.
* The C4 heads' stage 5 (`roi_head/head/layer4_{b}`) maps as the trunk's
  stages do; SE_ON's `se/fc1`, `se/fc2` are 1x1 convs, OFFSET_ON's
  `offset_conv` a conv and `offset_fc`, `offset_emb` dense layers.
* flax auto-names the norms (`AffineChannel_k`, or `GroupNorm_k/gn` under
  GN) in call order. In the stem they are `bn1`..`bn3`; in a block they map
  by the block's kind (`BLOCK_NORMS`), which its convs tell: `conv1_1` is an
  aligned block, no `conv3` a basic one; a block's `SeBlock_0` /
  `GlobalContextBlock_0` is its `context` (a LayerNorm's `scale` is its
  `weight`). The FPN's own norms are the ModuleList `fpn.norms`; a neck's
  `RefConv` norm is its `norm`; BiFPN's fusion weights `w1`..`w3` keep their
  names, as do the other necks' modules.

Every flax leaf must land on one port parameter and every port parameter
must receive one leaf, with matching shapes; anything else raises.

`load_flax_layer` loads one layer of the zoo (modeling/layers.py) from its
flax variables, `params` and `batch_stats`: the leaves keep their names,
save a scale (-> `weight`), `Conv2dSamePadding`'s inner `Conv_0` (->
`conv`), and a batch norm's `mean` / `var` (-> `running_mean` /
`running_var`); `ECA`'s 1-D kernel [k, 1, 1] -> [1, 1, k].
"""

import re
from typing import Dict, Mapping

import numpy as np
import torch

# (pattern, replacement) on the '/'-joined flax path; the first match wins
_RULES = [
    (r"^backbone/(?:AffineChannel|GroupNorm)_(\d)/(?:gn/)?", lambda m: f"backbone/bn{int(m[1]) + 1}/"),
    # the trunk's stages, and the C4 heads' stage 5 (roi_head/head/layer4_{b}),
    # whose norms torch_key has named by BLOCK_NORMS
    (r"^((?:backbone|roi_head/head)/layer\d+)_(\d+)/downsample_conv/", r"\1/\2/downsample/0/"),
    (r"^((?:backbone|roi_head/head)/layer\d+)_(\d+)/(?:SeBlock|GlobalContextBlock)_0/",
     r"\1/\2/context/"),
    (r"^((?:backbone|roi_head/head)/layer\d+)_(\d+)/", r"\1/\2/"),
    (r"^fpn/fpn_(in|out)_(\d+)/", r"fpn/fpn_\1/\2/"),
    (r"^fpn/(?:AffineChannel|GroupNorm)_(\d+)/(?:gn/)?", r"fpn/norms/\1/"),
    (r"^fpn/(.+?)/(?:AffineChannel|GroupNorm)_0/(?:gn/)?", r"fpn/\1/norm/"),
    (r"^roi_head/grid_head_(\d+)/conv(\d+)/", r"roi_head/grid_heads/\1/convs/\2/"),
    (r"^roi_head/grid_head_(\d+)/gn(\d+)/", r"roi_head/grid_heads/\1/gns/\2/"),
    (r"^roi_head/grid_head_(\d+)/([fs]order)_(\d+)_(\d+)/",
     r"roi_head/grid_heads/\1/\2/\3_\4/"),
    # OFFSET_ON's offset_conv and offset_fc
    (r"^roi_head/grid_head_(\d+)/", r"roi_head/grid_heads/\1/"),
    (r"^roi_head/grid_output_(\d+)/(deconv\d)_(kernel|bias)$",
     r"roi_head/grid_outputs/\1/\2/\3"),
    (r"^roi_head/grid_output_(\d+)/", r"roi_head/grid_outputs/\1/"),
    # Fast R-CNN (head, output) and Cascade R-CNN (box_head_{s}, output_{s},
    # rescore_head, rescore_output); the ConvFC head's convs are a ModuleList
    (r"^roi_head/head/conv(\d+)/", r"roi_head/head/convs/\1/"),
    (r"^roi_head/box_head_(\d+)/conv(\d+)/", r"roi_head/box_heads/\1/convs/\2/"),
    (r"^roi_head/box_head_(\d+)/", r"roi_head/box_heads/\1/"),
    (r"^roi_head/output_(\d+)/", r"roi_head/outputs/\1/"),
]
_LEAF = {"kernel": "weight", "weight": "weight", "scale": "weight", "bias": "bias",
         "w1": "w1", "w2": "w2", "w3": "w3"}
# a trunk block's norms in flax's call order, by the block's kind
BLOCK_NORMS = {
    "bottleneck": ("bn1", "bn2", "bn3", "downsample/1"),
    "aligned": ("bn1_1", "bn2_1", "bn2_2", "bn_concat", "bn", "downsample/1"),
    "basic": ("bn1", "bn2", "downsample/1"),
}
_BLOCK = r"^((?:backbone|roi_head/head)/layer\d+_\d+)/"


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = np.asarray(v)
    return out


def block_kinds(paths) -> Dict[str, str]:
    """Trunk block path -> 'bottleneck' | 'aligned' | 'basic', from the
    convs among the flax leaf paths (tuples of names)."""
    convs = {}
    for path in paths:
        m = re.match(_BLOCK + r"([^/]+)/", "/".join(path))
        if m:
            convs.setdefault(m[1], set()).add(m[2])
    return {block: "aligned" if "conv1_1" in names else ("bottleneck" if "conv3" in names
                                                           else "basic")
            for block, names in convs.items()}


def torch_key(flax_path, kinds: Mapping[str, str] = None) -> str:
    """The state_dict key of one flax leaf path (tuple of names); `kinds`
    (`block_kinds`) names each trunk block's kind, bottleneck by default."""
    path = "/".join(flax_path)
    m = re.match(_BLOCK + r"(?:AffineChannel|GroupNorm)_(\d+)/(?:gn/)?", path)
    if m:
        norm = BLOCK_NORMS[(kinds or {}).get(m[1], "bottleneck")][int(m[2])]
        path = f"{m[1]}/{norm}/{path[m.end():]}"
    for pattern, repl in _RULES:
        new, n = re.subn(pattern, repl, path)
        if n:
            path = new
            break
    *mods, leaf = path.split("/")
    if leaf not in _LEAF:
        raise KeyError(f"no torch counterpart for flax leaf {'/'.join(flax_path)}")
    return ".".join(mods + [_LEAF[leaf]])


def deconv_kernel_to_torch(kernel: np.ndarray, groups: int) -> np.ndarray:
    """Flax grouped-deconv kernel [kh, kw, Cin/P, Cout] -> ConvTranspose2d
    weight [Cin, Cout/P, kh, kw] for `groups` = P."""
    kh, kw, cin_g, cout = kernel.shape
    w = kernel.reshape(kh, kw, cin_g, groups, cout // groups)
    return w.transpose(3, 2, 4, 0, 1).reshape(groups * cin_g, cout // groups, kh, kw)


def deconv_kernel_to_flax(weight: np.ndarray, groups: int) -> np.ndarray:
    """The inverse of `deconv_kernel_to_torch`."""
    cin, cout_g, kh, kw = weight.shape
    w = weight.reshape(groups, cin // groups, cout_g, kh, kw)
    return w.transpose(3, 4, 1, 0, 2).reshape(kh, kw, cin // groups, groups * cout_g)


def _to_torch(flax_path, value: np.ndarray, torch_shape) -> np.ndarray:
    if value.ndim == 4 and "deconv" in flax_path[-1]:
        return deconv_kernel_to_torch(value, torch_shape[0] // value.shape[2])
    if value.ndim == 4:
        return value.transpose(3, 2, 0, 1)
    if value.ndim == 2:
        return value.T
    return value


def _to_flax(flax_path, value: np.ndarray, flax_shape) -> np.ndarray:
    if value.ndim == 4 and "deconv" in flax_path[-1]:
        return deconv_kernel_to_flax(value, value.shape[0] // flax_shape[2])
    if value.ndim == 4:
        return value.transpose(2, 3, 1, 0)
    if value.ndim == 2:
        return value.T
    return value


def name_map(tree: Mapping) -> Dict[tuple, str]:
    """Flax leaf path (tuple of names) -> port parameter name, for every
    leaf of a tree of the params' structure; two leaves on one name raise."""
    out = {}
    paths = list(_flatten(tree))
    kinds = block_kinds(paths)
    for path in paths:
        key = torch_key(path, kinds)
        if key in out.values():
            raise KeyError(f"two flax leaves map to {key}")
        out[path] = key
    return out


def flax_tree_to_named(tree: Mapping, shapes: Mapping[str, tuple]) -> Dict[str, np.ndarray]:
    """Any tree of the flax params' structure -> {port parameter name:
    numpy array in the port's layout}. `shapes` gives the port's shape for
    every parameter name; each must receive exactly one leaf."""
    leaves = _flatten(tree)
    out = {}
    for path, key in name_map(tree).items():
        if key not in shapes:
            raise KeyError(f"flax leaf {'/'.join(path)} -> {key}: no such port parameter")
        want = tuple(shapes[key])
        w = _to_torch(path, leaves[path], want)
        if tuple(w.shape) != want:
            raise ValueError(
                f"{'/'.join(path)} {leaves[path].shape} -> {key}: got {w.shape}, want {want}"
            )
        out[key] = w
    missing = sorted(set(shapes) - set(out))
    if missing:
        raise KeyError(f"port parameters without a flax leaf: {missing}")
    return out


def flax_to_state_dict(params: Mapping, model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Convert a flax params tree into a state_dict for `model`."""
    targets = model.state_dict()
    named = flax_tree_to_named(params, {k: tuple(v.shape) for k, v in targets.items()})
    return {k: torch.tensor(w, dtype=targets[k].dtype) for k, w in named.items()}


def state_dict_to_flax(state_dict: Mapping, like: Mapping) -> dict:
    """The port's parameters (name -> tensor or array) as a flax tree of
    numpy arrays with the structure and leaf shapes of `like` (any tree of
    the flax params' structure). Every entry is used exactly once."""
    names = name_map(like)
    unused = set(state_dict) - set(names.values())
    if unused:
        raise KeyError(f"port parameters without a flax leaf: {sorted(unused)}")
    out = {}
    for path, leaf in _flatten(like).items():
        key = names[path]
        if key not in state_dict:
            raise KeyError(f"flax leaf {'/'.join(path)} -> {key}: no such port parameter")
        v = state_dict[key]
        v = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        w = _to_flax(path, v, leaf.shape)
        if w.shape != leaf.shape:
            raise ValueError(f"{key} {v.shape} -> {'/'.join(path)}: got {w.shape}, want {leaf.shape}")
        node = out
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = w
    return out


def load_flax_params(model: torch.nn.Module, params: Mapping) -> torch.nn.Module:
    """Load a flax params tree into `model` in place; returns the model."""
    model.load_state_dict(flax_to_state_dict(params, model), strict=True)
    return model


_LAYER_LEAF = {"kernel": "weight", "scale": "weight", "mean": "running_mean",
               "var": "running_var"}


def load_flax_layer(module: torch.nn.Module, variables: Mapping) -> torch.nn.Module:
    """Load a zoo layer's flax variables ({'params': ..., 'batch_stats':
    ...}, numpy leaves) into `module` in place; returns the module."""
    targets = module.state_dict()
    out = {}
    for collection in ("params", "batch_stats"):
        for path, value in _flatten(variables.get(collection, {})).items():
            *mods, leaf = ["conv" if m == "Conv_0" else m for m in path]
            key = ".".join(mods + [_LAYER_LEAF.get(leaf, leaf)])
            if key not in targets:
                raise KeyError(f"flax leaf {'/'.join(path)} -> {key}: no such port parameter")
            # kernels HWIO / WIO / [in, out] -> OIHW / OIW / [out, in]
            n = value.ndim
            w = value.transpose(n - 1, n - 2, *range(n - 2)) if leaf == "kernel" else value
            if tuple(w.shape) != tuple(targets[key].shape):
                raise ValueError(f"{'/'.join(path)} {value.shape} -> {key}: got {w.shape}, "
                                 f"want {tuple(targets[key].shape)}")
            out[key] = torch.tensor(np.ascontiguousarray(w), dtype=targets[key].dtype)
    module.load_state_dict(out, strict=True)
    return module
