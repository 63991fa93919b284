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

Every flax leaf must land on one port parameter and every port parameter
must receive one leaf, with matching shapes; anything else raises.
"""

import re
from typing import Dict, Mapping

import numpy as np
import torch

# (pattern, replacement) on the '/'-joined flax path; the first match wins
_RULES = [
    (r"^backbone/AffineChannel_0/", "backbone/bn1/"),
    (r"^(backbone/layer\d+)_(\d+)/AffineChannel_3/", r"\1/\2/downsample/1/"),
    (r"^(backbone/layer\d+)_(\d+)/AffineChannel_([0-2])/",
     lambda m: f"{m[1]}/{m[2]}/bn{int(m[3]) + 1}/"),
    (r"^(backbone/layer\d+)_(\d+)/downsample_conv/", r"\1/\2/downsample/0/"),
    (r"^(backbone/layer\d+)_(\d+)/", r"\1/\2/"),
    (r"^fpn/fpn_(in|out)_(\d+)/", r"fpn/fpn_\1/\2/"),
    (r"^roi_head/grid_head_(\d+)/conv(\d+)/", r"roi_head/grid_heads/\1/convs/\2/"),
    (r"^roi_head/grid_head_(\d+)/gn(\d+)/", r"roi_head/grid_heads/\1/gns/\2/"),
    (r"^roi_head/grid_head_(\d+)/([fs]order)_(\d+)_(\d+)/",
     r"roi_head/grid_heads/\1/\2/\3_\4/"),
    (r"^roi_head/grid_output_(\d+)/(deconv\d)_(kernel|bias)$",
     r"roi_head/grid_outputs/\1/\2/\3"),
    (r"^roi_head/grid_output_(\d+)/", r"roi_head/grid_outputs/\1/"),
]
_LEAF = {"kernel": "weight", "weight": "weight", "scale": "weight", "bias": "bias"}


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = np.asarray(v)
    return out


def torch_key(flax_path) -> str:
    """The state_dict key of one flax leaf path (tuple of names)."""
    path = "/".join(flax_path)
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
    for path in _flatten(tree):
        key = torch_key(path)
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
