"""RoIAlign in plain PyTorch: the plain versions of the port's CUDA kernels.

Port of cpm_tpu/ops/roi_align.py (`roi_align`, `multilevel_roi_align`):
sample-point gathers plus bilinear weights, with the reference CUDA
kernel's boundary rules (a sample with y < -1 or y > H, or x likewise,
reads zero; otherwise its coordinate is clamped into [0, H-1]) and the
JAX package's static 2 samples per bin for `sampling_ratio == 0`.

Every formulation below computes the same samples from the same
coordinates (`_roi_samples`) and differs in where it reads the cells from,
as the kernels do:

* `multilevel_roi_align`: each roi gathers from its own level map (the
  kernels of cpm_tpu_torch/ops/cuda/multilevel_roi_align.py);
* `roi_align`: its one-level case (cpm_tpu_torch/ops/cuda/roi_align.py);
* `multilevel_roi_align_stacked_plain`: all levels are first stacked into
  one buffer (`stack_levels`, `stack_geometry`; port of
  cpm_tpu/ops/pallas/stacked_pallas.py::_stack_levels/_stack_geometry
  without the TPU window's tail rows and pad to 8 columns; on the card the
  same buffer is made by `stack_levels_in_one_pass`), and each roi gathers
  through its level's row offset (cpm_tpu_torch/ops/cuda/stacked_roi_align.py);
* `multilevel_roi_align_clustered_plain`: rois are grouped by `cluster_rois`
  (port of cpm_tpu/ops/pallas/clustered_pallas.py::_cluster), each group's
  shared rectangle of cells is copied once into a tile, and the group's rois
  pool from that tile (cpm_tpu_torch/ops/cuda/clustered_roi_align.py);
* `crossroi_roi_align_plain`: the rois of one group all pool from the window
  of one roi (`crossroi_prep_rois`; port of what
  tools/probe_pooler_crossroi.py::make_probe computes;
  cpm_tpu_torch/ops/cuda/crossroi_roi_align.py).

The CPU paths run them, and each kernel is held against its plain version on
the card. Layouts are the JAX package's: features are NHWC `[B, H, W, C]`,
outputs `[R, ph, pw, C]`.
"""

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

# The clustered formulation's own sizes (the TPU kernel's 64-cell window,
# 16-cell lattice and group of 8 followed from its memory; these follow from
# the card's shared memory, see csrc/clustered_roi_align.cu). Rois whose
# supports begin in the same LATTICE_Q x LATTICE_Q block of cells share a
# group if they fit a TILE x TILE rectangle placed at the block's origin: a
# support of up to TILE - LATTICE_Q + 1 = 17 cells always does, which covers
# the level mapper's 7 to 14 cell extents plus the bilinear neighbour.
TILE = 24
LATTICE_Q = 8


def group_cap(output_size) -> int:
    """Most rois in one group: 8 at 7x7 and 4 at 14x14, so that a group
    holds at most 784 output bins."""
    ph, pw = output_size
    return max(1, min(8, 784 // (ph * pw)))


def _bilinear_weights_1d(coord: torch.Tensor, size: torch.Tensor):
    """Source cells and weights of sample positions `coord` on an axis of
    length `size` (broadcastable against coord)."""
    oob = (coord < -1.0) | (coord > size)
    c = torch.minimum(torch.clamp(coord, min=0.0), size - 1.0)
    lo = torch.floor(c)
    hi = torch.minimum(lo + 1.0, size - 1.0)
    w_hi = c - lo
    w_lo = 1.0 - w_hi
    return lo.long(), hi.long(), w_lo, w_hi, oob


class _Axis(NamedTuple):
    """One axis of every roi's samples, `[R, bins * sr]` each: the two
    source cells, their weights, and whether the sample reads zero."""
    lo: torch.Tensor
    hi: torch.Tensor
    w_lo: torch.Tensor
    w_hi: torch.Tensor
    oob: torch.Tensor


def _roi_coords(rois, scale, output_size, sr, aligned):
    """The sample coordinates of rois `[R, 5]` on maps of per-roi scale
    (`[R]`): (ys `[R, ph*sr]`, xs `[R, pw*sr]`) in cells."""
    ph, pw = output_size
    dev = rois.device
    offset = 0.5 if aligned else 0.0
    # coordinates always in f32: bf16 would quantize image-scale coordinates
    rois = rois.float()
    x1 = rois[:, 1] * scale - offset
    y1 = rois[:, 2] * scale - offset
    x2 = rois[:, 3] * scale - offset
    y2 = rois[:, 4] * scale - offset
    roi_w = x2 - x1
    roi_h = y2 - y1
    if not aligned:
        roi_w = torch.clamp(roi_w, min=1.0)
        roi_h = torch.clamp(roi_h, min=1.0)
    # divide by tensors: CUDA turns a division by a Python number into a
    # multiplication by its reciprocal, which rounds differently from the
    # true division that the JAX package and the CUDA kernels take
    bin_w = roi_w / torch.full_like(roi_w, pw)
    bin_h = roi_h / torch.full_like(roi_h, ph)

    ix = torch.arange(pw * sr, dtype=torch.float32, device=dev) + 0.5
    iy = torch.arange(ph * sr, dtype=torch.float32, device=dev) + 0.5
    ix = ix / torch.full_like(ix, sr)
    iy = iy / torch.full_like(iy, sr)
    xs = x1[:, None] + ix[None, :] * bin_w[:, None]  # [R, pw*sr]
    ys = y1[:, None] + iy[None, :] * bin_h[:, None]  # [R, ph*sr]
    return ys, xs


def _roi_samples(rois, scale, h_l, w_l, output_size, sr, aligned):
    """The samples of rois `[R, 5]` on maps of per-roi scale, height and
    width (`[R]` float tensors): (y axis, x axis)."""
    ys, xs = _roi_coords(rois, scale, output_size, sr, aligned)
    return (_Axis(*_bilinear_weights_1d(ys, h_l[:, None])),
            _Axis(*_bilinear_weights_1d(xs, w_l[:, None])))


def _reach_1d(first, last, size):
    """`footprint` of csrc/roi_align_tiles.cuh along one axis: the cells
    [lo, hi] that samples between coordinates `first` and `last` can read
    after the out-of-bounds rule and the clamp, and whether any can; a
    coordinate that is not finite reaches the whole axis."""
    finite = torch.isfinite(first) & torch.isfinite(last)
    least, most = torch.minimum(first, last), torch.maximum(first, last)
    top = size - 1.0
    lo = torch.floor(torch.minimum(torch.clamp(least, min=0.0), top))
    hi = torch.minimum(torch.floor(torch.minimum(torch.clamp(most, min=0.0), top)) + 1.0, top)
    reaches = (most >= -1.0) & (least <= size)
    lo = torch.where(finite, lo, torch.zeros_like(lo))
    hi = torch.where(finite, hi, top.expand_as(hi))
    return lo.long(), hi.long(), reaches | ~finite


def roi_tile_reach(rois, levels, level_hw, spatial_scales, output_size, sampling_ratio: int = 0,
                   aligned: bool = False):
    """The plain version of the rule by which the tile-owned RoIAlign
    backward kernels (multilevel and stacked, csrc/roi_align_tiles.cuh) let a
    roi into a tile: the cells of its level that its first and last sample
    coordinates along each axis can reach. Returns (row_lo, row_hi, col_lo,
    col_hi) long `[R]` (inclusive) and `reaches` bool `[R]`, false where
    every sample of the roi reads zero; a tile of the roi's level and image
    that meets the rectangle takes the roi, every other tile skips it."""
    sr = sampling_ratio if sampling_ratio > 0 else 2
    lv = _level_columns([tuple(hw) for hw in level_hw], 1, levels, spatial_scales, rois.device)
    ys, xs = _roi_coords(rois, lv.scale, output_size, sr, aligned)
    row_lo, row_hi, y_in = _reach_1d(ys[:, 0], ys[:, -1], lv.height.float())
    col_lo, col_hi, x_in = _reach_1d(xs[:, 0], xs[:, -1], lv.width.float())
    return row_lo, row_hi, col_lo, col_hi, y_in & x_in


def _pool_samples(gather, ys: _Axis, xs: _Axis, output_size, sr, fd):
    """Bilinear interpolation and bin mean. gather(yi [R, Sy], xi [R, Sx])
    returns the cells' values `[R, Sy, Sx, C]` of dtype fd."""
    ph, pw = output_size
    wyl = ys.w_lo.to(fd)[:, :, None, None]
    wyh = ys.w_hi.to(fd)[:, :, None, None]
    wxl = xs.w_lo.to(fd)[:, None, :, None]
    wxh = xs.w_hi.to(fd)[:, None, :, None]
    vals = (
        gather(ys.lo, xs.lo) * wyl * wxl
        + gather(ys.lo, xs.hi) * wyl * wxh
        + gather(ys.hi, xs.lo) * wyh * wxl
        + gather(ys.hi, xs.hi) * wyh * wxh
    )
    oob = ys.oob[:, :, None] | xs.oob[:, None, :]
    vals = torch.where(oob[..., None], torch.zeros((), dtype=fd, device=vals.device), vals)
    r, c = vals.shape[0], vals.shape[-1]
    return vals.reshape(r, ph, sr, pw, sr, c).mean(dim=(2, 4))


class _Levels(NamedTuple):
    """Per-roi columns of the level table (`[R]` each) and, for the flat
    `[sum(B*H_l*W_l), C]` buffer of all maps, each roi's first row."""
    height: torch.Tensor      # long
    width: torch.Tensor       # long
    scale: torch.Tensor       # float32
    flat_offset: torch.Tensor  # long: start of the roi's level in the flat buffer


def _level_columns(level_hw, batch, levels, spatial_scales, dev) -> _Levels:
    if len(level_hw) != len(spatial_scales):
        raise ValueError(
            f"{len(level_hw)} feature levels but {len(spatial_scales)} scales"
        )
    offs, total = [], 0
    for h, w in level_hw:
        offs.append(total)
        total += batch * h * w
    lvl = levels.long()
    return _Levels(
        torch.tensor([h for h, _ in level_hw], dtype=torch.long, device=dev)[lvl],
        torch.tensor([w for _, w in level_hw], dtype=torch.long, device=dev)[lvl],
        torch.tensor(list(spatial_scales), dtype=torch.float32, device=dev)[lvl],
        torch.tensor(offs, dtype=torch.long, device=dev)[lvl],
    )


def _hw(features):
    return [(int(f.shape[1]), int(f.shape[2])) for f in features]


def _flatten(features):
    c = features[0].shape[-1]
    return torch.cat([f.reshape(-1, c) for f in features])


def multilevel_roi_align(
    features: Sequence[torch.Tensor],
    rois: torch.Tensor,
    levels: torch.Tensor,
    output_size,
    spatial_scales: Sequence[float],
    sampling_ratio: int = 0,
    aligned: bool = False,
) -> torch.Tensor:
    """RoIAlign over FPN levels, each roi gathering from its own level.

    Args:
      features: list of `[B, H_l, W_l, C]` maps, finest first.
      rois: `[R, 5]` (batch_index, x1, y1, x2, y2) in image coordinates.
      levels: `[R]` integer level ids in `[0, L)`.
      output_size: (ph, pw).
      spatial_scales: per-level 1/stride.

    Returns: `[R, ph, pw, C]` in the feature dtype.
    """
    sr = sampling_ratio if sampling_ratio > 0 else 2
    b, c = features[0].shape[0], features[0].shape[-1]
    r = rois.shape[0]
    lv = _level_columns(_hw(features), b, levels, spatial_scales, rois.device)
    flat = _flatten(features)
    ys, xs = _roi_samples(rois, lv.scale, lv.height.float(), lv.width.float(),
                          output_size, sr, aligned)
    # flat index of (b, y, x) at the roi's level: off + (b*H_l + y)*W_l + x
    base = lv.flat_offset + rois[:, 0].long() * lv.height * lv.width

    def gather(yi, xi):
        idx = base[:, None, None] + yi[:, :, None] * lv.width[:, None, None] + xi[:, None, :]
        return flat[idx.reshape(-1)].reshape(r, yi.shape[1], xi.shape[1], c)

    return _pool_samples(gather, ys, xs, output_size, sr, flat.dtype)


def roi_align(
    features: torch.Tensor,
    rois: torch.Tensor,
    output_size,
    spatial_scale: float,
    sampling_ratio: int = 0,
    aligned: bool = False,
) -> torch.Tensor:
    """RoIAlign over one `[B, H, W, C]` map: the one-level case of
    `multilevel_roi_align`, which computes the same samples."""
    levels = torch.zeros(rois.shape[0], dtype=torch.long, device=rois.device)
    return multilevel_roi_align(
        [features], rois, levels, output_size, (spatial_scale,),
        sampling_ratio, aligned,
    )


# --- the stacked formulation -------------------------------------------------


def stack_geometry(level_hw):
    """(row offset of each level, total rows, common width) of the one
    buffer that holds all levels one below the other."""
    offs, rows = [], 0
    for h, _ in level_hw:
        offs.append(rows)
        rows += h
    return tuple(offs), rows, max(w for _, w in level_hw)


def stack_levels(features: Sequence[torch.Tensor]) -> torch.Tensor:
    """`[B, H_l, W_l, C]` maps -> one contiguous `[B, sum(H_l), max(W_l), C]`
    buffer, each level's rows zero-padded on the right."""
    wmax = max(int(f.shape[2]) for f in features)
    parts = [F.pad(f, (0, 0, 0, wmax - int(f.shape[2]))) for f in features]
    return torch.cat(parts, dim=1).contiguous()


def stack_levels_in_one_pass(features: Sequence[torch.Tensor]) -> torch.Tensor:
    """`stack_levels` in one pass over the bytes: the buffer is allocated
    empty, each level is copied into its rows and only the padding columns
    of those rows are zeroed, so every level is read once and every byte of
    the buffer written once (the pad and the cat write the padded levels and
    then the buffer). Not differentiated: the stacked backward kernel
    returns the levels' gradients itself."""
    level_hw = _hw(features)
    offs, rows, wmax = stack_geometry(level_hw)
    f0 = features[0]
    stack = torch.empty((f0.shape[0], rows, wmax, f0.shape[3]), dtype=f0.dtype,
                        device=f0.device)
    with torch.no_grad():
        for f, off, (h, w) in zip(features, offs, level_hw):
            stack[:, off:off + h, :w].copy_(f)
            stack[:, off:off + h, w:].zero_()
    return stack


def unstack_levels(stack: torch.Tensor, level_hw):
    """The per-level `[B, H_l, W_l, C]` slices of a stacked buffer."""
    offs, _, _ = stack_geometry(level_hw)
    return [stack[:, off:off + h, :w, :] for off, (h, w) in zip(offs, level_hw)]


def roi_align_from_stack(
    stack: torch.Tensor,
    level_hw,
    rois: torch.Tensor,
    levels: torch.Tensor,
    output_size,
    spatial_scales: Sequence[float],
    sampling_ratio: int = 0,
    aligned: bool = False,
) -> torch.Tensor:
    """Multilevel RoIAlign reading every level out of one stacked buffer
    `[B, total rows, common width, C]`: row `row_offset[level] + y` of the
    roi's image, clamped to the level's own height and width, so that no
    sample reads a neighbour level's rows or the padding."""
    sr = sampling_ratio if sampling_ratio > 0 else 2
    offs, total_rows, wmax = stack_geometry(level_hw)
    if tuple(stack.shape[1:3]) != (total_rows, wmax):
        raise ValueError(f"stack {tuple(stack.shape)} does not hold levels {list(level_hw)}")
    b, c = stack.shape[0], stack.shape[-1]
    r = rois.shape[0]
    lv = _level_columns(level_hw, b, levels, spatial_scales, rois.device)
    ys, xs = _roi_samples(rois, lv.scale, lv.height.float(), lv.width.float(),
                          output_size, sr, aligned)
    flat = stack.reshape(b * total_rows * wmax, c)
    row0 = torch.tensor(offs, dtype=torch.long, device=rois.device)[levels.long()]
    base = rois[:, 0].long() * total_rows + row0

    def gather(yi, xi):
        idx = (base[:, None, None] + yi[:, :, None]) * wmax + xi[:, None, :]
        return flat[idx.reshape(-1)].reshape(r, yi.shape[1], xi.shape[1], c)

    return _pool_samples(gather, ys, xs, output_size, sr, flat.dtype)


def multilevel_roi_align_stacked_plain(
    features: Sequence[torch.Tensor],
    rois: torch.Tensor,
    levels: torch.Tensor,
    output_size,
    spatial_scales: Sequence[float],
    sampling_ratio: int = 0,
    aligned: bool = False,
) -> torch.Tensor:
    """The stacked formulation of `multilevel_roi_align`: stack the maps,
    then gather from the one buffer. Autograd through the stack's pad and
    cat slices the buffer's gradient back per level."""
    return roi_align_from_stack(
        stack_levels(features), _hw(features), rois, levels, output_size,
        spatial_scales, sampling_ratio, aligned,
    )


# --- the clustered formulation -----------------------------------------------


class Grouping(NamedTuple):
    """What `cluster_rois` returns; R is the number of rois.

    order: `[R]` int32, sorted slot -> roi: a group's members are
      neighbours in it, masked rois come last.
    groups: `[R, 8]` int32, row g = (first slot, size, level, batch image,
      y0, x0, rows, cols) of group g: its members are
      `order[first : first + size]` and `[y0, y0+rows) x [x0, x0+cols)` is
      the union of their supports on the level. Rows beyond the last group
      are zeros.
    slot_group: `[R]` long, sorted slot -> its group (undefined for the
      masked slots).
    n_groups: 0-d long tensor.
    """
    order: torch.Tensor
    groups: torch.Tensor
    slot_group: torch.Tensor
    n_groups: torch.Tensor


def _support(axis: _Axis):
    """First cell and number of cells that an axis of samples reads:
    (origin [R], extent [R]), both long; (0, 0) where every sample is out
    of bounds."""
    far = torch.iinfo(torch.int64).max
    first = torch.where(axis.oob, far, axis.lo).amin(dim=1)
    last = torch.where(axis.oob, -1, axis.hi).amax(dim=1)
    extent = torch.clamp(last - first + 1, min=0)
    return torch.where(extent > 0, first, 0), extent


class _GroupKeys(NamedTuple):
    """What the grouping computes for each roi before it sorts (`[R]` long
    each): its sort key, its support's origin and extent on its level along
    each axis, its batch image and its level id; and the size of the key
    space of the grouped rois."""
    key: torch.Tensor
    y0: torch.Tensor
    need_r: torch.Tensor
    x0: torch.Tensor
    need_c: torch.Tensor
    image: torch.Tensor
    level: torch.Tensor
    shared_keys: int


def _group_keys(rois, levels, valid, level_hw, batch, output_size, spatial_scales, sr,
                aligned) -> _GroupKeys:
    """Rois of one image and level whose supports (the cells their bilinear
    samples read) begin in the same LATTICE_Q x LATTICE_Q lattice block, and
    fit the TILE x TILE rectangle placed at that block's origin, get that
    block's key, below `shared_keys`; every other valid roi i gets
    `shared_keys + i`, a key of its own, and masked roi i `shared_keys + R +
    i`."""
    tile, pitch = TILE, LATTICE_Q
    dev = rois.device
    n = rois.shape[0]
    lv = _level_columns(level_hw, batch, levels, spatial_scales, dev)
    ys, xs = _roi_samples(rois, lv.scale, lv.height.float(), lv.width.float(),
                          output_size, sr, aligned)
    y0, need_r = _support(ys)
    x0, need_c = _support(xs)
    image = torch.clamp(rois[:, 0].long(), 0, batch - 1)
    lvl = levels.long()
    valid = valid.bool()

    cy, cx = y0 // pitch, x0 // pitch
    fits = ((y0 - cy * pitch + need_r <= tile) & (x0 - cx * pitch + need_c <= tile)
            & (need_r > 0) & (need_c > 0))
    eligible = fits & valid
    ny = max(h for h, _ in level_hw) // pitch + 1
    nx = max(w for _, w in level_hw) // pitch + 1
    cell = ((image * len(level_hw) + lvl) * ny + cy) * nx + cx
    arange = torch.arange(n, dtype=torch.long, device=dev)
    beyond = batch * len(level_hw) * ny * nx
    key = torch.where(eligible, cell, beyond + arange)
    key = torch.where(valid, key, beyond + n + arange)
    return _GroupKeys(key, y0, need_r, x0, need_c, image, lvl, beyond)


def _group_rows(keys: _GroupKeys, order, new_group, slot_group, valid_s):
    """The `Grouping` of rois sorted into `order`, where `new_group` marks
    the slots that open a group and `slot_group` holds each slot's group."""
    n = order.shape[0]
    dev = order.device
    arange = torch.arange(n, dtype=torch.long, device=dev)
    # one spare row takes what belongs to no group
    member_of = torch.where(valid_s, slot_group, n)
    leader_of = torch.where(new_group, slot_group, n)
    y0_s, x0_s = keys.y0[order], keys.x0[order]
    far = torch.iinfo(torch.int64).max

    def reduce(values, how, start):
        out = torch.full((n + 1,), start, dtype=torch.long, device=dev)
        return out.scatter_reduce(0, member_of, values, how, include_self=True)

    top, left = reduce(y0_s, "amin", far), reduce(x0_s, "amin", far)
    bottom = reduce(y0_s + keys.need_r[order], "amax", -1)
    right = reduce(x0_s + keys.need_c[order], "amax", -1)
    size = reduce(valid_s.long(), "sum", 0)
    groups = torch.zeros((n + 1, 8), dtype=torch.long, device=dev)
    groups[leader_of, 0] = arange
    groups[leader_of, 2] = keys.level[order]
    groups[leader_of, 3] = keys.image[order]
    groups[:, 1] = size
    groups[:, 4], groups[:, 5] = top, left
    groups[:, 6], groups[:, 7] = bottom - top, right - left
    groups = torch.where(size[:, None] > 0, groups, 0)[:n]
    return Grouping(order.int(), groups.int(), slot_group, new_group.sum())


def cluster_rois(
    rois: torch.Tensor,
    levels: torch.Tensor,
    valid: torch.Tensor,
    level_hw,
    batch: int,
    output_size,
    spatial_scales: Sequence[float],
    sampling_ratio: int = 0,
    aligned: bool = False,
    group: int = None,
) -> Grouping:
    """Group rois that can share one rectangle of cells.

    Rois of one image and level whose supports (the cells their bilinear
    samples read) begin in the same LATTICE_Q x LATTICE_Q lattice block, and
    fit the TILE x TILE rectangle placed at that block's origin, get the
    same key; every other valid roi gets a key of its own (a singleton
    group, whatever its size), and masked rois join no group. A stable sort
    by key makes the members of a group neighbours; runs of one key are cut
    into groups of at most `group` rois. Fixed shapes and torch ops only:
    nothing is read on the host.
    """
    sr = sampling_ratio if sampling_ratio > 0 else 2
    group = group_cap(output_size) if group is None else int(group)
    dev = rois.device
    n = rois.shape[0]
    keys = _group_keys(rois, levels, valid, level_hw, batch, output_size, spatial_scales, sr,
                       aligned)
    arange = torch.arange(n, dtype=torch.long, device=dev)

    order = torch.argsort(keys.key, stable=True)
    key_s, valid_s = keys.key[order], valid.bool()[order]
    boundary = torch.ones(n, dtype=torch.bool, device=dev)
    boundary[1:] = key_s[1:] != key_s[:-1]
    run_start = torch.cummax(torch.where(boundary, arange, 0), dim=0).values
    # groups open only at valid slots; the masked tail joins none
    new_group = (boundary | ((arange - run_start) % group == 0)) & valid_s
    slot_group = torch.cumsum(new_group.long(), dim=0) - 1
    return _group_rows(keys, order, new_group, slot_group, valid_s)


def counting_sort_groups(
    rois: torch.Tensor,
    levels: torch.Tensor,
    valid: torch.Tensor,
    level_hw,
    batch: int,
    output_size,
    spatial_scales: Sequence[float],
    sampling_ratio: int = 0,
    aligned: bool = False,
    group: int = None,
) -> Grouping:
    """`cluster_rois` as the grouping kernel (csrc/clustered_roi_align.cu::
    cluster_rois_kernel) computes it, without a sort: the plain statement of
    its rule, which gives `cluster_rois`' integers.

    The grouped rois (a shared key, below `shared_keys`) are counted per key;
    the exclusive scan of the counts gives each key's first slot, and that of
    ceil(count / group) its first group. A grouped roi's rank is the number
    of rois of its key with a smaller index (stable); its slot is its key's
    first slot plus its rank, its group its key's first group plus rank //
    group. The other valid rois follow in index order, one group each, and
    the masked rois last, in no group (their slot group is the last group).
    """
    sr = sampling_ratio if sampling_ratio > 0 else 2
    group = group_cap(output_size) if group is None else int(group)
    dev = rois.device
    n = rois.shape[0]
    keys = _group_keys(rois, levels, valid, level_hw, batch, output_size, spatial_scales, sr,
                       aligned)
    valid = valid.bool()
    grouped = keys.key < keys.shared_keys
    loner = valid & ~grouped
    cell = torch.where(grouped, keys.key, 0)
    count = torch.bincount(cell[grouped], minlength=keys.shared_keys)
    first_slot = torch.cumsum(count, 0) - count
    first_group = torch.cumsum((count + group - 1) // group, 0) - (count + group - 1) // group
    n_grouped, shared_groups = int(count.sum()), int(((count + group - 1) // group).sum())
    index = torch.arange(n, dtype=torch.long, device=dev)
    same_before = (cell[:, None] == cell[None, :]) & grouped[None, :] & (index[None, :] < index[:, None])
    rank = same_before.sum(1)
    loner_rank = torch.cumsum(loner.long(), 0) - loner.long()
    masked_rank = torch.cumsum((~valid).long(), 0) - (~valid).long()
    slot = torch.where(grouped, first_slot[cell] + rank,
                       torch.where(loner, n_grouped + loner_rank,
                                   n_grouped + int(loner.sum()) + masked_rank))
    n_groups = shared_groups + int(loner.sum())
    roi_group = torch.where(grouped, first_group[cell] + rank // group,
                            torch.where(loner, shared_groups + loner_rank, n_groups - 1))
    opens = (grouped & (rank % group == 0)) | loner
    order = torch.empty(n, dtype=torch.long, device=dev)
    order[slot] = index
    slot_group = torch.empty(n, dtype=torch.long, device=dev)
    slot_group[slot] = roi_group
    new_group = torch.zeros(n, dtype=torch.bool, device=dev)
    new_group[slot] = opens
    return _group_rows(keys, order, new_group, slot_group, valid[order])


def multilevel_roi_align_clustered_plain(
    features: Sequence[torch.Tensor],
    rois: torch.Tensor,
    levels: torch.Tensor,
    valid: torch.Tensor,
    output_size,
    spatial_scales: Sequence[float],
    sampling_ratio: int = 0,
    aligned: bool = False,
    grouping: Grouping = None,
) -> torch.Tensor:
    """The clustered formulation of `multilevel_roi_align`: the rois are
    grouped (`cluster_rois`, or the given `grouping`), each group's rectangle
    of cells is copied once from its level into a TILE x TILE tile, and
    every roi reads the cells of its samples from its group's tile. A cell
    outside the rectangle, or any cell of a group whose rectangle exceeds the
    tile (a singleton), is read from the level itself. Rows of masked rois
    are zeros."""
    sr = sampling_ratio if sampling_ratio > 0 else 2
    b, c = features[0].shape[0], features[0].shape[-1]
    n = rois.shape[0]
    dev = rois.device
    level_hw = _hw(features)
    if grouping is None:
        grouping = cluster_rois(rois, levels, valid, level_hw, b, output_size,
                                spatial_scales, sr, aligned)
    tile = TILE
    lv = _level_columns(level_hw, b, levels, spatial_scales, dev)
    flat = _flatten(features)
    ys, xs = _roi_samples(rois, lv.scale, lv.height.float(), lv.width.float(),
                          output_size, sr, aligned)
    base = lv.flat_offset + torch.clamp(rois[:, 0].long(), 0, b - 1) * lv.height * lv.width

    # the tiles: cell (i, j) of group g's tile is cell (y0 + i, x0 + j) of
    # its level, clamped into the map where the tile overhangs it
    g = grouping.groups.long()
    g_lv = _level_columns(level_hw, b, g[:, 2], spatial_scales, dev)
    g_base = g_lv.flat_offset + g[:, 3] * g_lv.height * g_lv.width
    step = torch.arange(tile, dtype=torch.long, device=dev)
    ty = torch.minimum(g[:, 4, None] + step, g_lv.height[:, None] - 1)  # [R, tile]
    tx = torch.minimum(g[:, 5, None] + step, g_lv.width[:, None] - 1)
    tile_idx = g_base[:, None, None] + ty[:, :, None] * g_lv.width[:, None, None] + tx[:, None, :]
    tiles = flat[tile_idx.reshape(-1)]                   # [R * tile * tile, C]
    cells = torch.cat([flat, tiles])

    # each roi's group, in roi order (masked rois: any group; zeroed below)
    roi_group = torch.zeros(n, dtype=torch.long, device=dev)
    roi_group[grouping.order.long()] = torch.clamp(grouping.slot_group, min=0)
    mine = g[roi_group]                                  # [R, 8]
    y0, x0, rows, cols = (mine[:, k, None, None] for k in (4, 5, 6, 7))
    use_tile = (rows <= tile) & (cols <= tile)
    tile_base = flat.shape[0] + roi_group[:, None, None] * (tile * tile)

    def gather(yi, xi):
        yy, xx = yi[:, :, None], xi[:, None, :]
        inside = use_tile & (yy >= y0) & (yy < y0 + rows) & (xx >= x0) & (xx < x0 + cols)
        in_tile = tile_base + (yy - y0) * tile + (xx - x0)
        in_level = base[:, None, None] + yy * lv.width[:, None, None] + xx
        idx = torch.where(inside, in_tile, in_level)
        return cells[idx.reshape(-1)].reshape(n, yi.shape[1], xi.shape[1], c)

    out = _pool_samples(gather, ys, xs, output_size, sr, flat.dtype)
    return torch.where(valid.bool()[:, None, None, None], out, torch.zeros((), dtype=out.dtype, device=dev))


# --- the cross-roi shared-window formulation ----------------------------------

# The window, in cells, that the rois of one group share (the TPU pooler's WIN).
CROSSROI_WINDOW = 64


class WindowedRois(NamedTuple):
    """What `crossroi_prep_rois` returns, per roi: the batch image, the window
    origin (int32 `[R]` each) and the sample positions relative to that origin
    (float32 `[R, ph*sr]` rows, `[R, pw*sr]` columns; -2 where the sample is
    out of bounds and reads zero)."""
    batch: torch.Tensor
    y0: torch.Tensor
    x0: torch.Tensor
    ys: torch.Tensor
    xs: torch.Tensor


def crossroi_prep_rois(rois, spatial_scale: float, map_hw, output_size,
                       sampling_ratio: int = 2) -> WindowedRois:
    """Each roi's window origin and its sample positions relative to it, on
    one `[B, H, W, C]` map: the one-level, not-aligned case of
    cpm_tpu/ops/pallas/multilevel_pallas.py::_prep_rois. The origin lies one
    cell before the roi's first sample, clamped so that the window stays
    inside the map, its column rounded down to a multiple of 8 (the TPU's DMA
    alignment, kept because it decides which cells a group shares)."""
    ph, pw = output_size
    sr = sampling_ratio
    window = CROSSROI_WINDOW
    h, w = (int(d) for d in map_hw)
    if h < window or w < window:
        raise ValueError(f"the map {h}x{w} must hold a {window}x{window} window")
    dev = rois.device
    r = rois.float()
    scale = torch.full_like(r[:, 0], spatial_scale)
    x1, y1, x2, y2 = (r[:, k] * scale for k in (1, 2, 3, 4))
    roi_w = torch.clamp(x2 - x1, min=1.0)
    roi_h = torch.clamp(y2 - y1, min=1.0)
    # divisions by tensors, as in `_roi_samples`
    bin_w = roi_w / torch.full_like(roi_w, pw)
    bin_h = roi_h / torch.full_like(roi_h, ph)
    ix = torch.arange(pw * sr, dtype=torch.float32, device=dev) + 0.5
    iy = torch.arange(ph * sr, dtype=torch.float32, device=dev) + 0.5
    ix = ix / torch.full_like(ix, sr)
    iy = iy / torch.full_like(iy, sr)
    xs = x1[:, None] + ix[None, :] * bin_w[:, None]
    ys = y1[:, None] + iy[None, :] * bin_h[:, None]
    oob_x = (xs < -1.0) | (xs > w)
    oob_y = (ys < -1.0) | (ys > h)
    xs_c = torch.clamp(xs, 0.0, w - 1.0)
    ys_c = torch.clamp(ys, 0.0, h - 1.0)
    x0 = torch.clamp(torch.floor(xs_c.amin(dim=1)) - 1.0, 0.0, float(w - window)).int()
    x0 = (x0 // 8) * 8
    y0 = torch.clamp(torch.floor(ys_c.amin(dim=1)) - 1.0, 0.0, float(h - window)).int()
    xs_rel = torch.where(oob_x, -2.0, xs_c - x0.float()[:, None])
    ys_rel = torch.where(oob_y, -2.0, ys_c - y0.float()[:, None])
    return WindowedRois(rois[:, 0].int(), y0, x0, ys_rel, xs_rel)


def _hat_axis(pos: torch.Tensor):
    """The two window cells that a relative position weighs, floor(pos) and
    the next, with the hat weight relu(1 - |pos - cell|) of each; a cell
    outside the window weighs zero. Returns (cells long, clamped into the
    window; weights), `[..., 2]` each."""
    window = CROSSROI_WINDOW
    cells = torch.floor(pos)[..., None] + torch.arange(2, dtype=pos.dtype, device=pos.device)
    inside = (cells >= 0) & (cells <= window - 1)
    weights = F.relu(1.0 - torch.abs(pos[..., None] - cells)) * inside
    return torch.clamp(cells, 0, window - 1).long(), weights


def crossroi_roi_align_plain(features: torch.Tensor, prep: WindowedRois, group: int, output_size,
                             sampling_ratio: int = 2) -> torch.Tensor:
    """Single-level RoIAlign in which `group` rois share one window: what
    tools/probe_pooler_crossroi.py::make_probe computes.

    Step i pools rois `i*group ... i*group + group - 1`, each at its own
    positions relative to its own origin, from the window of roi i:
    `features[batch[i], y0[i] : y0[i] + window, x0[i] : x0[i] + window]`. A
    position weighs the window cells by `relu(1 - |position - cell|)`; cells
    outside the window weigh zero. At `group == 1` this is the windowed
    RoIAlign; at `group > 1` the numbers are those of samples shifted to
    another roi's window, as the probe's are: it measures a bound, and this
    states the same rule. Returns `[R, ph, pw, C]` in the features' dtype;
    R must be a multiple of `group`."""
    ph, pw = output_size
    sr = sampling_ratio
    window = CROSSROI_WINDOW
    n = prep.batch.shape[0]
    if n % group:
        raise ValueError(f"{n} rois do not fill groups of {group}")
    b, h, w, c = features.shape
    if h < window or w < window:
        raise ValueError(f"the map {h}x{w} must hold a {window}x{window} window")
    step = torch.arange(n, device=features.device) // group
    image, y0, x0 = prep.batch.long()[step], prep.y0.long()[step], prep.x0.long()[step]
    yi, wy = _hat_axis(prep.ys.float())    # [R, Sy, 2]
    xi, wx = _hat_axis(prep.xs.float())    # [R, Sx, 2]
    flat = features.reshape(b * h * w, c)
    base = image * (h * w)
    vals = None
    for i in (0, 1):
        for j in (0, 1):
            rows = (y0[:, None] + yi[..., i])[:, :, None]       # [R, Sy, 1]
            cols = (x0[:, None] + xi[..., j])[:, None, :]       # [R, 1, Sx]
            idx = base[:, None, None] + rows * w + cols
            cell = flat[idx.reshape(-1)].reshape(n, yi.shape[1], xi.shape[1], c)
            weight = wy[..., i][:, :, None] * wx[..., j][:, None, :]
            term = cell * weight.to(cell.dtype)[..., None]
            vals = term if vals is None else vals + term
    return vals.reshape(n, ph, sr, pw, sr, c).mean(dim=(2, 4))
