"""The deformable-conv sampler kernels alone on one NVIDIA GPU.

    python3 -m cpm_tpu_torch.tools.probe_dcn_sampler [--dtype bfloat16]

Port of tools/probe_dcn_pallas_sampler.py (`run_geometry`, `main`) and of the
sampler part of tools/bench_deform_conv.py, with their geometries: the inputs
of the deformable 3x3 convs of X-101-32x4d-FPN-DCN at the 832x1344 bucket,
res3 104x168x256, res4 52x84x512 and res5 26x42x1024, batch 2, K = 9 taps,
coordinates uniform in (-1.5, size + 0.5): inside, on the border and wholly
outside the map.

For each geometry it holds the forward and the backward kernel against the
plain version (`deform_sample_plain` and autograd of it) and prints their
median CUDA-event times beside the plain version's, the bound (the least time
the card could take, `sampler_bounds`) and the time of one
`F.grid_sample(mode='bilinear', padding_mode='zeros', align_corners=True)`
call on the same inputs (for the backward, that call's backward to the map
and the grid): the PyTorch call that computes the same function, timed as a
yardstick and used nowhere in the port. Every line that holds a
number ends with the card's name and power limit.

Tolerances. Forward f32 atol 1e-5 at unit-scale maps (kernel and plain version
weigh the same cells with the same weights; the kernel fuses each
multiply-add), bf16 rtol 1.6e-2 / atol 1e-2 (one bf16 rounding of an f32
sum). Backward f32 rtol 1e-4 / atol 1e-4 for the map (the kernel sums each
cell's terms in another order than the plain version) and rtol 1e-4 / atol
1e-3 for the coordinates (sums of up to 1024 products of unit-scale values in
another order); bf16 map gradients as the forward, coordinate gradients as in
f32 (both sides take them in f32 from the same bf16 values). Two backward runs
on the same inputs must give the same bits. For the backward, the library call
is one `F.grid_sample` backward to both the map and the grid, and the binning
of the samples by tile (the binning kernels, inside the backward's time) is
printed on a line of its own.
"""

import argparse
import sys

import numpy as np
import torch
import torch.nn.functional as F

from cpm_tpu_torch.tools.bench_roi_align import cuda_ms
from cpm_tpu_torch.tools.profile_eval import card_line

GEOMETRIES = (("res3 104x168xC256", 104, 168, 256), ("res4 52x84xC512", 52, 84, 512),
              ("res5 26x42xC1024", 26, 42, 1024))
BATCH, TAPS = 2, 9
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12     # f32 outside the tensor cores, same sheet
F32_ATOL = 1e-5
BF16_TOL = dict(rtol=1.6e-2, atol=1e-2)
BWD_MAP_TOL = dict(rtol=1e-4, atol=1e-4)
BWD_COORD_TOL = dict(rtol=1e-4, atol=1e-3)


def make_inputs(h, w, c, dtype, dev, seed=0, batch=BATCH, taps=TAPS):
    """(feat [B, H, W, C], ys, xs [B, H*W*taps]) as the JAX probe draws them."""
    rng = np.random.RandomState(seed)
    p = h * w * taps
    feat = torch.from_numpy(rng.randn(batch, h, w, c).astype(np.float32)).to(dev, dtype)
    ys = torch.from_numpy(rng.uniform(-1.5, h + 0.5, (batch, p)).astype(np.float32)).to(dev)
    xs = torch.from_numpy(rng.uniform(-1.5, w + 0.5, (batch, p)).astype(np.float32)).to(dev)
    return feat, ys, xs


def sampler_bounds(feat, ys, xs):
    """((forward ms, by), (backward ms, by)): the least time the card could
    take for one call on these inputs, the larger of its bytes over 3.35 TB/s
    and its f32 operations over 67 TFLOP/s. Forward bytes: every map cell that
    some sample weighs (once), the coordinates, the output. Backward bytes:
    `g`, those cells again (the coordinate gradients need them), the
    coordinates, the map's gradient and the coordinates' gradients written
    once. Operations: a multiply-add per channel of every weighed cell of
    every sample (forward), two (backward)."""
    from cpm_tpu_torch.ops.deform_conv import _tent_axis

    b, h, w, c = feat.shape
    e = feat.element_size()
    ys, xs = ys.flatten(1), xs.flatten(1)
    yi, wy = _tent_axis(ys, h)
    xi, wx = _tent_axis(xs, w)
    image = torch.arange(b, device=feat.device)[:, None] * (h * w)
    touched, weighed = [], 0
    for i in (0, 1):
        for j in (0, 1):
            live = (wy[..., i] * wx[..., j]) > 0
            weighed += int(live.sum())
            touched.append((image + yi[..., i] * w + xi[..., j])[live])
    cells = int(torch.unique(torch.cat(touched)).numel())
    n = ys.numel()
    fwd_bytes = cells * c * e + n * 8 + n * c * e
    bwd_bytes = n * c * e + cells * c * e + n * 8 + b * h * w * c * e + n * 8
    return (bound_of(fwd_bytes, weighed * c * 2), bound_of(bwd_bytes, weighed * c * 4))


def bound_of(nbytes, flops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def grid_sample_call(feat, ys, xs, g=None):
    """The one PyTorch call for the same function, and its inputs prepared:
    the map as an NCHW view and the coordinates as a normalised grid.
    Returns (call, to_samples): call() runs F.grid_sample alone, to_samples
    turns its output into `[B, P, C]`. With `g` (the coordinates' shape +
    `[C]`), call() runs instead the backward of that call to both the map
    and the grid (`torch.autograd.grad`, the forward made once beforehand)."""
    b, h, w, c = feat.shape
    ys, xs = ys.flatten(1), xs.flatten(1)
    nchw = feat.permute(0, 3, 1, 2)
    gx = xs / max(w - 1, 1) * 2.0 - 1.0
    gy = ys / max(h - 1, 1) * 2.0 - 1.0
    grid = torch.stack([gx, gy], dim=-1)[:, :, None, :].to(feat.dtype)   # [B, P, 1, 2]

    def to_samples(out):
        return out[..., 0].permute(0, 2, 1)

    if g is None:
        def call():
            return F.grid_sample(nchw, grid, mode="bilinear", padding_mode="zeros",
                                 align_corners=True)

        return call, to_samples
    nchw, grid = nchw.detach().requires_grad_(), grid.detach().requires_grad_()
    out = F.grid_sample(nchw, grid, mode="bilinear", padding_mode="zeros", align_corners=True)
    grad_out = g.flatten(1, -2).permute(0, 2, 1)[..., None].to(out.dtype)

    def backward_call():
        return torch.autograd.grad(out, (nchw, grid), grad_out, retain_graph=True)

    return backward_call, to_samples


def beyond(got, want, rtol, atol):
    return int(((got - want).abs() > atol + rtol * want.abs()).sum())


def check_forward(name, feat, ys, xs, card, reps=20, timed=True):
    """The forward kernel against the plain version on these inputs, in the
    map's dtype, with times, bound and the library call's time (only the
    error unless `timed`). Raises on a disagreement."""
    from cpm_tpu_torch.ops.cuda.deform_sample import KERNEL
    from cpm_tpu_torch.ops.deform_conv import deform_sample_plain

    got = KERNEL(feat, ys, xs)
    want = deform_sample_plain(feat.float(), ys, xs)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite samples")
    err = (got.float() - want).abs().max().item()
    if feat.dtype == torch.float32:
        if err > F32_ATOL:
            raise AssertionError(f"{name}: f32 kernel vs plain max |err| {err} > {F32_ATOL}")
        tol = f"atol {F32_ATOL}"
    else:
        want = want.to(feat.dtype).float()
        bad = beyond(got.float(), want, **BF16_TOL)
        if bad:
            raise AssertionError(f"{name}: {bad} elements beyond {BF16_TOL}")
        tol = f"rtol {BF16_TOL['rtol']}, atol {BF16_TOL['atol']}"
    outside = (ys < -1) | (ys > feat.shape[1]) | (xs < -1) | (xs > feat.shape[2])
    if got[outside].any():
        raise AssertionError(f"{name}: a sample outside the map is not zero")
    if not timed:
        return dict(err=err)
    call, to_samples = grid_sample_call(feat, ys, xs)
    library_note = ""
    try:
        lib_out = call()
    except RuntimeError:
        # the yardstick only: where the library has no kernel for this dtype
        call, to_samples = grid_sample_call(feat.float(), ys, xs)
        lib_out, library_note = call(), " on a float32 copy"
    lib_err = (to_samples(lib_out).float() - want.flatten(1, -2)).abs().max().item()
    del lib_out, got, want
    ms = cuda_ms(lambda: KERNEL(feat, ys, xs), reps)
    plain_ms = cuda_ms(lambda: deform_sample_plain(feat, ys, xs), 5)
    library_ms = cuda_ms(call, 5)
    (bound_ms, bound_by), _ = sampler_bounds(feat, ys, xs)
    print(f"[kernel] deform_sample {name} {str(feat.dtype)[6:]}: N={ys.numel()} samples "
          f"({int(outside.sum())} outside the map) max|err|={err:.3g} ({tol}) kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, F.grid_sample{library_note} {library_ms:.4f} ms (max |diff| "
          f"to plain {lib_err:.3g}), bound {bound_ms:.4f} ms ({bound_by}) | {card}")
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)


def plain_backward(feat, ys, xs, g):
    """The plain version of the backward kernel: autograd of the plain
    forward. Returns (gradient to feat, gys, gxs)."""
    from cpm_tpu_torch.ops.deform_conv import deform_sample_plain

    f = feat.detach().requires_grad_()
    y, x = ys.detach().requires_grad_(), xs.detach().requires_grad_()
    return torch.autograd.grad(deform_sample_plain(f, y, x), (f, y, x), g)


def check_backward(name, feat, ys, xs, g, card, reps=20, timed=True):
    """The backward kernels against autograd of the plain version, in the map's
    dtype: the map's gradient, the coordinates' gradients, two runs on the
    same inputs bit-equal, with times, the binning's time, the bound and one
    `F.grid_sample` backward's time (only the error unless `timed`). Raises
    on a disagreement."""
    from cpm_tpu_torch.ops.cuda.deform_sample import KERNEL

    got = KERNEL.backward(feat, ys, xs, g)
    want = plain_backward(feat.float(), ys, xs, g.float())
    torch.cuda.synchronize()
    if not all(torch.isfinite(t).all() for t in got):
        raise AssertionError(f"{name}: non-finite gradient")
    map_tol = BWD_MAP_TOL if feat.dtype == torch.float32 else BF16_TOL
    coord_tol = BWD_COORD_TOL
    want_map = want[0].to(feat.dtype).float()
    errs = [(got[0].float() - want_map).abs().max().item()]
    bad = beyond(got[0].float(), want_map, **map_tol)
    if bad:
        raise AssertionError(f"{name}: map gradient, {bad} cells beyond {map_tol}, max |err| {errs[0]}")
    for what, a, b in (("gys", got[1], want[1]), ("gxs", got[2], want[2])):
        errs.append((a - b).abs().max().item())
        bad = beyond(a, b, **coord_tol)
        if bad:
            raise AssertionError(f"{name}: {what}, {bad} samples beyond {coord_tol}, "
                                 f"max |err| {errs[-1]}")
    if not got[1].any() or not got[2].any():
        raise AssertionError(f"{name}: the coordinates got no gradient")
    again = KERNEL.backward(feat, ys, xs, g)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{name}: two backward runs on the same inputs differ")
    # the flags: a map or coordinates that need no gradient get none
    only_map = KERNEL.backward(feat, ys, xs, g, need_coords=False)
    only_coords = KERNEL.backward(feat, ys, xs, g, need_map=False)
    if only_map[1] is not None or only_coords[0] is not None or not torch.equal(
            only_coords[1], got[1]) or not torch.equal(only_map[0], got[0]):
        raise AssertionError(f"{name}: the need_map / need_coords flags are not honoured")
    del got, want, want_map, again, only_map, only_coords
    if not timed:
        return dict(err=max(errs))
    library_note = ""
    try:
        call, _ = grid_sample_call(feat, ys, xs, g)
        call()
    except RuntimeError:
        # the yardstick only: where the library has no kernel for this dtype
        call, _ = grid_sample_call(feat.float(), ys, xs, g.float())
        library_note = " on float32 copies"
    ms = cuda_ms(lambda: KERNEL.backward(feat, ys, xs, g), reps)
    binning_ms = cuda_ms(lambda: KERNEL.bin_samples(feat, ys, xs), reps)
    plain_ms = cuda_ms(lambda: plain_backward(feat, ys, xs, g), 3)
    library_ms = cuda_ms(call, 5)
    del call
    _, (bound_ms, bound_by) = sampler_bounds(feat, ys, xs)
    print(f"[bwd kernel] deform_sample {name} {str(feat.dtype)[6:]}: N={ys.numel()} map gradient "
          f"max|err|={errs[0]:.3g} ({map_tol}), gys {errs[1]:.3g} gxs {errs[2]:.3g} ({coord_tol}), "
          f"two runs bit-equal, kernel {ms:.4f} ms (binning included), plain {plain_ms:.4f} ms, "
          f"F.grid_sample backward to map and grid{library_note} {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}) | {card}")
    print(f"[binning] deform_sample {name} {str(feat.dtype)[6:]}: the binning kernels "
          f"{binning_ms:.4f} ms of the kernel's {ms:.4f} ms | {card}")
    return dict(err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms, binning_ms=binning_ms)


def run_geometries(dtypes, dev, card, reps=20):
    """{'forward': [...], 'backward': [...]} of the checks over the three
    geometries in each of `dtypes`; the results keep the geometry's name and
    dtype."""
    out = dict(forward=[], backward=[])
    for name, h, w, c in GEOMETRIES:
        for dtype in dtypes:
            feat, ys, xs = make_inputs(h, w, c, dtype, dev)
            g = torch.randn(feat.shape[0], ys.shape[1], c,
                            generator=torch.Generator().manual_seed(1)).to(dev, dtype)
            for key, res in (("forward", check_forward(name, feat, ys, xs, card, reps)),
                             ("backward", check_backward(name, feat, ys, xs, g, card, reps))):
                out[key].append(dict(res, geometry=name, dtype=str(dtype)[6:]))
            del feat, ys, xs, g
            torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32", "both"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("probe_dcn_sampler: needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dtypes = {"bfloat16": [torch.bfloat16], "float32": [torch.float32],
              "both": [torch.float32, torch.bfloat16]}[args.dtype]
    card = card_line()
    results = run_geometries(dtypes, "cuda", card)
    for key, rows in results.items():
        for r in rows:
            print(f"{key:8s} {r['geometry']:18s} {r['dtype']:8s} kernel {r['ms']:8.4f} ms  "
                  f"{r['ms'] / r['bound_ms']:6.1f}x its bound | {card}")


if __name__ == "__main__":
    main()
