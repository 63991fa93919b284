"""The port's nine CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked `cuda` and skips where there is no NVIDIA GPU. The
file imports nothing of JAX or of the JAX package (the plain versions are
held against those by the CPU tests), so it also runs on a machine that has
only PyTorch, nvcc and a card:

    python3 -m pytest tests/test_torch_cuda_kernels.py -q

Tolerances: forward f32 atol 1e-5 (TF32 off; kernel and plain version read
the same cells with the same weights and differ in the order of a few sums),
bf16 rtol 1.6e-2 / atol 1e-2 (one bf16 rounding of an f32 sum); backward f32
rtol 1e-4 / atol 1e-4 (each cell's terms summed in another order: by the
stacked kernel's atomics in one that changes from run to run, by the
tile-owned multilevel and sampler backwards in one fixed order, so that two
of their runs are bit-equal), bf16 as the forward.

torch and the port are imported inside the tests, so that collecting this
file loads no torch into a test worker.
"""

import sys
import types

import numpy as np
import pytest


@pytest.fixture(scope="module", autouse=True)
def _drop_stub_modules_that_answer_every_name():
    """tests/test_weight_parity.py leaves stub modules in `sys.modules` whose
    `__getattr__` answers every name, `__file__` included, with a function.
    torch registers custom ops at the first backward or optimizer of a process
    and looks its caller up with `inspect.getmodule`, which walks
    `sys.modules` and fails on such a `__file__`. Whether that file ran
    earlier in this worker depends on the scheduling, so the stubs go before
    this file's first torch call; that file installs them again when it needs
    them."""
    for name, mod in list(sys.modules.items()):
        if isinstance(mod, types.ModuleType) and callable(getattr(mod, "__file__", None)):
            del sys.modules[name]


SCALES = (0.25, 0.125, 0.0625, 0.03125)
SHAPES = [(56, 80), (28, 40), (14, 20), (7, 10)]
POOLS = [(7, 7), (14, 14)]
BWD_TOL = dict(rtol=1e-4, atol=1e-4)
BACKENDS = ["multilevel", "stacked", "clustered"]


def _inputs(dtype_name, seed=11, channels=256):
    """Level maps, rois, levels and mask on the card: rois crowded around six
    spots so that groups form, a few strips and whole-image rois whose
    supports exceed any shared tile, and a quarter of the rois masked."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(seed)
    n = 96
    rois = np.zeros((n + 4, 5), np.float32)
    rois[:, 0] = rng.randint(0, 2, n + 4)
    x1 = rng.choice([40.0, 90.0, 150.0], n) + rng.rand(n) * 20
    y1 = rng.choice([30.0, 80.0], n) + rng.rand(n) * 16
    rois[:n, 1], rois[:n, 2] = x1, y1
    rois[:n, 3] = x1 + rng.rand(n) * 130 + 4
    rois[:n, 4] = y1 + rng.rand(n) * 90 + 4
    rois[n:, 1:] = [[0, 100, 319, 102], [0, 0, 319, 223], [10, 5, 300, 40], [150, 0, 156, 223]]
    levels = rng.randint(0, 4, n + 4).astype(np.int32)
    levels[n:] = [0, 0, 1, 0]
    valid = np.arange(n + 4) % 4 != 2
    dtype = getattr(torch, dtype_name)
    feats = [torch.from_numpy(rng.randn(2, h, w, channels).astype(np.float32)).cuda().to(dtype)
             for h, w in SHAPES]
    as_cuda = lambda x: torch.from_numpy(x).cuda()  # noqa: E731
    return dtype, feats, as_cuda(rois), as_cuda(levels), as_cuda(valid)


def _ops(name):
    """(wrapper module whose KERNEL counts the forward launches, the op, its
    plain version with the mask applied)."""
    from cpm_tpu_torch.ops import roi_align as plain
    from cpm_tpu_torch.ops.cuda import clustered_roi_align, multilevel_roi_align, stacked_roi_align

    def masked(fn):
        return lambda fs, rois, levels, valid, pool: fn(fs, rois, levels, pool, SCALES, 2) * valid[
            :, None, None, None]

    return dict(
        multilevel=(multilevel_roi_align, multilevel_roi_align.multilevel_roi_align,
                    masked(plain.multilevel_roi_align)),
        stacked=(stacked_roi_align, stacked_roi_align.multilevel_roi_align_stacked,
                 masked(plain.multilevel_roi_align_stacked_plain)),
        clustered=(clustered_roi_align, clustered_roi_align.multilevel_roi_align_clustered,
                   lambda fs, rois, levels, valid, pool: plain.multilevel_roi_align_clustered_plain(
                       fs, rois, levels, valid, pool, SCALES, 2)),
    )[name]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", BACKENDS)
def test_cuda_forward_kernel_matches_plain(name, dtype_name):
    import torch

    dtype, fs, rois, levels, valid = _inputs(dtype_name)
    mod, op, plain = _ops(name)
    before = mod.KERNEL.launches
    for pool in POOLS:
        got = op(fs, rois, levels, valid, pool, SCALES, 2)
        want = plain([f.float() for f in fs], rois, levels, valid, pool)
        assert got.dtype == dtype and not got[~valid].any()
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
        else:
            torch.testing.assert_close(got.float(), want.to(dtype).float(), rtol=1.6e-2, atol=1e-2)
    assert mod.KERNEL.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["stacked", "clustered"])
def test_cuda_forward_kernels_give_the_multilevel_kernels_bits(name):
    import torch

    _, fs, rois, levels, valid = _inputs("float32")
    for pool in POOLS:
        want = _ops("multilevel")[1](fs, rois, levels, valid, pool, SCALES, 2)
        assert torch.equal(_ops(name)[1](fs, rois, levels, valid, pool, SCALES, 2), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", BACKENDS)
def test_cuda_backward_matches_plain(name, dtype_name):
    import torch

    from cpm_tpu_torch.ops.cuda import multilevel_roi_align, stacked_roi_align
    from cpm_tpu_torch.ops.cuda.stacked_roi_align import plain_stacked_roi_align_backward

    dtype, fs, rois, levels, valid = _inputs(dtype_name)
    fs = [f.requires_grad_() for f in fs]
    g = torch.randn(len(rois), 7, 7, 256, generator=torch.Generator().manual_seed(3)).cuda().to(dtype)
    # the clustered forward trains through the multilevel backward kernel
    counter = stacked_roi_align.KERNEL if name == "stacked" else multilevel_roi_align.KERNEL
    before = counter.backward_launches
    out = _ops(name)[1](fs, rois, levels, valid, (7, 7), SCALES, 2)
    # a permuted gradient: the Function makes it contiguous
    out.permute(0, 3, 1, 2).mul(g.permute(0, 3, 1, 2)).sum().backward()
    assert counter.backward_launches == before + 1
    want = plain_stacked_roi_align_backward(
        [f.shape for f in fs], rois, levels, valid, g.float(), SCALES, 2)
    for f, w in zip(fs, want):
        assert f.grad.dtype == dtype and f.grad.shape == f.shape
        if dtype == torch.float32:
            torch.testing.assert_close(f.grad, w, **BWD_TOL)
        else:
            torch.testing.assert_close(f.grad.float(), w.to(dtype).float(), rtol=1.6e-2, atol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("pool", POOLS, ids=["7x7", "14x14"])
def test_cuda_single_level_kernel_matches_plain(pool):
    import torch

    from cpm_tpu_torch.ops.cuda import roi_align as op
    from cpm_tpu_torch.ops.roi_align import roi_align

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    rng = np.random.RandomState(2)
    feats = rng.randn(2, 16, 24, 1024).astype(np.float32)
    rois = np.zeros((64, 5), np.float32)
    rois[:, 0] = rng.randint(0, 2, 64)
    rois[:, 1], rois[:, 2] = rng.rand(64) * 300 - 40, rng.rand(64) * 200 - 40
    rois[:, 3] = rois[:, 1] + rng.rand(64) * 240 + 1
    rois[:, 4] = rois[:, 2] + rng.rand(64) * 160 + 1
    rois[0, 1:] = [240, 160, 200, 120]    # degenerate: roi_w = roi_h = 1 cell
    rois[1, 1:] = [800, 800, 900, 900]    # outside the map: zeros
    f = torch.from_numpy(feats).cuda().requires_grad_()
    r = torch.from_numpy(rois).cuda()
    before = op.KERNEL.launches
    got = op.roi_align_cuda(f, r, pool, 0.0625, 2)
    assert op.KERNEL.launches == before + 1 and not got[1].any()
    torch.testing.assert_close(got, roi_align(f.detach(), r, pool, 0.0625, 2), rtol=0, atol=1e-5)
    (got ** 2).sum().backward()
    f2 = torch.from_numpy(feats).cuda().requires_grad_()
    (roi_align(f2, r, pool, 0.0625, 2) ** 2).sum().backward()
    torch.testing.assert_close(f.grad, f2.grad, **BWD_TOL)


def _sampler_inputs(dtype_name, shape, seed=5):
    """A map, coordinates over the map and past its border (a few pinned to
    the border, the outside and whole cells) and an output gradient, on the
    card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    b, h, w, c = shape
    rng = np.random.RandomState(seed)
    p = 4000
    ys = rng.uniform(-1.5, h + 0.5, (b, p)).astype(np.float32)
    xs = rng.uniform(-1.5, w + 0.5, (b, p)).astype(np.float32)
    pinned = np.array([[-0.5, 0.0], [h - 0.5, w - 0.5], [-1.25, 1.0], [1.0, w + 0.25],
                       [h - 1.0, w - 1.0], [0.0, 0.0], [1.0, 0.5], [0.5, 1.0]], np.float32)
    ys[:, : len(pinned)], xs[:, : len(pinned)] = pinned[:, 0], pinned[:, 1]
    dtype = getattr(torch, dtype_name)
    feat = torch.from_numpy(rng.randn(b, h, w, c).astype(np.float32)).cuda().to(dtype)
    g = torch.from_numpy(rng.randn(b, p, c).astype(np.float32)).cuda().to(dtype)
    return dtype, feat, torch.from_numpy(ys).cuda(), torch.from_numpy(xs).cuda(), g


SAMPLER_SHAPES = [(2, 13, 21, 256), (1, 9, 7, 1024), (2, 1, 12, 64), (2, 10, 1, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SAMPLER_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_cuda_deform_sample_forward_matches_plain(shape, dtype_name):
    import torch

    from cpm_tpu_torch.ops import deform_conv
    from cpm_tpu_torch.ops.cuda import deform_sample as op

    dtype, feat, ys, xs, _ = _sampler_inputs(dtype_name, shape)
    before = op.KERNEL.launches
    got = deform_conv.deform_sample(feat, ys, xs)
    assert op.KERNEL.launches == before + 1 and got.dtype == dtype
    want = deform_conv.deform_sample_plain(feat.float(), ys, xs)
    assert not got[:, 2].any() and not got[:, 3].any()   # wholly outside the map
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    else:
        torch.testing.assert_close(got.float(), want.to(dtype).float(), rtol=1.6e-2, atol=1e-2)
    with pytest.raises(ValueError):
        op.KERNEL(feat[..., :6].contiguous(), ys, xs)   # C must fill 16-byte vectors
    with pytest.raises(ValueError):
        op.KERNEL(feat.cpu(), ys.cpu(), xs.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SAMPLER_SHAPES[:2] + [(2, 1, 12, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_cuda_deform_sample_backward_matches_autograd_of_plain(shape, dtype_name):
    """Map and coordinate gradients through the op (forward and backward
    kernels) against autograd of the plain version. On a one-row map the
    plain version takes the four-corner form, whose derivative at a whole
    coordinate is one-sided where the tent's is zero: those samples are left
    out of the coordinate comparison."""
    import torch

    from cpm_tpu_torch.ops import deform_conv
    from cpm_tpu_torch.ops.cuda import deform_sample as op

    dtype, feat, ys, xs, g = _sampler_inputs(dtype_name, shape)
    f = feat.clone().requires_grad_()
    y, x = ys.clone().requires_grad_(), xs.clone().requires_grad_()
    before = op.KERNEL.backward_launches
    deform_conv.deform_sample(f, y, x).backward(g)
    assert op.KERNEL.backward_launches == before + 1
    f2 = feat.float().requires_grad_()
    y2, x2 = ys.clone().requires_grad_(), xs.clone().requires_grad_()
    deform_conv.deform_sample_plain(f2, y2, x2).backward(g.float())
    assert f.grad.dtype == dtype and y.grad.dtype == torch.float32
    if dtype == torch.float32:
        torch.testing.assert_close(f.grad, f2.grad, **BWD_TOL)
    else:
        torch.testing.assert_close(f.grad.float(), f2.grad.to(dtype).float(), rtol=1.6e-2, atol=1e-2)
    off = ((ys - ys.round()).abs() > 1e-3) & ((xs - xs.round()).abs() > 1e-3)
    if min(shape[1:3]) >= 2:
        off = torch.ones_like(off)
        # the tent's derivative is zero at a whole coordinate: sample (1.0, 0.5)
        assert not y.grad[:, 6].any() and x.grad[:, 6].any()
    torch.testing.assert_close(y.grad[off], y2.grad[off], rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(x.grad[off], x2.grad[off], rtol=1e-4, atol=1e-3)
    assert y.grad.abs().max() > 0.1 and not y.grad[:, 2].any()


@pytest.mark.cuda
@pytest.mark.parametrize("v2,groups,stride", [(False, 1, 1), (True, 4, 2), (False, 32, 2)])
def test_cuda_deform_conv_pack_matches_the_cpu_port(v2, groups, stride):
    import torch

    from cpm_tpu_torch.ops.deform_conv import DeformConvPack, ModulatedDeformConvPack

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cls = ModulatedDeformConvPack if v2 else DeformConvPack
    gen = torch.Generator().manual_seed(0)
    pack = cls(64, 64, stride=stride, groups=groups, generator=gen)
    conv = getattr(pack, pack.offset_conv_name)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen) * 0.05)
        conv.bias.copy_(torch.randn(conv.bias.shape, generator=gen))
    x = torch.randn(2, 64, 14, 18, generator=gen).contiguous(memory_format=torch.channels_last)
    g = torch.randn(2, 64, 14 // stride, 18 // stride, generator=gen)
    outs = {}
    for dev in ("cpu", "cuda"):
        p = cls(64, 64, stride=stride, groups=groups).to(dev)
        p.load_state_dict(pack.state_dict())
        xi = x.detach().clone().to(dev).requires_grad_()
        out = p(xi)
        out.backward(g.to(dev))
        outs[dev] = [out.detach().cpu(), xi.grad.cpu()] + [q.grad.cpu() for q in p.parameters()]
    for a, b in zip(outs["cuda"], outs["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("group,pool", [(1, (7, 7)), (2, (7, 7)), (8, (7, 7)), (4, (14, 14))])
def test_cuda_crossroi_kernel_matches_plain(group, pool, dtype_name):
    import torch

    from cpm_tpu_torch.ops.cuda import crossroi_roi_align as op
    from cpm_tpu_torch.ops.roi_align import crossroi_prep_rois, crossroi_roi_align_plain

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    rng = np.random.RandomState(6)
    dtype = getattr(torch, dtype_name)
    feat = torch.from_numpy(rng.randn(2, 80, 104, 64).astype(np.float32)).cuda()
    n = 64
    rois = np.zeros((n, 5), np.float32)
    rois[:, 0] = rng.randint(0, 2, n)
    w, h = rng.uniform(40, 130, n), rng.uniform(40, 130, n)
    rois[:, 1] = rng.uniform(-10, 416 - w + 10, n)
    rois[:, 2] = rng.uniform(-10, 320 - h + 10, n)
    rois[:, 3], rois[:, 4] = rois[:, 1] + w, rois[:, 2] + h
    rois[1, 1:] = [-900, -900, -800, -800]   # every sample out of bounds: zeros
    r = torch.from_numpy(rois).cuda()
    before = op.KERNEL.launches
    got = op.crossroi_roi_align(feat.to(dtype), r, group, pool, 0.25, 2)
    assert op.KERNEL.launches == before + 1 and got.dtype == dtype and not got[1].any()
    prep = crossroi_prep_rois(r, 0.25, feat.shape[1:3], pool, 2)
    want = crossroi_roi_align_plain(feat.to(dtype).float(), prep, group, pool, 2)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    else:
        torch.testing.assert_close(got.float(), want.to(dtype).float(), rtol=1.6e-2, atol=1e-2)
    with pytest.raises(ValueError):
        op.crossroi_roi_align(feat, r[:63], 2, pool, 0.25, 2)   # 63 rois do not fill groups of 2


def _colliding_rois(n, rng):
    """[n, 5] rois on image 0 that are jittered copies of one small box: their
    samples share a few cells of one level."""
    rois = np.tile(np.array([[0, 100.0, 60.0, 112.0, 70.0]], np.float32), (n, 1))
    rois[:, 1:] += rng.uniform(-1.5, 1.5, (n, 4)).astype(np.float32)
    return rois


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("channels", [256, 1024])
def test_cuda_multilevel_backward_is_exact_and_deterministic(channels, dtype_name):
    """The tile-owned backward against autograd of the plain forward, and two
    runs bit-equal, on rois larger than a tile (whole image), rois spanning
    tile and level borders, 512 rois colliding on a few cells, and masked,
    degenerate and outside rois. The reference is the plain backward in
    float64: each of the colliding cells sums some 25,000 terms, which a
    float32 reference would round as much as the kernel does; their `g` is
    scaled by 2^-3 (exact) so that those sums stay of unit scale."""
    import torch

    from cpm_tpu_torch.ops.cuda import multilevel_roi_align as op
    from cpm_tpu_torch.ops.pooler import assign_fpn_levels

    dtype, _, rois, _, valid = _inputs(dtype_name, seed=13, channels=16)
    rng = np.random.RandomState(14)
    extra = np.array([
        [0, 0, 0, 319, 223],          # the whole image: every tile of its level
        [1, 60, 28, 132, 36],         # across tile borders (x 64, 128 / 4 = 16, 32 cells)
        [0, 30, 30, 30, 30],          # zero area
        [1, 200, 150, 180, 120],      # degenerate: x2 < x1, y2 < y1
        [0, 400, 300, 480, 400],      # outside the image
        [1, -90, -60, -20, -10],      # outside, negative
    ], np.float32)
    rows = np.concatenate([rois.cpu().numpy(), extra, _colliding_rois(512, rng)])
    mask = np.concatenate([valid.cpu().numpy(), np.ones(len(extra) + 512, bool)])
    mask[len(rois) + 1] = False   # a masked roi across borders adds nothing
    r = torch.from_numpy(rows).cuda()
    v = torch.from_numpy(mask).cuda()
    levels = assign_fpn_levels(r[:, 1:5], 2, 5) - 2
    levels[len(rois):len(rois) + 2] = torch.tensor([0, 1], dtype=levels.dtype)
    shapes = [(2, h, w, channels) for h, w in SHAPES]
    g = rng.randn(len(rows), 7, 7, channels).astype(np.float32)
    g[-512:] *= 0.125
    g = torch.from_numpy(g).cuda().to(dtype)
    before = op.KERNEL.backward_launches
    got = op.KERNEL.backward(shapes, r, levels.int(), v, g, SCALES, 2)
    again = op.KERNEL.backward(shapes, r, levels.int(), v, g, SCALES, 2)
    assert op.KERNEL.backward_launches == before + 2
    want = op.plain_multilevel_roi_align_backward(shapes, r, levels.int(), v, g.double(), SCALES, 2)
    for a, b, w in zip(got, again, want):
        assert a.dtype == dtype and tuple(a.shape) == tuple(w.shape)
        assert torch.equal(a, b)
        if dtype == torch.float32:
            torch.testing.assert_close(a, w.float(), **BWD_TOL)
        else:
            torch.testing.assert_close(a.float(), w.to(dtype).float(), rtol=1.6e-2, atol=1e-2)
    assert got[0].abs().sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 19, 37, 256), (1, 11, 21, 512), (1, 9, 18, 1024)],
                         ids=lambda s: "x".join(map(str, s)))
def test_cuda_deform_sample_backward_tiles_are_exact_and_deterministic(shape, dtype_name):
    """The tile-owned map gradient and the coordinate gradients against
    autograd of the plain version, two runs bit-equal: samples straddling the
    8x16 tiles' borders, beyond the map (at +-1e6 too), and 3000 samples on a
    few cells, so that one tile's list takes several rounds of staging."""
    import torch

    from cpm_tpu_torch.ops.cuda import deform_sample as op
    from cpm_tpu_torch.ops.deform_conv import window_tiles
    from cpm_tpu_torch.tools.probe_dcn_sampler import plain_backward

    dtype, feat, ys, xs, _ = _sampler_inputs(dtype_name, shape, seed=8)
    b, h, w, c = shape
    rng = np.random.RandomState(9)
    crowd_y = rng.uniform(6.5, 8.5, (b, 3000)).astype(np.float32)
    crowd_x = rng.uniform(14.5, 16.5, (b, 3000)).astype(np.float32)
    border = np.array([[7.5, 15.5], [7.0, 16.0], [8.0, 15.0], [1e6, 3.0], [2.0, -1e6],
                       [h - 1.0, w - 1.0], [h - 0.5, 2.0], [-0.75, w - 0.25]], np.float32)
    y = torch.cat([ys, torch.from_numpy(crowd_y).cuda()], 1)
    x = torch.cat([xs, torch.from_numpy(crowd_x).cuda()], 1)
    y[:, 8:16], x[:, 8:16] = torch.from_numpy(border[:, 0]).cuda(), torch.from_numpy(border[:, 1]).cuda()
    y, x = y.contiguous(), x.contiguous()
    g = torch.from_numpy(rng.randn(b, y.shape[1], c).astype(np.float32)).cuda().to(dtype)
    before = op.KERNEL.backward_launches
    got = op.KERNEL.backward(feat, y, x, g)
    again = op.KERNEL.backward(feat, y, x, g)
    assert op.KERNEL.backward_launches == before + 2
    for a, b_ in zip(got, again):
        assert torch.equal(a, b_)
    want = plain_backward(feat.float(), y, x, g.float())
    assert got[0].dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got[0], want[0], **BWD_TOL)
    else:
        torch.testing.assert_close(got[0].float(), want[0].to(dtype).float(), rtol=1.6e-2, atol=1e-2)
    torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=1e-3)
    assert not got[1][:, 11:13].any() and not got[2][:, 11:13].any()   # at +-1e6
    only_map = op.KERNEL.backward(feat, y, x, g, need_coords=False)
    assert only_map[1] is None and torch.equal(only_map[0], got[0])
    # the binning kernels give what their plain version gives, to the bit
    order, offsets, *_ = op.KERNEL.bin_samples(feat, y, x)
    want_order, want_offsets = window_tiles(y, x, (h, w), op.KERNEL.tile)
    assert torch.equal(order, want_order) and torch.equal(offsets, want_offsets)


@pytest.mark.cuda
def test_cuda_deform_sample_backward_at_batch_4_on_the_res3_stride_2_map():
    """The first deformable block of res3 samples the 200x336 map of an
    800x1344 image at stride 2: 4200 tiles and 151,200 samples an image. At a
    batch of 4 the backward holds against autograd of the plain version,
    reruns bit-equal, and its binning gives what `window_tiles` gives."""
    import torch

    from cpm_tpu_torch.ops.cuda import deform_sample as op
    from cpm_tpu_torch.ops.deform_conv import sampling_grid, window_tiles
    from cpm_tpu_torch.tools.probe_dcn_sampler import plain_backward

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    b, h, w, c = 4, 200, 336, 256
    gen = torch.Generator().manual_seed(10)
    feat = torch.randn(b, h, w, c, generator=gen).cuda().to(torch.bfloat16)
    offset = (torch.rand(b, h // 2, w // 2, 18, generator=gen) * 4 - 2).cuda()
    ys, xs = (t.contiguous() for t in sampling_grid(offset, (3, 3), 2, 1, 1))
    g = torch.randn(b, ys.shape[1], c, generator=gen).cuda().to(torch.bfloat16)
    got = op.KERNEL.backward(feat, ys, xs, g)
    again = op.KERNEL.backward(feat, ys, xs, g)
    for a, b_ in zip(got, again):
        assert torch.equal(a, b_)
    order, offsets, *_ = op.KERNEL.bin_samples(feat, ys, xs)
    want_order, want_offsets = window_tiles(ys, xs, (h, w), op.KERNEL.tile)
    assert torch.equal(order, want_order) and torch.equal(offsets, want_offsets)
    want = plain_backward(feat.float(), ys, xs, g.float())
    torch.testing.assert_close(got[0].float(), want[0].to(torch.bfloat16).float(),
                               rtol=1.6e-2, atol=1e-2)
    torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=1e-3)
