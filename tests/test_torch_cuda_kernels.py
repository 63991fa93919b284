"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked `cuda` and skips where there is no NVIDIA GPU. The
file imports nothing of JAX or of the JAX package (the plain versions are
held against those by the CPU tests), so it also runs on a machine that has
only PyTorch, nvcc and a card:

    python3 -m pytest tests/test_torch_cuda_kernels.py -q

Tolerances: forward f32 atol 1e-5 (TF32 off; kernel and plain version read
the same cells with the same weights and differ in the order of a few sums),
bf16 rtol 1.6e-2 / atol 1e-2 (one bf16 rounding of an f32 sum); backward f32
rtol 1e-4 / atol 1e-4 (each cell's terms summed in another order: by the
tile-owned multilevel, stacked and sampler backwards in one fixed order, so
that two of their runs are bit-equal, and the stacked one gives the
multilevel one's bits), bf16 as the forward. The NMS kernels and the RPN's
candidate kernel are exact: bit for bit against the fixed point and the
per-level loop of cpm_tpu_torch/tools/probe_nms.py.

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
@pytest.mark.parametrize("batch,channels,stride", [(1, 128, 1), (1, 256, 1), (2, 256, 2),
                                                   (2, 512, 1), (1, 1024, 2), (2, 1024, 1)])
def test_cuda_deform_sample_forward_tiles_are_exact(batch, channels, stride, dtype_name):
    """The forward over a deformable conv's sampling grid given in rows of
    output positions, as `deform_conv2d` gives it (tiles by output rows for
    cells of at most 512 bytes, the flat form above): offsets of about +-2
    cells, a few far outliers, whole tiles thrown past the map's border, and
    non-finite coordinates. Exact against the plain version at the forward's
    tolerances, and to the bit the same as on the flat list of the same
    samples."""
    import torch

    from cpm_tpu_torch.ops import deform_conv
    from cpm_tpu_torch.ops.cuda import deform_sample as op

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    h, w = 23, 37
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    rng = np.random.RandomState(20 + channels + stride)
    offset = rng.uniform(-2, 2, (batch, ho, wo, 18)).astype(np.float32)
    far = rng.rand(batch, ho, wo, 18) < 0.02
    offset[far] = rng.uniform(-30, 30, int(far.sum()))
    offset[:, :4, :8] += 60.0                       # a corner of tiles past the border
    offset[:, 5, 3, 0], offset[:, 6, 2, 1] = np.nan, np.inf
    offset[:, 7, 1, 2], offset[:, 8, 4, 3] = -np.inf, 1e7
    ys, xs = (t.view(batch, ho, wo * 9) for t in deform_conv.sampling_grid(
        torch.from_numpy(offset).cuda(), (3, 3), stride, 1, 1))
    dtype = getattr(torch, dtype_name)
    feat = torch.from_numpy(rng.randn(batch, h, w, channels).astype(np.float32)).cuda().to(dtype)
    before = op.KERNEL.launches
    got = deform_conv.deform_sample(feat, ys, xs)
    assert op.KERNEL.launches == before + 1 and got.dtype == dtype
    assert got.shape == (batch, ho, wo * 9, channels)
    # the plain version's gathers take no NaN index: a coordinate that is not
    # finite weighs nothing, as one far outside the map does
    finite = torch.isfinite(ys) & torch.isfinite(xs)
    far = torch.full_like(ys, -10.0)
    want = deform_conv.deform_sample_plain(
        feat.float(), torch.where(finite, ys, far), torch.where(finite, xs, far))
    assert torch.isfinite(got).all()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    else:
        torch.testing.assert_close(got.float(), want.to(dtype).float(), rtol=1.6e-2, atol=1e-2)
    outside = (ys < -1) | (ys > h) | (xs < -1) | (xs > w) | ~finite
    assert outside.sum() > 100 and (~finite).sum() == 3 * batch and not got[outside].any()
    flat = op.KERNEL(feat, ys.flatten(1), xs.flatten(1))
    assert torch.equal(flat, got.flatten(1, 2))
    assert op.KERNEL.launches == before + 2


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


CROSSROI_EDGES = ["far corner", "outside the leader's window", "all out of bounds", "one vector",
                  "ragged chunk", "one step", "G=16"]


def _crossroi_edge(case, element_size):
    """(rois [R, 5], group, channels) of one edge of the cross-roi kernel on a
    [2, 80, 100, C] map at scale 0.25 (an image of 320 x 400 px), whose
    windows' column origins (at most 36) round down to 32:
    - far corner: every leader is clamped to the map's far corner, so its
      members' positions reach 64 rows and 64 columns;
    - outside the leader's window: every member but the leader lies in the
      far corner, its positions up to 67 columns past its own origin, past
      the leader's window (cells there weigh zero);
    - all out of bounds: every sample of step 1 lies outside the map;
    - one vector: C of one 16-byte vector; ragged chunk: C of 9 vectors, not a
      multiple of the kernel's 8 lanes;
    - one step: R = G = 4; G=16: two steps of 16 (and 64 members at 14x14,
      whose staged samples exceed a block's 48 KB, refused)."""
    rng = np.random.RandomState(8)
    group = {"one step": 4, "G=16": 16}.get(case, 2)
    n = {"one step": 4, "G=16": 32}.get(case, 16)
    channels = {"one vector": 1, "ragged chunk": 9}.get(case, 8) * 16 // element_size
    rois = np.zeros((n, 5), np.float32)
    rois[:, 0] = rng.randint(0, 2, n)
    w, h = rng.uniform(40, 130, n), rng.uniform(40, 130, n)
    rois[:, 1] = rng.uniform(0, 400 - w, n)
    rois[:, 2] = rng.uniform(0, 320 - h, n)
    rois[:, 3], rois[:, 4] = rois[:, 1] + w, rois[:, 2] + h
    corner = [270, 190, 399, 319]     # 32 x 32 cells ending at the far corner
    if case == "far corner":
        rois[::group, 1:] = corner
    if case == "outside the leader's window":
        rois[np.arange(n) % group != 0, 1:] = corner
    if case == "all out of bounds":
        rois[group:2 * group, 1:] = [-900, -900, -800, -800]
    return rois, group, channels


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CROSSROI_EDGES)
def test_cuda_crossroi_kernel_edges_match_plain(case, dtype_name):
    import torch

    from cpm_tpu_torch.ops.cuda import crossroi_roi_align as op
    from cpm_tpu_torch.ops.roi_align import crossroi_prep_rois, crossroi_roi_align_plain

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dtype = getattr(torch, dtype_name)
    rois, group, channels = _crossroi_edge(case, torch.finfo(dtype).bits // 8)
    rng = np.random.RandomState(9)
    feat = torch.from_numpy(rng.randn(2, 80, 100, channels).astype(np.float32)).cuda().to(dtype)
    r = torch.from_numpy(rois).cuda()
    prep = crossroi_prep_rois(r, 0.25, feat.shape[1:3], (7, 7), 2)
    if case == "far corner":
        assert (prep.y0[::group] == 16).all() and (prep.ys[::group].amax() >= 62)
    if case == "outside the leader's window":
        assert (prep.xs[1::group].amax(dim=1) > 64).all()
    before = op.KERNEL.launches
    got = op.crossroi_roi_align(feat, r, group, (7, 7), 0.25, 2)
    assert op.KERNEL.launches == before + 1 and got.dtype == dtype
    want = crossroi_roi_align_plain(feat.float(), prep, group, (7, 7), 2)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    else:
        torch.testing.assert_close(got.float(), want.to(dtype).float(), rtol=1.6e-2, atol=1e-2)
    if case == "all out of bounds":
        assert not got[group:2 * group].any()
    if case == "G=16":
        # 64 members' 56 axis samples each take 57 KB of shared memory: refused
        with pytest.raises(ValueError):
            op.crossroi_roi_align(feat, r.repeat(2, 1), 64, (14, 14), 0.25, 2)


def _colliding_rois(n, rng):
    """[n, 5] rois on image 0 that are jittered copies of one small box: their
    samples share a few cells of one level."""
    rois = np.tile(np.array([[0, 100.0, 60.0, 112.0, 70.0]], np.float32), (n, 1))
    rois[:, 1:] += rng.uniform(-1.5, 1.5, (n, 4)).astype(np.float32)
    return rois


def _backward_case(dtype_name, channels):
    """Rois larger than a tile (whole image), rois spanning tile and level
    borders, 512 rois colliding on a few cells, and masked, degenerate and
    outside rois, with their levels, mask and `g` (the colliding rois' `g`
    scaled by 2^-3, exact, so that their sums stay of unit scale)."""
    import torch

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
    return dtype, shapes, r, levels.int(), v, torch.from_numpy(g).cuda().to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("channels", [256, 1024])
@pytest.mark.parametrize("name", ["multilevel", "stacked"])
def test_cuda_multilevel_backward_is_exact_and_deterministic(name, channels, dtype_name):
    """The tile-owned backward of the multilevel and of the stacked RoIAlign
    against autograd of the plain forward, and two runs bit-equal, on
    `_backward_case`'s rois. The reference is the plain backward in float64:
    each of the colliding cells sums some 25,000 terms, which a float32
    reference would round as much as the kernel does."""
    import torch

    from cpm_tpu_torch.ops.cuda import multilevel_roi_align, stacked_roi_align

    op = dict(multilevel=multilevel_roi_align, stacked=stacked_roi_align)[name]
    dtype, shapes, r, levels, v, g = _backward_case(dtype_name, channels)
    before = op.KERNEL.backward_launches
    got = op.KERNEL.backward(shapes, r, levels, v, g, SCALES, 2)
    again = op.KERNEL.backward(shapes, r, levels, v, g, SCALES, 2)
    assert op.KERNEL.backward_launches == before + 2
    want = multilevel_roi_align.plain_multilevel_roi_align_backward(
        shapes, r, levels, v, g.double(), SCALES, 2)
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
@pytest.mark.parametrize("channels", [256, 1024])
def test_cuda_stacked_backward_gives_the_multilevel_backwards_bits(channels, dtype_name):
    """The stacked backward runs the multilevel one's tile loop over the
    stacked buffer: on the same inputs, colliding rois included, it gives
    the same bits, as views of one buffer in g's dtype, without padding."""
    import torch

    from cpm_tpu_torch.ops.cuda import multilevel_roi_align, stacked_roi_align

    dtype, shapes, r, levels, v, g = _backward_case(dtype_name, channels)
    got = stacked_roi_align.KERNEL.backward(shapes, r, levels, v, g, SCALES, 2)
    want = multilevel_roi_align.KERNEL.backward(shapes, r, levels, v, g, SCALES, 2)
    base = got[0].untyped_storage().data_ptr()
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.untyped_storage().data_ptr() == base
        assert torch.equal(a, b)


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


# the flagship's level maps at 800x1344
FLAGSHIP_SHAPES = [(200, 336), (100, 168), (50, 84), (25, 42)]


def _pooler_rois(n, seed, dense=False, masked=0.3):
    """[n, 5] rois over a batch of two 800x1344 images on the card, their
    levels by the FPN rule, and a mask: boxes of every size, the first
    (up to seven) rows extreme aspect ratios, a whole-map roi, boxes outside
    the image and a degenerate one; `dense`: jittered copies of a few boxes,
    so that rois share cells and groups form."""
    import torch

    from cpm_tpu_torch.ops.pooler import assign_fpn_levels

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    rng = np.random.RandomState(seed)
    side = np.exp(rng.uniform(np.log(8), np.log(900), n))
    aspect = np.exp(rng.uniform(np.log(0.25), np.log(4.0), n))
    w, h = side * np.sqrt(aspect), side / np.sqrt(aspect)
    x1, y1 = rng.uniform(-40, 1344, n), rng.uniform(-40, 800, n)
    boxes = np.stack([x1, y1, x1 + w, y1 + h], 1)
    if dense:
        base = boxes[rng.randint(0, max(1, n // 12), n)]
        boxes = base + rng.uniform(-4, 4, (n, 4)) * np.tile(base[:, 2:] - base[:, :2], 2) / 100
    special = np.array([[0, 300, 1340, 310], [600, 0, 606, 799], [0, 0, 1343, 799],
                        [1400, 900, 1500, 1000], [-300, -300, -100, -100], [500, 400, 480, 380],
                        [700, 300, 700, 300]])
    k = min(n, len(special)) if not dense else 0
    boxes[:k] = special[:k]
    rois = np.concatenate([rng.randint(0, 2, n)[:, None], boxes], 1).astype(np.float32)
    valid = rng.rand(n) >= masked
    valid[:k] = True
    rois = torch.from_numpy(rois).cuda()
    levels = (assign_fpn_levels(rois[:, 1:5], 2, 5) - 2).int()
    return rois, levels, torch.from_numpy(valid).cuda()


def _flagship_maps(dtype, seed=0, channels=256):
    import torch

    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(2, h, w, channels, generator=gen).cuda().to(dtype)
            for h, w in FLAGSHIP_SHAPES]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("pool", POOLS, ids=["7x7", "14x14"])
@pytest.mark.parametrize("num_rois", [1, 7, 300, 1000])
def test_cuda_multilevel_forward_bin_slices_match_plain(num_rois, pool, dtype_name):
    """The multilevel forward spreads each roi's bins over several blocks
    (`bin_slices`); at roi counts that fill none of the splits evenly, with
    masked rois, extreme aspect ratios and a whole-map roi it gives the plain
    version's values and zeros for the masked rois."""
    import torch

    from cpm_tpu_torch.ops.cuda import multilevel_roi_align as op
    from cpm_tpu_torch.ops.roi_align import multilevel_roi_align as plain

    rois, levels, valid = _pooler_rois(num_rois, seed=num_rois)
    dtype = getattr(torch, dtype_name)
    fs = _flagship_maps(dtype)
    before = op.KERNEL.launches
    got = op.multilevel_roi_align(fs, rois, levels, valid, pool, SCALES, 2)
    assert op.KERNEL.launches == before + 1
    assert got.dtype == dtype and not got[~valid].any()
    want = torch.cat([plain([f.float() for f in fs], r, l, pool, SCALES, 2)
                      for r, l in zip(rois.split(100), levels.split(100))])
    want = want * valid[:, None, None, None]
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    else:
        torch.testing.assert_close(got.float(), want.to(dtype).float(), rtol=1.6e-2, atol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("pool", POOLS, ids=["cap 8 at 7x7", "cap 4 at 14x14"])
@pytest.mark.parametrize("kind", ["random", "dense", "all masked", "one roi"])
def test_cuda_grouping_kernel_equals_cluster_rois(kind, pool):
    """The grouping kernel's order, groups, slot groups and group count are
    `cluster_rois`' integer for integer, at the group caps of both pool
    sizes."""
    import torch

    from cpm_tpu_torch.ops.cuda import clustered_roi_align as op
    from cpm_tpu_torch.ops.roi_align import Grouping, cluster_rois, group_cap

    n = {"random": 600, "dense": 1000, "all masked": 64, "one roi": 1}[kind]
    rois, levels, valid = _pooler_rois(n, seed=3, dense=kind == "dense",
                                       masked=1.0 if kind == "all masked" else 0.3)
    if kind == "one roi":
        valid[:] = True
    args = (rois, levels, valid, FLAGSHIP_SHAPES, 2, pool, SCALES, 2)
    before = op.KERNEL.grouping_launches
    got, want = op.KERNEL.group(*args), cluster_rois(*args)
    assert op.KERNEL.grouping_launches == before + 1
    for field in Grouping._fields:
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and torch.equal(a, b), field
    sizes = want.groups[:, 1]
    assert int(sizes.max()) <= group_cap(pool)
    if kind == "dense":
        assert int((sizes > 1).sum()) > 10   # groups of several rois formed


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["random", "dense"])
def test_cuda_clustered_forward_on_the_grouping_kernel_gives_the_multilevel_bits(kind, dtype_name):
    """Kernel 3 on the grouping kernel's groups gives the multilevel
    forward's bits at both pool sizes, and launches the grouping once a
    call."""
    import torch

    from cpm_tpu_torch.ops.cuda import clustered_roi_align as op
    from cpm_tpu_torch.ops.cuda import multilevel_roi_align as level_op

    rois, levels, valid = _pooler_rois(1000, seed=5, dense=kind == "dense")
    fs = _flagship_maps(getattr(torch, dtype_name), seed=1)
    for pool in POOLS:
        before = (op.KERNEL.launches, op.KERNEL.grouping_launches)
        got = op.multilevel_roi_align_clustered(fs, rois, levels, valid, pool, SCALES, 2)
        assert (op.KERNEL.launches, op.KERNEL.grouping_launches) == (before[0] + 1, before[1] + 1)
        assert torch.equal(got, level_op.multilevel_roi_align(fs, rois, levels, valid, pool,
                                                              SCALES, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("pool", POOLS, ids=["7x7", "14x14"])
@pytest.mark.parametrize("num_rois", [1, 7, 300, 1000])
def test_cuda_stacked_forward_gives_the_multilevel_bits_over_bin_slices(num_rois, pool, dtype_name):
    """4f runs the multilevel forward's loop (csrc/roi_align_forward.cuh)
    over the stacked buffer: at the roi counts of the bin-split test above it
    gives kernel 1's bits, masked rows zero, one launch and one stack a
    call."""
    import torch

    from cpm_tpu_torch.ops.cuda import multilevel_roi_align as level_op
    from cpm_tpu_torch.ops.cuda import stacked_roi_align as op

    rois, levels, valid = _pooler_rois(num_rois, seed=num_rois)
    fs = _flagship_maps(getattr(torch, dtype_name))
    before = (op.KERNEL.launches, op.STACKS.builds)
    got = op.multilevel_roi_align_stacked(fs, rois, levels, valid, pool, SCALES, 2)
    assert (op.KERNEL.launches, op.STACKS.builds) == (before[0] + 1, before[1] + 1)
    assert not got[~valid].any()
    assert torch.equal(got, level_op.multilevel_roi_align(fs, rois, levels, valid, pool, SCALES, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("pool", POOLS, ids=["7x7", "14x14"])
@pytest.mark.parametrize("num_rois", [1, 7, 300, 1000])
def test_cuda_single_level_forward_gives_the_multilevel_bits_at_one_level(num_rois, pool):
    """Kernel 5 is the multilevel forward's loop at one level, not aligned,
    with no mask: on a C4-wide map it gives kernel 1's bits on a one-level
    table with every roi valid."""
    import torch

    from cpm_tpu_torch.ops.cuda import multilevel_roi_align as level_op
    from cpm_tpu_torch.ops.cuda import roi_align as op

    rois, _, _ = _pooler_rois(num_rois, seed=num_rois + 1)
    feats = torch.randn(2, 50, 84, 1024, generator=torch.Generator().manual_seed(4)).cuda()
    zeros = torch.zeros(num_rois, dtype=torch.int32, device=rois.device)
    everyone = torch.ones(num_rois, dtype=torch.bool, device=rois.device)
    before = op.KERNEL.launches
    got = op.roi_align_cuda(feats, rois, pool, 0.0625, 2)
    assert op.KERNEL.launches == before + 1
    want = level_op.multilevel_roi_align([feats], rois, zeros, everyone, pool, (0.0625,), 2, False)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_cuda_one_level_pooler_backward_skips_masked_rows(dtype_name):
    """A one-level `Pooler` (kernel 5 forward, kernel 2 at one level
    backward) with a NaN box in a masked row: the map's gradient is finite
    and bit-equal to the gradient without that row, and the forward writes
    zeros there."""
    import torch

    from cpm_tpu_torch.ops.cuda import multilevel_roi_align as level_op
    from cpm_tpu_torch.ops.cuda import roi_align as op
    from cpm_tpu_torch.ops.pooler import Pooler

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dtype = getattr(torch, dtype_name)
    rois, _, _ = _pooler_rois(64, seed=9)
    rois = rois.clone()
    rois[5, 1:] = float("nan")
    mask = torch.ones(64, dtype=torch.bool, device=rois.device)
    mask[5] = False
    feats = torch.randn(2, 50, 84, 64, generator=torch.Generator().manual_seed(3)).cuda().to(dtype)
    g = torch.randn(64, 7, 7, 64, generator=torch.Generator().manual_seed(6)).cuda().to(dtype)
    pooler = Pooler((7, 7), (0.0625,), 2)
    grads = []
    for r, m, gg in ((rois, mask, g), (rois[mask].contiguous(), mask[mask], g[mask])):
        f = feats.clone().requires_grad_()
        before = (op.KERNEL.launches, level_op.KERNEL.backward_launches)
        out = pooler([f], r, m)
        (out * gg).float().sum().backward()
        assert (op.KERNEL.launches, level_op.KERNEL.backward_launches) == (
            before[0] + 1, before[1] + 1)
        assert torch.isfinite(out).all() and not out[~m].any()
        grads.append(f.grad)
    assert torch.isfinite(grads[0]).all() and grads[0].any()
    assert torch.equal(grads[0], grads[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_cuda_one_pass_stack_gives_stack_levels_bits_once_per_set_of_maps(dtype_name):
    """The card's stack (one pass: levels copied into an empty buffer, only
    the padding columns zeroed) gives `stack_levels`' bits, padding zeros
    included; the memo builds it once for a set of maps and anew after an
    in-place change."""
    import torch

    from cpm_tpu_torch.ops.cuda.stacked_roi_align import StackMemo
    from cpm_tpu_torch.ops.roi_align import stack_levels, stack_levels_in_one_pass

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the stack is built on the card")
    fs = _flagship_maps(getattr(torch, dtype_name), seed=2)
    # leave non-zero bytes behind in the caching allocator for the stack's
    # padding to land on
    junk = torch.full((2, 375, 336, 256), float("nan"), dtype=fs[0].dtype, device="cuda")
    del junk
    memo = StackMemo()
    got = memo(fs, stack_levels_in_one_pass)
    assert torch.equal(got, stack_levels(fs))
    assert memo(list(fs), stack_levels_in_one_pass) is got and memo.builds == 1
    fs[3].mul_(2)
    again = memo(fs, stack_levels_in_one_pass)
    assert again is not got and memo.builds == 2 and torch.equal(again, stack_levels(fs))


def _tiny_stacked_cfg():
    import torch

    from cpm_tpu_torch.config import flagship_cfg

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the stacked kernels have no CPU mode")
    cfg = flagship_cfg(tiny=True)
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.POOLER_KERNEL = "stacked"
    return cfg


@pytest.mark.cuda
def test_cuda_one_stack_per_eval_forward_under_stacked():
    """The five pooler calls of an eval forward (cls, three grid stages,
    rescore) pool the same FPN maps from one stack; the next forward builds
    its own."""
    from cpm_tpu_torch.engine.test import make_forward_fn
    from cpm_tpu_torch.modeling.model import build_model
    from cpm_tpu_torch.ops import pooler as pooler_mod
    from cpm_tpu_torch.ops.cuda import stacked_roi_align as op

    cfg = _tiny_stacked_cfg()
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    sizes = np.array([[64, 64], [56, 48]], np.int32)
    try:
        forward = make_forward_fn(cfg, build_model(cfg, "cuda", seed=0))
        for _ in range(2):
            before = (op.KERNEL.launches, op.STACKS.builds)
            forward(images, sizes)
            assert (op.KERNEL.launches, op.STACKS.builds) == (before[0] + 5, before[1] + 1)
    finally:
        pooler_mod.set_pooler_backend("auto")


@pytest.mark.cuda
def test_cuda_one_stack_per_training_step_under_stacked():
    """The training step's five pooler calls share one stack, and each of
    them launches the stacked backward once."""
    from cpm_tpu_torch.data.synthetic import synthetic_batch
    from cpm_tpu_torch.engine.train import create_train_state, make_train_step
    from cpm_tpu_torch.ops import pooler as pooler_mod
    from cpm_tpu_torch.ops.cuda import stacked_roi_align as op

    cfg = _tiny_stacked_cfg()
    try:
        model, optimizer, state = create_train_state(cfg, "cuda", seed=0)
        step = make_train_step(cfg, model, optimizer)
        batch = synthetic_batch(2, 64, 64, max_gt=4, num_classes=cfg.MODEL.NUM_CLASSES, seed=3)
        for _ in range(2):
            before = (op.KERNEL.launches, op.KERNEL.backward_launches, op.STACKS.builds)
            step(state, batch)
            assert (op.KERNEL.launches, op.KERNEL.backward_launches, op.STACKS.builds) == (
                before[0] + 5, before[1] + 5, before[2] + 1)
    finally:
        pooler_mod.set_pooler_backend("auto")


# The NMS kernels (ops/cuda/nms.py) and the RPN's candidate kernel
# (ops/cuda/rpn_candidates.py), bit for bit against the fixed point and the
# per-level loop (tools/probe_nms.py).


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _assert_same_bits(got, want):
    import torch

    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


def _rows(n, rows, dtype, seed, spread=200.0):
    """Boxes [rows, n, 4] crowded around a few centres (so that suppression
    chains form), scores in steps of 1/16 (ties), and row r valid at rate
    1 - r / (rows - 1): the last row has no valid box."""
    import torch

    rng = np.random.RandomState(seed)
    centres = rng.rand(max(1, n // 20), 2) * spread
    ctr = centres[rng.randint(0, len(centres), (rows, n))] + rng.randn(rows, n, 2) * 6
    wh = rng.rand(rows, n, 2) * 40 + 4
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1)
    scores = np.round(rng.rand(rows, n) * 16) / 16
    rate = 1 - np.arange(rows) / max(rows - 1, 1)
    valid = rng.rand(rows, n) < rate[:, None]
    valid[-1] = False
    as_cuda = lambda x, d: torch.tensor(x, dtype=d, device="cuda")  # noqa: E731
    return as_cuda(boxes, dtype), as_cuda(scores, torch.float32), as_cuda(valid, torch.bool)


@pytest.mark.cuda
@pytest.mark.parametrize("legacy_plus1", [False, True], ids=["no offset", "legacy_plus1"])
@pytest.mark.parametrize("n", [1, 63, 64, 65, 1000, 2000])
def test_cuda_nms_kernel_matches_the_fixed_point(n, legacy_plus1):
    import torch

    from cpm_tpu_torch.ops.cuda import nms as op
    from cpm_tpu_torch.ops.nms import nms
    from cpm_tpu_torch.tools.probe_nms import fixed_point_nms

    _card()
    boxes, scores, valid = _rows(n, 3, torch.float32, seed=n)
    for max_output in sorted({n, n // 7 + 1, n + 5}):
        before = op.KERNEL.launches
        got = nms(boxes, scores, 0.5, max_output, mask=valid, legacy_plus1=legacy_plus1)
        want = fixed_point_nms(boxes, scores, 0.5, max_output, valid, legacy_plus1)
        assert op.KERNEL.launches == before + 1
        _assert_same_bits(got, want)
        assert not got[1][-1].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", ["bfloat16", "float64"])
@pytest.mark.parametrize("n", [65, 1000])
def test_cuda_nms_kernel_matches_the_fixed_point_in_other_dtypes(n, dtype_name):
    import torch

    from cpm_tpu_torch.ops.nms import nms
    from cpm_tpu_torch.tools.probe_nms import fixed_point_nms

    _card()
    boxes, scores, valid = _rows(n, 3, getattr(torch, dtype_name), seed=n + 1)
    for thresh in (0.3, 0.7):
        _assert_same_bits(nms(boxes, scores, thresh, n, mask=valid),
                          fixed_point_nms(boxes, scores, thresh, n, valid))


def _next(x, direction):
    """The neighbouring value of x (a 0-d tensor) in its dtype."""
    import torch

    if x.dtype == torch.bfloat16:
        bits = x.view(torch.int16) + (1 if direction > 0 else -1)
        return bits.view(torch.bfloat16)
    return torch.nextafter(x, torch.tensor(direction * 2.0, dtype=x.dtype, device=x.device))


def _every_value(dtype, lo, hi):
    """Every value of a 16-bit float dtype in [lo, hi], on the card."""
    import torch

    every = torch.arange(-2**15, 2**15, dtype=torch.int32).to(torch.int16).view(dtype)
    return every[(every >= lo) & (every <= hi)].cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("legacy_plus1", [False, True], ids=["no offset", "legacy_plus1"])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_cuda_nms_kernel_at_the_threshold_and_one_ulp_either_side(dtype_name, legacy_plus1):
    """Pairs (a higher-scored box, a later one) whose IoU, as box_iou rounds
    it, is the threshold in the boxes' dtype and its two neighbours: the
    later box is removed exactly when its IoU is above."""
    import torch

    from cpm_tpu_torch.ops.nms import nms
    from cpm_tpu_torch.structures.boxes import box_iou
    from cpm_tpu_torch.tools.probe_nms import fixed_point_nms

    _card()
    dtype = getattr(torch, dtype_name)
    thr = torch.tensor(0.7, dtype=dtype, device="cuda")
    targets = torch.stack([_next(thr, -1), thr, _next(thr, 1)])
    # a fixed box against boxes inside it whose far corner walks the dtype's
    # values: every bfloat16 value; float32 values ulp by ulp around the x2
    # that puts the IoU at 0.7 for a few y2
    if dtype == torch.bfloat16:
        x2 = _every_value(dtype, 40.0, 100.0)
        y2 = _every_value(dtype, 40.0, 110.0)
    else:
        off = 1.0 if legacy_plus1 else 0.0
        y2 = torch.tensor([98.5, 99.0, 100.0, 101.0], dtype=dtype, device="cuda")
        centre = 0.7 * (100.0 + off) ** 2 / (y2 + off) - off
        x2 = (centre[:, None].view(torch.int32)
              + torch.arange(-4096, 4097, device="cuda", dtype=torch.int32)).view(dtype).flatten()
    x2, y2 = torch.meshgrid(x2, y2, indexing="ij")
    others = torch.stack([torch.zeros_like(x2), torch.zeros_like(x2), x2, y2], -1).reshape(-1, 4)
    a = torch.tensor([[0.0, 0.0, 100.0, 100.0]], dtype=dtype, device="cuda")
    iou = box_iou(a, others, legacy_plus1=legacy_plus1)[0]
    hit = (iou[:, None] == targets[None, :])
    assert hit.any(0).all(), "no pair at the threshold or a neighbour"
    pairs = torch.stack([a.expand(int(hit.any(1).sum()), 4), others[hit.any(1)]], 1)
    scores = torch.tensor([1.0, 0.5], device="cuda").expand(pairs.shape[0], 2).contiguous()
    valid = torch.ones(scores.shape, dtype=torch.bool, device="cuda")
    got = nms(pairs, scores, 0.7, 2, mask=valid, legacy_plus1=legacy_plus1)
    _assert_same_bits(got, fixed_point_nms(pairs, scores, 0.7, 2, valid, legacy_plus1))
    removed = ~got[1][:, 1]
    assert torch.equal(removed, iou[hit.any(1)] > thr)


@pytest.mark.cuda
@pytest.mark.parametrize("fn_name", ["batched_nms", "multiclass_nms"])
def test_cuda_batched_nms_with_coordinate_offsets_matches_the_fixed_point(fn_name):
    """The detection filter's call: label-aware NMS by shifting each label's
    boxes past the others, over 1024 candidates an image."""
    import torch

    from cpm_tpu_torch.ops import nms as nms_mod
    from cpm_tpu_torch.tools.probe_nms import fixed_point_nms

    _card()
    boxes, scores, valid = _rows(1024, 2, torch.float32, seed=3, spread=600.0)
    labels = torch.tensor(np.random.RandomState(4).randint(1, 81, (2, 1024)), device="cuda")
    got = getattr(nms_mod, fn_name)(boxes, scores, labels, 0.5, 100, mask=valid)
    max_coord = torch.amax(boxes, dim=(-2, -1), keepdim=True) + 1.0
    shifted = boxes + labels.to(boxes.dtype)[..., None] * max_coord
    _assert_same_bits(got, fixed_point_nms(shifted, scores, 0.5, 100, valid))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("cell", ["serve", "train"])
def test_cuda_select_proposals_equals_the_per_level_loop(cell, seed):
    """At the benchmark cells' shapes: 1 image at 800x1344 with 1000
    candidates a level, 4 at 864x1408 with 2000 and the per-batch top-k."""
    from cpm_tpu_torch.modeling.rpn import select_proposals
    from cpm_tpu_torch.tools.probe_nms import per_level_select, rpn_inputs

    _card()
    layout, obj, reg, sizes, kw = rpn_inputs(cell, seed, "cuda")
    _assert_same_bits(select_proposals(layout, obj, reg, sizes, **kw),
                      per_level_select(layout, obj, reg, sizes, **kw))


@pytest.mark.cuda
def test_cuda_select_proposals_at_one_level_equals_the_per_level_loop():
    """The C4 layout (one level of 15 anchors a cell, 50x84 at 800x1344)
    with Detectron's C4 values: 6000 candidates, 1000 kept."""
    import torch

    from cpm_tpu_torch.modeling.rpn import AnchorLayout, select_proposals
    from cpm_tpu_torch.tools.probe_nms import per_level_select

    _card()
    layout = AnchorLayout([(50, 84)], (16,), (32, 64, 128, 256, 512), (0.5, 1.0, 2.0))
    g = torch.Generator().manual_seed(6)
    obj = [torch.randn(2, 50, 84, 15, generator=g).cuda().bfloat16()]
    reg = [(0.5 * torch.randn(2, 50, 84, 60, generator=g)).cuda().bfloat16()]
    sizes = torch.tensor([[800, 1333], [750, 1344]], dtype=torch.int32, device="cuda")
    kw = dict(pre_nms_top_n=6000, post_nms_top_n=1000, nms_thresh=0.7, min_size=0,
              fpn_post_nms_top_n=1000)
    _assert_same_bits(select_proposals(layout, obj, reg, sizes, **kw),
                      per_level_select(layout, obj, reg, sizes, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["serve", "train"])
def test_cuda_select_proposals_never_waits_and_dispatches_few_ops(cell):
    """No host wait (torch's sync debug mode raises on one) and, in serving,
    at most 60 dispatched ATen ops, where the per-level loop dispatched
    about 950."""
    import torch

    from cpm_tpu_torch.modeling.rpn import select_proposals
    from cpm_tpu_torch.tools.probe_nms import OpCount, rpn_inputs

    _card()
    layout, obj, reg, sizes, kw = rpn_inputs(cell, 2, "cuda")
    select_proposals(layout, obj, reg, sizes, **kw)  # builds the kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with OpCount() as count:
            select_proposals(layout, obj, reg, sizes, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if cell == "serve":
        assert count.total <= 60, count.ops


@pytest.mark.cuda
def test_cuda_rpn_candidates_decode_every_bfloat16_delta():
    """Every bfloat16 value as dw and dh (the heads' deltas are bf16) on
    anchors 16, 1024 and 2^20 px wide centred on 0, where x2 = w/2 * exp(dw)
    - 1 holds exp's bits for exp(dw) from 1/8, 2^-9 and 2^-19 up; and a
    million float32 deltas. The kernel's boxes, scores and flags against the
    plain decode, clip and mask on the card, bit for bit (any NaN for NaN:
    a NaN delta gives a NaN box on both sides)."""
    import torch

    from cpm_tpu_torch.ops.box_coder import BoxCoder
    from cpm_tpu_torch.ops.cuda.rpn_candidates import KERNEL
    from cpm_tpu_torch.structures.boxes import clip_boxes_to_image, remove_small_boxes_mask

    _card()
    coder = BoxCoder(weights=(1.0, 1.0, 1.0, 1.0))
    every = torch.arange(-2**15, 2**15, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    rng = np.random.RandomState(5)
    f32 = torch.tensor(rng.uniform(-14.0, 4.2, 2**20), dtype=torch.float32)
    for d in (every, f32):
        d = d.cuda()
        t = 3 * d.numel()
        half = torch.tensor([8.0, 512.0, 2.0**19], device="cuda").repeat_interleave(d.numel())
        anchors = torch.stack([-half, -half, half - 1, half - 1], -1)
        deltas = torch.zeros(1, t, 4, dtype=d.dtype, device="cuda")
        deltas[0, :, 2] = d.repeat(3)
        deltas[0, :, 3] = d.repeat(3).flip(0)
        scores = torch.rand(1, t, device="cuda")
        sizes = torch.tensor([[2**24, 2**24]], dtype=torch.int32, device="cuda")
        order = torch.arange(t, device="cuda")[None]
        boxes, out_scores, valid = KERNEL([scores], [order], [deltas], [anchors], sizes, [t],
                                          coder, 2.0)
        want = clip_boxes_to_image(coder.decode(deltas.float(), anchors[None]),
                                   (sizes[:, None, 1].float(), sizes[:, None, 0].float()))
        same = (boxes[:, 0].view(torch.int32) == want.view(torch.int32)) | (
            boxes[:, 0].isnan() & want.isnan())
        assert same.all(), f"{int((~same).sum())} coordinates differ"
        assert torch.equal(out_scores[:, 0], scores)
        assert torch.equal(valid[:, 0], remove_small_boxes_mask(want, 2.0))


@pytest.mark.cuda
def test_cuda_nms_launches_in_a_forward_and_a_step():
    """Every NMS of an eval forward (the RPN's, the detection filter's) and of
    a training step (the RPN's) goes through the kernels; the fixed point
    never runs on the card."""
    from cpm_tpu_torch.config import flagship_cfg
    from cpm_tpu_torch.data.synthetic import synthetic_batch
    from cpm_tpu_torch.engine.test import make_forward_fn
    from cpm_tpu_torch.engine.train import create_train_state, make_train_step
    from cpm_tpu_torch.ops import nms as nms_mod
    from cpm_tpu_torch.ops.cuda import nms as op
    from cpm_tpu_torch.ops.cuda import rpn_candidates

    _card()
    cfg = flagship_cfg(tiny=True)
    cfg.TPU.COMPUTE_DTYPE = "float32"
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    sizes = np.array([[64, 64], [56, 48]], np.int32)

    def launches():
        return op.KERNEL.launches, rpn_candidates.KERNEL.launches

    def no_fixed_point(*args):
        raise AssertionError("the fixed point ran on the card")

    real = nms_mod._sorted_keep_mask
    nms_mod._sorted_keep_mask = no_fixed_point
    try:
        model, optimizer, state = create_train_state(cfg, "cuda", seed=0)
        forward = make_forward_fn(cfg, model)
        step = make_train_step(cfg, model, optimizer)
        batch = synthetic_batch(2, 64, 64, max_gt=4, num_classes=cfg.MODEL.NUM_CLASSES, seed=3)
        for _ in range(2):
            before = launches()
            forward(images, sizes)
            assert launches() == (before[0] + 2, before[1] + 1)
            before = launches()
            step(state, batch)
            assert launches() == (before[0] + 1, before[1] + 1)
    finally:
        nms_mod._sorted_keep_mask = real
