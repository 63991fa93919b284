"""The plain rules behind two RoIAlign kernels of the port, on the CPU.

* `ops/cuda/multilevel_roi_align.py::bin_slices`: how the multilevel forward
  kernel spreads a roi's bins over blocks. Every bin is pooled by exactly one
  block, no block is empty, and no row of threads takes more than
  `BINS_PER_ROW` bins.
* `ops/roi_align.py::counting_sort_groups`: the grouping kernel's counting
  sort over the key space, stated in torch ops. It gives `cluster_rois`'
  `Grouping` (order, groups, slot groups, group count) integer for integer.

The kernels themselves run only on a card (tests/test_torch_cuda_kernels.py);
these tests hold the rules they follow. torch and the port are imported
inside the tests, so that collecting this file loads no torch into a test
worker.
"""

import sys
import types

import numpy as np
import pytest
from tests.torch_support import _one_torch_thread  # noqa: F401  (autouse)


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
LEVEL_HW = [(200, 336), (100, 168), (50, 84), (25, 42)]


@pytest.mark.parametrize("channels,element_size", [(256, 2), (256, 4), (1024, 2), (64, 4)])
@pytest.mark.parametrize("bins", [1, 7 * 7, 14 * 14, 28 * 28, 3 * 5])
def test_bin_slices_pool_every_bin_once(bins, channels, element_size):
    from cpm_tpu_torch.ops.cuda.multilevel_roi_align import BINS_PER_ROW, bin_slices

    slices, span = bin_slices(bins, channels, element_size)
    rows = 256 // min(channels * element_size // 16, 64)
    covered = np.zeros(bins, np.int64)
    for s in range(slices):
        first, last = s * span, min(s * span + span, bins)
        assert first < last, "an empty block"
        covered[first:last] += 1
    assert (covered == 1).all()
    assert span <= BINS_PER_ROW * rows
    # the fewest blocks that hold BINS_PER_ROW bins a row
    assert slices == -(-bins // (BINS_PER_ROW * rows))


def _rois(kind, n, seed):
    """Rois over a batch of two 800x1344 images, their FPN levels and a
    mask: boxes of every size with extreme and outside ones, or (`dense`)
    jittered copies of a few boxes, so that groups of several rois form."""
    import torch

    from cpm_tpu_torch.ops.pooler import assign_fpn_levels

    rng = np.random.RandomState(seed)
    side = np.exp(rng.uniform(np.log(8), np.log(900), n))
    aspect = np.exp(rng.uniform(np.log(0.25), np.log(4.0), n))
    w, h = side * np.sqrt(aspect), side / np.sqrt(aspect)
    x1, y1 = rng.uniform(-40, 1344, n), rng.uniform(-40, 800, n)
    boxes = np.stack([x1, y1, x1 + w, y1 + h], 1)
    if kind == "dense":
        base = boxes[rng.randint(0, max(1, n // 12), n)]
        boxes = base + rng.uniform(-4, 4, (n, 4)) * np.tile(base[:, 2:] - base[:, :2], 2) / 100
    else:
        special = [[0, 300, 1340, 310], [600, 0, 606, 799], [0, 0, 1343, 799],
                   [1400, 900, 1500, 1000], [500, 400, 480, 380]]
        boxes[:min(n, 5)] = special[:min(n, 5)]
    rois = torch.from_numpy(
        np.concatenate([rng.randint(0, 2, n)[:, None], boxes], 1).astype(np.float32))
    valid = torch.from_numpy(rng.rand(n) >= (1.0 if kind == "all masked" else 0.3))
    if kind == "one roi":
        valid[:] = True
    return rois, (assign_fpn_levels(rois[:, 1:5], 2, 5) - 2).int(), valid


@pytest.mark.parametrize("pool,group", [((7, 7), None), ((14, 14), None), ((7, 7), 4),
                                        ((14, 14), 8)],
                         ids=["cap 8 at 7x7", "cap 4 at 14x14", "cap 4 at 7x7", "cap 8 at 14x14"])
@pytest.mark.parametrize("kind", ["random", "dense", "all masked", "one roi"])
def test_counting_sort_groups_equals_cluster_rois(kind, pool, group):
    import torch

    from cpm_tpu_torch.ops.roi_align import Grouping, cluster_rois, counting_sort_groups

    n = {"random": 300, "dense": 400, "all masked": 40, "one roi": 1}[kind]
    rois, levels, valid = _rois(kind, n, seed=n)
    args = (rois, levels, valid, LEVEL_HW, 2, pool, SCALES, 2, False, group)
    got, want = counting_sort_groups(*args), cluster_rois(*args)
    for field in Grouping._fields:
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and torch.equal(a, b), field
    if kind == "dense":
        assert int((want.groups[:, 1] > 1).sum()) > 5   # groups of several rois formed
