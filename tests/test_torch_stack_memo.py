"""The stacked pooler's stack: built in one pass, and once for each set of maps.

* `ops/roi_align.py::stack_levels_in_one_pass` (the card's stack: the buffer
  allocated empty, each level copied into its rows, only the padding
  columns zeroed) gives `stack_levels`' (pad and cat) bits, padding zeros
  included, whatever the allocation held;
* `ops/cuda/stacked_roi_align.py::StackMemo` (a one-entry memo keyed on
  the maps' identity through weak references and on their versions) builds
  one stack for a set of maps, a new one after an in-place change or for
  new maps, and keeps nothing once the maps die;
* `ops/cuda/stacked_roi_align.py::STACKS` shares a stack only within its
  scope, one forward: outside it every call builds, and a map changed in
  place under `torch.inference_mode` between two forwards gets a new stack;
* the five pooler calls of an eval forward, and of a training step, of the
  tiny flagship model under `TPU.POOLER_KERNEL stacked` run within one such
  scope (on the CPU the stacked path builds its differentiable stack every
  call; tests/test_torch_cuda_kernels.py counts one build a forward and a
  step on the card), and the stacked step gives the `auto` step's losses
  and gradients.

The port's stacked pooler is held against the JAX package's stacked Pallas
kernel and the gather formulation by tests/test_torch_pooler_kernels.py and
tests/test_torch_model.py. torch is imported inside the tests.
"""

import gc
import sys
import types
import weakref

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


# the flagship's four levels at a 64x96 image, and a set whose widest level
# is not the first
LEVELS = {"fpn": [(16, 24), (8, 12), (4, 6), (2, 3)], "widest last": [(3, 5), (6, 2), (2, 9)]}


def _maps(level_hw, dtype_name="float32", seed=0, channels=8):
    import torch

    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(2, h, w, channels).astype(np.float32))
            .to(getattr(torch, dtype_name)) for h, w in level_hw]


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("levels", list(LEVELS), ids=list(LEVELS))
def test_one_pass_stack_gives_stack_levels_bits(levels, dtype_name, monkeypatch):
    import torch

    from cpm_tpu_torch.ops.roi_align import stack_levels, stack_levels_in_one_pass

    maps = _maps(LEVELS[levels], dtype_name)
    want = stack_levels(maps)
    # whatever the allocation held: every byte must be written
    real_empty = torch.empty
    monkeypatch.setattr(torch, "empty",
                        lambda *a, **k: real_empty(*a, **k).fill_(float("nan")))
    got = stack_levels_in_one_pass(maps)
    monkeypatch.undo()
    assert got.dtype == want.dtype and got.shape == want.shape and got.is_contiguous()
    assert torch.equal(got, want)


def test_stack_memo_builds_once_per_set_of_maps():
    import torch

    from cpm_tpu_torch.ops.cuda.stacked_roi_align import StackMemo
    from cpm_tpu_torch.ops.roi_align import stack_levels, stack_levels_in_one_pass

    memo = StackMemo()
    maps = _maps(LEVELS["fpn"])
    first = memo(list(maps), stack_levels_in_one_pass)
    # another list of the same tensors: the same stack
    assert memo(list(maps), stack_levels_in_one_pass) is first and memo.builds == 1
    # an in-place change makes a new stack, which holds the change
    maps[2].mul_(2.0)
    second = memo(maps, stack_levels_in_one_pass)
    assert second is not first and memo.builds == 2
    assert torch.equal(second, stack_levels(maps))
    # other tensors of the same values are other maps
    clones = [m.clone() for m in maps]
    assert memo(clones, stack_levels_in_one_pass) is not second and memo.builds == 3
    assert memo(maps[:3], stack_levels_in_one_pass) is not None and memo.builds == 4


def test_stack_memo_keys_inference_tensors_on_identity():
    import torch

    from cpm_tpu_torch.ops.cuda.stacked_roi_align import StackMemo
    from cpm_tpu_torch.ops.roi_align import stack_levels_in_one_pass

    memo = StackMemo()
    with torch.inference_mode():
        maps = [m.clone() for m in _maps(LEVELS["fpn"])]
        stack = memo(maps, stack_levels_in_one_pass)
        for _ in range(4):
            assert memo(maps, stack_levels_in_one_pass) is stack
    assert maps[0].is_inference() and memo.builds == 1


def test_stack_memo_keeps_nothing_once_the_maps_die():
    from cpm_tpu_torch.ops.cuda.stacked_roi_align import StackMemo
    from cpm_tpu_torch.ops.roi_align import stack_levels_in_one_pass

    memo = StackMemo()
    maps = _maps(LEVELS["fpn"])
    stack = weakref.ref(memo(maps, stack_levels_in_one_pass))
    assert stack() is not None
    del maps[1]        # one map dies: the entry goes with it
    gc.collect()
    assert stack() is None and memo._entry is None
    # the survivors stack anew
    memo(maps, stack_levels_in_one_pass)
    assert memo.builds == 2


def test_stacks_share_a_stack_only_within_a_scope():
    import torch

    from cpm_tpu_torch.ops.cuda.stacked_roi_align import ForwardStacks
    from cpm_tpu_torch.ops.roi_align import stack_levels

    stacks = ForwardStacks()
    maps = _maps(LEVELS["fpn"])
    # outside a scope the op keeps no state: every call builds
    assert stacks(maps) is not stacks(maps) and stacks.builds == 2
    with stacks.scope():
        first = stacks(maps)
        assert stacks(list(maps)) is first and stacks.builds == 3
        with stacks.scope():   # a nested forward has its own
            assert stacks(maps) is not first and stacks.builds == 4
        assert stacks(maps) is first
    # the scope's memo died with it
    assert stacks._memo.get() is None
    assert stacks(maps) is not first and stacks.builds == 5
    assert torch.equal(first, stack_levels(maps))


def test_stacks_rebuild_after_an_in_place_change_under_inference_mode():
    """Inference tensors keep no version counter: what keeps a map changed in
    place (a reused or static feature buffer) from getting its old stack is
    that a stack lives one forward."""
    import torch

    from cpm_tpu_torch.ops.cuda.stacked_roi_align import ForwardStacks
    from cpm_tpu_torch.ops.roi_align import stack_levels

    stacks = ForwardStacks()
    with torch.inference_mode():
        maps = [m.clone() for m in _maps(LEVELS["widest last"])]
        with stacks.scope():
            before = stacks(maps)
        maps[1].mul_(3.0)
        with stacks.scope():
            after = stacks(maps)
    assert maps[1].is_inference() and stacks.builds == 2
    assert not torch.equal(after, before)
    assert torch.equal(after, stack_levels(maps))


def _tiny_stacked_cfg():
    from cpm_tpu_torch.config import flagship_cfg

    cfg = flagship_cfg(tiny=True)
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.POOLER_KERNEL = "stacked"
    return cfg


def test_eval_forward_pools_within_one_stack_scope_under_stacked():
    """cls, three grid stages and rescore pool the same FPN maps inside one
    scope of `STACKS`, a new one each forward, none left after it."""
    from cpm_tpu_torch.engine.test import make_forward_fn
    from cpm_tpu_torch.modeling.model import build_model
    from cpm_tpu_torch.ops import pooler as pooler_mod
    from cpm_tpu_torch.ops import roi_align as plain
    from cpm_tpu_torch.ops.cuda import stacked_roi_align as op

    cfg = _tiny_stacked_cfg()
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    sizes = np.array([[64, 64], [56, 48]], np.int32)
    scopes = []
    real = plain.roi_align_from_stack
    try:
        forward = make_forward_fn(cfg, build_model(cfg, "cpu", seed=0))
        plain.roi_align_from_stack = lambda *a, **k: scopes.append(
            op.STACKS._memo.get()) or real(*a, **k)
        for n in (1, 2):
            forward(images, sizes)
            assert len(scopes) == 5 * n and scopes[-1] is not None
            assert all(s is scopes[-1] for s in scopes[-5:])
            assert op.STACKS._memo.get() is None
        assert scopes[0] is not scopes[-1]
    finally:
        plain.roi_align_from_stack = real
        pooler_mod.set_pooler_backend("auto")


def test_training_step_pools_within_one_stack_scope_under_stacked():
    """The training step's five pooler calls run inside one scope of
    `STACKS`, and the stacked step gives the `auto` step's losses and
    gradients."""
    import torch

    from cpm_tpu_torch.data.synthetic import synthetic_batch
    from cpm_tpu_torch.engine.train import create_train_state, make_train_step
    from cpm_tpu_torch.ops import pooler as pooler_mod
    from cpm_tpu_torch.ops import roi_align as plain
    from cpm_tpu_torch.ops.cuda import stacked_roi_align as op

    runs, scopes = {}, []
    real = plain.roi_align_from_stack
    plain.roi_align_from_stack = lambda *a, **k: scopes.append(
        op.STACKS._memo.get()) or real(*a, **k)
    try:
        for backend in ("auto", "stacked"):
            cfg = _tiny_stacked_cfg()
            cfg.TPU.POOLER_KERNEL = backend
            model, optimizer, state = create_train_state(cfg, "cpu", seed=0)
            step = make_train_step(cfg, model, optimizer)
            batch = synthetic_batch(2, 64, 64, max_gt=4, num_classes=cfg.MODEL.NUM_CLASSES,
                                    seed=3)
            _, metrics = step(state, batch)
            runs[backend] = ({k: float(v) for k, v in metrics.items()},
                             {k: p.grad for k, p in model.named_parameters() if p.grad is not None})
    finally:
        plain.roi_align_from_stack = real
        pooler_mod.set_pooler_backend("auto")
    assert len(scopes) == 5 and scopes[0] is not None and all(s is scopes[0] for s in scopes)
    assert op.STACKS._memo.get() is None
    (want, want_grads), (got, got_grads) = runs["auto"], runs["stacked"]
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-5), k
    assert set(got_grads) == set(want_grads)
    for k, g in want_grads.items():
        torch.testing.assert_close(got_grads[k], g, rtol=1e-5, atol=1e-6, msg=k)
