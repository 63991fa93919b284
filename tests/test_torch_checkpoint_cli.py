"""The port's checkpoints and train CLI on the CPU.

A checkpoint's save and load round trip is bit-equal (parameters, momentum,
step and the samplers' generator state); `train_net.main` on
cfgs/debug/tiny_cpm.yaml over the repository's synthetic COCO set trains 4
steps in one go, and 2 steps then a resume to 4, with bit-equal final
state_dicts and logged losses, and the snapshot layout of the JAX package;
the CLI refuses `cuda` where there is no card and an existing TRAIN.WEIGHTS
file that is no torch checkpoint (tests/test_torch_weight_import.py loads
real ones).

torch and the port's modules are imported inside the tests, so that
collecting this file loads no torch into a test worker.
"""

import os
import sys
import types

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "cfgs", "debug", "tiny_cpm.yaml")
DATA_DIR = os.path.join(REPO, "data")


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


def _argv(ckpt, *opts, device="cpu"):
    argv = ["--cfg", TINY] + (["--device", device] if device else [])
    return argv + ["CKPT", str(ckpt), "DATA_DIR", DATA_DIR, "SOLVER.SNAPSHOT_ITERS", "2", *opts]


def _tensors_equal(a, b):
    import torch

    if isinstance(a, dict):
        return set(a) == set(b) and all(_tensors_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_tensors_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def test_checkpoint_round_trip_is_bit_equal(tmp_path):
    import torch

    from cpm_tpu_torch.config import flagship_cfg
    from cpm_tpu_torch.data.synthetic import synthetic_batch
    from cpm_tpu_torch.engine.checkpoint import CheckPointer
    from cpm_tpu_torch.engine.train import create_train_state, make_train_step

    cfg = flagship_cfg(tiny=True)
    cfg.TPU.COMPUTE_DTYPE = "float32"
    model, optimizer, state = create_train_state(cfg, "cpu", seed=0)
    state, _ = make_train_step(cfg, model, optimizer)(
        state, synthetic_batch(2, 64, 64, max_gt=4, num_classes=9, seed=3))
    checkpointer = CheckPointer(str(tmp_path))
    assert not checkpointer.resumed
    assert CheckPointer(str(tmp_path / "empty")).load(state) is None
    checkpointer.save(state, state.step, snapshot=True)
    assert sorted(os.listdir(tmp_path)) == ["empty", "model_iter1", "model_latest"]

    model2, optimizer2, fresh = create_train_state(cfg, "cpu", seed=1)
    assert not _tensors_equal(model2.state_dict(), model.state_dict())
    reloaded = CheckPointer(str(tmp_path))
    assert reloaded.resumed
    assert reloaded.load(fresh) is fresh and fresh.step == state.step == 1
    assert _tensors_equal(model2.state_dict(), model.state_dict())
    assert optimizer.state and _tensors_equal(optimizer2.state_dict(), optimizer.state_dict())
    # the samplers draw on where the saved run's draws left off
    assert torch.equal(fresh.draws((3, 5), "cpu"), state.draws((3, 5), "cpu"))
    with pytest.raises(TypeError):
        type(state.draws)([np.zeros(3, np.float32)]).state_dict()


def test_resumed_training_equals_the_uninterrupted_run(tmp_path):
    import torch

    from cpm_tpu_torch.tools import train_net

    straight = train_net.main(_argv(tmp_path / "a", "SOLVER.MAX_ITER", "4"))
    first = train_net.main(_argv(tmp_path / "b", "SOLVER.MAX_ITER", "2"))
    resumed = train_net.main(_argv(tmp_path / "b", "SOLVER.MAX_ITER", "4"))
    assert [r["iter"] for r in straight] == [1, 2, 3, 4]
    assert [r["iter"] for r in first + resumed] == [1, 2, 3, 4]

    losses = [k for k in straight[0] if k.startswith("loss_")]
    assert len(losses) == 8
    for a, b in zip(straight, first + resumed):
        for k in losses + ["total_loss", "lr"]:
            assert a[k] == b[k], (a["iter"], k)
            assert np.isfinite(a[k])

    for run in ("a", "b"):
        assert sorted(os.listdir(tmp_path / run)) == [
            "model_iter2", "model_iter4", "model_latest", "tiny_cpm.yaml"]
    a, b = (torch.load(tmp_path / run / "model_latest", weights_only=True) for run in ("a", "b"))
    assert a["step"] == b["step"] == 4
    assert _tensors_equal(a["model"], b["model"])
    assert _tensors_equal(a["optimizer"], b["optimizer"])
    assert _tensors_equal(a["draws"], b["draws"])
    snap = torch.load(tmp_path / "a" / "model_iter4", weights_only=True)
    assert _tensors_equal(snap["model"], a["model"])
    two = torch.load(tmp_path / "a" / "model_iter2", weights_only=True)
    assert two["step"] == 2 and not _tensors_equal(two["model"], a["model"])
    # a run that is already at MAX_ITER takes no step and leaves the files alone
    mtime = os.stat(tmp_path / "b" / "model_latest").st_mtime_ns
    assert train_net.main(_argv(tmp_path / "b", "SOLVER.MAX_ITER", "4")) == []
    assert os.stat(tmp_path / "b" / "model_latest").st_mtime_ns == mtime


def test_train_cli_runs_on_the_card_unless_told_cpu(tmp_path, monkeypatch):
    import torch

    from cpm_tpu_torch.tools import train_net

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_net.main(_argv(tmp_path, "SOLVER.MAX_ITER", "1", device=None))
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_net.main(_argv(tmp_path, "SOLVER.MAX_ITER", "1", device="cuda"))
    assert not os.path.exists(tmp_path / "model_latest")


def test_existing_train_weights_raise(tmp_path):
    from cpm_tpu_torch.tools import train_net

    weights = tmp_path / "resnet50_caffe.pth"
    weights.write_bytes(b"")  # no torch checkpoint: torch.load runs out of input
    with pytest.raises(EOFError):
        train_net.main(_argv(tmp_path, "TRAIN.WEIGHTS", str(weights)))
    # a TRAIN.WEIGHTS that does not exist is no file to import, as in the JAX CLI
    assert len(train_net.main(_argv(tmp_path / "run", "SOLVER.MAX_ITER", "1",
                                    "TRAIN.WEIGHTS", str(tmp_path / "absent.pth")))) == 1
