"""Data parallelism: the JAX package's ('data',) mesh, and the port's ranks.

The contract first, in the JAX package as it stands: `jit_train_step` over
make_mesh(2) computes what it computes over make_mesh(1) on the same global
batch, to float noise. Under jit, GSPMD keeps the program's meaning whatever
the sharding, so the RPN's per-batch train top-k runs over every image and
the loss normalisers count the whole batch, whatever the docstring of
tests/test_multichip.py::test_dp_sharded_step_matches_single_device says
(per-shard top-k and normalisers); the samplers' draws do not depend on the
mesh either. Both meshes' programs are compiled at XLA's backend
optimisation level 0 to keep the test cheap: the partitioned program is the
same, and both are compiled alike.

The port follows that program. Two gloo ranks on the CPU, each stepping on
one image of the tiny CPM's batch of two (the images hold 1 and 2 gt boxes,
so every count differs between the ranks), are held against the port's one
process on the batch and against the JAX step over make_mesh(2): the same
bridged weights, the same recorded draws
(tests/test_torch_train.py::RecordedUniform, each rank taking its rows), two
steps. Then the pieces: the per-batch top-k and the ISM loss across ranks,
with ties, a masked image and ranks of different candidate counts, against
one process; `Draws` with (rank, world) against the one-process stream; a
world-1 group against no group, bit for bit; `init_data_group` refusing what
it cannot start; and `train_net` on two gloo ranks (4 steps with a snapshot
at 2, and 2 steps then a resume to 4).

Tolerances (f32 on the CPU): the two meshes, losses 1e-5 relative and
parameters rtol 1e-5 / atol 1e-7; the ranks against one process, losses 1e-5
relative and parameters 1e-6 absolute after each step; the ranks against
make_mesh(2), losses 2e-5 relative and parameters rtol 1e-4 / atol 1e-6
after two steps (tests/test_torch_train.py::test_two_steps_match_jax's); the
ranks' parameters equal to the bit after every step; the top-k's kept slots
exactly; the ISM loss's rank shares summed and its gradients 1e-6.

The ranks are spawned processes of one thread (cpm_tpu_torch/parallel/
launch.py), meet through a file store in a fresh directory, and are joined
with a timeout that fails the test; they import this file to find their
functions, so JAX, the JAX package and torch are imported inside the tests
(torch in a test worker at collection has deadlocked tests/test_multichip.py).
"""

import os
import re
import sys
import types

import numpy as np
import pytest
from tests.torch_support import _one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "cfgs", "debug", "tiny_cpm.yaml")
DATA_DIR = os.path.join(REPO, "data")
TIMEOUT_S = 240  # for the ranks of one spawn


@pytest.fixture(scope="module", autouse=True)
def _drop_stub_modules_that_answer_every_name():
    """tests/test_weight_parity.py leaves a stub module in `sys.modules` whose
    `__getattr__` answers every name, `__file__` included, with a function.
    torch registers custom ops when the first optimizer of a process is made
    and looks its caller up with `inspect.getmodule`, which walks
    `sys.modules` and fails on such a `__file__`. Whether that file ran
    before this one in a test worker depends on the scheduling, so the stubs
    go before the first optimizer is built; that file installs them again
    when it needs them."""
    for name, mod in list(sys.modules.items()):
        if isinstance(mod, types.ModuleType) and callable(getattr(mod, "__file__", None)):
            del sys.modules[name]


# ---------------- the JAX package's mesh, and the port's step over ranks ----------------


@pytest.fixture(scope="module")
def dp_runs():
    """Two steps of: the JAX step over make_mesh(1) and over make_mesh(2), the
    port's one process, and the port's two gloo ranks; the port's seeded
    weights bridged into the JAX model, the JAX sampler's recorded draws."""
    import jax
    import jax.numpy as jnp

    from cpm_tpu.engine.train import TrainState, jit_train_step, make_train_step
    from cpm_tpu.modeling.model import build_model as jax_build_model
    from cpm_tpu.parallel.mesh import make_mesh, shard_batch
    from cpm_tpu.solver import build_optimizer as jax_build_optimizer
    from cpm_tpu.solver import make_lr_fn as jax_make_lr_fn
    from cpm_tpu_torch.data.synthetic import synthetic_batch
    from cpm_tpu_torch.modeling.model import build_model
    from cpm_tpu_torch.parallel.launch import spawn_ranks, train_steps
    from cpm_tpu_torch.utils.param_bridge import flax_tree_to_named, state_dict_to_flax
    from tests.test_torch_train import RecordedUniform, _tiny_cfg

    cfg = _tiny_cfg()
    batch = synthetic_batch(2, 64, 64, max_gt=4, num_classes=cfg.MODEL.NUM_CLASSES)
    model = build_model(cfg, "cpu", seed=0)
    start = {k: p.detach().numpy().copy() for k, p in model.named_parameters()}
    jm = jax_build_model(cfg)
    like = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, batch["images"], batch["image_sizes"],
        train=False))["params"]
    params = state_dict_to_flax(
        model.state_dict(), jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), like))
    tx = jax_build_optimizer(cfg, params, jax_make_lr_fn(cfg.SOLVER))
    state0 = TrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params),
                        rng=jax.random.PRNGKey(1))
    step = make_train_step(cfg, jm, tx)

    jax_runs, draws = {}, {}
    mp = pytest.MonkeyPatch()
    try:
        for n in (1, 2):
            recorded = RecordedUniform(7)
            mp.setattr(jax.random, "uniform", recorded)
            mesh = make_mesh(n)
            state = jax.tree_util.tree_map(jnp.array, state0)
            with mesh:
                sharded = shard_batch(batch, mesh)
                fn = jit_train_step(step, mesh).lower(state, sharded).compile(
                    compiler_options={"xla_backend_optimization_level": "0"})
                metrics = []
                for _ in range(2):
                    state, m = fn(state, sharded)
                    metrics.append({k: float(v) for k, v in m.items()})
            jax_runs[n] = dict(metrics=metrics,
                               params=flax_tree_to_named(jax.device_get(state.params),
                                                         {k: v.shape for k, v in start.items()}))
            draws[n] = recorded.arrays
    finally:
        mp.undo()

    spec = dict(cfg=cfg, device="cpu", seed=0, steps=2, batch=batch, draws=draws[2],
                params_after=(1, 2))
    one = train_steps(0, 1, None, spec)
    ranks = spawn_ranks(train_steps, 2, spec, timeout_s=TIMEOUT_S)
    return dict(batch=batch, start=start, jax=jax_runs, draws=draws, one=one, ranks=ranks)


def _assert_losses(got, want, rel, what):
    assert set(got) == set(want), what
    for k, v in want.items():
        assert np.isfinite(v), (what, k)
        assert got[k] == pytest.approx(v, rel=rel, abs=1e-12 if k == "lr" else 0), (what, k)


def test_jax_step_over_two_devices_is_the_one_device_step(dp_runs):
    """The finding that decides the port's semantics (ROADMAP Queue 3)."""
    from tests.test_torch_train import DRAW_SHAPES, LOSS_NAMES

    assert [a.shape for a in dp_runs["draws"][2]] == DRAW_SHAPES
    for a, b in zip(dp_runs["draws"][1], dp_runs["draws"][2]):
        np.testing.assert_array_equal(a, b)
    one, two = dp_runs["jax"][1], dp_runs["jax"][2]
    for i in range(2):
        assert set(LOSS_NAMES) < set(two["metrics"][i])
        _assert_losses(two["metrics"][i], one["metrics"][i], 1e-5, f"step {i + 1}")
    moved = 0
    for k, want in one["params"].items():
        np.testing.assert_allclose(two["params"][k], want, rtol=1e-5, atol=1e-7, err_msg=k)
        moved += int(not np.array_equal(want, dp_runs["start"][k]))
    assert moved > 60


def test_two_ranks_match_the_jax_step_over_two_devices(dp_runs):
    import torch

    want = dp_runs["jax"][2]
    for r, rank in enumerate(dp_runs["ranks"]):
        for i in range(2):
            _assert_losses(rank["metrics"][i], want["metrics"][i], 2e-5, f"rank {r} step {i + 1}")
    got = dp_runs["ranks"][0]["params"][2]
    for k, w in want["params"].items():
        assert got[k].dtype == torch.float32, k
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-4, atol=1e-6, err_msg=k)


def test_two_ranks_match_one_process_and_stay_bit_equal(dp_runs):
    import torch

    batch = dp_runs["batch"]
    # the ranks' images differ in their gt counts, so every count differs
    assert batch["gt_mask"][0].sum() != batch["gt_mask"][1].sum()
    one, (r0, r1) = dp_runs["one"], dp_runs["ranks"]
    assert r0["digests"] == r1["digests"]
    assert r0["metrics"] == r1["metrics"]
    for i in range(2):
        _assert_losses(r0["metrics"][i], one["metrics"][i], 1e-5, f"step {i + 1}")
    for step in (1, 2):
        for k, want in one["params"][step].items():
            got = r0["params"][step][k]
            assert got.dtype == torch.float32 and got.shape == want.shape, k
            diff = (got - want).abs().max().item()
            assert diff <= 1e-6, (step, k, diff)
            assert torch.equal(got, r1["params"][step][k]), (step, k)
    # one rank's step alone: its losses are its shares, not the batch's
    assert r0["step_s"] and all(np.isfinite(s) for s in r0["step_s"])


def test_jax_sampler_draws_do_not_depend_on_the_mesh():
    """The samplers draw `jax.random.uniform(key, mask.shape)` with the mask
    sharded like the batch: the draws of make_mesh(2) are make_mesh(1)'s."""
    import jax

    from cpm_tpu.parallel.mesh import batch_sharding, make_mesh, replicated_sharding

    key = jax.random.fold_in(jax.random.PRNGKey(3), 5)
    mask = np.ones((2, 1023), bool)
    out = {}
    for n in (1, 2):
        mesh = make_mesh(n)
        fn = jax.jit(lambda m, k: jax.random.uniform(k, m.shape) * m,
                     in_shardings=(batch_sharding(mesh), replicated_sharding(mesh)),
                     out_shardings=batch_sharding(mesh))
        with mesh:
            out[n] = np.asarray(jax.device_get(fn(mask, key)))
    np.testing.assert_array_equal(out[1], out[2])
    assert out[2].std() > 0.2


# ---------------- the pieces, across two ranks ----------------


def _topk_cases():
    """name -> (per-rank scores [B_r, N_r], per-rank valid, k): ties at the
    k-th score, an image with no valid slot, and ranks of different batch
    and candidate counts."""
    rng = np.random.RandomState(0)
    ties = [np.round(rng.rand(1, 12) * 4) / 4 for _ in range(2)]
    masked = [rng.rand(1, 10), rng.rand(1, 10)]
    uneven = [rng.rand(1, 9), rng.rand(2, 5)]
    return {
        "ties": (ties, [rng.rand(*s.shape) > 0.2 for s in ties], 7),
        "masked_image": (masked, [rng.rand(1, 10) > 0.3, np.zeros((1, 10), bool)], 6),
        "uneven_counts": (uneven, [rng.rand(*s.shape) > 0.2 for s in uneven], 8),
        "k_above_every_slot": (uneven, [np.ones(s.shape, bool) for s in uneven], 40),
    }


def _ism_cases():
    """name -> per-rank (pred [N_r, 2], target [N_r, 2], valid [N_r]): the
    global batch's first valid rows on rank 0, split between the ranks, or
    on rank 1 alone."""
    rng = np.random.RandomState(1)

    def rank_inputs(n, n_valid_first):
        iou = rng.rand(n) * (rng.rand(n) > 0.3)
        valid = np.zeros(n, bool)
        valid[rng.permutation(n)[:n_valid_first]] = True
        return (rng.randn(n, 2).astype(np.float32), np.stack([1 - iou, iou], -1).astype(np.float32),
                valid)

    return {
        "first_rows_on_rank0": [rank_inputs(6, 4), rank_inputs(4, 3)],
        "one_valid_row_on_rank0": [rank_inputs(5, 1), rank_inputs(6, 4)],
        "none_on_rank0": [rank_inputs(4, 0), rank_inputs(7, 5)],
    }


def _rank_checks(rank, world_size, workdir):
    """A rank's part in the checks of the pieces: keep_batch_top_k and
    ism_l2_loss on its inputs, batch_total, concat_ranks and ranks_agree
    (rank 1 moves one parameter by one ulp)."""
    import torch

    from cpm_tpu_torch.modeling.rpn import keep_batch_top_k
    from cpm_tpu_torch.ops.losses import ism_l2_loss
    from cpm_tpu_torch.parallel.launch import file_init_method
    from cpm_tpu_torch.parallel.mesh import (
        batch_total,
        concat_ranks,
        destroy_data_group,
        init_data_group,
        ranks_agree,
    )

    group = init_data_group("cpu", rank=rank, world_size=world_size, local_rank=rank,
                            init_method=file_init_method(workdir, "checks"))
    try:
        out = dict(group=(group.rank, group.world_size, str(group.device), group.backend))
        for name, (scores, valid, k) in _topk_cases().items():
            s = torch.tensor(scores[rank], dtype=torch.float32)
            v = torch.tensor(valid[rank])
            masked = torch.where(v, s, torch.finfo(s.dtype).min)
            out["topk", name] = keep_batch_top_k(masked, v, k)
        for name, per_rank in _ism_cases().items():
            pred, target, valid = (torch.tensor(a) for a in per_rank[rank])
            pred.requires_grad_(True)
            loss = ism_l2_loss(pred, target, valid)
            loss.backward()
            out["ism", name] = (loss.detach(), pred.grad)
        out["total"] = batch_total(torch.tensor([rank + 1.0, 10.0]))
        out["concat"] = concat_ranks(torch.full((2, 2), float(rank)))
        torch.manual_seed(0)
        model = torch.nn.Sequential(torch.nn.Linear(3, 2), torch.nn.BatchNorm1d(2))
        out["agree"] = ranks_agree(model)
        if rank == 1:
            with torch.no_grad():
                model[0].bias[1] = torch.nextafter(model[0].bias[1], torch.tensor(2.0))
        out["drifted"] = ranks_agree(model)
        return out
    finally:
        destroy_data_group()


@pytest.fixture(scope="module")
def rank_checks():
    from cpm_tpu_torch.parallel.launch import spawn_ranks

    return spawn_ranks(_rank_checks, 2, timeout_s=TIMEOUT_S)


@pytest.mark.parametrize("case", ["ties", "masked_image", "uneven_counts", "k_above_every_slot"])
def test_batch_top_k_across_ranks_matches_one_process(rank_checks, case):
    import torch

    from cpm_tpu_torch.modeling.rpn import keep_batch_top_k
    from cpm_tpu_torch.ops.nms import topk

    scores, valid, k = _topk_cases()[case]
    neg = np.finfo(np.float32).min
    masked = [np.where(v, s, neg).astype(np.float32) for s, v in zip(scores, valid)]
    # one process: the k-th of the whole batch's flat scores, in rank order
    flat = torch.tensor(np.concatenate([m.reshape(-1) for m in masked]))
    kth = topk(flat, min(k, flat.shape[0]))[0][-1].item()
    for r, (m, v) in enumerate(zip(masked, valid)):
        want = v & (m >= kth)
        assert np.array_equal(rank_checks[r]["topk", case].numpy(), want), r
    if all(m.shape[1] == masked[0].shape[1] for m in masked):
        # and the one-process path itself on the concatenated batch
        got = keep_batch_top_k(torch.tensor(np.concatenate(masked)),
                               torch.tensor(np.concatenate(valid)), k)
        assert np.array_equal(got.numpy(), np.concatenate(
            [rank_checks[r]["topk", case].numpy() for r in range(2)]))
    if case == "ties":
        # the k-th score is tied, and the ties keep more than k slots
        assert (flat == kth).sum() > 1
        assert sum(int(rank_checks[r]["topk", case].sum()) for r in range(2)) > k


@pytest.mark.parametrize("case", ["first_rows_on_rank0", "one_valid_row_on_rank0", "none_on_rank0"])
def test_ism_loss_across_ranks_sums_to_one_process(rank_checks, case):
    import torch

    from cpm_tpu_torch.ops.losses import ism_l2_loss

    per_rank = _ism_cases()[case]
    pred = torch.tensor(np.concatenate([p for p, _, _ in per_rank]), requires_grad=True)
    loss = ism_l2_loss(pred, torch.tensor(np.concatenate([t for _, t, _ in per_rank])),
                       torch.tensor(np.concatenate([v for _, _, v in per_rank])))
    loss.backward()
    shares = [rank_checks[r]["ism", case] for r in range(2)]
    assert float(shares[0][0] + shares[1][0]) == pytest.approx(float(loss.detach()), rel=1e-6)
    grads = torch.cat([g for _, g in shares])
    np.testing.assert_allclose(grads.numpy(), pred.grad.numpy(), rtol=1e-6, atol=1e-6)
    if case == "none_on_rank0":
        # rank 0 holds no valid row, so none of the quirk's terms
        assert float(shares[0][0]) == 0.0


def test_batch_total_and_concat_ranks(rank_checks):
    for r in range(2):
        assert rank_checks[r]["group"] == (r, 2, "cpu", "gloo")
        assert rank_checks[r]["total"].tolist() == [3.0, 20.0]
        assert rank_checks[r]["concat"].tolist() == [[0.0, 0.0], [0.0, 0.0], [1.0, 1.0], [1.0, 1.0]]


def test_ranks_agree_finds_a_rank_one_bit_away(rank_checks):
    for r in range(2):
        assert rank_checks[r]["agree"] is True
        assert rank_checks[r]["drifted"] is False


def test_draws_hand_each_rank_its_rows_of_the_global_draw():
    import torch

    from cpm_tpu_torch.utils.sampler import Draws

    shapes = [(1, 7), (1, 5, 4), (1, 3)]
    one = Draws(torch.Generator().manual_seed(3))
    want = [one((2,) + s[1:], "cpu") for s in shapes]
    for rank in range(2):
        draws = Draws(torch.Generator().manual_seed(3), rank, 2)
        for s, w in zip(shapes, want):
            assert torch.equal(draws(s, "cpu"), w[rank:rank + 1])
        assert draws.shapes == shapes
    arrays = [w.numpy() for w in want]
    for rank in range(2):
        draws = Draws(arrays, rank, 2)
        for s, w in zip(shapes, want):
            assert torch.equal(draws(s, "cpu"), w[rank:rank + 1])
    with pytest.raises(ValueError, match="wanted"):
        Draws(arrays, 0, 2)((2, 7), "cpu")
    with pytest.raises(ValueError, match="rank"):
        Draws(arrays, 2, 2)


def test_world_one_group_keeps_the_steps_bits(tmp_path):
    """A world-1 gloo group runs every collective of the step (the all-reduces
    of the counts, the top-k's gather, the gradient buckets) and leaves the
    one-process step's bits alone. On one thread: the CPU's backward
    convolutions sum in a thread-dependent order on several."""
    import torch
    import torch.distributed as dist

    from cpm_tpu_torch.data.synthetic import synthetic_batch
    from cpm_tpu_torch.parallel.launch import train_steps
    from tests.test_torch_train import _tiny_cfg

    cfg = _tiny_cfg()
    spec = dict(cfg=cfg, device="cpu", seed=0, steps=2,
                batch=synthetic_batch(2, 64, 64, max_gt=4, num_classes=cfg.MODEL.NUM_CLASSES),
                profile_step=2)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        plain = train_steps(0, 1, None, spec)
        grouped = train_steps(0, 1, str(tmp_path), dict(spec, group=True))
    finally:
        torch.set_num_threads(threads)
    assert not dist.is_initialized()
    assert grouped["digests"] == plain["digests"]
    assert grouped["metrics"] == plain["metrics"]
    # the allreduce span is there, with and without a group
    assert plain["allreduce_s"] is not None and grouped["allreduce_s"] > 0


def test_init_data_group_raises_rather_than_fall_back(tmp_path, monkeypatch):
    import torch
    import torch.distributed as dist

    from cpm_tpu_torch.parallel.launch import file_init_method
    from cpm_tpu_torch.parallel.mesh import init_data_group, rank_device

    # the first LOCAL_RANK beyond the visible cards, with or without a card
    beyond = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match=f"LOCAL_RANK {beyond}"):
        rank_device("cuda", beyond)
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("LOCAL_RANK", str(beyond + 3))
    with pytest.raises(RuntimeError, match=f"LOCAL_RANK {beyond + 3}"):
        init_data_group("cuda", init_method=file_init_method(str(tmp_path), "cuda"))
    # NCCL named on a process without it: no gloo in its place
    with pytest.raises((RuntimeError, ValueError)):
        init_data_group("cpu", backend="nccl", init_method=file_init_method(str(tmp_path), "nccl"))
    assert not dist.is_initialized()
    monkeypatch.delenv("RANK")
    with pytest.raises(RuntimeError, match="RANK is not set"):
        init_data_group("cpu")


# ---------------- train_net on two ranks ----------------


def _train_net_rank(rank, world_size, workdir, ckpt_root):
    """A rank of torchrun's: 4 steps with a snapshot at 2 into one CKPT, and 2
    steps then a resume to 4 into another; what this rank wrote, its steps'
    records and its parameters' hash after each run."""
    import torch

    from cpm_tpu_torch.parallel.launch import file_init_method, params_digest
    from cpm_tpu_torch.tools import train_net

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world_size), LOCAL_RANK=str(rank))
    written, real_save = [], torch.save

    def save(obj, f, *args, **kwargs):
        written.append(os.path.basename(str(f)))
        return real_save(obj, f, *args, **kwargs)

    torch.save = save
    try:
        out = {}
        for run, ckpt, max_iter in (("straight", "a", 4), ("stopped", "b", 2), ("resumed", "b", 4)):
            argv = ["--cfg", TINY, "--device", "cpu",
                    "--init-method", file_init_method(workdir, run),
                    "CKPT", os.path.join(ckpt_root, ckpt), "DATA_DIR", DATA_DIR,
                    "SOLVER.SNAPSHOT_ITERS", "2", "SOLVER.MAX_ITER", str(max_iter)]
            args = train_net.parse_args(argv, train_net.train_arg_parser())
            history, state = train_net.train(args)
            out[run] = dict(history=history, digest=params_digest(state.model),
                            written=list(written))
            written.clear()
        return out
    finally:
        torch.save = real_save


def _losses(history):
    """The steps' records without their wall times."""
    return [{k: v for k, v in h.items() if k not in ("step_s", "wait_s")} for h in history]


def test_train_net_on_two_gloo_ranks_snapshots_from_rank0_and_resumes(tmp_path):
    import torch

    from cpm_tpu_torch.parallel.launch import spawn_ranks

    r0, r1 = spawn_ranks(_train_net_rank, 2, str(tmp_path), timeout_s=TIMEOUT_S)
    for run in ("straight", "stopped", "resumed"):
        assert r1[run]["written"] == [], run
        assert r0[run]["written"], run
        assert r0[run]["digest"] == r1[run]["digest"], run
        assert r0[run]["history"]
        assert _losses(r0[run]["history"]) == _losses(r1[run]["history"]), run
    assert sorted(os.listdir(tmp_path / "a")) == sorted(
        ["model_iter2", "model_iter4", "model_latest", "tiny_cpm.yaml"])
    # the resumed run: the uninterrupted run's losses and bits
    straight = r0["straight"]["history"]
    split = r0["stopped"]["history"] + r0["resumed"]["history"]
    assert [h["iter"] for h in split] == [1, 2, 3, 4]
    assert _losses(split) == _losses(straight)
    assert r0["resumed"]["digest"] == r0["straight"]["digest"]
    a = torch.load(tmp_path / "a" / "model_latest", weights_only=True)
    b = torch.load(tmp_path / "b" / "model_latest", weights_only=True)
    assert a["step"] == b["step"] == 4
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k


def test_check_data_parallel_tool_on_two_cpu_ranks(capsys):
    """The card's check of N ranks against one process
    (cpm_tpu_torch/tools/check_data_parallel.py), on two gloo ranks on the
    CPU with the tiny config: its checks pass and it prints each rank."""
    from cpm_tpu_torch.tools import check_data_parallel

    check_data_parallel.main(["--ranks", "2", "--device", "cpu", "--cfg", TINY, "--steps", "2"])
    out = capsys.readouterr().out
    assert "[dp check] 2 ranks (gloo), one image each" in out
    assert "the ranks bit-equal after each of 2 steps" in out
    assert "[dp check] rank 1: step wall times" in out
    calls = re.search(r"rank 0: .* step 2: (\d+) torch.distributed calls", out)
    assert calls and int(calls.group(1)) > 0, out


def test_check_torchrun_tool_on_two_cpu_ranks(capsys):
    """train_net as a user starts it, under torchrun (env:// rendezvous), on
    two gloo ranks with the tiny config (cpm_tpu_torch/tools/check_torchrun.py):
    each run checks its ranks bit-equal, and the stopped and resumed run's
    checkpoints are the straight run's to the bit."""
    from cpm_tpu_torch.tools import check_torchrun

    check_torchrun.main(["--ranks", "2", "--device", "cpu", "--cfg", TINY])
    out = capsys.readouterr().out
    for what in ("straight", "stopped", "resumed"):
        assert f"[torchrun check] {what} run" in out
    assert out.count("train_net: the 2 ranks' parameters and buffers bit-equal") == 3
    assert "auto-resumed from iter 2" in out
    assert "model_latest bit-equal to the straight run's" in out
