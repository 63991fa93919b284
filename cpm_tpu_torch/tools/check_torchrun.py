"""train_net under torchrun on N ranks: a straight run against a stopped and resumed one.

    python3 -m cpm_tpu_torch.tools.check_torchrun [--ranks N] [--device cuda|cpu]
        [--cfg file.yaml] [KEY VALUE ...]

What a user runs, `torchrun --standalone --nproc_per_node N -m
cpm_tpu_torch.tools.train_net`, three times, each run a group of its own: 4
steps with a snapshot at 2 into one CKPT, then 2 steps into another and a
resume to 4 there. The config is a YAML's (by default the headline CPM
R-50-FPN YAML) over the repository's synthetic COCO set at 2 images a rank
(TRAIN.BATCH_SIZE 2N at SOLVER.BASE_LR 0.02 for 16 images scaled to 2N),
in its own compute dtype. Every run starts from one step-0 checkpoint,
seeded with the frozen affines folded from the loader's first batch (a
random trunk with unit affines diverges), written into both CKPTs before
the first run. train_net itself raises unless its ranks' parameters are
bit-equal at its end. Then the stopped run's model_iter2 must equal the
straight run's, and the resumed run's model_latest the straight run's:
parameters, buffers, optimizer state, step and draws, to the bit. It prints,
beside the card's name and power limit, each run's wall time and rank 0's
lines; any failure raises.
"""

import argparse
import os
import subprocess
import sys
import tempfile
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
STEPS, SNAPSHOT = 4, 2
TIMEOUT_S = 900  # for one torchrun


def differences(a, b, prefix: str = "") -> list:
    """The keys of two checkpoints (nested dicts and lists of tensors and
    numbers) whose values are not equal to the bit."""
    if isinstance(a, dict) and isinstance(b, dict):
        if sorted(a, key=str) != sorted(b, key=str):
            return [f"{prefix}: keys {sorted(a, key=str)} vs {sorted(b, key=str)}"]
        return [d for k in a for d in differences(a[k], b[k], f"{prefix}/{k}")]
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return [f"{prefix}: {len(a)} vs {len(b)} items"]
        return [d for i, (x, y) in enumerate(zip(a, b)) for d in differences(x, y, f"{prefix}/{i}")]
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        same = a.dtype == b.dtype and a.shape == b.shape and torch.equal(
            *(t.contiguous().reshape(-1).view(torch.uint8) for t in (a, b)))
        return [] if same else [prefix]
    return [] if a == b else [f"{prefix}: {a!r} vs {b!r}"]


def torchrun(n: int, argv: list, what: str) -> str:
    """`torchrun --standalone --nproc_per_node n -m cpm_tpu_torch.tools.train_net
    argv` from the repository's root; raises with its output when it fails.
    Returns its standard output."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(n), "-m", "cpm_tpu_torch.tools.train_net"] + argv
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    try:
        run = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True,
                             timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        raise RuntimeError(f"[torchrun check] {what}: no end within {TIMEOUT_S} s\n"
                           f"{e.stdout}\n{e.stderr}") from e
    if run.returncode != 0:
        raise RuntimeError(f"[torchrun check] {what}: exit {run.returncode}\n"
                           f"{run.stdout[-4000:]}\n{run.stderr[-8000:]}")
    return run.stdout


def main(argv=None):
    from cpm_tpu_torch.engine.checkpoint import CheckPointer
    from cpm_tpu_torch.tools.check_data_parallel import HEADLINE_YAML, step0_state
    from cpm_tpu_torch.tools.train_net import load_config

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cfg", default=os.path.join(REPO, HEADLINE_YAML))
    ap.add_argument("opts", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    n = args.ranks
    cuda = args.device == "cuda"
    if cuda and torch.cuda.device_count() < n:
        raise RuntimeError(f"{n} ranks, one card each, and {torch.cuda.device_count()} cards "
                           "are visible")
    card = "cpu"
    if cuda:
        from cpm_tpu_torch.tools.profile_eval import card_line

        card = card_line()
    opts = ["TRAIN.DATASETS", "('coco_debug_synthetic',)", "DATA_DIR", os.path.join(REPO, "data"),
            "TRAIN.BATCH_SIZE", str(2 * n), "SOLVER.BASE_LR", str(0.02 * 2 * n / 16),
            "SOLVER.SNAPSHOT_ITERS", str(SNAPSHOT)] + args.opts
    cfg = load_config(args.cfg, opts)
    t_all = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="cpm_torchrun_") as tmp:
        ckpts = {name: os.path.join(tmp, name) for name in ("straight", "split")}
        state, _ = step0_state(cfg, args.device, cfg.TRAIN.BATCH_SIZE)
        for ckpt in ckpts.values():
            CheckPointer(ckpt).save(state, 0)
        del state
        if cuda:
            torch.cuda.empty_cache()
        for what, ckpt, max_iter in (("straight", ckpts["straight"], STEPS),
                                     ("stopped", ckpts["split"], SNAPSHOT),
                                     ("resumed", ckpts["split"], STEPS)):
            t0 = time.perf_counter()
            out = torchrun(n, ["--cfg", args.cfg, "--device", args.device] + opts
                           + ["CKPT", ckpt, "SOLVER.MAX_ITER", str(max_iter)], what)
            seconds = time.perf_counter() - t0
            lines = [line for line in out.splitlines() if line.startswith("train_net:")
                     or "auto-resumed" in line]
            if not any("bit-equal" in line for line in lines):
                raise AssertionError(f"[torchrun check] {what}: train_net did not check its "
                                     f"ranks:\n{out}")
            print(f"[torchrun check] {what} run to iter {max_iter}: {seconds:.1f} s | {card}")
            for line in lines:
                print(f"[torchrun check]   {line}")

        def load(name, file):
            return torch.load(os.path.join(ckpts[name], file), map_location="cpu",
                              weights_only=False)

        for what, a, b in (("model_iter2", load("straight", "model_iter2"),
                            load("split", "model_iter2")),
                           ("model_latest", load("straight", "model_latest"),
                            load("split", "model_latest"))):
            differ = differences(a, b)
            if differ:
                raise AssertionError(f"[torchrun check] {what}: the stopped and resumed run "
                                     f"differs from the straight one at {differ[:5]}")
        print(f"[torchrun check] {n} ranks under torchrun ({'NCCL, a card each' if cuda else 'gloo'}"
              f", {os.path.basename(args.cfg)}, 2 images a rank): the stopped run's model_iter2 "
              f"and the resumed run's model_latest bit-equal to the straight run's ({len(a['model'])}"
              f" model tensors, optimizer state, step {a['step']}, draws); all "
              f"{time.perf_counter() - t_all:.1f} s | {card}")


if __name__ == "__main__":
    main(sys.argv[1:])
