"""Where an eval request and a training step make the host wait for the card.

    python3 -m cpm_tpu_torch.tools.sync_sites [--config flagship|x101_dcn] [--batch 2]

Builds the model as tools/profile_train.py does (seeded random weights, the
offset convs spread, the trunk's affines folded, GRID_RCNN.SCORE_THRESH 0.0
so that every stage pools a full detection set), warms up, then runs one
eval request (batch 1 at 800x1344, uint8 numpy as TestLoader gives it) and
one training step (a synthetic uint8 batch of `--batch` images at 800x1344)
under `torch.cuda.set_sync_debug_mode("warn")`. Each warning is one call
that waited for the card. A site is the innermost frame of the port under
the call; it is covered when a `with sync(...)` statement (utils/spans.py)
encloses that frame's line or the line of one of its callers in the port,
and the span is `cpm/sync/<site>`. Prints a line a site and phase: the
count, file:line, function, the source line and the span, or "no span";
the card's name and power limit close each line. Waits that autograd's
thread makes in the backward are reported by torch at the `backward()` call.
"""

import argparse
import ast
import collections
import functools
import linecache
import sys
import traceback
import warnings
from pathlib import Path

PORT = Path(__file__).resolve().parents[1]


@functools.lru_cache(maxsize=None)
def _sync_blocks(path: str):
    """(first line, last line, span) of every `with sync("<site>")` block in
    the file at `path`."""
    blocks = []
    for node in ast.walk(ast.parse(Path(path).read_text())):
        if not isinstance(node, ast.With):
            continue
        for item in node.items:
            call = item.context_expr
            if (isinstance(call, ast.Call) and getattr(call.func, "id", None) == "sync"
                    and call.args and isinstance(call.args[0], ast.Constant)):
                blocks.append((node.lineno, node.end_lineno, "cpm/sync/" + call.args[0].value))
    return tuple(blocks)


def covering_span(frames):
    """The `cpm/sync/` span whose `with` statement encloses the line of the
    innermost frame of `frames` (innermost last, as `traceback.extract_stack`
    gives them) that any such statement encloses, among frames in the port;
    None where none does."""
    for f in reversed(frames):
        if not f.filename.startswith(str(PORT)):
            continue
        inner = [b for b in _sync_blocks(f.filename) if b[0] <= f.lineno <= b[1]]
        if inner:
            return max(inner)[2]
    return None


def site_of(frames):
    """The innermost frame of `frames` in the port, or the innermost frame."""
    ours = [f for f in frames if f.filename.startswith(str(PORT))]
    return (ours or frames)[-1]


class SyncLog:
    """Catches torch's sync-debug warnings and tallies them by phase, site
    and covering span."""

    def __init__(self):
        self.phase = None
        self.counts = collections.Counter()

    def showwarning(self, message, category, filename, lineno, file=None, line=None):
        if self.phase is None or "synchronizing" not in str(message):
            return
        frames = traceback.extract_stack()[:-1]
        f = site_of(frames)
        self.counts[(self.phase, f.filename, f.lineno, f.name, covering_span(frames))] += 1

    def lines(self, card: str):
        for (phase, path, lineno, name, span), n in sorted(
                self.counts.items(), key=lambda kv: tuple(str(x) for x in kv[0][:3])):
            where = Path(path).relative_to(PORT.parent) if path.startswith(str(PORT)) else path
            src = linecache.getline(path, lineno).strip()
            yield (f"[sync] {phase}: x{n} {where}:{lineno} {name}: {src[:70]} -> "
                   f"{span or 'no span'} | {card}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="flagship", choices=("flagship", "x101_dcn"))
    ap.add_argument("--batch", type=int, default=2, help="images of the training step")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("sync_sites: needs a CUDA device")
    from cpm_tpu_torch.data.synthetic import synthetic_batch
    from cpm_tpu_torch.engine.test import make_forward_fn
    from cpm_tpu_torch.engine.train import create_train_state, make_train_step
    from cpm_tpu_torch.tools.profile_eval import card_line, make_request
    from cpm_tpu_torch.tools.profile_train import (
        fold_batch_statistics,
        spread_offset_convs,
        training_cfg,
    )

    card = card_line()
    cfg = training_cfg(args.config)
    cfg.GRID_RCNN.SCORE_THRESH = 0.0
    model, optimizer, state = create_train_state(cfg, "cuda", seed=0)
    spread_offset_convs(model, seed=1)
    step_fn = make_train_step(cfg, model, optimizer)

    def batch_for(seed):
        return synthetic_batch(args.batch, 800, 1344, max_gt=32,
                               num_classes=cfg.MODEL.NUM_CLASSES, seed=seed, uint8=True)

    fold_batch_statistics(model, batch_for(99)["images"])
    request = make_request(np.random.RandomState(0), [(800, 1333)])
    batches = [batch_for(100 + i) for i in range(3)]
    for b in batches[:2]:
        state, _ = step_fn(state, b)
    forward = make_forward_fn(cfg, model)
    for _ in range(2):
        forward(*request)
    torch.cuda.synchronize()

    log = SyncLog()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = log.showwarning
        torch.cuda.set_sync_debug_mode("warn")
        try:
            log.phase = "eval"
            forward(*request)
            log.phase = "train"
            state, _ = step_fn(state, batches[2])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    for phase in ("eval", "train"):
        n = sum(v for k, v in log.counts.items() if k[0] == phase)
        covered = sum(v for k, v in log.counts.items() if k[0] == phase and k[4])
        print(f"[sync] {args.config} {phase}: {n} waits, {covered} under a cpm/sync/ span | {card}")
    for line in log.lines(card):
        print(line)


if __name__ == "__main__":
    main()
