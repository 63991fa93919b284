"""What decides `correct`: the numbers by which the port's timed output
departs from the plain reference's, each held to its limit.

Serving: the cell's head replay (replay.py, replays/<head>.py), the
reference following each checked request from the port's rois at its
pooler calls.

Training (the first three steps, driven through the window's own call and
feed):
  loss_gap     worst step's |total loss - reference's| / |reference's|
  grad_gap     worst leaf's gap between the norms of the first gradient (as
               the optimizer got it) and the reference's, over the larger
               of the reference leaf's norm and the median leaf's
  delta_gap    the same for each leaf's change over the three steps
  grad_med,    the median leaf's gap of each: steady from seed to seed where
  delta_med    the worst leaf is not
and the replay's stage checks (`proposal_stage`, `sampler_stage` where the
trunk has deformable convs, the head's own).

Leaves whose reference gradient is under a thousandth of the median leaf's
move by round-off alone and are left out, by that rule and not by name.

Limits live in `benchmark/limits/<cell>.json`, each with the readings it was
set from; a number without a limit is printed and not judged.
"""

import math
import statistics
from typing import Dict, List

QUIET_LEAF = 1e-3


def _leaf_gaps(got: Dict[str, float], want: Dict[str, float], keep) -> List[float]:
    norms = [want[k] for k in keep]
    if not norms:
        return [math.inf]
    med = statistics.median(norms)
    gaps = []
    for k in keep:
        g = got.get(k, math.nan)
        gaps.append(abs(g - want[k]) / max(want[k], med, 1e-30) if math.isfinite(g) else math.inf)
    return gaps


def train_numbers(got: dict, want: dict) -> Dict[str, float]:
    """got / want: dict(losses=[total loss of steps 1-3], grad={leaf: norm},
    delta={leaf: norm}) of the port and of the reference (None where the
    reference could not follow the port: every number infinite); `want`
    also carries the stage checks' readings."""
    if want is None:
        return dict(loss_gap=math.inf, grad_gap=math.inf, delta_gap=math.inf, grad_med=math.inf,
                    delta_med=math.inf, proposal_stage=math.inf, decode_stage=math.inf,
                    sampler_stage=math.inf)
    loss_gap = 0.0
    for g, w in zip(got["losses"], want["losses"]):
        if not math.isfinite(g):
            loss_gap = math.inf
            break
        loss_gap = max(loss_gap, abs(g - w) / max(abs(w), 1e-30))
    grads = want["grad"]
    med = statistics.median(grads.values()) if grads else 0.0
    keep = [k for k, v in grads.items() if v >= QUIET_LEAF * med]
    grad = _leaf_gaps(got["grad"], grads, keep)
    delta = _leaf_gaps(got["delta"], want["delta"], keep)
    stages = {k: v for k, v in want.items() if k.endswith("_stage")}
    return dict(loss_gap=loss_gap, grad_gap=max(grad), delta_gap=max(delta),
                grad_med=statistics.median(grad), delta_med=statistics.median(delta), **stages)


def worst_leaves(got: dict, want: dict) -> Dict[str, str]:
    """The leaves that set grad_gap and delta_gap (calibrate.py prints
    them beside the numbers)."""
    if want is None:
        return {}
    grads = want["grad"]
    med = statistics.median(grads.values()) if grads else 0.0
    keep = [k for k, v in grads.items() if v >= QUIET_LEAF * med]
    out = {}
    for name, key in (("grad_leaf", "grad"), ("delta_leaf", "delta")):
        gaps = _leaf_gaps(got[key], want[key], keep)
        out[name] = keep[max(range(len(keep)), key=gaps.__getitem__)] if keep else ""
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, dict]) -> List[dict]:
    """Each judged number with its limit: [{name, value, limit, ok}]."""
    rows = []
    for name, spec in limits.items():
        value = numbers.get(name, math.nan)
        rows.append(dict(name=name, value=value, limit=spec["limit"],
                         ok=bool(math.isfinite(value) and value <= spec["limit"])))
    return rows
