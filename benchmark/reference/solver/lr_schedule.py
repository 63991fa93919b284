"""Iteration-based learning-rate schedules.

Port of cpm_tpu/solver/lr_schedule.py::make_lr_fn: CONSTANT or LINEAR
warm-up, then the STEP, COSINE, STEP_COSINE or POLY policy. The schedule is
a host function of the step; the train step writes its value into the
optimizer's parameter groups before every update.
"""

import math


def make_lr_fn(solver):
    """solver: cfg.SOLVER. Returns fn(step) -> lr (a float).

    `step` counts completed updates from 0; the reference's iteration is
    step + 1, and warm-up covers iterations <= WARM_UP_ITERS.
    """
    base_lr = float(solver.BASE_LR)
    policy = solver.LR_POLICY
    warmup_iters = int(solver.WARM_UP_ITERS)
    warmup_factor = float(solver.WARM_UP_FACTOR)
    warmup_method = solver.WARM_UP_METHOD
    max_iter = int(solver.MAX_ITER)
    gamma = float(solver.GAMMA)
    steps = tuple(int(s) for s in solver.STEPS)
    lr_pow = float(getattr(solver, "LR_POW", 0.9))
    if policy not in ("STEP", "COSINE", "STEP_COSINE", "POLY"):
        raise KeyError(f"Unknown SOLVER.LR_POLICY: {policy}")

    def lr_fn(step) -> float:
        it = float(step) + 1.0  # 1-based iteration
        if it <= warmup_iters:
            if warmup_method == "CONSTANT":
                return base_lr * warmup_factor
            alpha = it / max(warmup_iters, 1)
            return base_lr * (warmup_factor * (1 - alpha) + alpha)

        step_lr = base_lr * gamma ** sum(it > s for s in steps)
        if policy == "STEP":
            return step_lr
        if policy == "COSINE":
            actual = max(max_iter - warmup_iters, 1)
            return 0.5 * base_lr * (math.cos((it - warmup_iters - 1) * math.pi / actual) + 1.0)
        if policy == "STEP_COSINE":
            if it < steps[-1]:
                return step_lr
            # the cosine tail starts from the rate of the last-but-one step
            new_base = base_lr * gamma ** sum(s <= steps[-1] - 1 for s in steps)
            actual = max(max_iter - steps[-1], 1)
            return 0.5 * new_base * (math.cos((it - steps[-1] - 1) * math.pi / actual) + 1.0)
        actual = max(max_iter - warmup_iters, 1)
        # past MAX_ITER the base turns negative; the rate stays at 0
        return base_lr * max(1.0 - (it - warmup_iters - 1) / actual, 0.0) ** lr_pow

    return lr_fn
