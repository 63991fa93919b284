"""Host time a step of the port's `train_step/backward` span (torch.profiler,
the traced part of the window)."""

LAYER = "train entry (engine/train.py)"
MOVES = "train_img_s"
SOURCE = "program_span"
UNIT = "ms"
BETTER = "lower"


def read(ctx):
    if ctx.trace is None or "train_step/backward" not in ctx.trace.spans:
        return None
    seconds, count = ctx.trace.spans["train_step/backward"]
    return seconds / count * 1e3 if count else None
