"""Host time a step of the port's `train_step/forward` span (torch.profiler,
the traced part of the window)."""

LAYER = "train entry (engine/train.py)"
MOVES = "train_img_s"
SOURCE = "program_span"
UNIT = "ms"
BETTER = "lower"


def read(ctx):
    if ctx.trace is None or "train_step/forward" not in ctx.trace.spans:
        return None
    seconds, count = ctx.trace.spans["train_step/forward"]
    return seconds / count * 1e3 if count else None
