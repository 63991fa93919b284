"""Host time of the port's `cpm/tta/merge` span (engine/test.py's merge of
an image's TTA passes, its soft-NMS in it) an image, over the traced part
of an evaluation run (torch.profiler)."""

LAYER = "eval entry (engine/test.py)"
MOVES = "serve_img_s"
SOURCE = "program_span"
UNIT = "ms"
BETTER = "lower"


def read(ctx):
    if ctx.trace is None or not ctx.traced_units or "cpm/tta/merge" not in ctx.trace.spans:
        return None
    seconds, _ = ctx.trace.spans["cpm/tta/merge"]
    return seconds / ctx.traced_units * 1e3
