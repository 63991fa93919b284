"""Host time of the port's `cpm/data/load` spans (a TestLoader image, file
to padded array, on the loop's thread) over an image's TTA passes, over
the traced part of an evaluation run (torch.profiler)."""

LAYER = "data (data/loader.py, native/)"
MOVES = "serve_img_s"
SOURCE = "program_span"
UNIT = "ms"
BETTER = "lower"


def read(ctx):
    if ctx.trace is None or not ctx.traced_units or "cpm/data/load" not in ctx.trace.spans:
        return None
    seconds, _ = ctx.trace.spans["cpm/data/load"]
    return seconds / ctx.traced_units * 1e3
