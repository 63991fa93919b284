"""Share of the traced window in which no operation ran on the device
(torch.profiler)."""

LAYER = "device (H100)"
MOVES = "serve_img_s"
SOURCE = "device_trace"
UNIT = "%"
BETTER = "lower"


def read(ctx):
    if ctx.trace is None or not ctx.trace.window_s or not ctx.trace.busy_s:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
