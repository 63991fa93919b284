"""Pooler kernels 1 and 2's share of their roofline in training: the bounds
of the captured steps' pooler forwards and backwards (bounds.py) per step,
over the device time of both kernels' launches per traced step."""
from benchmark.bounds import ROI_BACKWARD_KERNELS, ROI_FORWARD_KERNELS

LAYER = "kernels (ops/cuda, csrc)"
MOVES = "train_img_s"
SOURCE = "device_trace"
UNIT = "%"
BETTER = "higher"


def read(ctx):
    if ctx.trace is None or not ctx.bounds.get("roi_calls") or not ctx.captured_units:
        return None
    device_s, launches = ctx.trace.kernel_seconds(ROI_FORWARD_KERNELS + ROI_BACKWARD_KERNELS)
    if not launches or not device_s:
        return None
    bound = (ctx.bounds["roi_fwd_s"] + ctx.bounds["roi_bwd_s"]) / ctx.captured_units
    return 100.0 * bound / (device_s / ctx.traced_units)
