"""Pooler kernel 1's share of its roofline in serving: the bound of the
captured requests' pooler calls (bounds.py) per request, over the device time
of the kernel's launches per traced request."""
from benchmark.bounds import ROI_FORWARD_KERNELS

LAYER = "kernels (ops/cuda, csrc)"
MOVES = "serve_img_s"
SOURCE = "device_trace"
UNIT = "%"
BETTER = "higher"


def read(ctx):
    if ctx.trace is None or not ctx.bounds.get("roi_calls") or not ctx.captured_units:
        return None
    device_s, launches = ctx.trace.kernel_seconds(ROI_FORWARD_KERNELS)
    if not launches or not device_s:
        return None
    bound = ctx.bounds["roi_fwd_s"] / ctx.captured_units
    return 100.0 * bound / (device_s / ctx.traced_units)
