"""The deformable sampler's share of its roofline in training (kernels 6f
and 6b, binning included): the bounds of the captured steps' sampler calls
(bounds.py) per step, over their kernels' device time per traced step."""
from benchmark.bounds import SAMPLER_KERNELS

LAYER = "kernels (ops/cuda, csrc)"
MOVES = "train_img_s"
SOURCE = "device_trace"
UNIT = "%"
BETTER = "higher"


def read(ctx):
    if ctx.trace is None or not ctx.bounds.get("sampler_calls") or not ctx.captured_units:
        return None
    device_s, launches = ctx.trace.kernel_seconds(SAMPLER_KERNELS)
    if not launches or not device_s:
        return None
    bound = (ctx.bounds["sampler_fwd_s"] + ctx.bounds["sampler_bwd_s"]) / ctx.captured_units
    return 100.0 * bound / (device_s / ctx.traced_units)
