"""The deformable sampler's share of its roofline in evaluation (kernel 6f,
forward only): the bound of the captured image's sampler calls, every
pass's (bounds.sampler_bounds), over the kernel's device time per traced
image."""
from benchmark.bounds import SAMPLER_KERNELS

LAYER = "kernels (ops/cuda, csrc)"
MOVES = "serve_img_s"
SOURCE = "device_trace"
UNIT = "%"
BETTER = "higher"


def read(ctx):
    if (ctx.cell.mode != "evaluate" or ctx.trace is None or not ctx.bounds.get("sampler_calls")
            or not ctx.captured_units or not ctx.traced_units):
        return None
    device_s, launches = ctx.trace.kernel_seconds(SAMPLER_KERNELS)
    if not launches or not device_s:
        return None
    bound = ctx.bounds["sampler_fwd_s"] / ctx.captured_units
    return 100.0 * bound / (device_s / ctx.traced_units)
