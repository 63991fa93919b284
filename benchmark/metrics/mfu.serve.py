"""The whole request's share of the H100's bf16 peak: FLOPs an image (the
reference's forward under FlopCounterMode) times the images served in the
traced part of the window, over its seconds times 989 TFLOP/s."""
from benchmark.bounds import BF16_FLOPS_PER_S

LAYER = "device (H100)"
MOVES = "serve_img_s"
SOURCE = "device_trace"
UNIT = "%"
BETTER = "higher"


def read(ctx):
    if not ctx.flops_per_image or not ctx.traced_units or not ctx.traced_window_s:
        return None
    return 100.0 * ctx.flops_per_image * ctx.traced_units / (ctx.traced_window_s * BF16_FLOPS_PER_S)
