"""The whole step's share of the H100's bf16 peak: FLOPs an image (the
reference's forward and backward under FlopCounterMode) times the images
trained in the traced part of the window, over its seconds times 989
TFLOP/s."""
from benchmark.bounds import BF16_FLOPS_PER_S

LAYER = "device (H100)"
MOVES = "train_img_s"
SOURCE = "device_trace"
UNIT = "%"
BETTER = "higher"


def read(ctx):
    if not ctx.flops_per_image or not ctx.traced_units or not ctx.traced_window_s:
        return None
    images = ctx.traced_units * int(ctx.cell.mix["images_per_card"]) * ctx.cell.chips
    return 100.0 * ctx.flops_per_image * images / (ctx.traced_window_s * BF16_FLOPS_PER_S)
