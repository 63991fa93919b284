"""Mean time of the port's TestLoader read of an image (fused decode,
resize, pad) on the caller's thread, by the benchmark's clock."""
import statistics

LAYER = "data (data/loader.py, native/)"
MOVES = "serve_img_s"
SOURCE = "host_clock"
UNIT = "ms"
BETTER = "lower"


def read(ctx):
    xs = ctx.host.get("load_ms")
    return statistics.fmean(xs) if xs else None
