"""Mean time the step waited in `next()` on the port's TrainLoader (the
prefetch thread over the native decode pool), by the benchmark's clock."""
import statistics

LAYER = "data (data/loader.py, native/)"
MOVES = "train_img_s"
SOURCE = "host_clock"
UNIT = "ms"
BETTER = "lower"


def read(ctx):
    xs = ctx.host.get("loader_wait_ms")
    return statistics.fmean(xs) if xs else None
