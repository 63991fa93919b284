"""Median time from the `make_forward_fn` call to a synchronise after it,
by the benchmark's clock, over every request of the window."""
import statistics

LAYER = "eval entry (engine/test.py)"
MOVES = "serve_img_s"
SOURCE = "host_clock"
UNIT = "ms"
BETTER = "lower"


def read(ctx):
    xs = ctx.host.get("forward_ms")
    return statistics.median(xs) if xs else None
