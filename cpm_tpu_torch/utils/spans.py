"""Spans at the port's layer boundaries, for `torch.profiler`.

A span is a named range of the profiler's host trace, opened only while a
profiler runs; otherwise `span` returns one shared null context, so that an
untraced request or step pays a check of the profiler's state (about
0.5 us) and nothing more. The ranges are recorded on the profiler's clock,
the clock of its device trace, so a trace's idle gaps can be named by the
span open on the host at the time.

A span is an op range (`torch._C._profiler._RecordFunctionFast`, a
`cpu_op` of the trace), not `torch.profiler.record_function`'s user
annotation: the profiler lays every user annotation on the device timeline
too, over the kernels launched inside it, and a reader that counts the
device's events as its busy time (the benchmark's trace reduction counts
all but its own prefixes) would then see the card busy through the very
gaps a span is there to name. An op range has no device copy. Inside a
profiler session a span costs about 2 us on the host.

The names are a contract that readers find them by (tools/profile_eval.py,
tools/profile_train.py, parallel/launch.py, the benchmark's trace readers):

* `train_step/forward`, `/backward`, `/allreduce`, `/optimizer`
  (engine/train.py);
* `cpm/forward` (the eval forward), `cpm/cast` (the masters' casts of a
  train step, inside engine/train.py's `train_step/forward`);
* `cpm/data/load` (one TestLoader image, file to padded array),
  `cpm/data/decode` inside it, `cpm/data/wait` (a train batch's wait on the
  prefetch queue);
* `cpm/backbone`, `cpm/fpn`, `cpm/rpn/head`, `cpm/rpn/proposals`,
  `cpm/rpn/losses`;
* `cpm/head/cls` (with `cpm/head/filter` inside it at test),
  `cpm/head/stage<i>` for each CMM stage from 1 (ISM inside the last),
  `cpm/head/rescore`;
* `cpm/sync/<site>` (`sync`): one call that makes the host wait for the
  card, such as a read of a device value or a blocking copy from pageable
  host memory. The spans' count is the count of such waits, their host time
  the time the host waited. The sites: `nms` (ops/nms.py's convergence
  test), `tower_size` (the grid head's tower length), `draws` (the
  samplers' uniforms), `inputs` (a request's or a batch's arrays), `consts`
  (constants and list indices made on the host for the card), `ism_row`
  (the ISM loss's row index, read on the host). tools/sync_sites.py lists the
  waits of a request and a step and the span that covers each.

Spans open only on the thread that runs the request or the step: never on
TrainLoader's prefetch thread, in the native decode pool or in code that
autograd's thread runs, where a span would name the main thread's idle
gaps wrongly.
"""

import contextlib
import sys

_OFF = contextlib.nullcontext()


def span(name: str):
    """A range named `name` while a profiler runs, else a shared null
    context. Torch is not imported here, so that the host data modules,
    which open spans, stay free of it: where it is not loaded, no profiler
    runs."""
    torch = sys.modules.get("torch")
    if torch is not None and torch.autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return _OFF


def sync(site: str):
    """The span of one blocking call at `site`: `cpm/sync/<site>`."""
    return span("cpm/sync/" + site)
