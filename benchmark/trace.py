"""The traced run's reduction: `torch.profiler` over the window, reduced to
device busy time, kernel time by name, host spans, and idle gaps labelled by
the host span that was open.

Spans are `record_function` ranges: the port's own (`train_step/forward`,
`/backward`, `/allreduce`, `/optimizer`) and the benchmark's around its
calls into the port (`bench/load`, `bench/forward`, `bench/readback`,
`bench/next_batch`). Their device-side mirrors are not kernels and are left
out of the device time.
"""

import contextlib
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

SPAN_PREFIXES = ("train_step/", "bench/")
NOT_KERNELS = SPAN_PREFIXES + ("Optimizer.", "ProfilerStep")


def span(name: str, on: bool):
    """A `record_function` range when tracing, else nothing."""
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(name)


@dataclass
class TraceSummary:
    window_s: float = 0.0
    busy_s: float = 0.0
    kernels: Dict[str, Tuple[float, int]] = field(default_factory=dict)  # name -> (s, count)
    spans: Dict[str, Tuple[float, int]] = field(default_factory=dict)    # host s, count
    idle_by_span: Dict[str, float] = field(default_factory=dict)         # idle s under a span

    def kernel_seconds(self, patterns) -> Tuple[float, int]:
        """Device seconds and launches of the kernels whose name holds any of
        `patterns`."""
        hits = [(s, n) for k, (s, n) in self.kernels.items() if any(p in k for p in patterns)]
        return sum(s for s, _ in hits), sum(n for _, n in hits)

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:top]
        gaps = sorted(self.idle_by_span.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k[:160], s] for k, (s, _) in ops],
                "idle_gaps": [[k, s] for k, s in gaps]}


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


WINDOW = "bench/window"


def summarise(prof) -> TraceSummary:
    """The measured window of `prof`: the host span `bench/window`."""
    cuda = torch.autograd.DeviceType.CUDA
    events = list(prof.profiler.kineto_results.events())
    windows = [e for e in events if e.name() == WINDOW and e.device_type() != cuda]
    if not windows:
        raise RuntimeError("the trace holds no bench/window span")
    t_start_ns = windows[0].start_ns()
    t_end_ns = t_start_ns + windows[0].duration_ns()
    kernels, spans, busy, host_spans = {}, {}, [], []
    for e in events:
        name = e.name()
        a, b = e.start_ns(), e.start_ns() + e.duration_ns()
        if b < t_start_ns or a > t_end_ns:
            continue
        if e.device_type() == cuda:
            if name.startswith(NOT_KERNELS):
                continue
            a, b = max(a, t_start_ns), min(b, t_end_ns)
            s, n = kernels.get(name, (0.0, 0))
            kernels[name] = (s + (b - a) * 1e-9, n + 1)
            busy.append((a, b))
        elif name.startswith(SPAN_PREFIXES) and name != WINDOW:
            s, n = spans.get(name, (0.0, 0))
            spans[name] = (s + (b - a) * 1e-9, n + 1)
            host_spans.append((a, b, name))
    merged = _union(busy)
    summary = TraceSummary(window_s=(t_end_ns - t_start_ns) * 1e-9,
                           busy_s=sum(b - a for a, b in merged) * 1e-9,
                           kernels=kernels, spans=spans)
    # idle gaps, each labelled by the innermost host span open at its middle
    edges = [t_start_ns] + [x for ab in merged for x in ab] + [t_end_ns]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    host_spans.sort()
    active, nxt = [], 0
    for a, b in gaps:  # in time order: a sweep over the spans
        mid = (a + b) // 2
        while nxt < len(host_spans) and host_spans[nxt][0] <= mid:
            active.append(host_spans[nxt])
            nxt += 1
        active = [s for s in active if s[1] >= mid]
        label = min(active, key=lambda s: s[1] - s[0])[2] if active else "outside any span"
        summary.idle_by_span[label] = summary.idle_by_span.get(label, 0.0) + (b - a) * 1e-9
    return summary


def profiler():
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)
