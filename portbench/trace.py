"""Spans, counters and the device trace of a run.

Spans are the benchmark's own, around its calls into the program
(``stage``: a batch staged on the device; ``call``: the program's entry;
``fetch``: outputs brought to the host; ``drain``: training metrics brought
to the host).  Each keeps its durations on the host clock.  Inside a traced
slice each span is also a ``torch.profiler.record_function`` range, so that
the device's idle gaps can be labelled with what the host was doing.

The device's busy time is the union of the intervals of its operations
(kernels, copies, sets) in a ``torch.profiler`` trace, less the profiler's
own step annotations.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

__all__ = ["Spans", "profile_slice", "DeviceTrace"]

PREFIX = "portbench."


class Spans:
    """Durations by span name; ``annotate`` also marks each span in a trace."""

    def __init__(self):
        self.seconds = defaultdict(list)
        self.annotate = False

    @contextlib.contextmanager
    def span(self, name):
        mark = (torch.profiler.record_function(PREFIX + name) if self.annotate
                else contextlib.nullcontext())
        t = time.perf_counter()
        with mark:
            yield
        self.seconds[name].append(time.perf_counter() - t)


def _merged(intervals):
    """The union of [start, end) intervals as disjoint sorted intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class DeviceTrace:
    """What a traced slice holds: the device operations (name, start us,
    end us), the benchmark's host spans (name, start us, end us), the
    slice's length on the host clock and the iterations it covered."""

    def __init__(self, events, window_s: float, iterations: int):
        self.ops, self.spans = [], []
        for e in events:
            if e.device_type == torch.autograd.DeviceType.CUDA:
                if getattr(e, "is_user_annotation", False) or e.name.startswith("ProfilerStep"):
                    continue
                self.ops.append((e.name, e.time_range.start, e.time_range.end))
            elif e.name.startswith(PREFIX):
                self.spans.append((e.name[len(PREFIX):], e.time_range.start, e.time_range.end))
        self.window_s = window_s
        self.iterations = iterations

    def busy_s(self) -> float:
        """Seconds in which some device operation ran (the union of their
        intervals, which the trace gives in microseconds)."""
        return sum(e - s for s, e in _merged([(s, e) for _, s, e in self.ops])) * 1e-6

    def kernels(self, match) -> list:
        """Durations in seconds of the operations whose name ``match`` accepts."""
        return [(e - s) * 1e-6 for n, s, e in self.ops if match(n)]

    def top_ops(self, n=10) -> list:
        by_name = defaultdict(float)
        for name, s, e in self.ops:
            by_name[name[:160]] += (e - s) * 1e-6
        return sorted(([k, v] for k, v in by_name.items()), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n=10) -> list:
        """The longest gaps between device operations inside the span of the
        benchmark's host spans, each labelled with the host span that
        covers most of it ("other" where none does)."""
        if not self.spans or not self.ops:
            return []
        lo = min(s for _, s, _ in self.spans)
        hi = max(e for _, _, e in self.spans)
        busy = _merged([(s, e) for _, s, e in self.ops])
        gaps, prev = [], lo
        for s, e in busy:
            if s > prev:
                gaps.append((prev, min(s, hi)))
            prev = max(prev, e)
        if hi > prev:
            gaps.append((prev, hi))
        out = []
        for gs, ge in gaps:
            if ge <= gs:
                continue
            cover = defaultdict(float)
            for name, s, e in self.spans:
                cover[name] += max(0.0, min(e, ge) - max(s, gs))
            label = max(cover, key=cover.get) if cover and max(cover.values()) > 0 else "other"
            out.append([label, (ge - gs) * 1e-6])
        return sorted(out, key=lambda kv: -kv[1])[:n]


def profile_slice(step, iterations: int, spans: Spans) -> DeviceTrace:
    """Trace ``iterations`` calls of ``step()`` after one warm-up call inside
    the profiler (a trace can lose its first launches otherwise)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    holder = {}
    sched = schedule(wait=0, warmup=1, active=iterations, repeat=1)
    spans.annotate = True
    sync()
    with profile(activities=activities, schedule=sched,
                 on_trace_ready=lambda p: holder.setdefault("events", p.events())) as prof:
        step()
        sync()
        prof.step()
        t0 = time.perf_counter()
        for i in range(iterations):
            step()
            if i == iterations - 1:  # the cycle ends at this prof.step()
                sync()
                window = time.perf_counter() - t0
            prof.step()
    spans.annotate = False
    return DeviceTrace(holder.get("events", []), window, iterations)
