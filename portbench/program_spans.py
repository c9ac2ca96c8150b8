"""The program's own spans and counters (``simple_pose_torch/utils/tracing``)
of a traced slice, put on the device trace's timeline.

The tracer is on while the profiler records, so its buffer holds the spans
of the slice's active iterations.  Each root span of the program (the
serving call, the training step, the prefetcher's staging) sits inside one
of the benchmark's own ranges (``portbench.call``, ``portbench.stage``),
the last of the buffer's roots in the slice's ranges, in order.  The
program's clock (``time.time_ns()``, unix) and the trace's (microseconds
from the trace's start) differ by one constant: the offset is the median of
(root start - range start), and the slice is aligned only where every root
then lies inside its range to within ``TOLERANCE_US``.  A reader returns
None where there is nothing to align (a program without the tracer, or no
trace) or the alignment fails.
"""

from __future__ import annotations

import statistics
from typing import NamedTuple, Optional

from portbench.trace import _merged

__all__ = ["SERVE", "TRAIN", "TOLERANCE_US", "Placed", "program_records", "aligned",
           "per_root_ms", "per_root_mb", "idle_share"]

# the program's root spans and the benchmark's range each lies in
SERVE = {"serve.call": "call"}
TRAIN = {"train.step": "call", "prefetch.stage": "stage"}
TOLERANCE_US = 50.0


class Placed(NamedTuple):
    """A program span on the trace's timeline (microseconds)."""
    name: str
    start: float
    end: float
    counters: dict


def program_records() -> list:
    """The tracer's buffered spans; none where the program has no tracer."""
    try:
        from simple_pose_torch.utils import tracing
    except ImportError:
        return []
    return tracing.records()


def aligned(ctx, roots: dict, records=None) -> Optional[list]:
    """The slice's program spans (the roots named in ``roots`` and every
    span under them) as :class:`Placed`, or None (see the module's doc)."""
    tr = ctx.get("trace")
    records = program_records() if records is None else records
    if tr is None or not records:
        return None
    pairs = []
    for root, range_name in roots.items():
        ranges = sorted((s, e) for n, s, e in tr.spans if n == range_name)
        found = sorted((r for r in records if r.name == root and r.parent is None),
                       key=lambda r: r.start_ns)
        if not ranges or len(found) < len(ranges):
            return None
        pairs += zip(found[-len(ranges):], ranges)
    base = min(r.start_ns for r, _ in pairs)

    def us(ns):
        return (ns - base) * 1e-3

    offset = statistics.median(us(r.start_ns) - s for r, (s, _) in pairs)
    for r, (s, e) in pairs:
        if us(r.start_ns) - offset < s - TOLERANCE_US or us(r.end_ns) - offset > e + TOLERANCE_US:
            return None
    children = {}
    for r in records:
        children.setdefault(r.parent, []).append(r)
    out, todo = [], [r for r, _ in pairs]
    while todo:
        r = todo.pop()
        out.append(Placed(r.name, us(r.start_ns) - offset, us(r.end_ns) - offset, r.counters))
        todo += children.get(r.seq, [])
    return out


def per_root_ms(spans, name: str, root: str) -> float:
    """Milliseconds in the spans ``name`` over the number of roots ``root``."""
    total = sum(p.end - p.start for p in spans if p.name == name)
    return 1e-3 * total / sum(p.name == root for p in spans)


def per_root_mb(spans, counter: str, root: str) -> float:
    """The counter ``counter`` summed over the spans, in MB, over the number
    of roots ``root``."""
    total = sum(p.counters.get(counter, 0) for p in spans)
    return 1e-6 * total / sum(p.name == root for p in spans)


def idle_share(ctx, spans, names) -> Optional[float]:
    """Per cent of the slice's window in which no device operation runs and
    the host is inside a span named in ``names``; None without device
    operations."""
    tr = ctx["trace"]
    if not tr.ops:
        return None
    busy = _merged([(s, e) for _, s, e in tr.ops])
    under = _merged([(p.start, p.end) for p in spans if p.name in names])
    idle, i = 0.0, 0
    for s, e in under:
        idle += e - s
        while i < len(busy) and busy[i][1] <= s:
            i += 1
        j = i
        while j < len(busy) and busy[j][0] < e:
            idle -= min(e, busy[j][1]) - max(s, busy[j][0])
            j += 1
    return 100.0 * idle * 1e-6 / tr.window_s
