"""Spans and counters at the port's layer boundaries, on the profiler's clock.

The tracer is off unless a ``torch.profiler`` trace is recording or a
:func:`recording` context is open.  Off, :func:`span` returns one shared
null context (a read of the profiler's flag and of a counter, nothing
allocated) and :func:`add` does nothing.

On, each span keeps a :class:`Span` record in a bounded in-memory buffer
(:func:`records`, :func:`clear`): its name, the id of the request it serves
(the evaluator's call number, the train state's step, the prefetcher's
batch number; a child takes its parent's), its own number ``seq`` and its
parent's, start and end in nanoseconds of ``time.time_ns()``, and the
counters :func:`add` gave it while it was the innermost open span of its
thread (a caller whose count costs more than a read checks :func:`enabled`
first).  Under the profiler each span is also a ``record_function`` range
named ``sp.<name>``, so a chrome trace shows it above the kernels it
launched.  The profiler converts its CPU times to the unix clock, the one
``time.time_ns()`` reads, so one constant offset puts the records on the
trace's timeline.

A span touches no CUDA state: it never synchronizes and reads no tensor.

    with tracing.recording():      # host times without the profiler
        ev(batch)
    for r in tracing.records():
        print(r.name, r.id, (r.end_ns - r.start_ns) / 1e6, r.counters)
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import deque
from typing import NamedTuple, Optional

import torch.autograd.profiler as _profiler

__all__ = ["Span", "span", "add", "enabled", "recording", "records", "clear", "PREFIX",
           "MAX_SPANS"]

PREFIX = "sp."
MAX_SPANS = 100_000

_buffer: deque = deque(maxlen=MAX_SPANS)
_seq = itertools.count()
_local = threading.local()
_recording = [0]  # open recording() contexts
_recording_lock = threading.Lock()
_NULL = contextlib.nullcontext()


class Span(NamedTuple):
    name: str
    id: Optional[int]
    seq: int
    parent: Optional[int]
    start_ns: int
    end_ns: int
    counters: dict


class _Open:
    """A span while it is open: the innermost one on its thread's stack."""

    __slots__ = ("name", "id", "seq", "parent", "start_ns", "counters", "_range", "_stack")

    def __init__(self, name, id):
        self.name, self.id = name, id

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        outer = stack[-1] if stack else None
        self.parent = outer.seq if outer is not None else None
        if self.id is None and outer is not None:
            self.id = outer.id
        self.seq = next(_seq)
        self.counters = {}
        self._range = None
        if _profiler._is_profiler_enabled:
            self._range = _profiler.record_function(PREFIX + self.name)
            self._range.__enter__()
        self._stack = stack
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end_ns = time.time_ns()
        self._stack.pop()
        if self._range is not None:
            self._range.__exit__(*exc)
        _buffer.append(Span(self.name, self.id, self.seq, self.parent, self.start_ns, end_ns,
                            self.counters))
        return False


def enabled() -> bool:
    """Whether the tracer is on: a profile records or recording() is open."""
    return _profiler._is_profiler_enabled or _recording[0] > 0


def span(name: str, id: Optional[int] = None):
    """A context that records the span ``name`` while the tracer is on; a
    shared null context otherwise.  ``id`` is the request's; None takes the
    enclosing span's."""
    if _profiler._is_profiler_enabled or _recording[0]:
        return _Open(name, id)
    return _NULL


def add(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` of the innermost open span of this
    thread (nothing where none is open)."""
    stack = getattr(_local, "stack", None)
    if stack:
        c = stack[-1].counters
        c[name] = c.get(name, 0) + n


@contextlib.contextmanager
def recording():
    """Turn the tracer on for the block, without the profiler."""
    with _recording_lock:
        _recording[0] += 1
    try:
        yield
    finally:
        with _recording_lock:
            _recording[0] -= 1


def records() -> list:
    """The buffered spans, oldest first (at most ``MAX_SPANS``)."""
    return list(_buffer)


def clear() -> None:
    _buffer.clear()
