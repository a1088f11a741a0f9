"""The port's spans and counters: in memory, off by default.

``span(name)``, a context manager, records the span's name, its start and
end on ``time.time_ns()``, its parent (the innermost span open on the same
thread) and its request id: a root span takes ``request`` or the next
number of a sequence that ``enable`` restarts, and every span under it
carries the root's (a picture of ``predict_tiled``, a training step).
``time.time_ns()`` is the clock a ``torch.profiler`` trace is stamped on,
so a span lies at ``(start_ns - prof.profiler.kineto_results
.trace_start_ns()) / 1e3`` µs on that trace's timeline.

``span(name, device=True)`` also records a CUDA timing event at each edge
on the current stream, when ``enable(events=True)`` asked for them and a
card is there. The events come from a pool and are read only by ``drain``:
nothing on the traced path waits for the device. A span's device time
runs from the device reaching its first edge to it reaching the last, so
it holds the device's idle time inside the span too.

``count(name, n)`` adds ``n`` to a counter.

While tracing is off (the default) ``span`` checks one flag and returns a
shared no-op context, and ``count`` returns at once: no clock is read, no
event recorded, nothing allocated or appended. ``drain()`` returns what
was recorded since ``enable`` or the last ``drain`` and clears it::

    {"spans": [{"name", "start_ns", "end_ns", "parent" (an index into
                "spans" or None), "request", "device_ms" (None without
                events)}, ...],
     "counts": {name: n, ..., "launch.<wrapper>": launches, ...}}

The launches are those of ``kernels.LAUNCHES`` (always counted, and left
as they are) since ``enable`` or the last ``drain``.
"""

from __future__ import annotations

import itertools
import threading
import time

import torch

from ciaosr_torch.ops import kernels

_on = False
_events = False
_spans: list = []
_counts: dict = {}
_launch_base: dict = {}
_pool: list = []        # free CUDA timing events
_requests = itertools.count()
_lock = threading.Lock()
_local = threading.local()


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


def _event():
    return _pool.pop() if _pool else torch.cuda.Event(enable_timing=True)


class _Span:
    __slots__ = ("name", "parent", "request", "start_ns", "end_ns", "edges")

    def __init__(self, name: str, device: bool, request):
        self.name, self.request, self.end_ns = name, request, None
        self.edges = (_event(), _event()) if device and _events else None

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        if self.request is None:
            self.request = self.parent.request if self.parent is not None \
                else next(_requests)
        stack.append(self)
        _spans.append(self)
        if self.edges is not None:
            self.edges[0].record()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        if self.edges is not None:
            self.edges[1].record()
        _local.stack.pop()
        return False


def span(name: str, device: bool = False, request: int | None = None):
    """A context that records a span named ``name`` while tracing is on;
    ``device``: with CUDA events at its edges (``enable(events=True)``);
    ``request``: the id of a root span (default: the parent's, or the
    next of the sequence)."""
    if not _on:
        return _NOOP
    return _Span(name, device, request)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if not _on:
        return
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def enabled() -> bool:
    return _on


def enable(events: bool = False) -> None:
    """Start a fresh record: spans, counters and the request sequence;
    ``events``: CUDA events at the edges of ``device=True`` spans (where a
    card is there)."""
    global _on, _events, _spans, _counts, _launch_base, _requests
    _spans, _counts, _requests = [], {}, itertools.count()
    _launch_base = dict(kernels.LAUNCHES)
    _events = bool(events) and torch.cuda.is_available()
    _on = True


def disable() -> None:
    """Stop recording; what was recorded stays until ``drain``."""
    global _on
    _on = False


def drain() -> dict:
    """The spans and counters recorded since ``enable`` or the last
    ``drain`` (module docstring), cleared. Waits for the device to reach
    the last edge event of each span that has them."""
    global _spans, _counts, _launch_base
    with _lock:
        spans, counts, _spans, _counts = _spans, _counts, [], {}
    now = dict(kernels.LAUNCHES)
    for k, v in now.items():
        base = _launch_base.get(k, 0)
        counts["launch." + k] = v - base if v >= base else v
    _launch_base = now
    index = {id(s): i for i, s in enumerate(spans)}
    out = []
    for s in spans:
        device_ms = None
        if s.edges is not None and s.end_ns is not None:
            s.edges[1].synchronize()
            device_ms = s.edges[0].elapsed_time(s.edges[1])
            _pool.extend(s.edges)
        out.append({"name": s.name, "start_ns": s.start_ns,
                    "end_ns": s.end_ns,
                    "parent": None if s.parent is None
                    else index.get(id(s.parent)),
                    "request": s.request, "device_ms": device_ms})
    return {"spans": out, "counts": counts}
