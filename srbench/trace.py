"""The traced run's instruments: ranges that the benchmark opens around the
program's layers (forward hooks on its modules, a wrapper on a method),
the work each range's calls need (for the roofline shares), and the
reduction of a ``torch.profiler`` trace to what the per-layer readers
take: device time by range and by operator, copies, the union of device
activity, and the longest device operations and idle gaps.

A traced run reads three stretches, one after the other (``Traced``):
the window itself, unprofiled, for the shares of the whole step and the
memory peak; a stretch under a device-only profile with no ranges, for
the device's busy time, idle gaps, copies and longest operations; and a
stretch under the full profile with the ranges, for the device time of
each layer. Only device times are read from the fully profiled stretch,
since its host side is slowed by the profiler's own work.
"""

from __future__ import annotations

import bisect
import collections
from contextlib import contextmanager

import torch
from torch.autograd.profiler import record_function

PREFIX = "srbench."


class Ranges:
    """Named ranges around module calls, and the work of each call
    (``least_s[name]`` sums ``Work.least_s`` seconds; ``flops[name]`` the
    operations)."""

    def __init__(self, device):
        self.least_s = collections.defaultdict(float)
        self.flops = collections.defaultdict(float)
        self.log: list[tuple[str, int]] = []    # (range, 0 enter / 1 exit)
        self._cuda = torch.device(device).type == "cuda"
        self._handles = []

    def _mark(self, name: str, edge: int) -> None:
        """A marker kernel on the stream at the range's edge (its device
        time bounds the range's device work), in the order of ``log``."""
        if edge == 0:
            self.log.append((name, 0))
        if self._cuda:
            torch.cuda._sleep(1)
        if edge == 1:
            self.log.append((name, 1))

    def note(self, name: str, work) -> None:
        self.least_s[name] += work.least_s()
        self.flops[name] += work.flops

    def around_module(self, module, name: str, work_of=None) -> None:
        """A range ``srbench.<name>`` around each call of ``module``;
        ``work_of(args)`` gives the call's Work (or None)."""
        pre, post = self._edges(name, work_of)
        self._handles += [module.register_forward_pre_hook(pre),
                          module.register_forward_hook(
                              lambda m, a, o: post(m, a))]

    def around_backward(self, module, name: str, work_of=None) -> None:
        """A range ``srbench.<name>`` around the backward of ``module``
        (from the gradient of its output to that of its input)."""
        pre, post = self._edges(name, work_of)
        self._handles += [module.register_full_backward_pre_hook(pre),
                          module.register_full_backward_hook(
                              lambda m, gi, go: post(m, gi))]

    def _edges(self, name: str, work_of):
        stack = []

        def pre(_m, args):
            if work_of is not None:
                w = work_of(args)
                if w is not None:
                    self.note(name, w)
            rf = record_function(PREFIX + name)
            rf.__enter__()
            stack.append(rf)
            self._mark(name, 0)

        def post(_m, _args):
            self._mark(name, 1)
            stack.pop().__exit__(None, None, None)

        return pre, post

    def around_method(self, obj, attr: str, name: str, work_of=None) -> None:
        """The same around ``obj.attr(...)``, by an instance attribute."""
        orig = getattr(obj, attr)

        def wrapped(*args, **kw):
            if work_of is not None:
                w = work_of(args)
                if w is not None:
                    self.note(name, w)
            with record_function(PREFIX + name):
                self._mark(name, 0)
                try:
                    return orig(*args, **kw)
                finally:
                    self._mark(name, 1)

        setattr(obj, attr, wrapped)
        self._handles.append((obj, attr))

    def remove(self) -> None:
        for h in self._handles:
            if isinstance(h, tuple):
                delattr(*h)
            else:
                h.remove()
        self._handles = []


@contextmanager
def profiling(host: bool = True):
    """A CUDA profile kept in memory (no file); ``host`` also records the
    host's operators (and with them which operator launched a kernel), as
    does a run with no card (the CPU tests')."""
    acts = []
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    if host or not acts:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    with torch.profiler.profile(activities=acts, record_shapes=False,
                                with_stack=False) as prof:
        yield prof


class Traced:
    """What a traced run hands the per-layer readers: ``info``, the
    unprofiled window's counts (``window_s``, ``items``, ``steps``, the
    work of every picture or step, ``window_peak_bytes``); ``light``, the
    Trace of the device-only stretch; ``ranged``, the Trace of the fully
    profiled stretch with the ranges."""

    def __init__(self, info: dict, light: "Trace", ranged: "Trace"):
        self.info, self.light, self.ranged = info, light, ranged

    def slowdown(self) -> float:
        """The device-only stretch's time per item over the window's."""
        per = self.info["window_s"] / self.info["items"]
        return self.light.window_s / self.light.info["items"] / per


def _is_device(ev) -> bool:
    return getattr(ev.device_type, "name", str(ev.device_type)) != "CPU"


def _is_annotation(ev) -> bool:
    return bool(getattr(ev, "is_user_annotation", False)) \
        or ev.name.startswith(PREFIX)


def gaps(intervals, lo: float, hi: float):
    """The idle stretches (start, end) of [lo, hi] that no interval covers."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


def overlap(union, lo: float, hi: float) -> float:
    """Length of [lo, hi] covered by ``union`` (sorted, disjoint)."""
    i = bisect.bisect_left(union, (lo, lo)) - 1
    total = 0.0
    for s, e in union[max(i, 0):]:
        if s >= hi:
            break
        total += max(0.0, min(e, hi) - max(s, lo))
    return total


def merged(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


class Trace:
    """A profile reduced to what the per-layer readers take; times in
    seconds.

    * ``range_dev[name]``: device work inside the range's device spans,
      each span from the end of its entry marker to the start of its exit
      marker (``Ranges._mark``), so that every kernel the range enqueued
      lies in it whichever way it was launched;
    * ``op_dev(word)``: device time of the kernels that only operators
      named with ``word`` (or under one) launch, by kernel name;
    * ``busy_s``: the union of all device activity; ``info``: the run's
      counts; ``ranges``: the Ranges object of the run."""

    def __init__(self, events, window_s: float, ranges: Ranges, info: dict):
        self.window_s = window_s
        self.ranges = ranges
        self.info = info
        device, cpu = [], []
        for ev in events:
            (device if _is_device(ev) else cpu).append(ev)
        work = [ev for ev in device if not _is_annotation(ev)]
        self.device_intervals = [(ev.time_range.start, ev.time_range.end)
                                 for ev in work]
        union = merged(self.device_intervals)
        self.busy_s = sum(e - s for s, e in union) * 1e-6
        by_name = collections.defaultdict(float)
        for ev in work:
            by_name[ev.name] += (ev.time_range.end - ev.time_range.start)
        self.device_by_name = {k: v * 1e-6 for k, v in by_name.items()}
        self.range_dev = collections.defaultdict(float)
        for name, lo, hi in self._spans(work):
            self.range_dev[name] += overlap(union, lo, hi) * 1e-6
        self._launchers = collections.defaultdict(set)
        for ev in cpu:
            for k in getattr(ev, "kernels", ()):
                self._launchers[k.name].add(self._lineage(ev))
        self._cpu = [(ev.time_range.start, ev.time_range.end, ev.name)
                     for ev in cpu if not ev.name.startswith("ProfilerStep")
                     and not ev.name.startswith("cu")]
        self._starts = sorted((ev.time_range.start, ev.name) for ev in work)
        self._span = (union[0][0], union[-1][1]) if union else (0, 0)

    def _spans(self, work):
        """(range, device start, device end) of every range the log holds,
        or none when the markers do not match the log."""
        marks = sorted((ev.time_range.start, ev.time_range.end)
                       for ev in work if "spin_kernel" in ev.name)
        log = self.ranges.log if self.ranges is not None else []
        if not log or len(marks) != len(log):
            return []
        open_, spans = collections.defaultdict(list), []
        for (name, edge), (s, e) in zip(log, marks):
            if edge == 0:
                open_[name].append(e)
            elif open_[name]:
                spans.append((name, open_[name].pop(), s))
        return spans

    @staticmethod
    def _lineage(ev) -> str:
        names = []
        while ev is not None:
            names.append(ev.name)
            ev = ev.cpu_parent
        return " < ".join(names)

    def op_dev(self, word: str) -> float:
        """Device time of the kernels launched only under operators whose
        names hold ``word`` (kernels some other operator launches too are
        left out)."""
        return sum(self.device_by_name.get(k, 0.0)
                   for k, lines in self._launchers.items()
                   if all(word in line for line in lines))

    def device_s(self, prefix: str) -> float:
        """Device time of the operations whose names start with
        ``prefix`` (e.g. "Memcpy")."""
        return sum(v for k, v in self.device_by_name.items()
                   if k.startswith(prefix))

    def top_ops(self, n: int = 10) -> list:
        return [[k, v] for k, v in sorted(self.device_by_name.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """The n longest idle stretches between device operations, each
        named by the innermost host operator that spans its middle, where
        the profile has the host's operators, and by the device operation
        that ends it ("before <op>")."""
        lo, hi = self._span
        out = []
        for s, e in sorted(gaps(self.device_intervals, lo, hi),
                           key=lambda g: g[0] - g[1])[:n]:
            mid = 0.5 * (s + e)
            spans = [(ce - cs, name) for cs, ce, name in self._cpu
                     if cs <= mid <= ce]
            i = bisect.bisect_left(self._starts, (e, ""))
            nxt = self._starts[i][1][:60] if i < len(self._starts) else "end"
            name = (min(spans)[1] + ", " if spans else "") + "before " + nxt
            out.append([name, (e - s) * 1e-6])
        return out
