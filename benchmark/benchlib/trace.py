"""The traced run's reduction: from torch.profiler's events to the device's
busy and idle time, kernel time, kernel time inside named host spans,
host span shares and the breakdown.

Events are first turned into plain ``Event`` tuples (``from_profiler``),
so the arithmetic below runs on synthetic events in the tests.  Times are
nanoseconds on the profiler's clock, which it shares between host and
device events.

* busy: the union of every kernel, copy and memset interval (overlapping
  and nested intervals count once), clipped to the window;
* a kernel belongs to a host span when the host call that launched it (the
  runtime event with the same correlation id) started inside the span;
* a host span's share: the union of its intervals inside the operations,
  over the operations' summed wall;
* idle time is named by the innermost host span open over it.

A reader asks for spans by the program's names; where none of them is in
the trace (a span renamed or taken away), it raises ``Missing`` and the
run fails, rather than leaving the metric out unseen."""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Iterable, List, NamedTuple, Optional, Sequence, Tuple

KERNEL, COPY, SET, SPAN, LAUNCH = "kernel", "copy", "set", "span", "launch"
DEVICE_KINDS = (KERNEL, COPY, SET)
WINDOW_SPAN = "bench.window"
OP_SPAN = "bench.op"


class Missing(LookupError):
    """What a metric reads is not in the trace."""


class Event(NamedTuple):
    kind: str
    name: str
    start: int
    end: int
    corr: int = 0


def union(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Merge intervals into disjoint sorted ones."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clipped_length(merged: Sequence[Tuple[int, int]], lo: int,
                   hi: int) -> int:
    """Length of disjoint intervals inside [lo, hi]."""
    return sum(max(0, min(e, hi) - max(s, lo)) for s, e in merged)


def gaps(merged: Sequence[Tuple[int, int]], lo: int,
         hi: int) -> List[Tuple[int, int]]:
    """The stretches of [lo, hi] that disjoint sorted intervals leave
    uncovered."""
    out, t = [], lo
    for s, e in merged:
        if e <= lo or s >= hi:
            continue
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < hi:
        out.append((t, hi))
    return out


def innermost(spans: Sequence[Event], t: int) -> Optional[str]:
    """Name of the shortest span that holds time ``t``."""
    best = None
    for s in spans:
        if s.start <= t < s.end and (best is None or
                                     s.end - s.start < best.end - best.start):
            best = s
    return best.name if best else None


def _classify(e) -> Optional[Event]:
    """An ``Event`` of a profiler event, or None for those not read."""
    name = e.name()
    dev = str(e.device_type())
    corr = int(e.correlation_id() or 0)
    start = int(e.start_ns())
    end = start + int(e.duration_ns())
    if dev.endswith("CUDA"):
        activity = str(getattr(e, "activity_type", lambda: "")())
        if e.is_user_annotation() or "annotation" in activity.lower():
            return None
        low = name.lower()
        if low.startswith("memcpy"):
            return Event(COPY, name, start, end, corr)
        if low.startswith("memset"):
            return Event(SET, name, start, end, corr)
        return Event(KERNEL, name, start, end, corr)
    if e.is_user_annotation():
        return Event(SPAN, name, start, end)
    if name.startswith("cu") and corr:
        return Event(LAUNCH, name, start, end, corr)
    return None


def from_profiler(prof) -> List[Event]:
    """The events of a finished ``torch.profiler.profile``."""
    out = []
    for e in prof.profiler.kineto_results.events():
        ev = _classify(e)
        if ev is not None:
            out.append(ev)
    return out


class Summary:
    """What the per-layer readers read from one traced window."""

    def __init__(self, events: Sequence[Event]):
        self.spans = [e for e in events if e.kind == SPAN]
        windows = [e for e in self.spans if e.name == WINDOW_SPAN]
        if not windows:
            raise ValueError("the trace holds no window span")
        self.lo, self.hi = windows[0].start, windows[0].end
        self.ops = [e for e in self.spans if e.name == OP_SPAN]
        self.device = [e for e in events if e.kind in DEVICE_KINDS
                       and e.end > self.lo and e.start < self.hi]
        self.launch_at = {e.corr: e.start for e in events
                          if e.kind == LAUNCH}
        self.busy = union((e.start, e.end) for e in self.device)

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e9

    @property
    def busy_s(self) -> float:
        return clipped_length(self.busy, self.lo, self.hi) / 1e9

    @property
    def ops_s(self) -> float:
        return sum(o.end - o.start for o in self.ops) / 1e9

    def kernel_s(self, inside: Optional[Sequence[str]] = None) -> float:
        """Summed time of the window's kernels; with ``inside``, of those
        launched inside a host span of one of those names."""
        total = 0
        spans = None
        if inside is not None:
            spans = union(self._named(inside))
            starts = [s for s, _ in spans]
        for e in self.device:
            if e.kind != KERNEL:
                continue
            if spans is not None:
                t = self.launch_at.get(e.corr)
                if t is None:
                    continue
                i = bisect.bisect_right(starts, t) - 1
                if i < 0 or t >= spans[i][1]:
                    continue
            total += min(e.end, self.hi) - max(e.start, self.lo)
        return total / 1e9

    def _named(self, names: Sequence[str]) -> list:
        """(start, end) of every span of those names; raises Missing where
        the trace holds none."""
        out = [(s.start, s.end) for s in self.spans if s.name in names]
        if not out:
            raise Missing(f"no span named {' or '.join(names)} in the "
                          "trace")
        return out

    def span_s(self, names: Sequence[str]) -> float:
        """Union of the named host spans' intervals inside the
        operations."""
        merged = union(self._named(names))
        return sum(clipped_length(merged, o.start, o.end)
                   for o in self.ops) / 1e9

    def device_ops(self, top: int = 10) -> list:
        """The device operations that took most time, summed by name."""
        by = defaultdict(int)
        for e in self.device:
            by[e.name] += min(e.end, self.hi) - max(e.start, self.lo)
        return [[n, t / 1e9] for n, t in
                sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """Idle device time summed by what the host was doing: the
        innermost host span open over each stretch of each gap."""
        named = [s for s in self.spans if s.name != WINDOW_SPAN]
        cuts = sorted({self.lo, self.hi} | {
            t for s in named for t in (s.start, s.end)
            if self.lo < t < self.hi})
        idle = gaps(self.busy, self.lo, self.hi)
        by = defaultdict(int)
        i = 0
        for a, b in zip(cuts, cuts[1:]):
            name = innermost(named, (a + b) // 2) or "between operations"
            while i < len(idle) and idle[i][1] <= a:
                i += 1
            j = i
            while j < len(idle) and idle[j][0] < b:
                by[name] += min(b, idle[j][1]) - max(a, idle[j][0])
                j += 1
        return [[n, t / 1e9] for n, t in
                sorted(by.items(), key=lambda kv: -kv[1])[:top]]
