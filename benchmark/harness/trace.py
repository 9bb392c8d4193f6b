"""Reading a `torch.profiler` run in memory (no trace is written to disk).

Each device activity (kernel, copy, set) belongs to the innermost benchmark span
(`bench/...`) that the profiler puts around it on the device's timeline, or else to the
innermost span open on the host when the operation that launched it (its
`linked_correlation_id`) began, or to `outside`; it lies within every such span. The
device's busy time is the union of its activity intervals (the method of
`chip_smoke.busy_ms`), and its idle gaps are labelled by the innermost span open on the
host when each gap began.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import List, Optional, Tuple

from benchmark.harness.spans import PREFIX

OUTSIDE = "outside"


@dataclasses.dataclass
class Activity:
    name: str
    start: float   # seconds, on the profiler's clock
    end: float
    owner: str     # the layer key of its innermost span, or OUTSIDE
    within: frozenset = frozenset()   # the keys of every span that contains it


def _key(span_name: str) -> str:
    return span_name[len(PREFIX):]


@dataclasses.dataclass
class Trace:
    activities: List[Activity]
    host_spans: list      # [(name, thread, start, end)] of the benchmark's host spans
    window: Tuple[float, float]
    span_share: float     # share of activities found inside a benchmark span
    linked_share: float   # share linked to the host operation that launched them

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_intervals(self):
        iv = sorted((a.start, a.end) for a in self.activities)
        merged = []
        for a, b in iv:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def busy_s(self) -> float:
        lo, hi = self.window
        return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in self.busy_intervals())

    def device_s(self, key: Optional[str] = None) -> float:
        """Device seconds of the activities whose innermost span is `key` (all if None)."""
        return sum(a.end - a.start for a in self.activities if key is None or a.owner == key)

    def device_within_s(self, key: str) -> float:
        """Device seconds of the activities inside span `key`, nested spans included."""
        return sum(a.end - a.start for a in self.activities if key in a.within)

    def kernels(self) -> int:
        """Device kernels, copies and sets left out."""
        return sum(1 for a in self.activities if not a.name.startswith(("Memcpy", "Memset")))

    def top_ops(self, n: int = 10):
        total = collections.Counter()
        for a in self.activities:
            total[a.name] += a.end - a.start
        return [[k, v] for k, v in total.most_common(n)]

    def idle_gaps(self, n: int = 10):
        """The idle gaps inside the window, summed by the innermost span open on the
        host when each began: [[label, seconds]], longest first."""
        lo, hi = self.window
        edges = [lo] + [x for iv in self.busy_intervals() for x in iv] + [hi]
        gaps = [(max(a, lo), min(b, hi)) for a, b in zip(edges[0::2], edges[1::2])]
        gaps = [(a, b) for a, b in gaps if b > a]
        total = collections.Counter()
        for (a, b), inside in zip(gaps, _sweep(self.host_spans, [a for a, _ in gaps])):
            total["host in " + (_key(max(inside)[1]) if inside else "no span")] += b - a
        return [[k, v] for k, v in total.most_common(n)]


def _sweep(spans, times):
    """For each time, the (start, name) of every span [(name, thread, start, end)]
    containing it (none for a NaN time), in one pass over the sorted edges."""
    edges = sorted([(s, 0, i) for i, (_, _, s, _) in enumerate(spans)] +
                   [(e, 2, i) for i, (_, _, _, e) in enumerate(spans)] +
                   [(t, 1, i) for i, t in enumerate(times) if t == t])
    active, out = {}, [[] for _ in times]
    for _, kind, i in edges:
        if kind == 0:
            active[i] = (spans[i][2], spans[i][0])
        elif kind == 2:
            active.pop(i, None)
        else:
            out[i] = list(active.values())
    return out


def from_profiler(prof) -> Trace:
    """A Trace of a finished `torch.profiler.profile` run, from its kineto events.

    The profiler also puts each `record_function` span on the device's timeline (from
    the first to the last activity launched inside it). An activity belongs to the
    innermost such device span that contains it, or else to the innermost host span
    open when the operation that launched it began; it lies within every span of
    either kind that contains it (so a span's nested work counts toward it too)."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    ops, spans, dev_spans, device = {}, [], [], []
    window = None
    for e in events:
        start = e.start_ns() * 1e-9
        end = start + e.duration_ns() * 1e-9
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            if e.linked_correlation_id() == 0:
                ops[e.correlation_id()] = (e.start_thread_id(), start)
                if name == PREFIX + "window":
                    window = (start, end)
                elif name.startswith(PREFIX):
                    spans.append((name, e.start_thread_id(), start, end))
        elif name.startswith(PREFIX):
            if name != PREFIX + "window":
                dev_spans.append((name, 0, start, end))
        else:
            device.append((name, start, end, e.linked_correlation_id()))
    mids = [0.5 * (a[1] + a[2]) for a in device]
    launched = [ops[a[3]][1] if a[3] in ops else float("nan") for a in device]
    acts, found, linked = [], 0, 0
    for a, on_device, on_host in zip(device, _sweep(dev_spans, mids), _sweep(spans, launched)):
        name, start, end, corr = a
        linked += corr in ops
        inner = on_device or on_host
        owner = max(inner)[1] if inner else None
        found += owner is not None
        acts.append(Activity(name, start, end, _key(owner) if owner else OUTSIDE,
                             frozenset(_key(n) for _, n in on_device + on_host)))
    if window is None:
        raise RuntimeError("the trace holds no window span")
    return Trace(acts, spans, window, found / max(len(device), 1),
                 linked / max(len(device), 1))
