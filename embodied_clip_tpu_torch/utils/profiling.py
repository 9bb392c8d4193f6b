"""Tracing and profiling: the port's spans and counters, stage timers and the operator's
device trace (port of `embodied_clip_tpu/utils/profiling.py`, extended).

The program opens a `span(name)` at each layer boundary (the encoders' `encode`, the
int8 and bf16 trunks' pieces, the rollout's and the PPO update's steps) and adds to
named counters with `count`. Both are live exactly while a `torch.profiler` session
records (`torch.autograd._profiler_enabled()`): a traced benchmark run, or `trace`
below. Outside one, `span` costs one flag check and returns one shared no-op context,
and `count` returns at once: nothing is allocated and nothing of `torch.profiler` is
called. Inside one, a span records its name, its id, its parent's and its root's (the
request: one `encode`, `rollout` or `update`), its thread, its host start and end from
`time.time_ns()` (Unix-epoch nanoseconds, the clock of the profiler's own events), and
where CUDA is initialised a pair of timing events at entry and exit on the stream that
was current when its root opened, resolved only when read (and then reused). It never
opens a `record_function` (a span stays out of the profiler's event list, so it neither
adds device annotations nor splits the profiler's own spans) and never synchronises.
`recorded()` returns the session's spans and counters, with each name's calls, host
seconds, host self-seconds and stream seconds. Each timing event costs the card about
2 µs between kernels (it waits for the kernel before it).

A store holds one session: the first span or count of a session, opened outside any span
after a span call found the profiler off, clears it (`trace` clears it at its start). It
is capped (`MAX_SPANS`, `MAX_HELD_BYTES`); what is past the cap is counted as dropped. A
count that needs device work (the stride shortcut's near-ties) holds its tensors, filled
in the recorder's own device arena (`buffer`), and is counted when the session is read,
so that it adds no launch to the traced stretch and moves no block of the caching
allocator.

`StageTimer` gives the host path's per-stage seconds (act / env_step / update) as trainer
metrics, each stage also a span (`stage.<name>`); `trace` wraps `torch.profiler` for an
on-demand device trace of a block, written for TensorBoard's profiler plugin or
Perfetto, with the block's spans and counters beside it as JSON.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import socket
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, Iterator, List, Optional

import torch

__all__ = ["StageTimer", "trace", "span", "count", "hold", "buffer", "recorded",
           "Recording", "SpanRecord", "MAX_SPANS", "MAX_HELD_BYTES", "ARENA_CHUNK_BYTES"]

MAX_SPANS = 200_000
MAX_HELD_BYTES = 1 << 30
ARENA_CHUNK_BYTES = 256 << 20

_profiler_enabled = torch.autograd._profiler_enabled


@dataclasses.dataclass(slots=True)
class SpanRecord:
    """One span; while open, also its own context manager."""

    name: str
    id: int
    parent: Optional[int]   # None for a root
    root: int
    thread: int
    start_ns: int = 0       # time.time_ns(): the profiler's clock
    end_ns: Optional[int] = None
    events: Optional[tuple] = None      # (start, end) CUDA timing events, until read
    stream_ns: Optional[float] = None   # the time between them on their stream

    @property
    def host_s(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        _RECORDER.close(self)
        return False


@dataclasses.dataclass
class Stat:
    calls: int = 0
    host_s: float = 0.0
    self_s: float = 0.0
    stream_s: Optional[float] = None


@dataclasses.dataclass
class Recording:
    """A session's closed spans (in the order they opened), its counters, and what the
    caps dropped (`dropped`: spans, and under `held:<counter>` each counter's held
    values)."""

    spans: List[SpanRecord]
    counters: Dict[str, int]
    dropped: Dict[str, int]

    def by_name(self) -> Dict[str, Stat]:
        """Per span name: calls, host seconds, host self-seconds (each span's duration
        less its children's) and stream seconds (None where no span of the name has
        timing events)."""
        children = defaultdict(float)
        for s in self.spans:
            if s.parent is not None:
                children[s.parent] += s.host_s
        out: Dict[str, Stat] = {}
        for s in self.spans:
            st = out.setdefault(s.name, Stat())
            st.calls += 1
            st.host_s += s.host_s
            st.self_s += s.host_s - children[s.id]
            if s.stream_ns is not None:
                st.stream_s = (st.stream_s or 0.0) + s.stream_ns * 1e-9
        return out

    def to_json(self) -> dict:
        return {"clock": "unix_ns", "spans": [
            {k: v for k, v in dataclasses.asdict(s).items() if k != "events"}
            for s in self.spans],
            "counters": self.counters, "dropped": self.dropped,
            "by_name": {k: dataclasses.asdict(v) for k, v in self.by_name().items()}}


class _Off:
    """The shared no-op context of a span opened with the profiler off; it marks the
    store's session as over."""

    __slots__ = ()

    def __enter__(self):
        _RECORDER.ended = True
        return self

    def __exit__(self, *exc):
        return False


class _Dropped:
    """The shared context of a span past `MAX_SPANS`: it only keeps the stack."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        _RECORDER.local.stack.pop()
        return False


class _Recorder:
    """The store. Spans take no lock: ids come from an `itertools.count` and list appends
    are atomic; the counters and the held values are read-modify-write and take it."""

    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()   # .stack of open spans, .stream of the root
        self.ended = False
        self.free: List = []   # timing events to reuse
        self.spans: List[SpanRecord] = []
        self.clear()

    def clear(self):
        with self.lock:
            for s in self.spans:
                if s.events is not None:
                    self.free += [e for e in s.events if e is not None]
            self.spans = []
            self.ids = itertools.count()
            self.counters: Dict[str, int] = defaultdict(int)
            self.held: List[tuple] = []   # (counter, fn, args)
            self.held_bytes = 0
            self.arena: List[list] = []   # [chunk, bytes used] of device memory to hold
            self.dropped: Dict[str, int] = defaultdict(int)

    def session(self) -> list:
        """This thread's span stack, the store cleared first if a span call found the
        profiler off since the last session and no span is open here."""
        local = self.local
        stack = getattr(local, "stack", None)
        if stack is None:
            stack = local.stack = []
        if self.ended and not stack:
            self.ended = False
            self.clear()
        return stack

    def _event(self):
        return self.free.pop() if self.free else torch.cuda.Event(enable_timing=True)

    def open(self, name: str):
        stack = self.session()
        if len(self.spans) >= MAX_SPANS:
            with self.lock:
                self.dropped["spans"] += 1
            stack.append(None)
            return _DROPPED
        sid, local = next(self.ids), self.local
        if stack:
            parent = stack[-1]
            record = SpanRecord(name, sid, parent.id, parent.root, parent.thread)
        else:
            record = SpanRecord(name, sid, None, sid, threading.get_ident())
            # A root's stream, looked up once (5-7 µs a lookup): its spans time it.
            local.stream = (torch.cuda.current_stream() if torch.cuda.is_initialized()
                            else None)
        self.spans.append(record)
        stack.append(record)
        if local.stream is not None:
            start = self._event()
            start.record(local.stream)
            record.events = (start, None)
        record.start_ns = time.time_ns()
        return record

    def close(self, record: SpanRecord):
        end_ns = time.time_ns()
        local = self.local
        local.stack.pop()
        record.end_ns = end_ns
        if record.events is not None:
            end = self._event()
            end.record(local.stream)
            record.events = (record.events[0], end)

    def count(self, name: str, n: int):
        self.session()
        with self.lock:
            self.counters[name] += n

    def buffer(self, n: int, dtype: torch.dtype, device: torch.device):
        self.session()
        nbytes = n * dtype.itemsize
        size = -(-nbytes // 256) * 256
        with self.lock:
            if sum(len(c) for c, _ in self.arena) + size > MAX_HELD_BYTES:
                return None
            if not self.arena or self.arena[-1][0].device != device or \
                    self.arena[-1][1] + size > len(self.arena[-1][0]):
                self.arena.append([torch.empty(max(ARENA_CHUNK_BYTES, size),
                                               dtype=torch.uint8, device=device), 0])
            chunk, used = self.arena[-1]
            self.arena[-1][1] = used + size
        return chunk[used:used + nbytes].view(dtype)

    def hold(self, name: str, fn: Callable[..., int], args: tuple) -> bool:
        self.session()
        nbytes = sum(a.numel() * a.element_size() for a in args
                     if isinstance(a, torch.Tensor))
        with self.lock:
            if self.held_bytes + nbytes > MAX_HELD_BYTES:
                self.dropped[f"held:{name}"] += 1
                return False
            self.held_bytes += nbytes
            self.held.append((name, fn, args))
        return True

    def read(self) -> Recording:
        with self.lock:
            for name, fn, args in self.held:
                self.counters[name] += int(fn(*args))
            self.held, self.held_bytes, self.arena = [], 0, []
            spans = [s for s in self.spans if s.end_ns is not None]
        for s in spans:
            if s.events is not None and s.events[1] is not None:
                start, end = s.events
                end.synchronize()
                s.stream_ns, s.events = start.elapsed_time(end) * 1e6, None
                self.free += [start, end]
        return Recording(spans, dict(self.counters), dict(self.dropped))


_RECORDER = _Recorder()
_OFF = _Off()
_DROPPED = _Dropped()


def span(name: str):
    """A context manager around one layer's work, recorded while a `torch.profiler`
    session records; otherwise one shared no-op context."""
    if not _profiler_enabled():
        return _OFF
    return _RECORDER.open(name)


def count(name: str, n: int = 1) -> None:
    """Add `n` to counter `name` while a `torch.profiler` session records."""
    if not _profiler_enabled():
        return
    _RECORDER.count(name, n)


def hold(name: str, fn: Callable[..., int], *args) -> bool:
    """While a session records, keep `args` (tensors are held, not copied) and add
    `fn(*args)` to counter `name` when the session is read, so that the count adds no
    device work to the traced stretch. False, and nothing held, with the profiler off or
    past `MAX_HELD_BYTES` (counted as dropped): a caller that counts a base beside the
    held count adds to it only when this returns True."""
    if not _profiler_enabled():
        return False
    return _RECORDER.hold(name, fn, args)


def buffer(n: int, dtype: torch.dtype, device) -> Optional[torch.Tensor]:
    """While a session records, an uninitialised tensor of `n` elements for the program
    to fill and then `hold`: a view into the recorder's device arena (chunks of at least
    `ARENA_CHUNK_BYTES`, released when the session is read), so that holding it keeps no
    block of the caching allocator from reuse. None with the profiler off or past
    `MAX_HELD_BYTES`: the caller allocates as usual."""
    if not _profiler_enabled():
        return None
    return _RECORDER.buffer(n, dtype, torch.device(device))


def recorded() -> Recording:
    """The spans and counters of the current or last profiler session, each closed span
    with its stream time resolved (this synchronises on the spans' timing events)."""
    return _RECORDER.read()


class StageTimer:
    """Accumulates host wall time per named stage; `summary()` returns seconds and
    shares. A stage's seconds are the host's time inside it: the work it enqueues on the
    card is in them only as far as the stage waits for it (a read back to the host, a
    synchronising copy); the timer adds no synchronise. Each stage is also a span,
    `stage.<name>`, on the trace's clock."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            with span(f"stage.{name}"):
                yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, float]:
        total = sum(self.totals.values()) or 1.0
        out: Dict[str, float] = {}
        for name, secs in self.totals.items():
            out[f"{name}_s"] = secs
            out[f"{name}_frac"] = secs / total
            out[f"{name}_calls"] = float(self.counts[name])
        return out

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a `torch.profiler` trace (host, and the card's kernels where there is
    one) of the enclosed block into `log_dir`, and beside it the block's program spans
    and counters as `<host>_<pid>.spans.json` (nanoseconds on the trace's clock).
    Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    _RECORDER.clear()
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)
                 ) as prof:
        yield prof
    path = os.path.join(log_dir, f"{socket.gethostname()}_{os.getpid()}.spans.json")
    with open(path, "w") as f:
        json.dump(recorded().to_json(), f)
