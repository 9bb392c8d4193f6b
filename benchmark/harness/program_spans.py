"""Reading the program's own spans and counters for the per-layer metrics.

The program records them itself while the traced stretch's `torch.profiler` session
runs (`embodied_clip_tpu_torch.utils.profiling`): each span's host start and end on the
profiler's clock (Unix-epoch nanoseconds), its parent, and on the card the stream time
between two timing events; its counters. They stay out of the profiler's event list, so
they move none of the harness's own readings. Every function here returns None where
the program records nothing to read: a program without the recorder, a session without
the span or counter, a CPU run's missing stream times.

- `host_ms_per_unit`: host ms of a span name's calls per traced unit;
- `stream_roofline`: the least time of a launch kind (`work/launch_kinds.py`, from the
  cell's published shapes, at `device.least_seconds`'s peaks) over the stream time of
  the spans that run it, percent; stream time is the kernels' time plus the gaps
  between them, so the share errs low;
- `idle_pct_under`: the share of the traced window in which the card is idle while the
  innermost program span open on the host when the gap began lies under one of the
  given spans (the harness's rule for its own spans, on the same busy intervals);
- `counter_pct`: one counter over another, percent;
- `stream_ms_per_unit`: stream ms of a span name's calls per traced unit;
- `rank_host_ms`: each rank's mean host ms a call of a span name, in a multi-rank run.
"""

from __future__ import annotations

import json
from typing import Iterable, Optional

from benchmark.harness import device as card
from benchmark.harness.cell import HERE, REPO, module
from benchmark.harness.trace import _sweep


def recording():
    """The program's recording of the traced stretch, or None."""
    try:
        from embodied_clip_tpu_torch.utils.profiling import recorded
    except ImportError:
        return None
    return recorded()


def _stat(name: str):
    rec = recording()
    return None if rec is None else rec.by_name().get(name)


def host_ms_per_unit(view, name: str) -> Optional[float]:
    st = _stat(name)
    return None if st is None else 1e3 * st.host_s / view.units


def unit_kinds(view) -> Optional[dict]:
    """The launch kinds' work of one unit of the traced cell: the cell of BENCHMARK.json
    whose configuration and traffic declare the view's work (None where none does, as at
    a test's size)."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    files = {c["name"]: c["file"] for c in bench["configs"]}
    for w in bench["workloads"]:
        config = json.loads((REPO / files[w["config"]]).read_text())
        traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
        if config["work"] not in module("work", "launch_kinds").KINDS or "batch" not in traffic:
            continue
        args = (config, traffic["batch"], tuple(traffic["frame_hw"]))
        if module("work", config["work"]).work(*args) == view.work:
            return module("work", "launch_kinds").work(*args)
    return None


def stream_roofline(view, name: str, kind: str) -> Optional[float]:
    st = _stat(name)
    if st is None or not st.stream_s:
        return None
    kinds = unit_kinds(view)
    if kinds is None or kind not in kinds:
        return None
    return 100.0 * card.least_seconds(kinds[kind]) * view.units / st.stream_s


def _under(rec, names: Iterable[str]):
    """(by id, is a span id's span under one of `names`)."""
    names = set(names)
    by_id = {s.id: s for s in rec.spans}

    def under(sid) -> bool:
        s = by_id.get(sid)
        while s is not None:
            if s.name in names:
                return True
            s = by_id.get(s.parent)
        return False
    return under


def _host(rec):
    return [(s.id, s.thread, s.start_ns * 1e-9, s.end_ns * 1e-9) for s in rec.spans]


def idle_pct_under(view, names: Iterable[str]) -> Optional[float]:
    rec = recording()
    if rec is None or not rec.spans:
        return None
    under = _under(rec, names)
    lo, hi = view.trace.window
    edges = [lo] + [x for iv in view.trace.busy_intervals() for x in iv] + [hi]
    gaps = [(max(a, lo), min(b, hi)) for a, b in zip(edges[0::2], edges[1::2])]
    gaps = [(a, b) for a, b in gaps if b > a]
    idle = sum(b - a for (a, b), inside in zip(gaps, _sweep(_host(rec), [a for a, _ in gaps]))
               if inside and under(max(inside)[1]))
    return 100.0 * idle / view.trace.window_s


def stream_ms_per_unit(view, name: str) -> Optional[float]:
    st = _stat(name)
    return None if st is None or not st.stream_s else 1e3 * st.stream_s / view.units


def rank_host_ms(view, name: str) -> Optional[list]:
    """[each rank's mean host ms a call of span `name`] in a multi-rank run; None in one
    process or where a rank never called it."""
    if not view.ranks or any(name not in r for r in view.ranks):
        return None
    return [1e3 * r[name][1] / r[name][0] for r in view.ranks]


def counter_pct(part: str, whole: str) -> Optional[float]:
    rec = recording()
    if rec is None or not rec.counters.get(whole):
        return None
    return 100.0 * rec.counters.get(part, 0) / rec.counters[whole]
