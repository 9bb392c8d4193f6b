"""Span wrapping and the attribution of work to the innermost span, on a CPU profiler
run (the card's kernels are attributed by the same sweep over the spans the profiler
puts on the device's timeline)."""

import sys
import types

import torch

from benchmark.harness import spans
from benchmark.harness.trace import _sweep

MOD = types.ModuleType("bench_span_case")


def inner(x):
    return torch.mm(x, x)


def outer(x):
    y = torch.add(x, 1.0)
    return MOD.inner(y)   # looked up where it is wrapped, as the program looks up its own


MOD.inner, MOD.outer = inner, outer
sys.modules["bench_span_case"] = MOD
LAYERS = {"outer_layer": {"spans": ["bench_span_case:outer"], "host_timed": True},
          "inner_layer": {"spans": ["bench_span_case:inner"]}}


def test_wrapped_restores_and_times():
    times = {}
    with spans.wrapped(LAYERS, times):
        assert MOD.outer is not outer and MOD.inner is not inner
        MOD.outer(torch.ones(4, 4))
    assert MOD.outer is outer and MOD.inner is inner
    assert len(times["outer_layer"]) == 1 and "inner_layer" not in times


def test_cpu_ops_attributed_to_innermost_span():
    x = torch.ones(64, 64)
    with spans.wrapped(LAYERS, {}):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            MOD.outer(x)
            torch.sub(x, 1.0)
    events = prof.profiler.kineto_results.events()
    host = [(e.name(), e.start_thread_id(), e.start_ns() * 1e-9,
             (e.start_ns() + e.duration_ns()) * 1e-9)
            for e in events if e.name().startswith(spans.PREFIX)]
    assert {h[0] for h in host} == {"bench/outer_layer", "bench/inner_layer"}
    ops = [(e.name(), e.start_thread_id(), (e.start_ns() + 1) * 1e-9)
           for e in events if e.name() in ("aten::mm", "aten::add", "aten::sub")]
    inside = dict(zip([o[0] for o in ops], _sweep(host, [o[2] for o in ops])))
    owner = {name: max(spans_)[1] if spans_ else None for name, spans_ in inside.items()}
    assert owner == {"aten::mm": "bench/inner_layer", "aten::add": "bench/outer_layer",
                     "aten::sub": None}
    assert sorted(n for _, n in inside["aten::mm"]) == ["bench/inner_layer",
                                                        "bench/outer_layer"]
    assert [n for _, n in inside["aten::add"]] == ["bench/outer_layer"]
    assert inside["aten::sub"] == []
