"""The per-layer metrics read from the program's own spans and counters
(`harness/program_spans.py`, `work/launch_kinds.py`): every new metric on the cells at a
test's size reads a finite number or nothing; the idle attribution, the stream rooflines
and the counter share on synthetic recordings; the launch kinds' work against the
trunks' and hand-worked least times."""

import json
import math
import types

import pytest

from benchmark.harness import program_spans as P
from benchmark.harness.cell import REPO, metric_reader, module
from benchmark.harness.device import least_seconds
from benchmark.harness.runner import run
from benchmark.tests.conftest import SEED
from embodied_clip_tpu_torch.utils.profiling import Recording, SpanRecord

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NEW = [m for m in BENCH["per_layer"]
       if "program_spans" in (REPO / "benchmark" / "metrics" / f"{m['name']}.py").read_text()]
TRAIN = {"env_step_ms.train", "policy_ms.train", "optimizer_ms.train", "env_idle_pct.train"}
HOST = {"clip_rn50_int8.act_b8": {"h2d_ms.act", "dispatch_idle_pct.act"},
        "clip_rn50_int8.ddppo_gridnav_4chip": TRAIN | {"rank_skew_pct.train"}}


def _config(name):
    return json.loads((REPO / "benchmark" / "configs" / f"{name}.json").read_text())


def test_the_new_metrics():
    assert [m["name"] for m in NEW] == [
        "int8_stem_roofline", "k3_roofline", "stride_blocks_roofline", "k5_roofline",
        "near_tie_pct.encode", "k7_roofline", "k6_roofline", "bf16_stride_blocks_roofline",
        "bf16_stem_roofline", "h2d_ms.act", "dispatch_idle_pct.act", "env_step_ms.train",
        "policy_ms.train", "optimizer_ms.train", "env_idle_pct.train", "attention_roofline",
        "attention_pad_pct.encode", "pointwise_fused_pct.encode",
        "bf16_stride_fused_pct.encode", "allreduce_ms.train", "rank_skew_pct.train"]


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_new_metrics_read_a_number_or_nothing_at_test_size(tiny_cell, name):
    result, checks = run(tiny_cell(name), SEED, 0.2, True, "cpu")
    assert result["correct"], checks
    for m in NEW:
        if name in m["workloads"] and m["name"] in result["metrics"]:
            assert math.isfinite(result["metrics"][m["name"]]["value"])
    # The host spans read on the CPU too; stream times and counters need the card.
    assert HOST.get(name, set()) <= set(result["metrics"])


def _view(work=None, units=2, busy=(), window=(10.0, 11.0)):
    trace = types.SimpleNamespace(window=window, window_s=window[1] - window[0],
                                  busy_intervals=lambda: [list(iv) for iv in busy])
    return types.SimpleNamespace(trace=trace, units=units, work=work or {})


def _span(name, sid, parent, start, end, thread=1, stream=None):
    return SpanRecord(name, sid, parent, sid if parent is None else 0, thread,
                      int(start * 1e9), int(end * 1e9), stream_ns=stream)


def _recording(monkeypatch, spans, counters=None):
    rec = Recording(spans, counters or {}, {})
    monkeypatch.setattr(P, "recording", lambda: rec)
    return rec


def test_idle_attribution_on_synthetic_spans(monkeypatch):
    # Busy: [10.1, 10.2] and [10.5, 10.6] of the window [10, 11]; gaps start at 10.0,
    # 10.2 and 10.6. The host at 10.0 is in encode.to_device; at 10.2 in int8.stem
    # (under encode.trunk); at 10.6 in encode.heads on thread 1 while thread 2 sits in an
    # env step opened later, which is the innermost span open.
    _recording(monkeypatch, [
        _span("encode", 0, None, 9.9, 10.9),
        _span("encode.to_device", 1, 0, 9.95, 10.15),
        _span("encode.trunk", 2, 0, 10.15, 10.55),
        _span("int8.stem", 3, 2, 10.16, 10.3),
        _span("encode.heads", 4, 0, 10.55, 10.9),
        _span("rollout.env", 5, None, 10.58, 10.7, thread=2)])
    view = _view(busy=[(10.1, 10.2), (10.5, 10.6)])
    assert P.idle_pct_under(view, ("encode.trunk", "encode.heads")) == pytest.approx(30.0)
    assert P.idle_pct_under(view, ("encode.to_device",)) == pytest.approx(10.0)
    assert P.idle_pct_under(view, ("rollout.env",)) == pytest.approx(40.0)
    assert metric_reader("dispatch_idle_pct.act")(view) == pytest.approx(30.0)
    assert metric_reader("env_idle_pct.train")(view) == pytest.approx(40.0)


def test_host_ms_and_counters_on_synthetic_spans(monkeypatch):
    _recording(monkeypatch, [_span("rollout.env", 0, None, 1.0, 1.25),
                             _span("rollout.env", 1, None, 2.0, 2.5),
                             _span("update.optimizer", 2, None, 3.0, 3.1)],
               {"sb.near_tie_elements": 7, "sb.shortcut_elements": 1000})
    view = _view(units=2)
    assert metric_reader("env_step_ms.train")(view) == pytest.approx(375.0)
    assert metric_reader("optimizer_ms.train")(view) == pytest.approx(50.0)
    assert metric_reader("policy_ms.train")(view) is None
    assert metric_reader("near_tie_pct.encode")(view) == pytest.approx(0.7)
    _recording(monkeypatch, [])
    assert metric_reader("near_tie_pct.encode")(view) is None
    assert metric_reader("dispatch_idle_pct.act")(view) is None


def test_stream_roofline_reads_the_cells_work(monkeypatch):
    cfg = _config("clip_rn50_int8")
    args = (cfg, 128, (300, 300))
    view = _view(work=module("work", cfg["work"]).work(*args), units=4)
    least = least_seconds(module("work", "launch_kinds").work(*args)["k3"])
    _recording(monkeypatch, [_span("int8.stage1", i, None, i, i + 0.1, stream=4e6)
                             for i in range(4)])
    # 4 units over 4 spans of 4 ms of stream time.
    assert metric_reader("k3_roofline")(view) == pytest.approx(100.0 * least / 4e-3)
    assert metric_reader("k5_roofline")(view) is None     # no such span
    assert P.stream_roofline(_view(work={"model": {}}), "int8.stage1", "k3") is None
    monkeypatch.setattr(P, "recording", lambda: None)      # a program without the recorder
    assert metric_reader("k3_roofline")(view) is None


@pytest.mark.parametrize("name,least_ms", [
    ("clip_rn50_int8", {"int8_stem": 0.543, "k3": 0.0931, "stride_blocks": 0.3191,
                        "k5": 0.2825}),
    ("imagenet_rn50_bf16", {"bf16_stem": 0.0305, "k7": 0.1729, "bf16_stride_blocks": 0.2893,
                            "k6": 0.5652}),
    ("clip_rn50_bf16", {"bf16_stem": 0.0926, "k7": 0.1729, "bf16_stride_blocks": 0.5586,
                        "k6": 0.5652})])
def test_launch_kinds_add_up_to_the_trunk(name, least_ms):
    cfg = _config(name)
    kinds = module("work", "launch_kinds").work(cfg, 128, (300, 300))
    trunk = module("work", cfg["work"]).work(cfg, 128, (300, 300))[
        f"{cfg['precision']['stage_convs']}_trunk"]
    total = {}
    for k in kinds.values():
        for p, v in k["ops"].items():
            total[p] = total.get(p, 0.0) + v
    assert total == pytest.approx(trunk["ops"], rel=1e-12)
    assert {k: round(1e3 * least_seconds(v), 4) for k, v in kinds.items()} == least_ms
    # Every kind is bound by its operations at this batch.
    for k in kinds.values():
        assert k["bytes"] / 3.35e12 < least_seconds(k)


# The parent commit's kinds of the two configurations that had them (batch 128, 300x300),
# copied from its `launch_kinds.work`: keying the kinds by the trunk's path moved none.
PARENT_KINDS = {
    "clip_rn50_int8": {
        "int8_stem": {"ops": {"f32": 32369541120.0, "bf16": 59190018048.0}, "bytes": 64282304.0},
        "k3": {"ops": {"int8": 157840048128.0, "bf16": 13153337344.0}, "bytes": 128679936.0},
        "stride_blocks": {"ops": {"int8": 473520144384.0, "bf16": 78920024064.0},
                          "bytes": 280412160.0},
        "k5": {"ops": {"int8": 559016837120.0}, "bytes": 207994880.0}},
    "imagenet_rn50_bf16": {
        "bf16_stem": {"ops": {"bf16": 30211571712.0}, "bytes": 89934208.0},
        "k7": {"ops": {"bf16": 170993385472.0}, "bytes": 257327104.0},
        "bf16_stride_blocks": {"ops": {"bf16": 286085087232.0}, "bytes": 555319296.0},
        "k6": {"ops": {"bf16": 559016837120.0}, "bytes": 390299648.0}}}


@pytest.mark.parametrize("name", list(PARENT_KINDS))
def test_launch_kinds_of_the_existing_configs_are_the_parents(name):
    assert module("work", "launch_kinds").work(_config(name), 128, (300, 300)) == \
        PARENT_KINDS[name]


def test_clip_bf16_gets_the_kinds_its_spans_time():
    int8, bf16 = _config("clip_rn50_int8"), _config("clip_rn50_bf16")
    kinds = module("work", "launch_kinds").work(bf16, 128, (300, 300))
    assert list(kinds) == ["bf16_stem", "k7", "bf16_stride_blocks", "k6"]
    assert set(kinds["k6"]["ops"]) == {"bf16"}
    # The same shapes as the int8 trunk: only the precisions differ, kind for kind.
    same = module("work", "launch_kinds").work(int8, 128, (300, 300))
    for a, b in zip(kinds.values(), same.values()):
        assert sum(a["ops"].values()) == sum(b["ops"].values())
    readers = {m["name"]: m for m in BENCH["per_layer"]}
    for metric in ("k7_roofline", "k6_roofline", "bf16_stride_blocks_roofline",
                   "bf16_stem_roofline", "bf16_trunk_roofline"):
        assert "clip_rn50_bf16.encode_b128" in readers[metric]["workloads"]


def test_unit_kinds_skips_a_family_without_kinds(monkeypatch, tmp_path):
    # A benchmark whose first cell is a ViT, which has no launch kinds: the search
    # passes over it to the cell whose work the view holds.
    vit = {"name": "vit", "work": "clip_vision_transformer",
           "model": {"patch_size": 16, "width": 32, "layers": 1, "heads": 4,
                     "output_dim": 16, "image_size": 64}}
    (tmp_path / "vit.json").write_text(json.dumps(vit))
    bf16 = REPO / "benchmark" / "configs" / "clip_rn50_bf16.json"
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({
        "configs": [{"name": "vit", "file": "vit.json"},
                    {"name": "clip_rn50_bf16", "file": str(bf16)}],
        "workloads": [{"config": "vit", "traffic": "encode_b128"},
                      {"config": "clip_rn50_bf16", "traffic": "encode_b128"}]}))
    monkeypatch.setattr(P, "REPO", tmp_path)
    cfg = _config("clip_rn50_bf16")
    args = (cfg, 128, (300, 300))
    view = _view(work=module("work", cfg["work"]).work(*args))
    assert P.unit_kinds(view) == module("work", "launch_kinds").work(*args)
    assert P.unit_kinds(_view(work={"model": {"ops": {}, "bytes": 0.0}})) is None
