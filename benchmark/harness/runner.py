"""One run of a cell: set-up, warm-up, the measured window (traced or not), the
program freed, then its outputs judged against the reference. A cell on more than one
card runs the same on every rank, in lockstep (`harness/ranks.py`), and rank 0 gives
the one result: the cards used, every rank's peak memory, the failed operations of all.

With `trace` off the metrics are the cell's end-to-end metrics; with it on, the
layers' spans are wrapped and `torch.profiler` records a steady stretch of the window
(`trace_units` units after `trace_skip`), from which the per-layer metrics are read.
"""

from __future__ import annotations

import contextlib
import gc
import os
import sys
import time

import numpy as np
import torch

from benchmark.harness import device as card
from benchmark.harness import ranks, spans, trace as tracing
from benchmark.harness.cell import Cell, metric_reader, module
from benchmark.harness.compare import judge


PREFIX = ""   # a rank above 0 marks its lines
# What no rank may have loaded once the window has closed, by top-level module name.
FORBIDDEN = {"jax", "jaxlib", "flax", "embodied_clip_tpu"}


def log(msg: str):
    # One write a line, so that the ranks' lines on a shared stderr do not interleave.
    sys.stderr.write(PREFIX + msg + "\n")
    sys.stderr.flush()


def forbidden_loaded() -> list:
    """The FORBIDDEN top-level modules this process has loaded, sorted."""
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def process_start() -> float:
    """This process's start on the `time.time()` clock (Linux: /proc), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(l.split()[1]) for l in f if l.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


class View:
    """What a per-layer metric's reader sees: the traced stretch and the work of the
    units in it."""

    def __init__(self, trace: tracing.Trace, units: int, work: dict, host_times: dict,
                 ranks=None):
        self.trace, self.units, self.work, self.host_times = trace, units, work, host_times
        self.ranks = ranks   # in a multi-rank run, each rank's {span: [calls, host s]}

    def roofline(self, layer: str):
        """Percent of the layer's least time (its work at the peaks) over its device
        time; None where the layer ran no device work or has no work count."""
        dev = self.trace.device_s(layer)
        if dev <= 0 or layer not in self.work:
            return None
        return 100.0 * card.least_seconds(self.work[layer]) * self.units / dev

    def mfu(self):
        """Percent of the model's operations at their precisions' peaks over the
        traced window's time."""
        return 100.0 * card.compute_seconds(self.work["model"]) * self.units / self.trace.window_s

    def idle_pct(self):
        return 100.0 * (1.0 - self.trace.busy_s() / self.trace.window_s)

    def kernels_per_unit(self):
        return self.trace.kernels() / self.units

    def host_ms(self, layer: str):
        """Mean host-clock ms of a host-timed layer's calls over the traced run's
        window (each synchronised at its end); None if it was never called."""
        t = self.host_times.get(layer)
        return 1e3 * sum(t) / len(t) if t else None

    def device_ms_per_unit(self, layer: str):
        """Device ms a unit inside the layer's span, nested spans included."""
        dev = self.trace.device_within_s(layer)
        return 1e3 * dev / self.units if dev > 0 else None


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
        control: bool = False, started: float = None):
    """One run: returns (the result line without its checks, the checks). A cell on
    more than one card runs as one process per card (`harness/ranks.py`), this process
    rank 0."""
    group = ranks.start(cell, seed, seconds, trace, device, control) if cell.chips > 1 \
        else ranks.Solo()
    try:
        out = run_rank(cell, seed, seconds, trace, group.device(device), control, group,
                       started)
    except BaseException:
        group.abort()
        raise
    group.close()
    return out


def _rank_stats() -> dict:
    """{program span name: [calls, host seconds]} of this rank's traced stretch."""
    from benchmark.harness.program_spans import recording

    rec = recording()
    if rec is None:
        return {}
    return {k: [st.calls, st.host_s] for k, st in rec.by_name().items()}


def run_rank(cell: Cell, seed: int, seconds: float, trace: bool, device, control: bool,
             group, started: float = None):
    """One rank's run. Every rank runs the same units; rank 0 returns (the result line
    without its checks, the checks), the others None."""
    dev = torch.device(device)
    started = time.time() if started is None else started
    if "host_threads" in cell.traffic:   # the process's CPU thread pool, where the mix sets it
        torch.set_num_threads(cell.traffic["host_threads"])
    t_harness = time.time()
    driver = module("drivers", cell.traffic["driver"]).Driver(cell, seed, dev, control,
                                                                group)
    driver.setup()
    t_setup = time.time()
    for i in range(cell.traffic["warmup_units"]):
        driver.unit(i)
    _sync(dev)
    group.barrier()
    group.expect("unit")
    driver.start_window()
    setup_s = time.time() - started
    log(f"[bench] set-up {setup_s:.3f} s: to the harness {t_harness - started:.3f} (interpreter, "
        f"imports), the cell's set-up {t_setup - t_harness:.3f}, warm-up "
        f"{time.time() - t_setup:.3f}; TF32 matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cuDNN TF32 {torch.backends.cudnn.allow_tf32} in the window")
    log("[bench] " + ranks.host_line())

    skip, want = cell.traffic["trace_skip"], cell.traffic["trace_units"]
    prof, window_span, traced_done = None, None, not trace
    unit_times, n, host_times = [], 0, {}
    with spans.wrapped(cell.layers, host_times) if trace else contextlib.nullcontext():
        t0 = time.perf_counter()
        while True:
            if trace and n == skip:
                _sync(dev)
                acts = [torch.profiler.ProfilerActivity.CPU]
                if dev.type == "cuda":
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                prof = torch.profiler.profile(activities=acts)
                prof.__enter__()
                window_span = torch.profiler.record_function(spans.PREFIX + "window")
                window_span.__enter__()
            ts = time.perf_counter()
            if trace:
                with torch.profiler.record_function(spans.PREFIX + "unit"):
                    driver.unit(n)
            else:
                driver.unit(n)
            unit_times.append(time.perf_counter() - ts)
            n += 1
            if prof is not None and not traced_done and n == skip + want:
                _sync(dev)
                window_span.__exit__(None, None, None)
                prof.__exit__(None, None, None)
                traced_done = True
            if group.decide(time.perf_counter() - t0 >= seconds and traced_done and
                            n >= driver.min_units):
                break
        _sync(dev)
        group.barrier()
        elapsed = time.perf_counter() - t0
    group.expect("judge")

    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    tr = tracing.from_profiler(prof) if trace else None
    mine = {"peak": int(memory_peak), "failed": getattr(driver, "failed", 0),
            "busy": (tr.busy_s(), tr.window_s) if trace else None,
            "spans": _rank_stats() if trace and group.size > 1 else None}
    every = group.gather(mine)
    if group.rank != 0:
        driver.release()
        gc.collect()
        driver.readings()   # its part of the collectives; rank 0 judges
        _sync(dev)
        group.barrier()
        return None
    peaks = [r["peak"] for r in every]
    result = {"correct": False, "attempted": n, "failed": sum(r["failed"] for r in every),
              "metrics": {}, "device": {
                  "platform": "gpu" if dev.type == "cuda" else "cpu",
                  "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                  "count": group.size, "memory_peak_bytes": max(peaks)}}
    if group.size > 1:
        result["device"]["memory_peak_bytes_by_rank"] = peaks
    if trace:
        view = View(tr, want, driver.unit_work(), host_times,
                    [r["spans"] for r in every] if group.size > 1 else None)
        for m in cell.per_layer:
            value = metric_reader(m["name"])(view)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        result["device"]["busy_s"] = sum(r["busy"][0] for r in every) / len(every)
        result["device"]["window_s"] = sum(r["busy"][1] for r in every) / len(every)
        result["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
        shares = {}
        for a in tr.activities:
            shares[a.owner] = shares.get(a.owner, 0.0) + a.end - a.start
        total = sum(shares.values()) or 1.0
        log("[bench] device time by span: " + ", ".join(
            f"{k} {100 * v / total:.2f}%" for k, v in sorted(shares.items())) +
            f"; activities inside a span {100 * tr.span_share:.2f}%, linked to their "
            f"launch {100 * tr.linked_share:.2f}%")
        if group.size > 1:
            nccl = [a for a in tr.activities if a.name.startswith("nccl")]
            log("[bench] busy share by rank: " + ", ".join(
                f"{100 * b / w:.2f}%" for b, w in (r["busy"] for r in every)) +
                f"; rank 0's NCCL kernels {len(nccl)}: "
                f"{sorted({a.name.split('(')[0] for a in nccl})}")
        del prof
    else:
        e2e = driver.window_metrics(n, elapsed, unit_times)
        e2e["setup_s"] = setup_s
        for m in cell.end_to_end:
            if m["name"] not in e2e:
                raise RuntimeError(f"cell {cell.name} lists {m['name']}, which its driver "
                                   f"does not measure")
            result["metrics"][m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    q = 1e3 * np.percentile(unit_times, [50, 95, 99, 100])
    log(f"[bench] window {elapsed:.3f} s, {n} units (ms a unit: p50 {q[0]:.4f}, p95 "
        f"{q[1]:.4f}, p99 {q[2]:.4f}, max {q[3]:.4f}; "
        f"{torch.get_num_threads()} CPU threads); peak memory {memory_peak} B"
        f"{f' on rank 0, {peaks} by rank' if group.size > 1 else ''}; "
        f"{card.power_limit()}; peaks: {card.PEAK_SOURCE}")

    t_judge = time.perf_counter()
    driver.release()
    gc.collect()
    readings = driver.readings()
    group.barrier()
    correct, checks = judge(readings, cell.limits)
    result["correct"] = correct
    log(f"[bench] judged in {time.perf_counter() - t_judge:.3f} s")
    return result, checks
