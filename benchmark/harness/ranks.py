"""A cell on more than one card: one process per card, in lockstep, with one result.

Rank 0 is the process the command started. For a cell whose `chips` is above 1, it
launches ranks 1 to n-1 as child processes (`spawn`, before its own imports, so that
theirs overlap), hands each the cell, the run's arguments and the faults planted in
rank 0 as JSON on its standard input (`start`), and joins them through the program's own `parallel/distributed.initialize_distributed`:
NCCL on the cards (rank r on card r), gloo on the CPU. Beside it a gloo group carries
the harness's own commands: after every unit rank 0 decides whether the window ends and
broadcasts that before the next unit starts (`decide`), so that every rank runs the
same units and none is left inside a collective; `gather` brings each rank's readings
to rank 0 after the window.

A failure anywhere ends every rank, and the run prints no result. Rank 0's watchdog
thread ends the run when a child exits with an error, or when rank 0 takes longer over
a step than the traffic's `rank_timeout_s` allows (`setup`: the set-up, kernel builds
included; `unit`: one unit of the window; `judge`: the judging after it): it kills
every child and ends rank 0 with exit code 3. A child ends with rank 0 (the kernel's
parent-death signal), and an exception in rank 0 kills the children before it
propagates. A one-card cell takes none of this: `Solo` is the identity.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import datetime
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import traceback

from benchmark.harness.cell import REPO, Cell

class Solo:
    """One process: every command is the identity."""

    rank, size = 0, 1

    def device(self, device: str) -> str:
        return device

    def decide(self, flag: bool) -> bool:
        return flag

    def gather(self, obj):
        return [obj]

    def barrier(self):
        pass

    def expect(self, phase: str):
        pass

    def close(self):
        pass

    abort = close


class Ranks:
    """This process's place in a multi-rank run and the harness's gloo group."""

    def __init__(self, rank: int, size: int, timeouts: dict, watch=None):
        import torch.distributed as dist

        self.rank, self.size, self.timeouts, self.watch = rank, size, timeouts, watch
        self.dist = dist
        self.group = dist.new_group(backend="gloo", timeout=datetime.timedelta(
            seconds=max(timeouts.values())))

    def device(self, device: str) -> str:
        return f"cuda:{self.rank}" if device == "cuda" else device

    def decide(self, flag: bool) -> bool:
        """Rank 0's `flag`, on every rank."""
        import torch

        t = torch.tensor([int(bool(flag))], dtype=torch.int32)
        self.dist.broadcast(t, 0, group=self.group)
        self.expect("unit")
        return bool(t.item())

    def gather(self, obj):
        """[every rank's obj] on rank 0, None on the others."""
        out = [None] * self.size if self.rank == 0 else None
        self.dist.gather_object(obj, out, dst=0, group=self.group)
        return out

    def barrier(self):
        self.dist.barrier(group=self.group)

    def expect(self, phase: str):
        """Rank 0's next step has to end within the phase's timeout."""
        if self.watch is not None:
            self.watch.deadline = time.monotonic() + self.timeouts[phase]

    def close(self):
        """After a run that ended well: leave the groups, wait for the children."""
        self.dist.destroy_process_group()
        if self.watch is not None:
            self.watch.finish()

    def abort(self):
        """After a failure in this process: end the children first (they may wait in a
        collective for this rank), then leave the groups where that cannot hang."""
        if self.watch is not None:
            self.watch.stop.set()
            self.watch.kill()
        if self.dist.get_backend() == "gloo":
            self.dist.destroy_process_group()


class _Watch(threading.Thread):
    """Rank 0's watchdog over its children and its own steps."""

    def __init__(self, procs, setup_s: float):
        super().__init__(daemon=True, name="bench-ranks-watchdog")
        self.procs, self.deadline = procs, time.monotonic() + setup_s
        self.stop = threading.Event()

    def run(self):
        while not self.stop.wait(0.1):
            for r, p in enumerate(self.procs, 1):
                code = p.poll()
                if code not in (None, 0):
                    self.fail(f"rank {r} ended with exit code {code}")
            if time.monotonic() > self.deadline:
                self.fail("a step of the run outlasted its timeout (rank_timeout_s)")

    def fail(self, why: str):
        print(f"[ranks] {why}: ending every rank; no result", file=sys.stderr, flush=True)
        self.kill()
        os._exit(3)

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def finish(self, timeout: float = 60.0):
        """Wait for every child to end (killing those still running after `timeout`);
        a child that ended with an error still fails the run."""
        end = time.monotonic() + timeout
        for p in self.procs:
            try:
                p.wait(max(0.0, end - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
        self.stop.set()
        self.join()
        failed = [(r, p.returncode) for r, p in enumerate(self.procs, 1)
                  if p.returncode not in (None, 0)]
        self.kill()
        if failed:
            raise RuntimeError(f"ranks ended with errors: {failed}")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _join(rank: int, size: int, address: str, device: str, timeouts: dict, watch=None):
    from embodied_clip_tpu_torch.parallel.distributed import initialize_distributed

    initialize_distributed(address, size, rank, device=device)
    return Ranks(rank, size, timeouts, watch)


CHILD = ("import sys; sys.path.insert(0, {repo!r}); "
         "from benchmark.harness.ranks import child; sys.exit(child({rank}, {driver!r}, {device!r}))")
_SPAWNED = []   # ranks launched by `spawn` and not yet handed a run


def spawn(size: int, driver: str, device: str):
    """Launch ranks 1 to n-1 now, before rank 0's own imports, so that their start
    (the interpreter, torch, the driver, the card's context) overlaps rank 0's; `start`
    hands them the run."""
    for r in range(1, size):
        _SPAWNED.append(subprocess.Popen(
            [sys.executable, "-c", CHILD.format(repo=str(REPO), rank=r, driver=driver,
                                                device=device)],
            stdin=subprocess.PIPE, stdout=2, cwd=REPO))


def discard():
    """End the ranks that `spawn` launched (a run that will not start)."""
    while _SPAWNED:
        p = _SPAWNED.pop()
        p.kill()
        p.wait()


def start(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
          control: bool) -> Ranks:
    """In rank 0: hand ranks 1 to n-1 the run (launching them if `spawn` has not) and
    join the run's groups with them."""
    size, timeouts = cell.chips, cell.traffic["rank_timeout_s"]
    if len(_SPAWNED) != size - 1:
        discard()
        spawn(size, cell.traffic["driver"], device)
    procs = list(_SPAWNED)
    _SPAWNED.clear()
    address = f"127.0.0.1:{_free_port()}"
    spec = {"cell": dataclasses.asdict(cell), "seed": seed, "seconds": seconds,
            "trace": trace, "device": device, "control": control, "size": size,
            "address": address, "parent": os.getpid()}
    watch = _Watch(procs, timeouts["setup"])
    try:
        for p in procs:
            p.stdin.write(json.dumps(spec).encode())
            p.stdin.close()
        watch.start()
        return _join(0, size, address, device, timeouts, watch)
    except BaseException:
        watch.stop.set()
        watch.kill()
        raise


def child(rank: int, driver: str, device: str) -> int:
    """A rank above 0: its imports first, then the run's arguments from standard input,
    the same faults planted, the same run; its readings go to rank 0 and it prints no
    result. It fails, as rank 0 does, if JAX or the JAX package was loaded in it."""
    with contextlib.suppress(OSError, AttributeError):
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)   # PR_SET_PDEATHSIG
    parent = os.getppid()
    import importlib

    import torch

    importlib.import_module(f"benchmark.drivers.{driver}")
    if device == "cuda":
        torch.cuda.set_device(rank)
        torch.cuda.init()
    text = sys.stdin.read()
    if not text or os.getppid() != parent:
        return 1   # rank 0 ended before it handed over the run
    spec = json.loads(text)
    from benchmark.harness import runner
    from benchmark.harness.faults import FAILURES, FAULTS

    cell = Cell(**spec["cell"])
    runner.PREFIX = f"[rank {rank}] "
    group = _join(rank, spec["size"], spec["address"], spec["device"],
                  cell.traffic["rank_timeout_s"])
    try:
        with contextlib.ExitStack() as stack:
            for name in list(cell.faults):
                stack.enter_context({**FAULTS, **FAILURES}[name](cell))
            runner.run_rank(cell, spec["seed"], spec["seconds"], spec["trace"],
                            group.device(spec["device"]), spec["control"], group)
    except BaseException:
        # No orderly exit: leaving the groups could wait on a collective forever.
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    loaded = runner.forbidden_loaded()
    if loaded:
        runner.log(f"[bench] the run loaded {', '.join(loaded)}: no result")
        os._exit(3)
    group.close()
    return 0


def host_line() -> str:
    """What the host gave this process: the CPU model, the CPUs it may run on and its
    threads (read only)."""
    import torch

    model = "unknown"
    with contextlib.suppress(OSError):
        with open("/proc/cpuinfo") as f:
            model = next((l.split(":", 1)[1].strip() for l in f
                          if l.startswith("model name")), model)
    cpus = sorted(os.sched_getaffinity(0))
    runs, lo = [], None
    for i, c in enumerate(cpus):
        lo = c if lo is None else lo
        if i + 1 == len(cpus) or cpus[i + 1] != c + 1:
            runs.append(f"{lo}-{c}" if c > lo else str(lo))
            lo = None
    threads = "unknown"
    with contextlib.suppress(OSError):
        with open("/proc/self/status") as f:
            threads = next((l.split()[1] for l in f if l.startswith("Threads:")), threads)
    return (f"host: pid {os.getpid()}; CPU {model}; {len(cpus)} CPUs allowed ({','.join(runs)}) of "
            f"{os.cpu_count()}; torch threads {torch.get_num_threads()}; process threads "
            f"{threads}")
