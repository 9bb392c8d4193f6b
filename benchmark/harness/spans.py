"""Spans from the benchmark's own files: each `layers/<layer>.json` lists callables as
`module:qualname`, at the place where the program looks them up. In a traced run each
is replaced, while the run lasts, by a wrapper that opens a `torch.profiler`
`record_function` span named `bench/<layer>` around the call (the pattern of
`chip_smoke.Recorder`: wrap a named callable from outside). A layer file with
`"host_timed": true` also synchronises the device at the span's end and records the
call's host-clock seconds. Untraced runs wrap nothing.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import time

import torch

PREFIX = "bench/"


def _resolve(target: str):
    """(owner, attribute name, raw attribute) of `module:qualname`."""
    mod_name, qual = target.split(":")
    owner = importlib.import_module(mod_name)
    *path, attr = qual.split(".")
    for part in path:
        owner = getattr(owner, part)
    raw = owner.__dict__[attr] if isinstance(owner, type) else getattr(owner, attr)
    return owner, attr, raw


def _wrap(fn, span: str, times=None):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if times is None:
            with torch.profiler.record_function(span):
                return fn(*args, **kwargs)
        t0 = time.perf_counter()
        with torch.profiler.record_function(span):
            out = fn(*args, **kwargs)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out
    return wrapper


@contextlib.contextmanager
def wrapped(layers: dict, host_times: dict):
    """Wrap every span target of `layers` ({layer key: layer file}) while inside;
    host-timed layers append each call's seconds to `host_times[key]`."""
    undo = []
    try:
        for key, layer in layers.items():
            times = host_times.setdefault(key, []) if layer.get("host_timed") else None
            for target in layer.get("spans", []):
                owner, attr, raw = _resolve(target)
                setattr(owner, attr, _wrap(raw, PREFIX + key, times))
                undo.append((owner, attr, raw))
        yield
    finally:
        for owner, attr, raw in reversed(undo):
            setattr(owner, attr, raw)
