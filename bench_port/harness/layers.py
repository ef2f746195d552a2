"""The traced run's readings, from which each per-layer metric's reader
(metrics/<name>.py) takes its number.

After the measured window, on the card:

1. a profiler trace of the device alone over calls of ``chunk_steps``
   more steps of the cell's own entry (its step graph), made as the
   window makes them, until BUSY_S seconds have passed at the end of a
   call, between two synchronisations timed by the host: the device's
   busy time (the union of its operations and WHILE nodes, harness/
   trace.py) within that stretch.  A stretch of one call (0.16 s in the
   mobile cell) read 22-45% idle from run to run, as a few host stalls
   fell in it or not; tracing the host too would slow the host's side of
   each call by a fifth (a manip step at 1024 envs, on the H100) and read
   as idle time;
2. a trace of host and device over as many steps again, inside the span
   trace.WINDOW: the breakdown, gaps named by what the host was doing;
3. a profiler trace of one eager step of the cell's law from the state
   the window ended at, with the calls the readers asked for recorded
   (their shapes) by wrappers the bench installs around the program's
   functions for that step only: kernels by name and the work of each
   call;
4. the stage graphs the readers asked for (harness/stages.py).

A reader that finds nothing to read returns None, and the metric is left
out of the result.
"""

from __future__ import annotations

import contextlib
import importlib
import statistics
import time

import torch

from harness import stages, trace

BUSY_S = 2.0        # seconds of the timed path in the device-only trace


class Probe:
    """What the readers ask for: calls to record and stages to time."""

    def __init__(self):
        self.wraps = []           # (module, function, record)
        self.stages = set()
        self.calls = {}

    def wrap(self, module: str, function: str, record):
        self.wraps.append((module, function, record))

    def stage(self, name: str):
        self.stages.add(name)

    @contextlib.contextmanager
    def installed(self):
        """The wrappers in place, recording into ``calls``."""
        saved = []
        try:
            for mod_name, fn_name, record in self.wraps:
                mod = importlib.import_module(mod_name)
                orig = getattr(mod, fn_name)
                calls = self.calls.setdefault(fn_name, [])

                def wrapped(*a, _orig=orig, _rec=record, _calls=calls, **k):
                    _calls.append(_rec(*a, **k))
                    return _orig(*a, **k)
                setattr(mod, fn_name, wrapped)
                saved.append((mod, fn_name, orig))
            yield
        finally:
            for mod, fn_name, orig in reversed(saved):
                setattr(mod, fn_name, orig)


class Ctx:
    """The readings a reader reads."""

    def __init__(self):
        self.trace = None         # trace.Trace of the graph stretch
        self.busy_s = self.window_s = None
        self.eager = None         # trace.Trace of the eager step
        self.calls = {}
        self.stages = {}

    def roofline_pct(self, function: str, kernel: str, bound_s):
        """100 x the mean bound of the recorded calls of ``function`` over
        the mean device time of the kernels named ``kernel``."""
        calls = self.calls.get(function)
        if self.eager is None or not calls:
            return None
        times = trace.kernel_times_s(self.eager.device, kernel)
        if not times:
            return None
        bound = statistics.fmean(bound_s(*c) for c in calls)
        return 100.0 * bound / statistics.fmean(times)


def _profile(fn):
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(trace.WINDOW):
            out = fn()
            torch.cuda.synchronize()
    return trace.events(prof), out


def _busy(entry, carry, chunk: int):
    """(device busy seconds, host seconds, the state after) of calls of
    ``chunk`` steps through the entry, as the window makes them, until
    BUSY_S seconds have passed at the end of a call; traced on the device
    alone."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < BUSY_S:
            carry = entry.segment(carry, chunk)
            if entry.sync_each_segment:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    return trace.busy_s(trace.events(prof, spanned=False)), t1 - t0, carry


def read(P, m, law, bufs, p, entry, carry, chunk: int, readers: dict):
    """(per-layer values, device busy_s, window_s, breakdown) of a traced
    run on the card; ``readers``: {metric name: reader module}."""
    probe, ctx = Probe(), Ctx()
    for r in readers.values():
        if hasattr(r, "prepare"):
            r.prepare(probe)
    ctx.busy_s, ctx.window_s, carry = _busy(entry, carry, chunk)
    ctx.trace, carry = _profile(lambda: entry.segment(carry, chunk))
    # the timed path's graphs go before the eager step and the stage
    # graphs, which would not fit beside them at the largest batches
    P.graph.clear_all()
    torch.cuda.empty_cache()
    with probe.installed():
        ctx.eager, _ = _profile(lambda: law.step(P, m, bufs, p)(carry))
    ctx.calls = probe.calls
    if probe.stages:
        ctx.stages = stages.stage_ms(P, m, law.data(carry), probe.stages)
    values = {}
    for name, r in readers.items():
        v = r.read(ctx)
        if v is not None:
            values[name] = v
    return values, ctx.busy_s, ctx.window_s, trace.breakdown(ctx.trace)
