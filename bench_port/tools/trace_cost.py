"""What the program's recorder costs and what it sees, on the card, for one
cell:

    python3 bench_port/tools/trace_cost.py --workload <cell> --seed <n> \
        --seconds <s> --pairs <n>

1. ``--pairs`` pairs of windows of the cell (harness/window.py, checks
   included), the program's tracing off and on in turns (off first in
   even pairs); before each window one untimed call captures the step
   graph for that state (a capture is keyed on it): a JSON line a window;
2. with tracing on, CUDA events around each call of a stretch of the
   entry: device ms a step beside the stamps' step span (the last stamp
   minus the first, averaged over the same steps);
3. a torch.profiler trace (host and device) of a stretch with tracing on:
   its idle gaps named by the program's span open at their start, the
   offset of the stamps' clock against the trace's (profiler.
   device_offset_ns) and the stamp clock's resolution.

Prints a JSON line for each window and each part.
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import run  # noqa: E402

STRETCH_S = 2.0


def _emit(rec):
    print(json.dumps(rec), flush=True)


def _resolution_ns(rows) -> dict:
    """The smallest step between distinct stamp values and the gcd of all
    steps between consecutive stamps of a step."""
    vals = sorted({v for r in rows for v in r.values() if v})
    diffs = [b - a for a, b in zip(vals, vals[1:])]
    g = 0
    for x in diffs:
        g = math.gcd(g, x)
    return {"min_step_ns": min(diffs) if diffs else None, "gcd_ns": g}


def _fit(pairs) -> dict:
    """The offsets' least-squares line over the kernels' starts: its
    slope (the stamp clock's drift against the trace's, in ppm) and the
    spread of what the line leaves, in ns."""
    t0 = pairs[0][0]
    xs = [t - t0 for t, _ in pairs]
    ys = [o for _, o in pairs]
    n = len(xs)
    mx, my = sum(xs) / n, sum(ys) / n
    sxx = sum((x - mx) ** 2 for x in xs)
    slope = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / sxx \
        if sxx else 0.0
    res = [y - my - slope * (x - mx) for x, y in zip(xs, ys)]
    return {"stamps_paired": n, "drift_ppm": slope * 1e6,
            "spread_after_drift_ns": max(res) - min(res),
            "stretch_s": (xs[-1] - xs[0]) / 1e9}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--pairs", type=int, default=3)
    args = ap.parse_args(argv)
    run._cache_dirs()
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from harness import spec, stats, trace, window
    from mujoco_sim_tpu_torch.runtime import profiler
    cell = spec.load(args.workload)
    dev = torch.device("cuda", 0)
    c = run.Cell(cell, dev)
    c.warm(args.seed)
    chunk = int(cell.traffic["chunk_steps"])
    card = {"card": torch.cuda.get_device_name(dev)}

    def traced(on):
        return profiler.tracing(dev) if on else profiler.tracing()

    def sync():
        torch.cuda.synchronize(dev)

    # 1. tracing off and on, in turns
    for i in range(args.pairs):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            with traced(on):
                c.entry.segment(c.carry0, chunk)       # the capture
                sync()
                plan = window.Plan.make(cell.traffic, c.nenv, args.seed)
                rows = torch.as_tensor(plan.rows, device=dev)
                w = window.run(c.entry, c.law, plan, c.carry0, c.fill,
                               args.seconds, c.nenv, rows, dev)
            profiler.clear_spans()
            _emit({"workload": args.workload, "pair": i,
                        "tracing": on, "env_steps_per_s":
                        stats.rate(w.steps, w.seconds), **card})
    carry = w.carry

    # 2. CUDA events around the calls against the stamps' step span
    with profiler.tracing(dev):
        carry = c.entry.segment(carry, chunk)
        sync()
        profiler.reset(dev)
        profiler.clear_spans()
        events, steps = [], 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < STRETCH_S:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            carry = c.entry.segment(carry, chunk)
            b.record()
            events.append((a, b))
            steps += chunk
            if c.entry.sync_each_segment:
                sync()
        sync()
        ring = profiler.ring(dev)
        counted = profiler.counts(dev)["step.count"]
    event_ms = sum(a.elapsed_time(b) for a, b in events) / steps
    step_span = [(r["integrate.end"] - r["position.start"]) / 1e6
                 for r in ring]
    span_ms = sum(step_span) / len(step_span)
    _emit({"workload": args.workload, "part": "step_span",
                "steps": steps, "steps_counted": counted,
                "event_device_ms_per_step": event_ms,
                "stamp_step_span_ms": span_ms,
                "span_over_events": span_ms / event_ms,
                "resolution": _resolution_ns(ring), **card})

    # 3. a traced stretch: idle gaps by program span, the clock offset
    profiler.clear_spans()
    with profiler.tracing(dev):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(trace.WINDOW):
                t0 = time.perf_counter()
                while time.perf_counter() - t0 < STRETCH_S:
                    carry = c.entry.segment(carry, chunk)
                    if c.entry.sync_each_segment:
                        sync()
                sync()
        offset = profiler.device_offset_ns(prof, dev)
        drift = _fit(profiler.stamp_offsets(prof, dev))
        names = {s.name for s in profiler.spans()}
    tr = trace.events(prof)
    mine = trace.Trace(tr.device, [h for h in tr.host if h[0] in names],
                       tr.window)
    gaps = trace.gaps(tr)
    by_span = collections.Counter()
    for s, e in gaps:
        by_span[trace.host_at(mine, s)] += (e - s) / 1e9
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    _emit({"workload": args.workload, "part": "gaps",
                "window_s": trace.window_s(tr), "busy_s": trace.busy_s(tr),
                "idle_s_by_program_span": dict(by_span.most_common()),
                "longest_gaps": [[trace.host_at(mine, s),
                                  trace.host_at(tr, s), (e - s) / 1e6]
                                 for s, e in longest],
                "device_offset_ns": offset[0],
                "device_offset_spread_ns": offset[1], **drift, **card})
    profiler.clear_spans()


if __name__ == "__main__":
    main()
