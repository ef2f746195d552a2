"""Device milliseconds a step of single stages of the program's step.

The arithmetic of the port's ``runtime/profiler.stage_timings``, copied:
each stage is a StepGraph of its own (one CUDA graph) that copies in every
leaf of its input and runs on the previous stage's output; its first call
(warm-up and capture) is not timed.  Here the timed part is ``repeats``
replays of the graph in place (``StepGraph.run``), between two CUDA events
on the stream, so the figure is device time a call, not host time.  Each
stage's input is its predecessors' output from the given state.
"""

from __future__ import annotations

import torch

# the program's stages in the order the step runs them: (name, where)
CHAIN = (
    ("fwd_position", "engine"),
    ("fwd_velocity", "engine"),
    ("fwd_acceleration", "engine"),
    ("solve", "solver"),
)


def stage_ms(P, m, d, wanted, repeats: int = 20) -> dict:
    """{stage: device ms a call} for the stages in ``wanted``, on the card;
    the stages before the last wanted one run untimed for its input."""
    last = max(i for i, (n, _) in enumerate(CHAIN) if n in wanted)
    out = {}
    cur = d
    for name, where in CHAIN[:last + 1]:
        fn = getattr(getattr(P, where), name)
        g = P.graph.StepGraph(fn, all_leaves=True)
        res = g(m, cur)
        if name in wanted:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            g.run(m, cur, n=repeats)
            b.record()
            torch.cuda.synchronize()
            out[name] = a.elapsed_time(b) / repeats
        g.clear()
        cur = res
    return out
