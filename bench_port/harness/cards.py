"""The program's recorder read on every card of a sharded cell, in one
stretch: each card's own stage stamps, and the host spans of the sharded
calls.

harness/program.py's reading traces the first card alone and counts the
calls of the one-batch entry points; a sharded cell's entry
(entries/sharded_rollout.py) steps a shard on each card of its mesh.
After layers.read's four readings, the first reader that asks
(``reading(ctx)``) takes the entry, its state and the chunk length from
layers.read's frame as program.py does (its ``_locals``), turns the
program's tracing on for every distinct device of the entry's mesh, and
runs the entry in calls of ``chunk_steps``, as the window does:

* the first call captures each shard's graph anew with tracing on;
* every card's table and ring are then zeroed and the spans dropped, and
  calls run until layers.BUSY_S seconds have passed at the end of a call
  (at least one call), every card synchronized after each;
* then each card's ring of stamps (each card counts its own
  ``step.count`` and stamps its own steps, on its own clock) and the
  stretch's spans are read, with the stretch's host seconds.

A program without the recorder, or an entry without a mesh, gives no
reading, and each reader of it returns None.  The arithmetic below works
on plain values (rows of stamps by name, spans as dicts), so it is tested
on the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import statistics
import time

import torch

from harness import program

SHARDED_CALL = "mesh.sharded_rollout"
SHARD = "mesh.shard"


@dataclasses.dataclass
class Reading:
    rings: list         # per card: its steps' stamps {name: ns}, oldest first
    spans: list         # the stretch's spans as dicts
    seconds: float      # the stretch's host seconds
    cards: list         # the cards' names, in the rings' order


def reading(ctx):
    """The cards' reading (made once, kept on ``ctx``), or None."""
    if not hasattr(ctx, "cards"):
        ctx.cards = _make()
    return ctx.cards


def _make():
    rec = program.recorder()
    if rec is None:
        return None
    from harness import layers
    loc = program._locals()
    entry, carry, chunk = loc["entry"], loc["carry"], loc["chunk"]
    del loc
    mesh = getattr(entry, "mesh", None)
    if mesh is None:
        return None
    cards = list(dict.fromkeys(mesh.local_devices))

    def call(c):
        c = entry.segment(c, chunk)
        for dev in cards:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return c

    rec.clear_spans()
    with contextlib.ExitStack() as on:
        for dev in cards:
            on.enter_context(rec.tracing(dev))
        carry = call(carry)                 # the captures, traced
        for dev in cards:
            rec.reset(dev)
        rec.clear_spans()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < layers.BUSY_S:
            carry = call(carry)
        seconds = time.perf_counter() - t0
        spans = [program._as_dict(s) for s in rec.spans()]
        rings = [rec.ring(dev) for dev in cards]
    rec.clear_spans()
    return Reading(rings, spans, seconds, [str(d) for d in cards])


# ------------------------------------------------------------- arithmetic

def step_ns(ring: list) -> list:
    """Each step's device ns, from its first stamp to its last."""
    out = []
    for row in ring:
        stamps = list(row.values())
        out.append(stamps[-1] - stamps[0])
    return out


def busy_min_pct(rings: list, seconds: float):
    """100 x the least busy card's summed step spans over the stretch's
    host seconds; None without a step."""
    if not any(rings) or seconds <= 0:
        return None
    return 100.0 * min(sum(step_ns(r)) for r in rings) / 1e9 / seconds


def skew_pct(rings: list):
    """100 x (the slowest card's mean device ms a step - the cards' mean
    of it) / the cards' mean, each card's from its own stamps; None
    without a step."""
    means = [statistics.fmean(step_ns(r)) for r in rings if r]
    if not means:
        return None
    mean = statistics.fmean(means)
    return 100.0 * (max(means) - mean) / mean


def issue_ms(spans: list):
    """The mean over the sharded calls of the host ms from the call's
    start to the end of its last shard's issue (``mesh.shard``); None
    without a sharded call that issued a shard."""
    ends: dict = {}
    for s in spans:
        if s["name"] == SHARD and s["parent"] is not None:
            ends[s["parent"]] = max(ends.get(s["parent"], 0), s["end_ns"])
    got = [(ends[s["id"]] - s["start_ns"]) / 1e6 for s in spans
           if s["name"] == SHARDED_CALL and s["id"] in ends]
    return statistics.fmean(got) if got else None
