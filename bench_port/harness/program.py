"""The program's own recorder, read in a traced run: spans, counts and
stage stamps from inside the step graph the cell replays.

After the four readings of harness/layers.py, the first reader that asks
(``reading(ctx)``) turns on the program's tracing on the card
(``mujoco_sim_tpu_torch.runtime.profiler.tracing``) and runs the cell's
own entry in calls of ``chunk_steps``, as the window does:

* first it keeps the ``graph.capture`` spans the program recorded before
  layers.read's traced readings began (the program records a capture's
  span whether or not tracing is on): the captures of the cell's set-up,
  and any the window made;
* the first call captures the entry's step graph anew (the timed path's
  graphs are gone by then, and a graph captured with tracing off is never
  replayed with it on);
* the recorder's table and ring are then zeroed and its spans dropped,
  and calls run until layers.BUSY_S seconds have passed at the end of a
  call; then the ring of stage stamps, the table of counts and the spans
  of that stretch are read (one sync).

layers.read hands its readers only the Ctx of its readings; the entry,
its state and the chunk length are locals of its frame, found here by
layers.read's code object (FRAME_LOCALS), and a reading made without
them raises, naming what it missed.  Until layers.read hands them over
itself, that is the one tie between the two files.  A program without
the recorder (a commit before it) gives no reading, and every reader of
it returns None.

The arithmetic below works on plain values (rows of stamps by name, counts
by name, spans as dicts), so it is tested on the CPU.
"""

from __future__ import annotations

import dataclasses
import importlib
import statistics
import sys
import time

import torch

RECORDER = "mujoco_sim_tpu_torch.runtime.profiler"
NEEDS = ("tracing", "counts", "ring", "reset", "spans", "clear_spans")
# the program's entry points: a span with no parent is one entry call
ENTRY_SPANS = ("rollout.rollout", "rollout.batched_step",
               "mesh.scan_reduced", "engine.step_with_control")
# what the reading takes from layers.read's frame
FRAME_LOCALS = ("entry", "carry", "chunk", "law")


@dataclasses.dataclass
class Reading:
    rows: list          # each step's stamps {name: ns}, oldest first
    table: dict         # counts over the stretch {slot: n}
    spans: list         # the stretch's spans as dicts
    captures: list      # the set-up's graph.capture spans, as dicts
    nenv: int


def recorder():
    """The program's recorder module, or None where the program has no
    such API."""
    try:
        mod = importlib.import_module(RECORDER)
    except ImportError:
        return None
    return mod if all(hasattr(mod, n) for n in NEEDS) else None


def _as_dict(sp) -> dict:
    return {"name": sp.name, "start_ns": sp.start_ns, "end_ns": sp.end_ns,
            "id": sp.id, "parent": sp.parent, "call": sp.call,
            "attrs": dict(sp.attrs)}


def _read_frame():
    from harness import layers
    code = layers.read.__code__
    f = sys._getframe(1)
    while f is not None and f.f_code is not code:
        f = f.f_back
    return f


def reading(ctx):
    """The program's reading (made once, kept on ``ctx``), or None."""
    if not hasattr(ctx, "program"):
        ctx.program = _make(ctx)
    return ctx.program


def _locals() -> dict:
    """FRAME_LOCALS of layers.read's frame, which must be on the stack."""
    frame = _read_frame()
    if frame is None:
        raise RuntimeError("harness/program.py: the reading is made only "
                           "inside harness/layers.read")
    loc = frame.f_locals
    missing = [n for n in FRAME_LOCALS if n not in loc]
    if missing:
        raise RuntimeError(f"harness/program.py: harness/layers.read has "
                           f"no local {', '.join(missing)}")
    return {n: loc[n] for n in FRAME_LOCALS}


def _make(ctx):
    rec = recorder()
    if rec is None:
        return None
    from harness import layers
    loc = _locals()
    entry, carry, chunk = loc["entry"], loc["carry"], loc["chunk"]
    d = loc["law"].data(carry)
    dev, nenv = d.qpos.device, int(d.qpos.shape[0])
    del loc
    # the captures made before the traced readings: the set-up's
    tr = getattr(ctx, "trace", None)
    began = tr.window[0] if tr is not None else time.time_ns()
    captures = [_as_dict(s) for s in rec.spans()
                if s.name == "graph.capture" and 0 < s.end_ns <= began]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def call(c):
        c = entry.segment(c, chunk)
        if entry.sync_each_segment:
            sync()
        return c

    rec.clear_spans()
    with rec.tracing(dev):
        carry = call(carry)                 # the capture, traced
        sync()
        rec.reset(dev)
        rec.clear_spans()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < layers.BUSY_S:
            carry = call(carry)
        sync()
        spans = [_as_dict(s) for s in rec.spans()]
        table = rec.counts(dev)
        rows = rec.ring(dev)
    rec.clear_spans()
    return Reading(rows, table, spans, captures, nenv)


# ------------------------------------------------------------- arithmetic

def span_ms(rows: list, start: str, end: str):
    """Mean over the steps of stamp ``end`` minus stamp ``start``, in ms;
    None without a step."""
    if not rows:
        return None
    return statistics.fmean(r[end] - r[start] for r in rows) / 1e6


def per_step(table: dict, slot: str):
    """Count ``slot`` a step, or None without a step."""
    steps = table.get("step.count", 0)
    return table[slot] / steps if steps else None


def active_pct(table: dict, loop: str, nenv: int):
    """100 x the iterations loop ``loop``'s envs needed over the lockstep
    iterations it ran times the envs; None where it never ran."""
    iters = table[f"loop.{loop}.iters"]
    if not iters:
        return None
    return 100.0 * table[f"loop.{loop}.env_iters"] / (iters * nenv)


def per_env_step(table: dict, slot: str, nenv: int):
    v = per_step(table, slot)
    return None if v is None else v / nenv


def _ms(sp: dict) -> float:
    return (sp["end_ns"] - sp["start_ns"]) / 1e6


def mean_span_ms(spans: list, name: str):
    """Mean ms of the spans named ``name``; None without one."""
    got = [_ms(s) for s in spans if s["name"] == name]
    return statistics.fmean(got) if got else None


def entry_calls(spans: list) -> list:
    """The spans of the entry calls: those with no parent."""
    return [s for s in spans if s["parent"] is None
            and s["name"] in ENTRY_SPANS]


def ms_per_call(spans: list, names) -> float | None:
    """Ms of the spans named in ``names``, summed, per entry call."""
    calls = len(entry_calls(spans))
    if not calls:
        return None
    return sum(_ms(s) for s in spans if s["name"] in names) / calls


def attr_sum_per_call(spans: list, names, attr: str):
    """Attribute ``attr`` of the spans named in ``names``, summed, per
    entry call; None without an entry call."""
    calls = len(entry_calls(spans))
    if not calls:
        return None
    return sum(s["attrs"].get(attr, 0) for s in spans
               if s["name"] in names) / calls


def attr_per_call(spans: list, attr: str):
    """Attribute ``attr`` of the entry calls' spans, a call; None where
    they do not carry it."""
    got = [s["attrs"][attr] for s in entry_calls(spans)
           if attr in s["attrs"]]
    return statistics.fmean(got) if got else None


def seconds_of(spans: list, name: str):
    """Seconds of the spans named ``name``, summed; None without one."""
    got = [_ms(s) for s in spans if s["name"] == name]
    return sum(got) / 1e3 if got else None
