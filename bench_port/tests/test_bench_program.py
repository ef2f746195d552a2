"""The readers of the program's own recorder (harness/program.py,
metrics/*.py): their arithmetic on made-up rings, tables and spans; None
against a program without the recorder; and the reading itself rehearsed
on the CPU through harness/layers.read at 4 envs."""

import json
import os
import types

import pytest

from conftest import CHECKOUT
from harness import program

B = json.load(open(os.path.join(CHECKOUT, "BENCHMARK.json")))
CELLS = [w["name"] for w in B["workloads"]]
# the per-layer metrics whose readers read the program's recorder
READS_PROGRAM = ("solve_span_ms", "position_span_ms", "newton_iters",
                 "newton_active_pct", "contacts_per_env", "launch_ms",
                 "copy_ms", "mallocs_per_call", "capture_s", "copy_mb")


def _sp(name, start, end, id_, parent=None, call=0, **attrs):
    return {"name": name, "start_ns": start, "end_ns": end, "id": id_,
            "parent": parent, "call": call, "attrs": attrs}


ROWS = [{"position.start": 0, "position.end": 4_000_000,
         "constraint.start": 5_000_000, "constraint.end": 8_000_000},
        {"position.start": 10_000_000, "position.end": 12_000_000,
         "constraint.start": 12_500_000, "constraint.end": 17_500_000}]
TABLE = {"step.count": 4, "loop.newton.iters": 10,
         "loop.newton.env_iters": 30, "contacts": 96,
         "loop.gjk.iters": 0, "loop.gjk.env_iters": 0}
SPANS = [
    _sp("rollout.batched_step", 0, 5_000_000, 0, mallocs=2),
    _sp("graph.load", 100_000, 600_000, 1, 0, bytes=10),
    _sp("graph.replay", 600_000, 3_600_000, 2, 0),
    _sp("graph.result", 3_600_000, 4_600_000, 3, 0, bytes=20),
    _sp("rollout.batched_step", 6_000_000, 8_000_000, 4, call=1, mallocs=0),
    _sp("graph.load", 6_100_000, 6_600_000, 5, 4, call=1),
    _sp("graph.replay", 6_600_000, 7_600_000, 6, 4, call=1),
    _sp("graph.result", 7_600_000, 7_900_000, 7, 4, call=1),
    _sp("graph.capture", 10, 2_500_000_010, 8, call=2),
]


def test_arithmetic_on_made_up_readings():
    assert program.span_ms(ROWS, "position.start", "position.end") == 3.0
    assert program.span_ms(ROWS, "constraint.start", "constraint.end") \
        == 4.0
    assert program.span_ms([], "a", "b") is None
    assert program.per_step(TABLE, "loop.newton.iters") == 2.5
    assert program.per_step({"step.count": 0, "x": 3}, "x") is None
    assert program.active_pct(TABLE, "newton", 8) == pytest.approx(37.5)
    assert program.active_pct(TABLE, "gjk", 8) is None
    assert program.per_env_step(TABLE, "contacts", 8) == 3.0
    assert program.mean_span_ms(SPANS, "graph.replay") == 2.0
    assert program.mean_span_ms(SPANS, "nothing") is None
    assert [s["id"] for s in program.entry_calls(SPANS)] == [0, 4]
    # (0.5 + 1.0 + 0.5 + 0.3) ms over 2 calls
    assert program.ms_per_call(SPANS, ("graph.load", "graph.result")) == \
        pytest.approx(1.15)
    assert program.ms_per_call(SPANS[8:], ("graph.load",)) is None
    # bytes (10 + 20) over 2 calls
    assert program.attr_sum_per_call(SPANS, ("graph.load", "graph.result"),
                                     "bytes") == 15.0
    assert program.attr_sum_per_call(SPANS[8:], ("graph.load",),
                                     "bytes") is None
    assert program.attr_per_call(SPANS, "mallocs") == 1.0
    assert program.attr_per_call(SPANS, "bytes") is None
    assert program.seconds_of(SPANS, "graph.capture") == pytest.approx(2.5)
    assert program.seconds_of(SPANS[:8], "graph.capture") is None


def _reader(name):
    from harness import spec
    return spec.module("metrics", name)


@pytest.mark.parametrize("name,want", [
    ("solve_span_ms", 4.0), ("position_span_ms", 3.0),
    ("newton_iters", 2.5), ("newton_active_pct", 37.5),
    ("contacts_per_env", 3.0), ("launch_ms", 2.0), ("copy_ms", 1.15),
    ("mallocs_per_call", 1.0), ("capture_s", 2.5),
    ("copy_mb", 15 / 2 ** 20)])
def test_each_reader_reads_its_number(name, want):
    ctx = types.SimpleNamespace(program=program.Reading(
        ROWS, TABLE, SPANS[:8], SPANS[8:], nenv=8))
    assert _reader(name).read(ctx) == pytest.approx(want)


@pytest.mark.parametrize("name", READS_PROGRAM)
def test_reader_returns_none_without_the_recorder(name, monkeypatch):
    """Against a program whose profiler module has no recorder (a commit
    before it), or none at all, each reader returns None."""
    monkeypatch.setattr(program, "RECORDER", "json")
    assert _reader(name).read(types.SimpleNamespace()) is None
    monkeypatch.setattr(program, "RECORDER", "no_such_module_here")
    assert _reader(name).read(types.SimpleNamespace()) is None


def _rehearse(cell, monkeypatch, readers, profile=None):
    """layers.read of ``readers`` at 4 envs on the CPU, its device
    readings stubbed (``profile``: the stand-in for layers._profile)."""
    import torch
    import run
    from harness import layers, spec, trace
    monkeypatch.setattr(layers, "BUSY_S", 0.05)
    monkeypatch.setattr(layers, "_busy",
                        lambda entry, carry, chunk: (1.0, 2.0, carry))
    monkeypatch.setattr(layers, "_profile",
                        profile or (lambda fn: (None, fn())))
    monkeypatch.setattr(trace, "breakdown", lambda tr: {})
    c = run.Cell(spec.load(cell), torch.device("cpu"), nenv=4)
    c.warm(7)
    values, _, _, _ = layers.read(
        c.P, c.m, c.law, c.bufs, c.p, c.entry, c.carry0,
        int(c.cell.traffic["chunk_steps"]),
        {n: _reader(n) for n in readers})
    return values


def test_capture_s_reads_the_captures_made_before_the_readings(
        monkeypatch):
    """capture_s sums the graph.capture spans that ended before the traced
    readings began (the set-up's), and leaves out one made after (a stage
    graph's)."""
    import time
    from mujoco_sim_tpu_torch.runtime import profiler
    from harness import trace
    t = time.time_ns()
    profiler.clear_spans()
    profiler._RECORDED.append(profiler.Span(
        "graph.capture", t - 3_000_000_000, t - 1_000_000_000))

    def profile(fn):
        profiler._RECORDED.append(profiler.Span(
            "graph.capture", t + 10, t + 5_000_000_000))
        return trace.Trace([], [], (t, t + 1)), fn()
    try:
        values = _rehearse("mobile-1024.cmd", monkeypatch, ["capture_s"],
                           profile)
    finally:
        profiler.clear_spans()
    assert values == {"capture_s": pytest.approx(2.0)}


def test_reading_without_the_entry_raises_naming_it(monkeypatch):
    """The reading takes the entry from layers.read's frame: outside
    layers.read, or without one of the locals it takes, it raises and
    names what it missed."""
    with pytest.raises(RuntimeError, match="only inside"):
        program.reading(types.SimpleNamespace())
    monkeypatch.setattr(program, "FRAME_LOCALS",
                        program.FRAME_LOCALS + ("no_such_local",))
    with pytest.raises(RuntimeError, match="no_such_local"):
        _rehearse("mobile-1024.cmd", monkeypatch, ["newton_iters"])


@pytest.mark.parametrize("cell", CELLS)
def test_reading_rehearses_on_the_cpu(cell, monkeypatch):
    """layers.read with the program's readers of the cell, at 4 envs on
    the CPU (its device readings stubbed): the reading finds the cell's
    entry in layers.read's frame, traces a stretch of it, and every
    reader but those of a card (allocator segments, the capture) reads a
    number."""
    from harness import spec
    mine = [m["name"] for m in spec.load(cell).per_layer
            if spec.base(m["name"]) in READS_PROGRAM]
    values = _rehearse(cell, monkeypatch, mine)
    card_only = {"mallocs_per_call", "capture_s"}
    want = {n for n in mine if spec.base(n) not in card_only}
    assert set(values) == want and want
    for n, v in values.items():
        assert v >= 0, n
    if "newton_iters" in {spec.base(n) for n in want}:
        assert next(v for n, v in values.items()
                    if spec.base(n) == "newton_iters") >= 1
