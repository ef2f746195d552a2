"""The sharded cell (manip-4x16384.stir): its traffic against its cell,
its checked rows over the shards, the law's gather of them, the readers
of every card's recorder (harness/cards.py, metrics/card_*.py,
metrics/shard_issue_ms.py) on made-up rings and spans, and their reading
rehearsed on the CPU through harness/layers.read."""

import json
import os
import types

import numpy as np
import pytest
import torch

from conftest import BENCH, CHECKOUT
from harness import cards, program, spec, window

CELL = "manip-4x16384.stir"
MINE = ("card_busy_min_pct", "card_skew_pct", "shard_issue_ms")
# the accepted metrics read on the first card's shard (harness/program.py's
# reading, the eager step and the stage graphs of law.data)
FIRST_CARD = ("position_ms", "solve_ms", "hull_sat_roofline_pct",
              "chol_solve_roofline_pct", "solve_span_ms", "position_span_ms",
              "newton_iters", "newton_active_pct", "contacts_per_env",
              "capture_s", "deep_live_pct")


def _sp(name, start, end, id_, parent=None, **attrs):
    return {"name": name, "start_ns": start, "end_ns": end, "id": id_,
            "parent": parent, "call": 0, "attrs": attrs}


def _row(t0, ms):
    """A step's stamps: first at t0 ns, last ms later, one between."""
    return {"position.start": t0, "constraint.end": t0 + 1,
            "integrate.end": t0 + int(ms * 1e6)}


# two cards: the first steps 2 x 10 ms, the second 2 x 30 ms
RINGS = [[_row(0, 10), _row(50_000_000, 10)],
         [_row(7, 30), _row(90_000_000, 30)]]
# a call whose last shard's issue ends late (at 9 ms), and one at 1 ms
SPANS = [_sp("mesh.sharded_rollout", 0, 100_000_000, 1),
         _sp("mesh.shard", 100_000, 1_000_000, 2, 1, device="cuda:0"),
         _sp("mesh.shard", 1_000_000, 9_000_000, 3, 1, device="cuda:1"),
         _sp("graph.replay", 1_500_000, 2_000_000, 4, 3),
         _sp("mesh.sharded_rollout", 200_000_000, 300_000_000, 5),
         _sp("mesh.shard", 200_100_000, 201_000_000, 6, 5, device="cuda:0"),
         _sp("mesh.scatter", 150_000_000, 151_000_000, 7, bytes=64)]


def test_arithmetic_on_made_up_readings():
    assert cards.step_ns(RINGS[1]) == [30_000_000, 30_000_000]
    # the least busy card: 20 ms of steps in a 0.5 s stretch
    assert cards.busy_min_pct(RINGS, 0.5) == pytest.approx(4.0)
    assert cards.busy_min_pct([[], []], 0.5) is None
    # card means 10 and 30 ms, their mean 20: the slowest 50% above
    assert cards.skew_pct(RINGS) == pytest.approx(50.0)
    assert cards.skew_pct([RINGS[0], RINGS[0]]) == 0.0
    assert cards.skew_pct([[]]) is None
    # (9 + 1) ms over the two calls
    assert cards.issue_ms(SPANS) == pytest.approx(5.0)
    assert cards.issue_ms(SPANS[6:]) is None


@pytest.mark.parametrize("name,want", [("card_busy_min_pct", 4.0),
                                       ("card_skew_pct", 50.0),
                                       ("shard_issue_ms", 5.0)])
def test_each_reader_reads_its_number(name, want):
    ctx = types.SimpleNamespace(cards=cards.Reading(
        RINGS, SPANS, 0.5, ["cuda:0", "cuda:1"]))
    assert spec.module("metrics", name).read(ctx) == pytest.approx(want)


@pytest.mark.parametrize("name", MINE)
def test_reader_returns_none_without_the_recorder(name, monkeypatch):
    monkeypatch.setattr(program, "RECORDER", "no_such_module_here")
    assert spec.module("metrics", name).read(types.SimpleNamespace()) \
        is None


def test_traffic_shards_equal_the_cells_chips():
    bench = json.load(open(os.path.join(CHECKOUT, "BENCHMARK.json")))
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    c = spec.load(CELL)
    assert c.traffic["law_params"]["shards"] == cell["chips"] == c.chips
    assert c.config["shards"] == cell["chips"]
    assert c.config["nenv"] == c.config["envs_per_shard"] * cell["chips"]
    # the cell reads its own metrics (every card) and those that read the
    # first card's shard; not device_idle_pct, a union over every card
    assert {m["name"] for m in c.per_layer} == set(MINE) | set(FIRST_CARD)


@pytest.mark.parametrize("seed", [2 ** 31 + 3, 2 ** 32 + 17, 5])
def test_checked_rows_come_from_every_shard(seed):
    c = spec.load(CELL)
    nenv, shards = int(c.config["nenv"]), c.chips
    plan = window.Plan.make(c.traffic, nenv, seed)
    assert len(plan.rows) == 96
    assert set((plan.rows // (nenv // shards)).tolist()) == \
        set(range(shards))


def _cpu_shards(nenv=8, shards=4):
    import run  # noqa: F401  (puts the checkout on the path)
    from harness import sims
    P = sims.program()
    m = sims.build_model(P, spec.load(CELL).config, torch.float64, "cpu")
    d = P.engine.make_data(m, nenv)
    d = d.replace(qpos=d.qpos + 1e-3 * torch.arange(nenv, dtype=d.qpos.dtype
                                                    )[:, None])
    mesh = P.mesh.make_env_mesh(["cpu"] * shards)
    return P, m, d, P.mesh.shard_batch(d, mesh)


def test_law_gathers_the_checked_rows_from_their_shards():
    from laws import sine_mesh
    P, m, d, dS = _cpu_shards()
    rows = torch.tensor([6, 0, 3, 7, 2])
    got = sine_mesh.snap(dS, rows)
    want = sine_mesh.snap(d, rows)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert sine_mesh.data(dS) is dS.shards[0]
    assert sine_mesh.data(d) is d


def test_cards_reading_rehearses_on_the_cpu(monkeypatch):
    """layers.read with the three readers at 4 envs on the CPU (one env a
    shard, its device readings stubbed): the reading finds the sharded
    entry in layers.read's frame, traces a stretch of it, and each reader
    reads a number; the stretch's spans hold every shard's issue."""
    import run
    from harness import layers, trace
    monkeypatch.setattr(layers, "BUSY_S", 0.05)
    monkeypatch.setattr(layers, "_busy",
                        lambda entry, carry, chunk: (1.0, 2.0, carry))
    monkeypatch.setattr(layers, "_profile", lambda fn: (None, fn()))
    monkeypatch.setattr(trace, "breakdown", lambda tr: {})
    c = run.Cell(spec.load(CELL), torch.device("cpu"), nenv=4)
    c.warm(7)
    ctx = {}
    readers = {n: spec.module("metrics", n) for n in MINE}
    orig = cards.reading

    def keep(x):
        r = orig(x)
        ctx["r"] = r
        return r
    monkeypatch.setattr(cards, "reading", keep)
    values, _, _, _ = layers.read(
        c.P, c.m, c.law, c.bufs, c.p, c.entry, c.carry0,
        int(c.cell.traffic["chunk_steps"]), readers)
    assert set(values) == set(MINE)
    assert 0 < values["card_busy_min_pct"] <= 100.0
    assert values["card_skew_pct"] == 0.0       # one CPU: one ring
    assert values["shard_issue_ms"] > 0
    r = ctx["r"]
    assert r.cards == ["cpu"] and len(r.rings[0]) % 4 == 0
    calls = [s for s in r.spans if s["name"] == "mesh.sharded_rollout"]
    assert calls and all(s["attrs"] == {"shards": 4, "envs": 4,
                                        "steps": 25} for s in calls)
    kids = [s for s in r.spans if s["name"] == "mesh.shard"
            and s["parent"] == calls[0]["id"]]
    assert [s["attrs"]["device"] for s in kids] == ["cpu"] * 4
