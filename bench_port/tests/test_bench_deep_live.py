"""metrics/deep_live_pct.py: its arithmetic on made-up tables, and None
where the program has no such count or counted no launch."""

import types

import pytest

from harness import program, spec


def _read(table, name="deep_live_pct", nenv=4):
    ctx = types.SimpleNamespace(program=program.Reading(
        [], table, [], [], nenv=nenv))
    return spec.module("metrics", name).read(ctx)


@pytest.mark.parametrize("name", ["deep_live_pct",
                                  "deep_live_pct.host_paced"])
def test_reads_live_slots_over_offered_slots(name):
    # 2 group calls of 4 envs x 8 slots, 16 of the 64 slots live
    table = {"step.count": 2, "feature_clip": 2, "deep.lanes": 16}
    assert _read(table, name) == pytest.approx(25.0)


def test_none_without_the_count_or_a_launch():
    assert _read({"step.count": 2, "feature_clip": 2}) is None
    assert _read({"step.count": 2, "feature_clip": 0,
                  "deep.lanes": 0}) is None
    assert _read({"step.count": 2, "deep.lanes": 3}) is None


def test_none_without_the_recorder(monkeypatch):
    monkeypatch.setattr(program, "RECORDER", "no_such_module_here")
    assert spec.module("metrics", "deep_live_pct").read(
        types.SimpleNamespace()) is None
