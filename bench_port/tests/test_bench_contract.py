"""BENCHMARK.json keeps to the benchmark's contract: keys, names, units,
bounds, and a file for every configuration, mix, limit and reader."""

import json
import os
import re

import pytest

from conftest import BENCH, CHECKOUT

B = json.load(open(os.path.join(CHECKOUT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["paths"] == ["bench_port"] and 1 <= B["run_seconds"] <= 51
    assert B["command"][1].startswith("bench_port/")
    assert os.path.getsize(os.path.join(CHECKOUT, "BENCHMARK.json")) < 65536


def test_configs():
    used = {w["config"] for w in B["workloads"]}
    files = set()
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("bench_port/") and c["file"] not in files
        files.add(c["file"])
        body = json.load(open(os.path.join(CHECKOUT, c["file"])))
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
        assert all(NAME.match(k) and k in body for k in c["reduced"])


def test_workloads():
    names, pairs = set(), set()
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["name"] not in names and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs and _line(w["why"])
        names.add(w["name"])
        pairs.add((w["config"], w["traffic"]))
        for d, ext in (("traffic", w["traffic"]), ("limits", w["name"])):
            assert os.path.exists(os.path.join(BENCH, d, ext + ".json"))


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metrics(kind):
    cells = {w["name"] for w in B["workloads"]}
    e2e = {m["name"] for m in B["end_to_end"]}
    for m in B[kind]:
        keys = {"name", "unit", "better", "source"}
        keys |= {"bound"} if kind == "end_to_end" else {"layer", "moves"}
        assert set(m) - {"workloads"} == keys
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        if kind == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert _line(m["layer"]) and m["moves"] in e2e
            # a split metric (<base>.<part>) is read by its base's reader
            assert os.path.exists(os.path.join(
                BENCH, "metrics", m["name"].split(".")[0] + ".py"))
    assert "setup_s" in e2e


def test_every_cell_reports_setup_another_and_a_layer():
    for w in B["workloads"]:
        e2e = [m["name"] for m in B["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        layer = [m for m in B["per_layer"]
                 if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
