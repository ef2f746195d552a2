"""A cell as data: its entry in BENCHMARK.json, its configuration, its
traffic mix, its limits, and the modules each of them names.

Every piece is found by name, so a new configuration, mix, law, entry or
per-layer metric is a new file and a new entry in BENCHMARK.json:

* ``configs/<config>.json``: the scene, dtype, env count, source;
* ``traffic/<traffic>.json``: the entry that drives the program, the law
  that makes its controls, episode and chunk lengths, the draws from the
  seed and the checks' sample;
* ``limits/<workload>.json``: the limit of each number ``correct``
  compares in that cell;
* ``entries/<entry>.py``, ``laws/<law>.py``, ``metrics/<metric>.py``.

A metric named ``<base>.<part>`` is ``<base>`` in the cells its entry
lists, kept apart from ``<base>`` in other cells because those report
another end-to-end metric (``env_steps_per_s.host_paced`` is the rate of
the cells whose host sets the pace); ``metrics/<base>.py`` reads it.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKOUT = os.path.dirname(BENCH)


def _json(*parts) -> dict:
    path = os.path.join(BENCH, *parts)
    with open(path) as f:
        return json.load(f)


def bench_path(rel: str) -> str:
    """A path of a data file, relative to bench_port/."""
    return os.path.join(BENCH, rel)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list      # the metric entries that this cell reports
    per_layer: list


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(workload: str) -> Cell:
    """The cell named ``workload`` in the checkout's BENCHMARK.json."""
    with open(os.path.join(CHECKOUT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(os.path.relpath(
        os.path.join(CHECKOUT, configs[w["config"]]["file"]), BENCH))
    return Cell(
        name=workload, chips=int(w["chips"]), config=config,
        traffic=_json("traffic", w["traffic"] + ".json"),
        limits=_json("limits", workload + ".json"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, workload)])


def base(metric: str) -> str:
    """The quantity a metric's name measures: its name up to the first
    dot."""
    return metric.split(".")[0]


def module(kind: str, name: str):
    """bench_port/<kind>/<name>.py, imported (a metric's reader by its
    base name)."""
    if kind == "metrics":
        name = base(name)
    return importlib.import_module(f"{kind}.{name}")
