"""On the card: the control, the reference in float32 with TF32 matmuls
put in the program's place, fails the check on the program's own checked
steps, on three seeds, for every cell, at up to 1024 envs and a short
window (a size a test run holds; bench_port/tools/readings.py reads it
at each cell's own size).  On the card: ``python3 -m pytest
-p no:cacheprovider bench_port/tests/test_bench_control_card.py``."""

import json
import os

import pytest
import torch

from conftest import CHECKOUT

CELLS = [w["name"] for w in
         json.load(open(os.path.join(CHECKOUT, "BENCHMARK.json")))["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(cell, card):
    import run
    from harness import check, spec
    c = spec.load(cell)
    cl = run.Cell(c, card, min(1024, int(c.config["nenv"])))
    for seed in (11, 12, 13):
        cl.warm(seed)
        w = cl.window(seed, 2.0)
        res = run.check(c, run.chosen(c, w, cl.plan), w.start,
                        len(cl.plan.rows), control=True)
        assert check.judge(res["numbers"], c.limits)[0] is True
        assert check.judge(res["control"], c.limits)[0] is False
