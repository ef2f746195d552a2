"""Every cell of BENCHMARK.json rehearsed on the CPU at 4 envs through
the program's CPU path (the plain twins of its kernels): the command
line, the window, the check and the last line's format.  Run as a
script, the harness refuses without a card, and in a checkout that holds
only BENCHMARK.json and bench_port/."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH, CHECKOUT

CELLS = [w["name"] for w in
         json.load(open(os.path.join(CHECKOUT, "BENCHMARK.json")))["workloads"]]


def _run(cell, trace, capsys, seed=2 ** 31 + 11, **kw):
    import run
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   "0.05", "--trace", str(trace)], device="cpu", nenv=4, **kw)
    out, err = capsys.readouterr()
    return rc, json.loads(out.strip().splitlines()[-1]), err


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_rehearses_on_the_cpu(cell, trace, capsys, early_checks):
    from harness import check, spec
    rc, res, err = _run(cell, trace, capsys)
    assert rc == 0
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 4
    assert res["device"]["platform"] == "cpu"
    names = [k for k in check.NUMBERS if k in spec.load(cell).limits]
    assert list(res["checks"]) == names
    # each number beside its limit, last on standard error too
    tail = err.strip().splitlines()[-len(names):]
    assert [ln.split()[1] for ln in tail] == names
    want = {m["name"] for m in spec.load(cell).end_to_end}
    if trace:
        assert res["metrics"] == {}      # device readings: none on a CPU
    else:
        assert set(res["metrics"]) == want
        assert all(v["value"] > 0 for v in res["metrics"].values())


def test_script_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=CHECKOUT, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_bench_alone_does_not_run(tmp_path):
    """A checkout of only BENCHMARK.json and bench_port/ has no program to
    run: the run fails and prints no result."""
    shutil.copy(os.path.join(CHECKOUT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    code = ("import sys; sys.path.insert(0, %r); import run; "
            "sys.exit(run.main(['--workload', %r, '--seed', '1', "
            "'--seconds', '0.05', '--trace', '0'], device='cpu', nenv=4))"
            % (str(tmp_path / "bench_port"), CELLS[0]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=tmp_path, timeout=300,
                         env={k: v for k, v in os.environ.items()
                              if k != "PYTHONPATH"})
    assert out.returncode != 0 and out.stdout.strip() == ""
