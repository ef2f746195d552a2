"""A configuration, a traffic mix, a per-layer metric and a cell are new
files and new entries in BENCHMARK.json: no file the benchmark has is
edited.  A throwaway cell is added to a copy of the benchmark and run."""

import json
import os
import shutil
import subprocess
import sys

from conftest import BENCH, CHECKOUT


def test_new_cell_from_new_files_only(tmp_path):
    bench = tmp_path / "bench_port"
    shutil.copytree(BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    os.symlink(os.path.join(CHECKOUT, "mujoco_sim_tpu_torch"),
               tmp_path / "mujoco_sim_tpu_torch")
    spec = json.load(open(os.path.join(CHECKOUT, "BENCHMARK.json")))
    before = {p: open(p, "rb").read() for p in map(str, bench.rglob("*"))
              if os.path.isfile(p)}
    # the new files: a configuration, a mix, its limits, a metric's reader
    cfg = json.load(open(bench / "configs" / "manip_bin6_1024.json"))
    cfg.update(name="manip_bin6_16", nenv=16)
    json.dump(cfg, open(bench / "configs" / "manip_bin6_16.json", "w"))
    mix = json.load(open(bench / "traffic" / "stir.json"))
    mix.update(episode_steps=6, chunk_steps=2)
    json.dump(mix, open(bench / "traffic" / "stir_short.json", "w"))
    shutil.copy(bench / "limits" / "manip-8192.stir.json",
                bench / "limits" / "manip-16.stir_short.json")
    (bench / "metrics" / "window_steps.py").write_text(
        "UNIT = 'steps'\n\ndef read(ctx):\n    return None\n")
    spec["configs"].append({"name": "manip_bin6_16", "source": "a test",
                            "file": "bench_port/configs/manip_bin6_16.json",
                            "reduced": ["nenv"], "why": "a test"})
    spec["workloads"].append({"name": "manip-16.stir_short",
                              "config": "manip_bin6_16",
                              "traffic": "stir_short", "chips": 1,
                              "why": "a test"})
    spec["per_layer"].append({"name": "window_steps", "unit": "steps",
                              "better": "higher", "source": "program_counter",
                              "layer": "device", "moves": "env_steps_per_s",
                              "workloads": ["manip-16.stir_short"]})
    json.dump(spec, open(tmp_path / "BENCHMARK.json", "w"))
    code = f"""
import json, sys
sys.path.insert(0, {str(bench)!r})
import run
from harness import spec
cell = spec.load("manip-16.stir_short")
assert [m["name"] for m in cell.per_layer][-1] == "window_steps"
assert spec.module("metrics", "window_steps").UNIT == "steps"
sys.exit(run.main(["--workload", "manip-16.stir_short", "--seed", "3",
                   "--seconds", "0.05", "--trace", "0"], device="cpu"))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=tmp_path, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["attempted"] >= 16
    after = {p: open(p, "rb").read() for p in before}
    assert after == before
