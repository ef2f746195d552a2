"""Nothing the benchmark runs imports JAX or the JAX package, and the
plain reference imports nothing of the program either.  Top-level module
names are compared whole: mujoco_sim_tpu_torch begins with mujoco_sim_tpu."""

import ast
import json
import os
import subprocess
import sys

from conftest import BENCH

JAX = {"jax", "jaxlib", "flax", "mujoco_sim_tpu"}
PROGRAM = {"mujoco_sim_tpu_torch"}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _files(sub=""):
    for root, _, names in os.walk(os.path.join(BENCH, sub)):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(root, n)


def test_no_file_imports_jax():
    bad = [(f, m) for f in _files() for m in _imports(f) if m in JAX]
    assert not bad


def test_reference_files_import_nothing_of_the_program():
    for sub in ("refsim", "laws"):
        bad = [(f, m) for f in _files(sub) for m in _imports(f)
               if m in PROGRAM | JAX]
        assert not bad


def test_reference_run_loads_no_program_module():
    """Build both configurations' reference models and step them, as the
    check does, in a fresh process; then list what was imported."""
    code = """
import json, sys, torch
sys.path.insert(0, %r)
from harness import check, sims, spec, tf32
R = sims.reference()
for name in ("manip_bin6_1024", "mobile_benchbot_1024"):
    cfg = json.load(open(%r + "/configs/" + name + ".json"))
    m = sims.build_model(R, cfg, torch.float64, "cpu")
    law = spec.module("laws", "sine" if "manip" in name else "pd_odom")
    p = {"amp": 1.0, "freq": 4.0} if "manip" in name else {
        "robot": "benchbot", "arm_joints": ["a1", "a2", "a3"], "kp": 80.0,
        "kd": 8.0}
    bufs = law.buffers(m, 2, p)
    law.step(R, m, bufs, p)(law.carry0(R, m, 2))
print(json.dumps(sorted({k.split(".")[0] for k in sys.modules})))
""" % (BENCH, BENCH)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & (JAX | PROGRAM)
    assert "refsim" in loaded


def test_forbidden_modules_compare_whole_names(monkeypatch):
    import run
    monkeypatch.setitem(sys.modules, "mujoco_sim_tpu_torch_probe", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "mujoco_sim_tpu.engine", sys)
    assert run.forbidden_modules() == ["mujoco_sim_tpu.engine"]
