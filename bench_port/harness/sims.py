"""The two simulators a cell runs: the program under test
(``mujoco_sim_tpu_torch``) and the plain reference (``refsim``, the
frozen CPU path under bench_port/refsim).  Both expose the same modules,
so one function makes either's model from a configuration file, each with
its own MJCF compiler.
"""

from __future__ import annotations

import importlib
import types

import torch

from harness.spec import bench_path

# Data leaves that a step reads before it writes them: a state as the
# checks take it from the program and hand it to the reference.
STATE = (
    "time", "qpos", "qvel", "act", "qacc_warmstart",
    "ctrl", "qfrc_applied", "xfrc_applied", "mocap_pos", "mocap_quat",
    "body_active", "geom_size", "geom_rbound", "body_mass", "body_inertia",
)

# what the checks also read of a step's output: the bodies' positions the
# position stage computed, and the contacts collision picked
OUTPUT = ("xpos",)
CONTACT = ("active", "geom1", "geom2", "pos", "dist", "includemargin")


def snap_data(d, rows) -> dict:
    """The rows of a Data's state, its OUTPUT leaves and its contacts."""
    out = {k: getattr(d, k).index_select(0, rows) for k in STATE + OUTPUT}
    out.update({"contact." + k: getattr(d.contact, k).index_select(0, rows)
                for k in CONTACT})
    return out


_MODULES = {
    "engine": "engine",
    "compile": "models.compile",
    "scene": "models.scene",
    "model": "models.model",
    "controllers": "control.controllers",
}


def namespace(package: str) -> types.SimpleNamespace:
    """The modules of one simulator package by short name."""
    return types.SimpleNamespace(**{
        k: importlib.import_module(f"{package}.{v}")
        for k, v in _MODULES.items()})


def program() -> types.SimpleNamespace:
    ns = namespace("mujoco_sim_tpu_torch")
    ns.rollout = importlib.import_module("mujoco_sim_tpu_torch.parallel."
                                         "rollout")
    ns.mesh = importlib.import_module("mujoco_sim_tpu_torch.parallel.mesh")
    ns.graph = importlib.import_module("mujoco_sim_tpu_torch.utils.graph")
    ns.solver = importlib.import_module("mujoco_sim_tpu_torch.ops.solver")
    return ns


def reference() -> types.SimpleNamespace:
    return namespace("refsim")


DTYPES = {"float32": torch.float32, "float64": torch.float64}


def build_model(ns, config: dict, dtype, device):
    """The configuration's model, compiled by ``ns``'s own compiler, cast
    to dtype and put on device."""
    scene = config["scene"]
    if "mjcf" in scene:
        m = ns.compile.load_model(bench_path(scene["mjcf"]))
    else:
        robots = {
            name: ns.scene.RobotConfig(
                path=bench_path(r["mjcf"]),
                add_odom_joints=dict.fromkeys(r.get("odom_joints", ()),
                                              True))
            for name, r in scene["robots"].items()}
        spec = ns.scene.compose(bench_path(scene["world"]), robots=robots)
        m = ns.engine.set_const(ns.compile.compile_spec(spec))
    integ = ns.model.Integrator[config["integrator"].upper()]
    m = m.replace(opt=m.opt.replace(integrator=int(integ)))
    return ns.engine.put_model(m, dtype, device)
