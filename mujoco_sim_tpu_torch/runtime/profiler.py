"""Tracing / profiling subsystem.

Torch port of mujoco_sim_tpu/runtime/profiler.py.  The reference's only
instrumentation is the RTF tracker + XML-I/O timing warnings (SURVEY §5).
Here: per-stage wall timings of the step, steps/s + RTF gauges, and a
one-call torch.profiler trace (Chrome trace format) of the card's
schedule.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass

import torch


@dataclass
class StepStats:
    steps: int = 0
    wall: float = 0.0
    sim_time: float = 0.0
    _t0: float | None = None

    def rate(self) -> float:
        return self.steps / self.wall if self.wall > 0 else 0.0

    def rtf(self) -> float:
        return self.sim_time / self.wall if self.wall > 0 else 0.0


class Profiler:
    """Aggregates step timing; optionally captures a device trace."""

    def __init__(self):
        self.stats = StepStats()
        self.stage_wall: dict[str, float] = {}

    @contextlib.contextmanager
    def step_block(self, n: int = 1, dt: float = 0.0):
        t0 = time.perf_counter()
        yield
        w = time.perf_counter() - t0
        self.stats.steps += n
        self.stats.wall += w
        self.stats.sim_time += n * dt

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        yield
        self.stage_wall[name] = self.stage_wall.get(name, 0.0) + (
            time.perf_counter() - t0)

    def report(self) -> dict:
        return {
            "steps": self.stats.steps,
            "steps_per_sec": round(self.stats.rate(), 1),
            "rtf": round(self.stats.rtf(), 3),
            "stages": {k: round(v, 4) for k, v in self.stage_wall.items()},
        }


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a torch.profiler trace of the host and, where there is a
    card, its kernels; written to ``log_dir/trace.json`` (open with
    chrome://tracing or Perfetto).  Yields the profiler, whose
    ``key_averages()`` sums the time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _sync(d):
    if d.qpos.is_cuda:
        torch.cuda.synchronize(d.qpos.device)


def stage_timings(m, d, repeats: int = 20) -> dict:
    """Wall-time each pipeline stage of the step (diagnostics), in
    seconds per call.  Each stage is a StepGraph of its own (one CUDA
    graph on the card, as the JAX profiler jits each stage), copying in
    every leaf of its input, and runs on the previous fwd stage's output;
    the first call (warm-up and capture) is not timed.  On the card each
    timing ends with a synchronize, so it holds the device time, not only
    the launches."""
    from mujoco_sim_tpu_torch import engine
    from mujoco_sim_tpu_torch.ops import solver as solver_mod
    from mujoco_sim_tpu_torch.utils.graph import StepGraph

    stages = {
        "fwd_position": engine.fwd_position,
        "fwd_velocity": engine.fwd_velocity,
        "fwd_acceleration": engine.fwd_acceleration,
        "solver": solver_mod.solve,
        "full_step": engine.step,
    }
    out = {}
    cur = d
    for name, fn in stages.items():
        g = StepGraph(fn, all_leaves=True)
        res = g(m, cur)
        _sync(cur)
        t0 = time.perf_counter()
        for _ in range(repeats):
            g(m, cur)
        _sync(cur)
        out[name] = (time.perf_counter() - t0) / repeats
        if name.startswith("fwd"):
            cur = res
    return out
