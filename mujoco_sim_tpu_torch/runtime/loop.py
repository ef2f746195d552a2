"""Interactive sim loop: real-time pacing, RTF tracking, adaptive timestep.

Torch port of mujoco_sim_tpu/runtime/loop.py.  Equivalent of simulate() +
the RTF governor (reference: src/mj_main.cpp:54-165): busy-wait sync to
wall clock, trailing-window real-time-factor, timestep doubled when >1 ms
behind (capped at max_time_step) and halved back to nominal when caught
up.  Option.timestep is a tensor leaf, so retiming builds nothing anew.

The step runs through utils/graph.StepGraph (one CUDA graph a step on
the card, as the JAX loop jits it).  A new timestep is a new model, which
the graph must not read stale: each timestep the governor uses keeps its
model object, and the graph keeps one capture per model, so moving
between timesteps captures each once.  The sim time is read once a step
(on the card each read waits for the step to finish).  Throughput mode
(real_time=False) runs free.
"""

from __future__ import annotations

import time
from collections import deque

import torch

from mujoco_sim_tpu_torch import engine
from mujoco_sim_tpu_torch.models.model import Model, Data
from mujoco_sim_tpu_torch.utils.graph import StepGraph

# captures the governor keeps: the nominal timestep and its doublings up to
# max_time_step (2^7 = 128x nominal)
_DT_LEVELS = 8


class SimLoop:
    def __init__(self, m: Model, d: Data, max_time_step: float | None = None,
                 real_time: bool = True, controller=None):
        self.m = m
        self.d = d
        self.nominal_dt = float(m.opt.timestep)
        self.max_dt = max_time_step or self.nominal_dt
        self.real_time = real_time
        self.controller = controller  # callable (m, d) -> d
        self.rtf = 1.0
        self._window: deque[tuple[float, float]] = deque()
        self._start_wall = None
        self._start_sim = None
        self.current_dt = self.nominal_dt
        self._models = {self.nominal_dt: m}
        self.step_graph = StepGraph(engine.step, keep=_DT_LEVELS)

    def _set_dt(self, dt: float):
        if dt != self.current_dt:
            self.current_dt = dt
            if dt not in self._models:
                ts = self.m.opt.timestep
                opt = self.m.opt.replace(timestep=torch.tensor(
                    dt, dtype=ts.dtype, device=ts.device))
                self._models[dt] = self.m.replace(opt=opt)
            self.m = self._models[dt]

    def run(self, sim_seconds: float):
        """Advance sim time by sim_seconds with pacing + governor."""
        sim_t = float(self.d.time[0])
        if self._start_wall is None:
            self._start_wall = time.perf_counter()
            self._start_sim = sim_t
        end_time = sim_t + sim_seconds
        while sim_t < end_time:
            if self.controller is not None:
                self.d = self.controller(self.m, self.d)
            self.d = self.step_graph(self.m, self.d)
            sim_t = float(self.d.time[0])
            now = time.perf_counter()
            sim_elapsed = sim_t - self._start_sim
            wall_elapsed = now - self._start_wall
            lag = wall_elapsed - sim_elapsed
            if self.real_time:
                if lag < 0:
                    # ahead of wall clock: busy-wait (mj_main.cpp:127-131)
                    target = self._start_wall + sim_elapsed
                    while time.perf_counter() < target:
                        pass
                elif lag > 1e-3 and self.current_dt * 2 <= self.max_dt:
                    # behind: double timestep (mj_main.cpp:149-156)
                    self._set_dt(self.current_dt * 2)
                elif lag <= 1e-3 and self.current_dt > self.nominal_dt:
                    # caught up: halve back toward nominal (:157-163)
                    self._set_dt(max(self.nominal_dt, self.current_dt / 2))
            # trailing-window RTF over ~1 s of sim time (mj_main.cpp:115-147)
            self._window.append((now, sim_t))
            while len(self._window) > 2 and sim_t - self._window[0][1] > 1.0:
                self._window.popleft()
            (w0, s0), (w1, s1) = self._window[0], self._window[-1]
            if w1 > w0:
                self.rtf = (s1 - s0) / (w1 - w0)
        return self.d
