"""Batched step and rollout over the env axis (port of the single-device
part of mujoco_sim_tpu/parallel/mesh.py: ``batched_step`` and ``rollout``).

The env axis is the leading axis of every Data leaf, so a batched step is
``engine.step``.  As the JAX package jits its rollout (a ``lax.scan`` of
the step), here both go through utils/graph.StepGraph: on the card one
CUDA graph a step, captured once and replayed ``nsteps`` times in place,
with ``ctrl_fn`` inside the graph; on the CPU the same static-buffer code
without a capture.  ``rollout_eager`` is the Python loop of eager
``engine.step`` calls that every graph rollout is held to.

A rollout carries only the recurrent leaves: everything else is per-step
derived output that the step recomputes.  The JAX package finds the
recurrent set by dead-code elimination over the step's jaxpr
(parallel/mesh.py:51-77); here it is listed by hand, and
tests/test_torch_step.py checks that the list gives the same final state
as carrying all of Data.  It is also the set of leaves a StepGraph copies
into its input buffers on each call.
"""

from __future__ import annotations

from mujoco_sim_tpu_torch import engine
from mujoco_sim_tpu_torch.models.model import Model, Data
from mujoco_sim_tpu_torch.runtime import profiler
from mujoco_sim_tpu_torch.utils import graph

# Data leaves that step() reads before writing them: the state proper and
# the per-env inputs and spawn-time overrides.
RECURRENT = (
    "time", "qpos", "qvel", "act", "qacc_warmstart",
    "ctrl", "qfrc_applied", "xfrc_applied", "mocap_pos", "mocap_quat",
    "body_active", "geom_size", "geom_rbound", "body_mass", "body_inertia",
)


def _carry(d: Data) -> dict:
    return {k: getattr(d, k) for k in RECURRENT}


def _step_fn(ctrl_fn):
    """The step a rollout's graph holds: ctrl_fn (if any) sets the controls
    from the state the step starts from, then engine.step."""
    if ctrl_fn is None:
        return engine.step
    return lambda m, d: engine.step(m, d.replace(ctrl=ctrl_fn(d)))


def step_graph(ctrl_fn=None) -> graph.StepGraph:
    """The cached StepGraph of one (controlled) batched step."""
    return graph.cached("rollout", ctrl_fn,
                        lambda: graph.StepGraph(_step_fn(ctrl_fn)))


def batched_step(m: Model, dB: Data) -> Data:
    """One batched step through the step's graph."""
    with profiler.span("rollout.batched_step", dB):
        return step_graph()(m, dB)


def rollout(m: Model, dB: Data, nsteps: int, full_final: bool = True,
            ctrl_fn=None) -> Data:
    """``nsteps`` batched steps from dB, carrying only RECURRENT leaves.

    Every step starts from dB with the carried leaves replaced, so a leaf
    the step reads but RECURRENT misses would show as a wrong result.
    full_final=False returns dB with only the recurrent leaves advanced
    (the derived leaves are stale template values, as in the JAX package).
    ctrl_fn(d) -> ctrl (nenv, nu), if given, sets the controls before each
    step from the state that step starts from (its ``time``, ``qpos``...);
    on the card it runs inside the graph, so it must be torch operations
    on d with no host read.
    """
    if nsteps <= 0:
        return dB
    with profiler.span("rollout.rollout", dB):
        d = step_graph(ctrl_fn).run(m, dB, n=nsteps)
    return d if full_final else dB.replace(**_carry(d))


def rollout_eager(m: Model, dB: Data, nsteps: int, full_final: bool = True,
                  ctrl_fn=None) -> Data:
    """``rollout`` as a Python loop of eager ``engine.step`` calls: the
    reference the graph rollout is held to (the JAX package's un-jitted
    step in a Python loop)."""
    if nsteps <= 0:
        return dB
    step = _step_fn(ctrl_fn)
    carry = _carry(dB)
    for i in range(nsteps):
        d = step(m, dB.replace(**carry))
        if i < nsteps - 1 or not full_final:
            carry = _carry(d)
    return d if full_final else dB.replace(**carry)
