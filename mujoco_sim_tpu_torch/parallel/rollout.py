"""Batched step and rollout over the env axis (port of the single-device
part of mujoco_sim_tpu/parallel/mesh.py: ``batched_step`` and ``rollout``).

The env axis is the leading axis of every Data leaf, so a batched step is
simply ``engine.step``.  The rollout is a Python loop over steps that
carries only the recurrent leaves: everything else is per-step derived
output that the step recomputes.  The JAX package finds the recurrent set
by dead-code elimination over the step's jaxpr (parallel/mesh.py:51-77);
here it is listed by hand, and tests/test_torch_step.py checks that the
list gives the same final state as carrying all of Data.
"""

from __future__ import annotations

from mujoco_sim_tpu_torch import engine
from mujoco_sim_tpu_torch.models.model import Model, Data

# Data leaves that step() reads before writing them: the state proper and
# the per-env inputs and spawn-time overrides.
RECURRENT = (
    "time", "qpos", "qvel", "act", "qacc_warmstart",
    "ctrl", "qfrc_applied", "xfrc_applied", "mocap_pos", "mocap_quat",
    "body_active", "geom_size", "geom_rbound", "body_mass", "body_inertia",
)


def batched_step(m: Model, dB: Data) -> Data:
    return engine.step(m, dB)


def _carry(d: Data) -> dict:
    return {k: getattr(d, k) for k in RECURRENT}


def rollout(m: Model, dB: Data, nsteps: int, full_final: bool = True) -> Data:
    """``nsteps`` batched steps from dB, carrying only RECURRENT leaves.

    Every step starts from dB with the carried leaves replaced, so a leaf
    the step reads but RECURRENT misses would show as a wrong result.
    full_final=False returns dB with only the recurrent leaves advanced
    (the derived leaves are stale template values, as in the JAX package).
    """
    if nsteps <= 0:
        return dB
    carry = _carry(dB)
    for _ in range(nsteps - 1):
        carry = _carry(batched_step(m, dB.replace(**carry)))
    if not full_final:
        return dB.replace(**_carry(batched_step(m, dB.replace(**carry))))
    return batched_step(m, dB.replace(**carry))
