"""Failure detection + elastic recovery for batched envs.

Torch port of mujoco_sim_tpu/runtime/health.py.  The reference has no
failure handling beyond retry/timeouts (SURVEY §5); for production fleets
of thousands of envs: per-env divergence detection (non-finite state or
exploding velocities) and auto-reset of only the diverged envs — the batch
keeps running, healthy envs untouched.
"""

from __future__ import annotations

import torch

from mujoco_sim_tpu_torch import engine
from mujoco_sim_tpu_torch.models.model import Model, Data
from mujoco_sim_tpu_torch.utils.struct import map_leaves


def env_healthy(d: Data, qvel_limit: float = 1e6) -> torch.Tensor:
    """Per-env boolean (batched Data -> (B,) mask)."""
    finite = (torch.isfinite(d.qpos).all(dim=-1)
              & torch.isfinite(d.qvel).all(dim=-1))
    bounded = d.qvel.abs().amax(dim=-1) < qvel_limit
    return finite & bounded


def contact_saturated(m: Model, d: Data) -> torch.Tensor:
    """True where the narrowphase found more active contacts than the
    compiled ncon_max budget — the top-K compaction silently dropped the
    shallowest ones (ops/collision.py).  Surfaced so fleets can flag
    under-budgeted scenes instead of quietly losing contacts."""
    return d.ncon > m.ncon_max


def auto_reset(m: Model, dB: Data, qvel_limit: float = 1e6):
    """Replace diverged envs with fresh make_data state; report the mask.

    Returns (dB', healthy_mask).  Healthy envs are bit-identical: every
    leaf is a new tensor selected by torch.where, dB itself is untouched.
    """
    healthy = env_healthy(dB, qvel_limit)
    fresh = engine.make_data(m, 1, dB.qpos.dtype)

    def mend(batched, clean):
        mask = healthy.reshape((-1,) + (1,) * (batched.ndim - 1))
        return torch.where(mask, batched, clean)

    return map_leaves(mend, dB, fresh), healthy
