"""Frozen copy of mujoco_sim_tpu_torch's CPU path for the benchmark's
plain reference (bench_port/refsim): imports rewritten, CUDA wrappers
and graph capture removed.  Do not import the program from here.

Force projection helpers (port of mujoco_sim_tpu/ops/support.py)."""

from __future__ import annotations

import torch

from refsim.models.model import Model
from refsim.ops import math as mm


def xfrc_accumulate(m: Model, com: dict, xipos: torch.Tensor,
                    xfrc_applied: torch.Tensor) -> torch.Tensor:
    """Project per-body Cartesian wrenches [torque, force] (B, nbody, 6)
    applied at body COM into joint space -> (B, nv) (mj_xfrcAccumulate)."""
    dtype = xfrc_applied.dtype
    torque = xfrc_applied[..., :3]
    force = xfrc_applied[..., 3:]
    # spatial force at the body's c-frame origin
    r = xipos - com["origin"]
    tau_o = torque + mm.cross(r, force)
    F = torch.cat([tau_o, force], dim=-1)  # (B, nbody, 6)
    mask = m.ancestor_mask.to(dtype)
    return torch.einsum("zdu,zbu,bd->zd", com["cdof"], F, mask)


def apply_ft(m: Model, com: dict, force: torch.Tensor, torque: torch.Tensor,
             point: torch.Tensor, body_id: int) -> torch.Tensor:
    """qfrc (B, nv) from a wrench (B, 3) applied at a world point (B, 3) on
    one body (mj_applyFT)."""
    dtype = force.dtype
    O = com["origin"][:, body_id]
    tau_o = torque + mm.cross(point - O, force)
    F = torch.cat([tau_o, force], dim=-1)
    mask = m.ancestor_mask.to(dtype)[body_id]
    return torch.einsum("zdu,zu->zd", com["cdof"], F) * mask
