"""Constraint row assembly: dof friction, joint limits, contacts.

Port of mujoco_sim_tpu/ops/constraint.py over an explicit leading env axis.
Implements MuJoCo's soft-constraint model (impedance d(r) from solimp,
reference acceleration from solref, regularization R = (1-d)/d * diagApprox)
with *static* row layout: every potential row owns a fixed slot
(models/compile.py assigns addresses); inactive rows are masked.  Rows are
built as per-section blocks and concatenated in the compile-time address
order (equality, dof friction, limits, contacts).

Equality rows and tendon-limit rows are not ported yet (ROADMAP §A.7) and
raise; so does the elliptic cone (ROADMAP §A.7).
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_sim_tpu_torch.models.model import (Model, Data, DisableBit,
                                                ConeType, contact_rows_per)
from mujoco_sim_tpu_torch.ops import math as mm

_MINIMP, _MAXIMP = 0.0001, 0.9999


def impedance(solimp: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Constraint impedance d(r) (MuJoCo getimpedance)."""
    d0, d1, width, mid, power = (solimp[..., 0], solimp[..., 1],
                                 solimp[..., 2], solimp[..., 3],
                                 solimp[..., 4])
    flat = 0.5 * (d0 + d1)
    x = torch.clamp(pos.abs() / torch.clamp(width, min=1e-12), 0.0, 1.0)
    mid = torch.clamp(mid, 0.0001, 0.9999)
    power = torch.clamp(power, min=1.0)
    # two power curves meeting at the midpoint (MuJoCo sigmoid)
    y_lo = mid * torch.pow(x / mid, power)
    y_hi = 1.0 - (1.0 - mid) * torch.pow((1.0 - x) / (1.0 - mid), power)
    y = torch.where(x <= mid, y_lo, y_hi)
    imp = d0 + y * (d1 - d0)
    imp = torch.where(width <= 1e-12, flat, imp)
    return torch.clamp(imp, _MINIMP, _MAXIMP)


def kbi(solref: torch.Tensor, solimp: torch.Tensor, pos: torch.Tensor):
    """(stiffness k, damping b, impedance imp) per row (MuJoCo mj_assignRef)."""
    imp = impedance(solimp, pos)
    dmax = torch.clamp(solimp[..., 1], _MINIMP, _MAXIMP)
    tc = solref[..., 0]
    dr = solref[..., 1]
    b_std = 2.0 / torch.clamp(dmax * tc, min=1e-12)
    k_std = 1.0 / torch.clamp(dmax * dmax * tc * tc * dr * dr, min=1e-12)
    k = torch.where(tc > 0, k_std, -solref[..., 0])
    b = torch.where(tc > 0, b_std, -solref[..., 1])
    return k, b, imp


def _point_jacobian(m: Model, cdof: torch.Tensor, point: torch.Tensor,
                    body_id, origin: torch.Tensor) -> torch.Tensor:
    """Translational Jacobian (B, n, 3, nv) of world points (B, n, 3) on
    bodies body_id (n,): v(point) = cdof_lin + cdof_ang x (point - O),
    masked by dof ancestry."""
    dtype = cdof.dtype
    ang, lin = cdof[..., :3], cdof[..., 3:]          # (B, nv, 3)
    r = point - origin                               # (B, n, 3)
    jac = lin.transpose(-1, -2)[:, None] + mm.cross(
        ang[:, None, :, :], r[..., None, :]).transpose(-1, -2)
    mask = m.ancestor_mask.to(dtype)[body_id]        # (n, nv)
    return jac * mask[..., None, :]


def _rot_jacobian(m: Model, cdof: torch.Tensor, body_id) -> torch.Tensor:
    """Rotational Jacobian (B, n, 3, nv) of bodies body_id (n,)."""
    ang = cdof[..., :3]                              # (B, nv, 3)
    mask = m.ancestor_mask.to(cdof.dtype)[body_id]
    return ang.transpose(-1, -2)[:, None] * mask[..., None, :]


def _onehot_rows(idx: np.ndarray, nv: int) -> np.ndarray:
    """Constant (n, nv) one-hot matrix (host-side)."""
    B = np.zeros((len(idx), nv))
    B[np.arange(len(idx)), idx] = 1.0
    return B


def _plan_np(m: Model) -> dict:
    lay = m.layout
    nv = m.nv
    plan = {}
    if len(lay.fri_dofid):
        plan["fri_rows"] = _onehot_rows(lay.fri_dofid, nv)
    if len(lay.lim_jntid):
        jids = lay.lim_jntid
        plan["lim"] = dict(jids=jids, qadr=lay.jnt_qposadr[jids],
                           dadr=lay.jnt_dofadr[jids],
                           body=lay.jnt_bodyid[jids],
                           rows=_onehot_rows(lay.jnt_dofadr[jids], nv))
    if m.ncon_max:
        geom2body = np.zeros((m.ngeom, m.nbody))
        geom2body[np.arange(m.ngeom), lay.geom_bodyid] = 1.0
        plan["g2b"] = geom2body
        # friction axis of each pyramidal row (+- pair per axis)
        plan["axis_of_row"] = np.repeat(np.arange(max(m.max_condim - 1, 0)),
                                        2)
    return plan


def make_constraint(m: Model, d: Data, com: dict) -> Data:
    """Fill efc_* rows (mj_makeConstraint equivalent), (B, nefc[, nv])."""
    lay = m.layout
    dtype = d.qpos.dtype
    nefc, nv = m.nefc_max, m.nv
    if nefc == 0:
        return d
    if m.neq:
        raise NotImplementedError(
            "equality constraint rows are not ported yet (ROADMAP §A.7)")
    if len(lay.tlim_tenid):
        raise NotImplementedError(
            "tendon-limit rows are not ported yet (ROADMAP §A.7)")
    if m.ncon_max and m.opt.cone == int(ConeType.ELLIPTIC) \
            and m.max_condim > 1:
        raise NotImplementedError(
            "the elliptic friction cone is not ported yet (ROADMAP §A.7)")
    B = d.qpos.shape[0]
    dev = d.qpos.device
    plan = lay.const("constraint", lambda: _plan_np(m), dtype)
    binv = m.body_invweight0.to(dtype)
    dinv = m.dof_invweight0.to(dtype)
    disable = m.opt.disableflags

    # section accumulators (concatenated in address order at the end)
    secs = {k: [] for k in ("J", "pos", "margin", "solref", "solimp",
                            "diag", "floss", "active", "type", "flossrow")}

    def emit(J, pos, solref, solimp, diag, active, etype,
             margin=None, floss=None, flossrow=None):
        n = J.shape[1]
        z = torch.zeros((B, n), dtype=dtype, device=dev)
        secs["J"].append(J.expand(B, n, nv))
        secs["pos"].append(pos.expand(B, n))
        secs["margin"].append(z if margin is None else margin.expand(B, n))
        secs["solref"].append(solref.expand(B, n, 2))
        secs["solimp"].append(solimp.expand(B, n, 5))
        secs["diag"].append(diag.expand(B, n))
        secs["floss"].append(z if floss is None else floss.expand(B, n))
        secs["active"].append(active.expand(B, n))
        secs["type"].append(torch.full((B, n), etype, dtype=torch.int32,
                                       device=dev))
        secs["flossrow"].append(
            torch.zeros((B, n), dtype=torch.bool, device=dev)
            if flossrow is None else flossrow.expand(B, n))

    # ---------------- dof friction loss ----------------
    if len(lay.fri_dofid):
        dofs = lay.dev.fri_dofid
        n = len(lay.fri_dofid)
        active = torch.full((1, n),
                            not (disable & int(DisableBit.FRICTIONLOSS)),
                            dtype=torch.bool, device=dev)
        emit(plan["fri_rows"][None], torch.zeros((1, n), dtype=dtype,
                                                 device=dev),
             m.opt.o_solref.to(dtype).expand(1, n, 2),
             m.opt.o_solimp.to(dtype).expand(1, n, 5),
             dinv[dofs][None], active, 1,
             floss=m.dof_frictionloss.to(dtype)[dofs][None],
             flossrow=torch.ones((1, n), dtype=torch.bool, device=dev))

    # ---------------- joint limits (hinge/slide) ----------------
    if len(lay.lim_jntid):
        lim = plan["lim"]
        jids = lim["jids"]
        rng = m.jnt_range.to(dtype)[jids]
        margin = m.jnt_margin.to(dtype)[jids]
        q = d.qpos[:, lim["qadr"]]
        dist_lo = q - rng[:, 0]
        dist_hi = rng[:, 1] - q
        lower = dist_lo < dist_hi
        dist = torch.where(lower, dist_lo, dist_hi)
        sign = torch.where(lower, 1.0, -1.0).to(dtype)
        rows = sign[..., None] * lim["rows"]
        active = (dist < margin) & d.body_active[:, lim["body"]]
        if disable & int(DisableBit.LIMIT):
            active = torch.zeros_like(active)
        emit(rows, dist - margin,
             m.jnt_solref.to(dtype)[jids][None],
             m.jnt_solimp.to(dtype)[jids][None],
             dinv[lim["dadr"]][None], active, 2, margin=margin[None])

    # ---------------- contacts (vectorized over the K budget) ----
    if m.ncon_max:
        con = d.contact
        K = m.ncon_max
        mc = m.max_condim
        nrows_per = contact_rows_per(mc, m.opt.cone)
        # per-contact body lookups via one-hot matmuls; geom->body is
        # folded into the one-hot with a static 0/1 matrix
        g2b = plan["g2b"]
        B1 = torch.nn.functional.one_hot(con.geom1.long(), m.ngeom).to(
            dtype) @ g2b                                        # (B, K, nb)
        B2 = torch.nn.functional.one_hot(con.geom2.long(), m.ngeom).to(
            dtype) @ g2b
        pos_c = con.pos            # (B, K, 3)
        frame = con.frame          # (B, K, 3, 3) rows n,t1,t2
        origin_of_body = d.subtree_com[:, lay.dev.body_rootid]
        o1 = B1 @ origin_of_body
        o2 = B2 @ origin_of_body
        anc = m.ancestor_mask.to(dtype)                         # (nb, nv)
        mask1 = B1 @ anc
        mask2 = B2 @ anc
        cdof = d.cdof
        ang, lin = cdof[..., :3], cdof[..., 3:]

        def point_jac(point, origin, mask):
            jac = lin.transpose(-1, -2)[:, None] + mm.cross(
                ang[:, None, :, :], (point - origin)[..., None, :]
            ).transpose(-1, -2)
            return jac * mask[..., None, :]

        Jp2 = point_jac(pos_c, o2, mask2)
        Jp1 = point_jac(pos_c, o1, mask1)
        Jdiff = Jp2 - Jp1          # (B, K, 3, nv)
        Jn = torch.einsum("zsi,zsiv->zsv", frame[:, :, 0], Jdiff)
        fric_axes = [
            torch.einsum("zsi,zsiv->zsv", frame[:, :, 1], Jdiff),
            torch.einsum("zsi,zsiv->zsv", frame[:, :, 2], Jdiff),
        ]
        if mc >= 4:
            Jrdiff = ang.transpose(-1, -2)[:, None] * (
                mask2 - mask1)[..., None, :]
            fric_axes.append(torch.einsum("zsi,zsiv->zsv", frame[:, :, 0],
                                          Jrdiff))
            if mc >= 6:
                fric_axes.append(
                    torch.einsum("zsi,zsiv->zsv", frame[:, :, 1], Jrdiff))
                fric_axes.append(
                    torch.einsum("zsi,zsiv->zsv", frame[:, :, 2], Jrdiff))
        pen = con.dist - con.includemargin
        invw = ((B1 + B2) @ binv[:, 0:1])[..., 0]
        con_active = con.active
        if disable & int(DisableBit.CONTACT):
            con_active = torch.zeros_like(con_active)

        if mc == 1:
            rows = Jn[:, :, None, :]                   # (B,K,1,nv)
            diag_rows = invw[..., None]
            row_act = con_active[..., None]
        else:
            axes = torch.stack(fric_axes[: mc - 1], dim=2)  # (B,K,mc-1,nv)
            mu = con.friction[..., : mc - 1]                # (B,K,mc-1)
            frictionless = (con.dim == 1)
            mu_eff = torch.where(frictionless[..., None], 0.0, mu)
            plus = Jn[:, :, None, :] + mu_eff[..., None] * axes
            minus = Jn[:, :, None, :] - mu_eff[..., None] * axes
            rows = torch.stack([plus, minus], dim=3).reshape(
                B, K, nrows_per, nv)
            dr = invw[..., None] * 2.0 * mu_eff * mu_eff * (
                1.0 + mu_eff * mu_eff)
            dr = torch.where(frictionless[..., None], invw[..., None], dr)
            diag_rows = torch.repeat_interleave(dr, 2, dim=-1)
            # rows for friction axes beyond the contact's condim are masked;
            # frictionless contacts keep only the first +- pair (mu=0)
            row_act = con_active[..., None] & (
                plan["axis_of_row"]
                < torch.clamp(con.dim - 1, min=1)[..., None])
        emit(rows.reshape(B, K * nrows_per, nv),
             torch.repeat_interleave(pen, nrows_per, dim=-1),
             torch.repeat_interleave(con.solref, nrows_per, dim=1),
             torch.repeat_interleave(con.solimp, nrows_per, dim=1),
             diag_rows.reshape(B, -1), row_act.reshape(B, -1), 3,
             margin=torch.repeat_interleave(con.includemargin, nrows_per,
                                            dim=-1))

    efc_J = torch.cat(secs["J"], dim=1)
    efc_pos = torch.cat(secs["pos"], dim=1)
    efc_solref = torch.cat(secs["solref"], dim=1)
    efc_solimp = torch.cat(secs["solimp"], dim=1)
    efc_diag = torch.cat(secs["diag"], dim=1)
    efc_floss = torch.cat(secs["floss"], dim=1)
    efc_active = torch.cat(secs["active"], dim=1)
    efc_type = torch.cat(secs["type"], dim=1)
    efc_floss_row = torch.cat(secs["flossrow"], dim=1)
    assert efc_J.shape[1] == nefc, (efc_J.shape, nefc)

    if disable & int(DisableBit.CONSTRAINT):
        efc_active = torch.zeros_like(efc_active)

    # ---------------- aref / D / R ----------------
    k, b, imp = kbi(efc_solref, efc_solimp, efc_pos)
    vel = torch.einsum("ziv,zv->zi", efc_J, d.qvel)
    aref = -b * vel - k * imp * efc_pos
    R = torch.clamp((1.0 - imp) / torch.clamp(imp, min=_MINIMP) * efc_diag,
                    min=1e-12)
    D = 1.0 / R
    return d.replace(
        efc_J=efc_J, efc_D=torch.where(efc_active, D, 0.0),
        efc_R=R, efc_aref=aref,
        efc_frictionloss=efc_floss,
        efc_floss_active=efc_floss_row,
        efc_active=efc_active, efc_type=efc_type,
    )
