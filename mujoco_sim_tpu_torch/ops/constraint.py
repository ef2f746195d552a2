"""Constraint row assembly: equality, dof friction, limits, contacts.

Port of mujoco_sim_tpu/ops/constraint.py over an explicit leading env axis.
Implements MuJoCo's soft-constraint model (impedance d(r) from solimp,
reference acceleration from solref, regularization R = (1-d)/d * diagApprox)
with *static* row layout: every potential row owns a fixed slot
(models/compile.py assigns addresses); inactive rows are masked.  Rows are
built as per-section blocks and concatenated in the compile-time address
order (equality, dof friction, joint limits, tendon limits, contacts).

Equality rows cover connect, weld, joint and tendon (polycoef)
equalities, contact rows both friction cones.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_sim_tpu_torch.models.model import (Model, Data, DisableBit,
                                                ConeType, EqType,
                                                contact_rows_per)
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


def _eq_plan_np(m: Model) -> dict:
    """Static equality-section plan: per-type index arrays, constant
    one-hot bases for joint couples, and the permutation restoring
    compile-time (interleaved) row order from [JOINT | CONNECT | WELD]
    block order."""
    lay = m.layout
    nv = m.nv
    et = lay.eq_type
    jsel = np.nonzero(et == int(EqType.JOINT))[0]
    csel = np.nonzero(et == int(EqType.CONNECT))[0]
    wsel = np.nonzero(et == int(EqType.WELD))[0]
    tsel = np.nonzero(et == int(EqType.TENDON))[0]
    plan = dict(jsel=jsel, csel=csel, wsel=wsel, tsel=tsel,
                c_o1=lay.eq_obj1id[csel], c_o2=lay.eq_obj2id[csel],
                w_o1=lay.eq_obj1id[wsel], w_o2=lay.eq_obj2id[wsel])
    if len(tsel):
        t_has2 = lay.eq_obj2id[tsel] >= 0
        plan.update(t_id1=lay.eq_obj1id[tsel], t_has2=t_has2,
                    t_id2=np.where(t_has2, lay.eq_obj2id[tsel], 0))
    if len(jsel):
        o1 = lay.eq_obj1id[jsel]
        o2 = lay.eq_obj2id[jsel]
        has2 = o2 >= 0
        o2s = np.where(has2, o2, 0)
        nJ = len(jsel)
        b1 = np.zeros((nJ, nv))
        b1[np.arange(nJ), lay.jnt_dofadr[o1]] = 1.0
        b2 = np.zeros((nJ, nv))
        b2[np.arange(nJ), lay.jnt_dofadr[o2s]] = 1.0
        b2[~has2] = 0.0
        plan.update(j_qa1=lay.jnt_qposadr[o1], j_da1=lay.jnt_dofadr[o1],
                    j_has2=has2, j_qa2=lay.jnt_qposadr[o2s],
                    j_da2=lay.jnt_dofadr[o2s], j_body=lay.jnt_bodyid[o1],
                    j_base1=b1, j_base2=b2)
    # row permutation: dest row (relative to eq section) -> src row in
    # the [J | T | C | W] block concat
    rows_of = {int(EqType.JOINT): 1, int(EqType.TENDON): 1,
               int(EqType.CONNECT): 3, int(EqType.WELD): 6}
    src_of_eq = {}
    cursor = 0
    for grp in (jsel, tsel, csel, wsel):
        for k in grp:
            src_of_eq[int(k)] = cursor
            cursor += rows_of[int(et[k])]
    inv = np.zeros(cursor, dtype=np.int64)
    base = lay.eq_efcadr[0] if len(et) else 0
    for k in range(len(et)):
        adr = lay.eq_efcadr[k] - base
        for i in range(rows_of[int(et[k])]):
            inv[adr + i] = src_of_eq[int(k)] + i
    plan["perm"] = inv
    plan["perm_is_identity"] = bool(np.all(inv == np.arange(cursor)))
    return plan


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
        # elliptic layout: one row per contact dimension; the friction
        # rows (all but the first of each contact) take no position term
        rp = contact_rows_per(m.max_condim, int(ConeType.ELLIPTIC))
        plan["ell_row_idx"] = np.arange(m.max_condim)
        fric_mask = np.zeros(m.nefc_max, dtype=bool)
        if m.opt.cone == int(ConeType.ELLIPTIC) and m.max_condim > 1:
            for kslot in range(m.ncon_max):
                base = m.contact_efcadr + kslot * rp
                fric_mask[base + 1: base + rp] = True
        plan["ell_fric_mask"] = fric_mask
    return plan


def make_constraint(m: Model, d: Data, com: dict) -> Data:
    """Fill efc_* rows (mj_makeConstraint equivalent), (B, nefc[, nv])."""
    lay = m.layout
    dtype = d.qpos.dtype
    nefc, nv = m.nefc_max, m.nv
    if nefc == 0:
        return d
    B = d.qpos.shape[0]
    dev = d.qpos.device
    plan = lay.const(("constraint", m.opt.cone, m.contact_efcadr,
                      m.ncon_max, m.max_condim, m.nefc_max),
                     lambda: _plan_np(m), dtype)
    elliptic = (m.ncon_max > 0 and m.opt.cone == int(ConeType.ELLIPTIC)
                and m.max_condim > 1)
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

    # ---------------- equality ----------------
    if m.neq:
        ep = lay.const("eqplan", lambda: _eq_plan_np(m), dtype)
        eq_off = (disable & int(DisableBit.EQUALITY)) != 0
        eq_data = m.eq_data.to(dtype)
        eq_solref = m.eq_solref.to(dtype)
        eq_solimp = m.eq_solimp.to(dtype)
        eq_act0 = m.eq_active0
        origin = com["origin"]                         # (B, nbody, 3)
        blocks = {k: [] for k in ("J", "pos", "solref", "solimp", "diag",
                                  "active")}

        def emit_eq(J, pos, solref, solimp, diag, active):
            n = J.shape[1]
            blocks["J"].append(J.expand(B, n, nv))
            blocks["pos"].append(pos.expand(B, n))
            blocks["solref"].append(solref.expand(B, n, 2))
            blocks["solimp"].append(solimp.expand(B, n, 5))
            blocks["diag"].append(diag.expand(B, n))
            blocks["active"].append(active.expand(B, n))

        if len(ep["jsel"]):
            js = ep["jsel"]
            has2 = ep["j_has2"]
            qpos0 = m.qpos0.to(dtype)
            q1 = d.qpos[:, ep["j_qa1"]] - qpos0[ep["j_qa1"]]
            dx = torch.where(has2,
                             d.qpos[:, ep["j_qa2"]] - qpos0[ep["j_qa2"]], 0.0)
            # poly and its derivative (Horner)
            c = eq_data[js][:, :5]
            poly = (((c[:, 4] * dx + c[:, 3]) * dx + c[:, 2]) * dx
                    + c[:, 1]) * dx + c[:, 0]
            dpoly = ((4.0 * c[:, 4] * dx + 3.0 * c[:, 3]) * dx
                     + 2.0 * c[:, 2]) * dx + c[:, 1]
            dpoly = torch.where(has2, dpoly, 0.0)
            rows = ep["j_base1"] - dpoly[..., None] * ep["j_base2"]
            diag = dinv[ep["j_da1"]] + torch.where(has2, dinv[ep["j_da2"]],
                                                   0.0)
            active = eq_act0[js] & d.body_active[:, ep["j_body"]]
            emit_eq(rows, q1 - poly, eq_solref[js][None], eq_solimp[js][None],
                    diag[None], active)

        if len(ep["tsel"]):
            # tendon couple: (L1 - L1_0) = poly(L2 - L2_0), the joint
            # couple's polynomial through the tendon moment rows
            ts, has2 = ep["tsel"], ep["t_has2"]
            t1, t2 = ep["t_id1"], ep["t_id2"]
            len0 = m.ten_length0.to(dtype)
            l1 = d.ten_length[:, t1] - len0[t1]
            dx = torch.where(has2, d.ten_length[:, t2] - len0[t2], 0.0)
            c = eq_data[ts][:, :5]
            poly = (((c[:, 4] * dx + c[:, 3]) * dx + c[:, 2]) * dx
                    + c[:, 1]) * dx + c[:, 0]
            dpoly = ((4.0 * c[:, 4] * dx + 3.0 * c[:, 3]) * dx
                     + 2.0 * c[:, 2]) * dx + c[:, 1]
            dpoly = torch.where(has2, dpoly, 0.0)
            rows = d.ten_J[:, t1] - dpoly[..., None] * d.ten_J[:, t2]
            tinv = m.ten_invweight0.to(dtype)
            diag = tinv[t1] + torch.where(has2, tinv[t2], 0.0)
            emit_eq(rows, l1 - poly, eq_solref[ts][None], eq_solimp[ts][None],
                    diag[None], eq_act0[ts][None])

        if len(ep["csel"]):
            cs, o1, o2 = ep["csel"], ep["c_o1"], ep["c_o2"]
            data = eq_data[cs]
            p1 = d.xpos[:, o1] + mm.rot_vec_quat(data[:, 0:3], d.xquat[:, o1])
            p2 = d.xpos[:, o2] + mm.rot_vec_quat(data[:, 3:6], d.xquat[:, o2])
            J1 = _point_jacobian(m, d.cdof, p1, o1, origin[:, o1])
            J2 = _point_jacobian(m, d.cdof, p2, o2, origin[:, o2])
            diag = torch.repeat_interleave(binv[o1, 0] + binv[o2, 0], 3)
            active = torch.repeat_interleave(
                eq_act0[cs] & d.body_active[:, o1], 3, dim=-1)
            emit_eq((J1 - J2).reshape(B, -1, nv), (p1 - p2).reshape(B, -1),
                    torch.repeat_interleave(eq_solref[cs], 3, dim=0)[None],
                    torch.repeat_interleave(eq_solimp[cs], 3, dim=0)[None],
                    diag[None], active)

        if len(ep["wsel"]):
            ws, o1, o2 = ep["wsel"], ep["w_o1"], ep["w_o2"]
            data = eq_data[ws]
            anchor = data[:, 0:3]
            relpose_p = data[:, 3:6]
            relpose_q = data[:, 6:10]
            torquescale = data[:, 10]
            xq1, xq2 = d.xquat[:, o1], d.xquat[:, o2]
            p2 = d.xpos[:, o2] + mm.rot_vec_quat(anchor, xq2)
            target = d.xpos[:, o1] + mm.rot_vec_quat(
                relpose_p + mm.rot_vec_quat(anchor, relpose_q), xq1)
            J2 = _point_jacobian(m, d.cdof, p2, o2, origin[:, o2])
            J1 = _point_jacobian(m, d.cdof, target, o1, origin[:, o1])
            rows_p = J2 - J1                         # (B, nW, 3, nv)
            pos_p = p2 - target
            q_target = mm.quat_mul(xq1, relpose_q)
            q_err = mm.quat_mul(mm.quat_inv(q_target), xq2)
            q_err = q_err * torch.where(q_err[..., 0:1] < 0, -1.0, 1.0)
            pos_r = q_err[..., 1:] * torquescale[:, None]
            Jr2 = _rot_jacobian(m, d.cdof, o2)
            Jr1 = _rot_jacobian(m, d.cdof, o1)
            Rt = mm.quat_to_mat(q_target).transpose(-1, -2)
            rows_r = 0.5 * torch.einsum("zkij,zkjv->zkiv", Rt, Jr2 - Jr1) \
                * torquescale[:, None, None]
            rows = torch.cat([rows_p, rows_r], dim=2).reshape(B, -1, nv)
            pos = torch.cat([pos_p, pos_r], dim=2).reshape(B, -1)
            diag_p = (binv[o1, 0] + binv[o2, 0])[:, None].expand(-1, 3)
            diag_r = ((binv[o1, 1] + binv[o2, 1])
                      * torquescale * torquescale)[:, None].expand(-1, 3)
            diag = torch.cat([diag_p, diag_r], dim=1).reshape(-1)
            active = torch.repeat_interleave(
                eq_act0[ws] & d.body_active[:, o1], 6, dim=-1)
            emit_eq(rows, pos,
                    torch.repeat_interleave(eq_solref[ws], 6, dim=0)[None],
                    torch.repeat_interleave(eq_solimp[ws], 6, dim=0)[None],
                    diag[None], active)

        Jb = torch.cat(blocks["J"], dim=1)
        posb = torch.cat(blocks["pos"], dim=1)
        srb = torch.cat(blocks["solref"], dim=1)
        sib = torch.cat(blocks["solimp"], dim=1)
        diagb = torch.cat(blocks["diag"], dim=1)
        actb = torch.cat(blocks["active"], dim=1)
        if not ep["perm_is_identity"]:
            p = ep["perm"]
            Jb, posb, srb, sib, diagb, actb = (
                Jb[:, p], posb[:, p], srb[:, p], sib[:, p], diagb[:, p],
                actb[:, p])
        if eq_off:
            actb = torch.zeros_like(actb)
        emit(Jb, posb, srb, sib, diagb, actb, 0)

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

    # ---------------- tendon limits ----------------
    # the joint limits' nearer-side single-row scheme, with the tendon's
    # moment row (MuJoCo mjCNSTR_LIMIT_TENDON)
    if len(lay.tlim_tenid):
        tids = lay.dev.tlim_tenid
        length = d.ten_length[:, tids]
        rng = m.ten_range.to(dtype)[tids]
        margin = m.ten_margin.to(dtype)[tids]
        dist_lo = length - rng[:, 0]
        dist_hi = rng[:, 1] - length
        lower = dist_lo < dist_hi
        dist = torch.where(lower, dist_lo, dist_hi)
        sign = torch.where(lower, 1.0, -1.0).to(dtype)
        rows = sign[..., None] * d.ten_J[:, tids]
        active = dist < margin
        if disable & int(DisableBit.LIMIT):
            active = torch.zeros_like(active)
        emit(rows, dist - margin,
             m.ten_solref.to(dtype)[tids][None],
             m.ten_solimp.to(dtype)[tids][None],
             m.ten_invweight0.to(dtype)[tids][None], active, 2,
             margin=margin[None])

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
        elif elliptic:
            # one row per contact dimension: [normal, t1, t2, tors, r1, r2].
            # Friction-row regularization:
            #   R_i = R_normal * mu0^2 / (impratio * mu_i^2)
            # realized as diag_i = invw * mu0^2/(impratio mu_i^2) with the
            # friction rows sharing the normal row's efc_pos (hence its
            # impedance); the position term is removed from their aref below.
            axes = torch.stack(fric_axes[: mc - 1], dim=2)  # (B,K,mc-1,nv)
            mu = con.friction[..., : mc - 1]                # (B,K,mc-1)
            mu0 = con.friction[..., 0:1]
            impratio = m.opt.impratio.to(dtype)
            rows = torch.cat([Jn[:, :, None, :], axes], dim=2)
            diag_fric = (invw[..., None] * mu0 * mu0
                         / (impratio * torch.clamp(mu * mu, min=1e-12)))
            diag_rows = torch.cat([invw[..., None], diag_fric], dim=-1)
            row_act = con_active[..., None] & (
                plan["ell_row_idx"] < torch.clamp(con.dim, min=1)[..., None])
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
    if elliptic:
        # elliptic friction rows: velocity damping only, no position term
        # (they share the normal row's pos for impedance)
        aref = torch.where(plan["ell_fric_mask"], aref + k * imp * efc_pos,
                           aref)
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
