"""Noslip post-solver: sequential friction-force polish after the main solve.

Port of mujoco_sim_tpu/ops/noslip.py over an explicit leading env axis.
MuJoCo's noslip pass (option noslip_iterations/noslip_tolerance) reruns a
modified Gauss-Seidel over the FRICTION rows only, pretending those rows
have no softness: normal forces stay fixed, friction forces are adjusted to
null the slip velocity, subject to their box/cone bounds.  This suppresses
the slow drift the regularized solver leaves.

Formulation: for each contact friction axis of a pyramidal cone the pair
(f+, f-) moves by (+delta, -delta) (a pure tangential change that keeps the
normal component fixed); for an elliptic cone the friction row moves inside
the per-axis box |f_a| <= mu_a f_normal; dof-friction-loss rows do the 1D
update clamped to [-floss, +floss].  delta zeroes the row's acceleration
residual and is clipped to its bounds.  Updates run in efc-row order,
sequentially (Gauss-Seidel, the order is the semantics), for
noslip_iterations sweeps.

The row loop is a Python loop over rows on (B,) tensors with no host sync.
A row's bounds depend only on its own forces at the start of the sweep, so
they are computed for all rows at once before the sweep; the serial part
of a row is its residual against the running qacc, the clipped delta and
the qacc update.

It needs the factor of the mass matrix itself (qLD, ops/chol_factor.py)
for the matrix right-hand side B = M^-1 Jd^T; that solve is two
triangular solves (torch.linalg.solve_triangular: LAPACK's trsm on the
CPU, bit for bit what torch.cholesky_solve computes there; cuBLAS's
batched trsm on the card, which a CUDA graph captures, where
torch.cholesky_solve goes through MAGMA, which cannot be captured).
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_sim_tpu_torch.models.model import (Model, Data, ConeType,
                                                contact_rows_per)


def _plan(m: Model):
    """Static update list: friction-loss rows then contact friction rows."""
    lay = m.layout
    rows_p, rows_m, kinds, con_k, con_a = [], [], [], [], []
    for adr in lay.fri_efcadr:
        rows_p.append(int(adr))
        rows_m.append(int(adr))   # unused for floss rows
        kinds.append(0)
        con_k.append(0)
        con_a.append(0)
    mc = m.max_condim
    nrows_per = contact_rows_per(mc, m.opt.cone)
    elliptic = m.opt.cone == int(ConeType.ELLIPTIC)
    if mc > 1:
        for k in range(m.ncon_max):
            base = m.contact_efcadr + k * nrows_per
            for a in range(mc - 1):
                if elliptic:
                    # friction row a (1D update bounded by the per-axis
                    # cone box |f_a| <= mu_a * f_normal, normal force fixed)
                    rows_p.append(base + 1 + a)
                    rows_m.append(base)          # the contact's normal row
                    kinds.append(2)
                else:
                    rows_p.append(base + 2 * a)
                    rows_m.append(base + 2 * a + 1)
                    kinds.append(1)
                con_k.append(k)
                con_a.append(a)
    kinds = np.asarray(kinds, dtype=np.int64)
    pair_sel = np.nonzero(kinds == 1)[0]
    rows_m = np.asarray(rows_m, dtype=np.int64)
    return dict(rows_p=np.asarray(rows_p, dtype=np.int64), rows_m=rows_m,
                is_pair=kinds == 1, is_ell=kinds == 2,
                con_k=np.asarray(con_k, dtype=np.int64),
                con_a=np.asarray(con_a, dtype=np.int64),
                pair_sel=pair_sel, pair_rows_m=rows_m[pair_sel])


def noslip(m: Model, d: Data) -> Data:
    """Apply the noslip sweeps; returns d with qacc/efc_force/qfrc_constraint
    updated.  No-op when the model has no friction rows."""
    dtype = d.qpos.dtype
    key = ("noslip", m.opt.cone, m.contact_efcadr, m.ncon_max, m.max_condim)
    pl = m.layout.const(key, lambda: _plan(m), dtype)
    rows_p, rows_m = pl["rows_p"], pl["rows_m"]
    nupd = len(rows_p)
    if nupd == 0:
        return d
    J = d.efc_J
    aref = d.efc_aref
    is_pair, is_ell = pl["is_pair"], pl["is_ell"]
    # B = M^-1 J^T for the updated rows only (static gather of rows)
    Jp = J[:, rows_p]                                   # (B, nupd, nv)
    Jm = J[:, rows_m]
    Jd = torch.where(is_pair[:, None], Jp - Jm, Jp)     # update direction
    Y = torch.linalg.solve_triangular(d.qLD, Jd.transpose(-1, -2),
                                      upper=False)
    Bd = torch.linalg.solve_triangular(d.qLD.mT, Y, upper=True)  # (B,nv,nupd)
    BdT = Bd.transpose(-1, -2).contiguous()             # (B, nupd, nv)
    Add = (Jd * BdT).sum(-1)                            # row curvatures
    denom = torch.clamp(Add, min=1e-12)
    arefd = torch.where(is_pair, aref[:, rows_p] - aref[:, rows_m],
                        aref[:, rows_p])
    act = d.efc_active[:, rows_p]
    floss = d.efc_frictionloss[:, rows_p]
    # per-axis friction coefficient for elliptic updates (static gather)
    mu_upd = d.contact.friction[:, pl["con_k"], pl["con_a"]]

    fp = d.efc_force[:, rows_p]
    fm = d.efc_force[:, rows_m]
    qacc = d.qacc

    for _ in range(m.opt.noslip_iterations):
        # bounds: floss box / pyramid pair nonnegativity / elliptic
        # per-axis cone box (|f_a| <= mu_a f_n, normal f_n = fm fixed);
        # inactive rows move by nothing
        lo = torch.where(is_pair, -fp,
                         torch.where(is_ell, -mu_upd * fm - fp, -floss - fp))
        hi = torch.where(is_pair, fm,
                         torch.where(is_ell, mu_upd * fm - fp, floss - fp))
        deltas = []
        for i in range(nupd):
            res = (Jd[:, i] * qacc).sum(-1) - arefd[:, i]
            delta = -res / denom[:, i]
            # clip(delta, lo, hi) with hi winning, as jnp.clip
            delta = torch.minimum(torch.maximum(delta, lo[:, i]), hi[:, i])
            delta = torch.where(act[:, i], delta, 0.0)
            qacc = qacc + BdT[:, i] * delta[:, None]
            deltas.append(delta)
        delta = torch.stack(deltas, dim=-1)
        fp = fp + delta
        fm = torch.where(is_pair, fm - delta, fm)

    efc_force = d.efc_force.index_copy(1, rows_p, fp)
    if len(pl["pair_sel"]):
        efc_force = efc_force.index_copy(1, pl["pair_rows_m"],
                                         fm[:, pl["pair_sel"]])
    qfrc_constraint = (J.transpose(-1, -2) @ efc_force[..., None])[..., 0]
    return d.replace(qacc=qacc, efc_force=efc_force,
                     qfrc_constraint=qfrc_constraint)
