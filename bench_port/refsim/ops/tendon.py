"""Frozen copy of mujoco_sim_tpu_torch's CPU path for the benchmark's
plain reference (bench_port/refsim): imports rewritten, CUDA wrappers
and graph capture removed.  Do not import the program from here.

Tendon lengths and moment rows (mj_tendon equivalent).

Port of mujoco_sim_tpu/ops/tendon.py over an explicit leading env axis.

Fixed tendons are a STATIC linear form (length = W_q qpos, moment = W_v).
Spatial tendons are compiled into static LEG tables (models/compile.py):

- plain legs: straight site-to-site segments; length |pb - pa|, moment
  u . (Jp_b - Jp_a) over the sites' point jacobians.
- wrap legs: site -> sphere/cylinder wrap geom (optional sidesite) ->
  site.  The 2D tangent wrap is solved in closed form in the geom's
  local frame; the taut-string identity makes the moment the straight
  -segment formula with the tangent points attached to the wrap geom's
  body.  Sidesite semantics (mju_wrap): the wrap activates when the
  straight segment crosses the circle, or when a sidesite lies on the
  opposite side of the segment; a sidesite INSIDE the circle means
  wrap-inside (the tendon touches the geom at the single surface point
  minimizing path length, found by a fixed 48-pass ternary search unless
  the segment already crosses); endpoints inside the circle fall back to
  straight.
- pulleys divide subsequent leg lengths/moments by `divisor` and break
  the chain (no segment across a pulley).

Every branch is computed and selected with ``torch.where`` (no data-
dependent Python branch, no host sync).  The legs are summed into their
tendon rows with a static (ntendon, nleg) weight matrix (a fixed
summation order on every device, no atomics).
"""

from __future__ import annotations

import numpy as np
import torch

from refsim.models.model import Model
from refsim.ops.constraint import _point_jacobian

_EPS = 1e-12
WRAP_INSIDE_ITERS = 48


def _norm(v):
    return torch.sqrt((v * v).sum(-1) + _EPS)


def _tangent2d(P, r, s):
    """tangent point of the line from 2D point P (..., 2) to the circle of
    radius r (...), picking the candidate on the side of unit-ish vector
    s (..., 2)."""
    p2 = (P * P).sum(-1)
    safe = torch.clamp(p2, min=_EPS)
    base = (r * r / safe)[..., None] * P
    k = r * torch.sqrt(torch.clamp(p2 - r * r, min=0.0)) / safe
    perp = torch.stack([-P[..., 1], P[..., 0]], -1)
    sgn = torch.where((perp * s).sum(-1) >= 0.0, 1.0, -1.0).to(P.dtype)
    return base + (k * sgn)[..., None] * perp


def _wrap_inside_touch(A, B, c, r, iters=WRAP_INSIDE_ITERS):
    """2D point on the circle minimizing |A-P| + |P-B| (wrap-inside mode),
    by a fixed count of ternary-search passes bracketed around the
    segment's closest approach c."""
    aa = torch.atan2(A[..., 1], A[..., 0])
    ab = torch.atan2(B[..., 1], B[..., 0])
    ac = torch.atan2(c[..., 1], c[..., 0])

    def wrap_pi(x):
        return torch.atan2(torch.sin(x), torch.cos(x))

    ba = wrap_pi(aa - ac)
    bb = wrap_pi(ab - ac)
    lo = torch.clamp(torch.minimum(ba, bb), max=0.0)
    hi = torch.clamp(torch.maximum(ba, bb), min=0.0)

    def f(beta):
        P = r[..., None] * torch.stack([torch.cos(ac + beta),
                                        torch.sin(ac + beta)], -1)
        return _norm(A - P) + _norm(P - B)

    for _ in range(iters):
        m1 = lo + (hi - lo) / 3.0
        m2 = hi - (hi - lo) / 3.0
        smaller = f(m1) < f(m2)
        lo, hi = torch.where(smaller, lo, m1), torch.where(smaller, m2, hi)
    beta = 0.5 * (lo + hi)
    return r[..., None] * torch.stack([torch.cos(ac + beta),
                                       torch.sin(ac + beta)], -1)


def _leg_matrix(rows, w, ntendon):
    """Static (ntendon, nleg) matrix summing weighted legs into rows."""
    W = np.zeros((ntendon, len(rows)))
    W[rows, np.arange(len(rows))] = w
    return W


def _plan_np(m: Model) -> dict:
    lay = m.layout
    T = m.ntendon
    plan = dict(Wq=np.asarray(lay.ten_Wq, np.float64),
                Wv=np.asarray(lay.ten_Wv, np.float64))
    if len(lay.ten_leg_ten):
        sa = lay.ten_leg_sites[:, 0]
        sb = lay.ten_leg_sites[:, 1]
        plan["leg"] = dict(
            sa=sa.astype(np.int64), sb=sb.astype(np.int64),
            ba=lay.site_bodyid[sa].astype(np.int64),
            bb=lay.site_bodyid[sb].astype(np.int64),
            W=_leg_matrix(lay.ten_leg_ten, lay.ten_leg_w, T))
    if len(lay.ten_wleg_ten):
        sa = lay.ten_wleg_sites[:, 0]
        sb = lay.ten_wleg_sites[:, 1]
        ga = lay.ten_wleg_geom
        plan["wleg"] = dict(
            sa=sa.astype(np.int64), sb=sb.astype(np.int64),
            ga=ga.astype(np.int64),
            side=np.maximum(lay.ten_wleg_side, 0).astype(np.int64),
            has_side=np.asarray(lay.ten_wleg_side >= 0, bool),
            is_sph=np.asarray(lay.ten_wleg_sphere, bool),
            ba=lay.site_bodyid[sa].astype(np.int64),
            bb=lay.site_bodyid[sb].astype(np.int64),
            bg=lay.geom_bodyid[ga].astype(np.int64),
            W=_leg_matrix(lay.ten_wleg_ten, lay.ten_wleg_w, T))
    return plan


def tendon_quantities(m: Model, qpos: torch.Tensor, site_xpos: torch.Tensor,
                      cdof: torch.Tensor, origin_body: torch.Tensor,
                      geom_xpos=None, geom_xmat=None, geom_size=None):
    """(ten_length (B, ntendon), ten_J (B, ntendon, nv)).

    origin_body: (B, nbody, 3) c-frame origin per body
    (subtree_com[body_rootid]).  geom_* (B, ngeom, ...) are needed only
    when wrap legs exist."""
    dtype = qpos.dtype
    B = qpos.shape[0]
    plan = m.layout.const("tendon", lambda: _plan_np(m), dtype)
    length = qpos @ plan["Wq"].T
    J = plan["Wv"].expand(B, -1, -1)

    def jac(pts, bodies):
        return _point_jacobian(m, cdof, pts, bodies, origin_body[:, bodies])

    # ---------------- plain site-site legs ----------------
    if "leg" in plan:
        lp = plan["leg"]
        pa = site_xpos[:, lp["sa"]]
        pb = site_xpos[:, lp["sb"]]
        seg = pb - pa
        slen = _norm(seg)
        u = seg / slen[..., None]
        Jleg = (u[..., None] * (jac(pb, lp["bb"]) - jac(pa, lp["ba"]))
                ).sum(-2)                                  # (B, L, nv)
        length = length + slen @ lp["W"].T
        J = J + torch.einsum("tl,blv->btv", lp["W"], Jleg)

    # ---------------- wrap legs ----------------
    if "wleg" in plan:
        wp = plan["wleg"]
        is_sph = wp["is_sph"]
        has_side = wp["has_side"]
        pa = site_xpos[:, wp["sa"]]
        pb = site_xpos[:, wp["sb"]]
        gp = geom_xpos[:, wp["ga"]]
        gR = geom_xmat[:, wp["ga"]]
        r = geom_size[:, wp["ga"], 0]

        def loc(p):                                   # R^T (p - gp)
            return (gR * (p - gp)[..., :, None]).sum(-2)

        a3 = loc(pa)
        b3 = loc(pb)
        sd3 = loc(site_xpos[:, wp["side"]])

        # 2D reduction: cylinder uses local (x, y); sphere uses the plane
        # spanned by (a, b) through the center
        e1 = a3 / _norm(a3)[..., None]
        b_perp = b3 - (b3 * e1).sum(-1)[..., None] * e1
        e2 = b_perp / _norm(b_perp)[..., None]
        sphm = is_sph[:, None]
        A2 = torch.where(sphm,
                         torch.stack([_norm(a3), torch.zeros_like(r)], -1),
                         a3[..., :2])
        B2 = torch.where(sphm,
                         torch.stack([(b3 * e1).sum(-1),
                                      (b3 * e2).sum(-1)], -1),
                         b3[..., :2])
        sd2 = torch.where(sphm,
                          torch.stack([(sd3 * e1).sum(-1),
                                       (sd3 * e2).sum(-1)], -1),
                          sd3[..., :2])

        sqa = (A2 * A2).sum(-1)
        sqb = (B2 * B2).sum(-1)
        outside = (sqa > r * r) & (sqb > r * r)
        d2 = B2 - A2
        dd = torch.clamp((d2 * d2).sum(-1), min=_EPS)
        tpar = torch.clamp(-(A2 * d2).sum(-1) / dd, 0.0, 1.0)
        c2v = A2 + tpar[..., None] * d2                # closest pt to center
        c2 = (c2v * c2v).sum(-1)
        sdin = has_side & ((sd2 * sd2).sum(-1) < r * r)
        crosses = c2 < r * r
        opposite = has_side & ((c2v * sd2).sum(-1) < 0.0)
        active_out = outside & ~sdin & (crosses | opposite)
        active_in = outside & sdin & ~crosses
        wrap_on = active_out | active_in

        s2 = torch.where(has_side[:, None], sd2, c2v)
        t0 = _tangent2d(A2, r, s2)
        t1 = _tangent2d(B2, r, s2)
        cosang = torch.clamp((t0 * t1).sum(-1) / torch.clamp(r * r,
                                                             min=_EPS),
                             -1.0, 1.0)
        arc = r * torch.arccos(cosang)
        P2 = _wrap_inside_touch(A2, B2, c2v, r)
        x0_2 = torch.where(active_out[..., None], t0, P2)
        x1_2 = torch.where(active_out[..., None], t1, P2)
        arc = torch.where(active_out, arc, 0.0)

        # back to 3D local: sphere lifts through the plane basis;
        # cylinder interpolates z along the 2D path length (the mju_wrap
        # convention), helix arc = hypot(arc2d, dz)
        la = _norm(A2 - x0_2)
        lb = _norm(B2 - x1_2)
        tot2 = torch.clamp(la + arc + lb, min=_EPS)
        za = a3[..., 2]
        zb = b3[..., 2]
        z0 = za + (zb - za) * la / tot2
        z1 = za + (zb - za) * (la + arc) / tot2
        X0_loc = torch.where(
            sphm,
            x0_2[..., 0:1] * e1 + x0_2[..., 1:2] * e2,
            torch.cat([x0_2, z0[..., None]], -1))
        X1_loc = torch.where(
            sphm,
            x1_2[..., 0:1] * e1 + x1_2[..., 1:2] * e2,
            torch.cat([x1_2, z1[..., None]], -1))
        wlen = torch.where(is_sph, arc,
                           torch.sqrt(arc * arc + (z1 - z0) ** 2 + _EPS))
        wlen = torch.where(active_out, wlen, 0.0)
        X0 = gp + (gR * X0_loc[..., None, :]).sum(-1)  # gR @ X_loc, world
        X1 = gp + (gR * X1_loc[..., None, :]).sum(-1)

        # lengths
        l_wrap = _norm(pa - X0) + wlen + _norm(X1 - pb)
        l_straight = _norm(pb - pa)
        l_leg = torch.where(wrap_on, l_wrap, l_straight)

        # moments: straight-segment formula; tangent points ride the
        # wrap geom's body (taut-string identity)
        u0 = (X0 - pa) / _norm(X0 - pa)[..., None]
        u1 = (pb - X1) / _norm(pb - X1)[..., None]
        us = (pb - pa) / l_straight[..., None]
        Ja = jac(pa, wp["ba"])
        Jb = jac(pb, wp["bb"])
        J0 = jac(X0, wp["bg"])
        J1 = jac(X1, wp["bg"])
        J_wrap = ((u0[..., None] * (J0 - Ja)).sum(-2)
                  + (u1[..., None] * (Jb - J1)).sum(-2))
        J_str = (us[..., None] * (Jb - Ja)).sum(-2)
        J_leg = torch.where(wrap_on[..., None], J_wrap, J_str)

        length = length + l_leg @ wp["W"].T
        J = J + torch.einsum("tl,blv->btv", wp["W"], J_leg)
    return length, J
