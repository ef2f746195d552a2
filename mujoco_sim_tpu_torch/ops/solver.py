"""Constraint solver: projected Newton on the primal soft-constraint problem.

Port of mujoco_sim_tpu/ops/solver.py.  Solves

  min_a  0.5 (a - a_smooth)' M (a - a_smooth) + sum_i c_i(J_i a - aref_i)

with per-row costs matching MuJoCo's convex formulation:
  equality rows     : 0.5 D x^2                  (two-sided)
  friction-loss rows: Huber(x; R*floss)          (linear tails +- floss)
  limit/contact rows: 0.5 D x^2 for x < 0 else 0 (one-sided, pyramidal)
  elliptic contacts : zone cost on the whole contact block (below)

Elliptic cones: with whitened friction coords
v_i = x_i * sqrt(impratio) * mu_i / mu0, T = |v|, and solver coefficient
mu_v = mu0/sqrt(impratio):
  top zone    N >= mu_v T         : cost 0
  bottom zone T <= -mu_v N        : cost 0.5 D0 (N^2 + T^2)
  middle zone                     : cost 0.5 D0 (mu_v T - N)^2 / (1+mu_v^2)

Batched loops.  The JAX solver is written per env; under vmap its
``lax.while_loop``s run the body for every env while ANY env's predicate
holds and keep the carry of finished envs unchanged.  Here the Newton
loop, the pyramidal line search and the elliptic bracket search go through
ops/loops.while_loop, which has exactly those semantics over the env axis
(``carry = where(active, new, old)``, ``active = cond(carry)``), so every
env's result equals its unbatched result.  Eagerly each iteration's exit
test is one host sync; inside a captured step (utils/graph.StepGraph) each
loop is a conditional WHILE node whose predicate is reduced on the card,
the line search's node nested in the Newton node's body, and the step
syncs nowhere.  The elliptic line search's bracket expansion has a fixed
cap of 8 doublings and runs all 8 masked, as straight-line code.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_sim_tpu_torch.models.model import (Model, Data, DisableBit,
                                                ConeType, contact_rows_per)
from mujoco_sim_tpu_torch.ops import chol, loops


def _is_elliptic(m: Model) -> bool:
    return (m.opt.cone == int(ConeType.ELLIPTIC) and m.ncon_max > 0
            and m.max_condim > 1)


def _cone_plan_np(m: Model) -> dict:
    rp = contact_rows_per(m.max_condim, m.opt.cone)
    crows = (m.contact_efcadr
             + np.arange(m.ncon_max)[:, None] * rp
             + np.arange(rp)[None, :])
    noncone = np.ones(m.nefc_max, dtype=bool)
    noncone[crows.reshape(-1)] = False
    return dict(crows=crows.astype(np.int64), noncone=noncone,
                crows_flat=crows.reshape(-1).astype(np.int64),
                fric_idx=np.arange(1, rp))


def _cone_plan(m: Model, dtype) -> dict:
    """Static elliptic-contact row layout as device tensors: crows (K, rp)
    index gather, its flat form, and the non-cone row mask (made once per
    layout)."""
    key = ("cone", m.opt.cone, m.ncon_max, m.max_condim, m.contact_efcadr,
           m.nefc_max)
    return m.layout.const(key, lambda: _cone_plan_np(m), dtype)


def _row_force_and_curv(d: Data, x: torch.Tensor, D: torch.Tensor):
    """c'(x) and c''(x) per row given jar x (vectorized, masked)."""
    floss = d.efc_frictionloss
    is_floss = d.efc_floss_active
    one_sided = (d.efc_type >= 2)
    quad = D * x
    # one-sided: zero cost for x >= 0
    zero_side = one_sided & (x >= 0)
    f = torch.where(zero_side, 0.0, quad)
    curv = torch.where(zero_side, 0.0, D)
    # friction loss: clamp to +-floss (linear tails)
    f = torch.where(is_floss, torch.minimum(torch.maximum(quad, -floss),
                                            floss), f)
    curv = torch.where(is_floss & (quad.abs() >= floss), 0.0, curv)
    return f, curv


def _row_cost(d: Data, x: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    floss = d.efc_frictionloss
    is_floss = d.efc_floss_active
    one_sided = (d.efc_type >= 2)
    quad = 0.5 * D * x * x
    c = torch.where(one_sided & (x >= 0), 0.0, quad)
    lin = floss * x.abs() - 0.5 * torch.where(
        D > 0, floss * floss / torch.clamp(D, min=1e-12), 0.0)
    c = torch.where(is_floss & ((D * x).abs() >= floss), lin, c)
    return c


class _EllipticCone:
    """Zone cost/gradient/Hessian for the elliptic contact blocks.

    Vectorized over envs and the K contact slots; inactive contacts have
    D0 = 0 so they contribute nothing; frictionless contacts (dim==1)
    reduce to the one-sided quadratic on the normal row.
    """

    def __init__(self, m: Model, d: Data, plan: dict):
        dtype = d.qpos.dtype
        con = d.contact
        crows = plan["crows"]
        rp = crows.shape[1]
        self.rp = rp
        fr = con.friction[..., : rp - 1]                  # (B, K, rp-1)
        mu0 = torch.clamp(con.friction[..., 0], min=1e-12)
        impratio = m.opt.impratio.to(dtype)
        dim_ok = plan["fric_idx"] < con.dim[..., None]
        self.s = torch.where(dim_ok,
                             torch.sqrt(impratio) * fr / mu0[..., None], 0.0)
        self.muv = mu0 / torch.sqrt(impratio)
        self.frictionless = con.dim == 1
        self.D0 = d.efc_D[:, crows[:, 0]]                 # 0 when inactive

    def terms(self, x_c, need_hess=True):
        """x_c (B, K, rp) -> (cost (B, K), grad (B, K, rp),
        hess (B, K, rp, rp) or None)."""
        rp = self.rp
        N = x_c[..., 0]
        v = x_c[..., 1:] * self.s                         # whitened coords
        T2 = (v * v).sum(-1)
        T = torch.sqrt(torch.clamp(T2, min=1e-24))
        muv, D0 = self.muv, self.D0
        top = N >= muv * T
        bottom = T <= -muv * N
        mid = ~top & ~bottom
        Dm = D0 / (1.0 + muv * muv)
        r = muv * T - N

        s2 = self.s * self.s
        s2x = x_c[..., 1:] * self.s * self.s              # s_i^2 x_i
        # gradients per zone
        g_bot = torch.cat([(D0 * N)[..., None], D0[..., None] * s2x], dim=-1)
        gr = torch.cat([-torch.ones_like(N)[..., None],
                        muv[..., None] * s2x / T[..., None]], dim=-1)
        g_mid = (Dm * r)[..., None] * gr
        zero = torch.zeros_like(x_c)
        grad = torch.where(mid[..., None], g_mid,
                           torch.where(bottom[..., None], g_bot, zero))
        neg = N < 0
        g_fl = torch.cat([torch.where(neg, D0 * N, 0.0)[..., None],
                          torch.zeros_like(s2x)], dim=-1)
        grad = torch.where(self.frictionless[..., None], g_fl, grad)

        # cost per zone
        c_mid = 0.5 * Dm * r * r
        c_bot = 0.5 * D0 * (N * N + T2)
        cost = torch.where(mid, c_mid, torch.where(bottom, c_bot, 0.0))
        cost = torch.where(self.frictionless,
                           torch.where(neg, 0.5 * D0 * N * N, 0.0), cost)
        if not need_hess:
            return cost, grad, None

        # Hessians: bottom diag(D_i) with D_i = D0 s_i^2; middle = cone
        eyep = torch.eye(rp, dtype=x_c.dtype, device=x_c.device)
        D_bot = torch.cat([D0[..., None], D0[..., None] * s2], dim=-1)
        H_bot = eyep * D_bot[..., None]
        eyef = torch.eye(rp - 1, dtype=x_c.dtype, device=x_c.device)
        d2r_f = (muv[..., None, None]
                 * (eyef * s2[..., None, :] / T[..., None, None]
                    - s2x[..., :, None] * s2x[..., None, :]
                    / (T ** 3)[..., None, None]))
        # d2r is zero in the normal row and column
        d2r = torch.nn.functional.pad(d2r_f, (1, 0, 1, 0))
        H_mid = Dm[..., None, None] * (
            gr[..., :, None] * gr[..., None, :] + r[..., None, None] * d2r)
        H = torch.where(mid[..., None, None], H_mid,
                        torch.where(bottom[..., None, None], H_bot, 0.0))
        H_fl = eyep * torch.cat(
            [torch.where(neg, D0, 0.0)[..., None],
             torch.zeros_like(self.s)], dim=-1)[..., None]
        H = torch.where(self.frictionless[..., None, None], H_fl, H)
        return cost, grad, H


def _mv(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per-env matrix-vector product (B, n, k) x (B, k) -> (B, n)."""
    return (A @ v[..., None])[..., 0]


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-env dot product over the trailing axis -> (B,)."""
    return (a * b).sum(-1)


def solve(m: Model, d: Data) -> Data:
    dtype = d.qpos.dtype
    M = d.qM
    a_smooth = d.qacc_smooth
    J = d.efc_J
    JT = J.transpose(-1, -2)
    aref = d.efc_aref
    nv = M.shape[-1]
    eye = torch.eye(nv, dtype=dtype, device=M.device)

    elliptic = _is_elliptic(m)
    if elliptic:
        cplan = _cone_plan(m, dtype)
        crows = cplan["crows"]
        D = torch.where(cplan["noncone"], d.efc_D, 0.0)
        cone = _EllipticCone(m, d, cplan)
    else:
        D = d.efc_D

    warm = not (m.opt.disableflags & int(DisableBit.WARMSTART))
    a0 = d.qacc_warmstart if warm else a_smooth
    # guard: warmstart of wrong scale falls back to smooth (per env)
    a0 = torch.where(torch.isnan(a0).any(-1, keepdim=True), a_smooth, a0)

    # jar x = J a - aref is CARRIED through the Newton loop and updated as
    # x += alpha * Jp (exact: J(a + alpha p) - aref = x + alpha Jp), so the
    # cost evaluations are (nefc,) elementwise and never re-form J @ a.
    def rowcost_sum(x):
        c = _row_cost(d, x, D).sum(-1)
        if elliptic:
            cc, _, _ = cone.terms(x[:, crows], need_hess=False)
            c = c + cc.sum(-1)
        return c

    def grad_hess(a, x):
        f, curv = _row_force_and_curv(d, x, D)
        Mda = _mv(M, a - a_smooth)
        grad = Mda + _mv(JT, f)
        H = M + torch.einsum("ziv,zi,ziw->zvw", J, curv, J)
        if elliptic:
            Jc = J[:, crows]                # (B, K, rp, nv) static row gather
            _, gc, Hc = cone.terms(x[:, crows])
            grad = grad + torch.einsum("zkrv,zkr->zv", Jc, gc)
            H = H + torch.einsum("zkrv,zkrs,zksw->zvw", Jc, Hc, Jc)
        return grad, H, Mda

    def line_search(a, p, x0, Mda, live):
        """(alpha, Jp, cost(alpha), cost(0.5)) per env; the candidate costs
        are evaluated on x0 + alpha*Jp and the scalar M-quadratic
        (cost_M(alpha) = c0M + alpha p'Mda + 0.5 alpha^2 p'Mp)."""
        Jp = _mv(J, p)
        Mp = _mv(M, p)
        pMp = _dot(p, Mp)
        pM_da = _dot(p, Mda)
        c0M = 0.5 * _dot(a - a_smooth, Mda)

        def phi_cost(alpha):
            return (c0M + alpha * pM_da + 0.5 * alpha * alpha * pMp
                    + rowcost_sum(x0 + alpha[:, None] * Jp))

        if elliptic:
            Jpc = Jp[:, crows]              # (B, K, rp)
            x0c = x0[:, crows]

        def phi_d(alpha, need_d2=True):
            """Slope and (unless need_d2 is off) curvature of phi at alpha;
            the bracket expansion reads the slope alone and skips the cone
            Hessians."""
            x = x0 + alpha[:, None] * Jp
            f, curv = _row_force_and_curv(d, x, D)
            d1 = pM_da + alpha * pMp + _dot(f, Jp)
            d2 = pMp + _dot(curv, Jp * Jp) if need_d2 else None
            if elliptic:
                xc = x0c + alpha[:, None, None] * Jpc
                _, gc, Hc = cone.terms(xc, need_hess=need_d2)
                d1 = d1 + (gc * Jpc).sum((-1, -2))
                if need_d2:
                    d2 = d2 + torch.einsum("zkr,zkrs,zks->z", Jpc, Hc, Jpc)
            return d1, d2

        d1_0, _ = phi_d(torch.zeros_like(pMp), need_d2=False)
        # stop when the slope has dropped to ls_tolerance of its initial
        # magnitude (the analogue of MuJoCo's ls_tolerance)
        gtol = m.opt.ls_tolerance * torch.clamp(d1_0.abs(), min=1e-8)
        curv_floor = 1e-8 * torch.clamp(pMp, min=1e-12)

        def c1(it, d1):
            return ((it < m.opt.ls_iterations) & (d1.abs() > gtol)
                    & torch.isfinite(d1))

        if elliptic:
            alpha, c_a, c_h = _bracket_search(phi_d, phi_cost, c1, pMp,
                                              curv_floor, live)
            return alpha, Jp, c_a, c_h

        # pyramidal: plain 1D Newton on phi' — a batched while loop
        # (envs outside `live` only ever produce discarded results)
        def ls_cond(c):
            _, it, d1 = c
            return c1(it, d1) & live

        def ls_body(c):
            alpha, it, d1 = c
            d1n, d2n = phi_d(alpha)
            step = d1n / torch.maximum(d2n, curv_floor)
            return torch.clamp(alpha - step, 0.0, 8.0), it + 1, d1n

        alpha, _, _ = loops.while_loop(ls_cond, ls_body, (
            torch.ones_like(pMp),
            torch.zeros(pMp.shape, dtype=torch.int32, device=pMp.device),
            torch.full_like(pMp, 1e30)), name="linesearch")
        alpha = torch.where(torch.isfinite(alpha), alpha, 0.0)
        alpha = torch.clamp(alpha, 0.0, 8.0)
        return alpha, Jp, phi_cost(alpha), phi_cost(torch.full_like(pMp, 0.5))

    def newton_body(a, x, prev_cost, live):
        grad, H, Mda = grad_hess(a, x)
        # small relative ridge keeps H SPD under f32 rounding
        ridge = 1e-7 * torch.diagonal(H, dim1=-2, dim2=-1).sum(-1) / nv
        H = H + ridge[:, None, None] * eye
        # fused factor+solve: the hand-written kernel on the card
        p = -chol.chol_solve(H, grad)
        p = torch.where(torch.isfinite(p), p, 0.0)
        alpha, Jp, new_cost, half_cost = line_search(a, p, x, Mda, live)
        # never accept an ascent step: fall back to a halved plain step,
        # else reject and stop.  alpha_eff keeps the carried jar x
        # consistent with the accepted a on every branch.
        use_half = (new_cost > prev_cost) & (half_cost < prev_cost)
        alpha_eff = torch.where(use_half, 0.5, alpha)
        new_cost = torch.where(use_half, half_cost, new_cost)
        worse = new_cost > prev_cost
        alpha_eff = torch.where(worse, 0.0, alpha_eff)
        new_cost = torch.where(worse, prev_cost, new_cost)
        a_new = a + alpha_eff[:, None] * p
        x_new = x + alpha_eff[:, None] * Jp
        improved = prev_cost - new_cost
        done = improved < m.opt.tolerance * torch.clamp(new_cost.abs(),
                                                        min=1.0)
        return a_new, x_new, new_cost, done

    # best-of-two init like the reference solver: warmstart vs smooth
    x_warm = _mv(J, a0) - aref
    x_smooth = _mv(J, a_smooth) - aref
    da_w = a0 - a_smooth
    c_warm = 0.5 * _dot(da_w, _mv(M, da_w)) + rowcost_sum(x_warm)
    c_smooth = rowcost_sum(x_smooth)
    take_warm = c_warm <= c_smooth
    a = torch.where(take_warm[:, None], a0, a_smooth)
    x = torch.where(take_warm[:, None], x_warm, x_smooth)
    cost = torch.where(take_warm, c_warm, c_smooth)

    # Newton iterations: a batched while loop over the env axis
    def newton_cond(c):
        *_, done, it = c
        return (it < m.opt.solver_iterations) & ~done

    def newton_step(c):
        a, x, cost, _, it = c
        return (*newton_body(a, x, cost, newton_cond(c)), it + 1)

    a, x, cost, _, _ = loops.while_loop(newton_cond, newton_step, (
        a, x, cost,
        torch.zeros(cost.shape, dtype=torch.bool, device=cost.device),
        torch.zeros(cost.shape, dtype=torch.int32, device=cost.device)),
        name="newton")

    efc_force, qfrc_constraint = constraint_force_from_qacc(m, d, a, jar=x)
    return d.replace(qacc=a, qfrc_constraint=qfrc_constraint,
                     efc_force=efc_force)


def _bracket_search(phi_d, phi_cost, c1, pMp, curv_floor, live):
    """Elliptic line search: phi is convex but has cone-zone kinks where
    pure 1D Newton oscillates; phi' is nondecreasing, so bracket its root
    then run safeguarded Newton-bisection.  Returns (alpha, cost(alpha),
    cost(0.5)) per env."""
    # expand: double hi while phi'(hi) < 0, at most 8 times.  The cap is
    # fixed, so all 8 doublings run masked with no host sync.
    lo = torch.zeros_like(pMp)
    hi = torch.ones_like(pMp)
    d1hi, _ = phi_d(hi, need_d2=False)
    for _ in range(8):
        grow = d1hi < 0
        hi2 = hi * 2.0
        d1n, _ = phi_d(hi2, need_d2=False)
        lo = torch.where(grow, hi, lo)
        hi = torch.where(grow, hi2, hi)
        d1hi = torch.where(grow, d1n, d1hi)
    # if phi' never turned positive, take the largest bracketed alpha
    alpha = torch.where(d1hi < 0, hi, 0.5 * (lo + hi))

    def cond(c):
        *_, d1, it = c
        return c1(it, d1) & live

    def body(c):
        lo, hi, alpha, _, it = c
        d1n, d2n = phi_d(alpha)
        lo_n = torch.where(d1n < 0, alpha, lo)
        hi_n = torch.where(d1n < 0, hi, alpha)
        newton = alpha - d1n / torch.maximum(d2n, curv_floor)
        inside = (newton > lo_n) & (newton < hi_n) & torch.isfinite(newton)
        alpha_n = torch.where(inside, newton, 0.5 * (lo_n + hi_n))
        return lo_n, hi_n, alpha_n, d1n, it + 1

    _, _, alpha, _, _ = loops.while_loop(cond, body, (
        lo, hi, alpha, torch.full_like(pMp, 1e30),
        torch.zeros(pMp.shape, dtype=torch.int32, device=pMp.device)),
        name="bracket")
    alpha = torch.where(torch.isfinite(alpha), alpha, 0.0)
    alpha = torch.clamp(alpha, 0.0, 256.0)
    return alpha, phi_cost(alpha), phi_cost(torch.full_like(pMp, 0.5))


def constraint_force_from_qacc(m: Model, d: Data, qacc: torch.Tensor,
                               jar: torch.Tensor | None = None):
    """Constraint force for a GIVEN qacc (B, nv) — the inverse constraint
    solver (mj_invConstraint): jar = J qacc - aref, force = -dcost/djar per
    row.  ``jar`` may be passed by the forward solver, which carries it."""
    J = d.efc_J
    elliptic = _is_elliptic(m)
    if elliptic:
        cplan = _cone_plan(m, d.qpos.dtype)
        D = torch.where(cplan["noncone"], d.efc_D, 0.0)
    else:
        D = d.efc_D
    x = (_mv(J, qacc) - d.efc_aref) if jar is None else jar
    f, _ = _row_force_and_curv(d, x, D)
    efc_force = -f
    if elliptic:
        cone = _EllipticCone(m, d, cplan)
        _, gc, _ = cone.terms(x[:, cplan["crows"]], need_hess=False)
        efc_force = efc_force.index_copy(
            1, cplan["crows_flat"], -gc.reshape(gc.shape[0], -1))
    qfrc_constraint = _mv(J.transpose(-1, -2), efc_force)
    return efc_force, qfrc_constraint
