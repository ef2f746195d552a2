"""Constraint solver: projected Newton on the primal soft-constraint problem.

Port of the pyramidal path of mujoco_sim_tpu/ops/solver.py.  Solves

  min_a  0.5 (a - a_smooth)' M (a - a_smooth) + sum_i c_i(J_i a - aref_i)

with per-row costs matching MuJoCo's convex formulation:
  equality rows     : 0.5 D x^2                  (two-sided)
  friction-loss rows: Huber(x; R*floss)          (linear tails +- floss)
  limit/contact rows: 0.5 D x^2 for x < 0 else 0 (one-sided, pyramidal)

The elliptic cone is ROADMAP §A.7 and raises.

Batched loops.  The JAX solver is written per env; under vmap its
``lax.while_loop``s run the body for every env while ANY env's predicate
holds and keep the carry of finished envs unchanged.  Here each loop runs
masked iterations over the env axis: ``carry = where(active, new, old)``,
then ``active &= cond(carry)``, until no env is active — so every env's
result equals its unbatched result.  Finished envs may compute garbage
(even NaN) in the discarded branch; ``torch.where`` selects and never
multiplies by a mask.  The ``.any()`` test is one host sync per Newton and
per line-search iteration; that is accepted for now (CUDA-graph capture of
the step is later work, ROADMAP).
"""

from __future__ import annotations

import torch

from mujoco_sim_tpu_torch.models.model import (Model, Data, DisableBit,
                                                ConeType)
from mujoco_sim_tpu_torch.ops import chol


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


def _mv(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per-env matrix-vector product (B, n, k) x (B, k) -> (B, n)."""
    return (A @ v[..., None])[..., 0]


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-env dot product over the trailing axis -> (B,)."""
    return (a * b).sum(-1)


def _check_pyramidal(m: Model):
    if m.opt.cone == int(ConeType.ELLIPTIC) and m.ncon_max > 0 \
            and m.max_condim > 1:
        raise NotImplementedError(
            "the elliptic friction cone is not ported yet (ROADMAP §A.7)")


def solve(m: Model, d: Data) -> Data:
    _check_pyramidal(m)
    dtype = d.qpos.dtype
    M = d.qM
    a_smooth = d.qacc_smooth
    J = d.efc_J
    JT = J.transpose(-1, -2)
    aref = d.efc_aref
    D = d.efc_D
    nv = M.shape[-1]
    eye = torch.eye(nv, dtype=dtype, device=M.device)

    warm = not (m.opt.disableflags & int(DisableBit.WARMSTART))
    a0 = d.qacc_warmstart if warm else a_smooth
    # guard: warmstart of wrong scale falls back to smooth (per env)
    a0 = torch.where(torch.isnan(a0).any(-1, keepdim=True), a_smooth, a0)

    # jar x = J a - aref is CARRIED through the Newton loop and updated as
    # x += alpha * Jp (exact: J(a + alpha p) - aref = x + alpha Jp), so the
    # cost evaluations are (nefc,) elementwise and never re-form J @ a.
    def rowcost_sum(x):
        return _row_cost(d, x, D).sum(-1)

    def grad_hess(a, x):
        f, curv = _row_force_and_curv(d, x, D)
        Mda = _mv(M, a - a_smooth)
        grad = Mda + _mv(JT, f)
        H = M + torch.einsum("ziv,zi,ziw->zvw", J, curv, J)
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

        def phi_d(alpha):
            x = x0 + alpha[:, None] * Jp
            f, curv = _row_force_and_curv(d, x, D)
            d1 = pM_da + alpha * pMp + _dot(f, Jp)
            d2 = pMp + _dot(curv, Jp * Jp)
            return d1, d2

        d1_0, _ = phi_d(torch.zeros_like(pMp))
        # stop when the slope has dropped to ls_tolerance of its initial
        # magnitude (the analogue of MuJoCo's ls_tolerance)
        gtol = m.opt.ls_tolerance * torch.clamp(d1_0.abs(), min=1e-8)
        curv_floor = 1e-8 * torch.clamp(pMp, min=1e-12)

        def c1(it, d1):
            return ((it < m.opt.ls_iterations) & (d1.abs() > gtol)
                    & torch.isfinite(d1))

        # pyramidal: plain 1D Newton on phi' — a masked batched while loop
        # (envs outside `live` only ever produce discarded results)
        alpha = torch.ones_like(pMp)
        it = torch.zeros(pMp.shape, dtype=torch.int32, device=pMp.device)
        d1 = torch.full_like(pMp, 1e30)
        active = c1(it, d1) & live
        while bool(active.any()):
            d1n, d2n = phi_d(alpha)
            step = d1n / torch.maximum(d2n, curv_floor)
            alpha = torch.where(active, torch.clamp(alpha - step, 0.0, 8.0),
                                alpha)
            it = torch.where(active, it + 1, it)
            d1 = torch.where(active, d1n, d1)
            active = active & c1(it, d1)
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

    # Newton iterations: a masked batched while loop over the env axis
    it = torch.zeros(cost.shape, dtype=torch.int32, device=cost.device)
    done = torch.zeros(cost.shape, dtype=torch.bool, device=cost.device)
    active = (it < m.opt.solver_iterations) & ~done
    while bool(active.any()):
        a_n, x_n, cost_n, done_n = newton_body(a, x, cost, active)
        a = torch.where(active[:, None], a_n, a)
        x = torch.where(active[:, None], x_n, x)
        cost = torch.where(active, cost_n, cost)
        done = torch.where(active, done_n, done)
        it = torch.where(active, it + 1, it)
        active = active & (it < m.opt.solver_iterations) & ~done

    efc_force, qfrc_constraint = constraint_force_from_qacc(m, d, a, jar=x)
    return d.replace(qacc=a, qfrc_constraint=qfrc_constraint,
                     efc_force=efc_force)


def constraint_force_from_qacc(m: Model, d: Data, qacc: torch.Tensor,
                               jar: torch.Tensor | None = None):
    """Constraint force for a GIVEN qacc (B, nv) — the inverse constraint
    solver (mj_invConstraint): jar = J qacc - aref, force = -dcost/djar per
    row.  ``jar`` may be passed by the forward solver, which carries it."""
    _check_pyramidal(m)
    J = d.efc_J
    x = (_mv(J, qacc) - d.efc_aref) if jar is None else jar
    f, _ = _row_force_and_curv(d, x, d.efc_D)
    efc_force = -f
    qfrc_constraint = _mv(J.transpose(-1, -2), efc_force)
    return efc_force, qfrc_constraint
