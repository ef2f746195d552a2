"""Frozen copy of mujoco_sim_tpu_torch's CPU path for the benchmark's
plain reference (bench_port/refsim): imports rewritten, CUDA wrappers
and graph capture removed.  Do not import the program from here.

Smooth (unconstrained) dynamics: FK, COM frame, CRB, RNEA.

Port of mujoco_sim_tpu/ops/smooth.py.  The JAX functions are written per
env and vmapped; here every per-env tensor carries an explicit leading env
axis (B, ...), and model tensors (no env axis) broadcast against it.

Tree structure is baked in as static index arrays and constant 0/1 masks
built on the host from ``Model.layout`` and cached on it (``Layout.const``),
so every (level, joint-slot, joint-type) subgroup is a vectorized,
branch-free gather/compute/scatter and the O(nv^2) work (mass matrix, bias
projection) is batched matmuls.  Matmuls run in true f32 on the card:
``engine.put_model`` turns TF32 off.

Quantities match MuJoCo's c-frame convention (world orientation, origin at
the subtree COM of each body's root) so cdof/cvel/qM are directly
oracle-comparable.
"""

from __future__ import annotations

import numpy as np
import torch

from refsim.models.model import Model, JointType
from refsim.ops import math as mm


def _fk_plan_np(m: Model, mocap_on: bool) -> dict:
    """Static pointer-doubling FK plan (numpy; see _fk_plan)."""
    lay = m.layout
    nb = m.nbody
    njnt = m.njnt
    nq = max(int(m.nq), 1)
    parent = np.asarray(lay.body_parentid).copy()
    jt = np.asarray(lay.jnt_type)
    qadr = np.asarray(lay.jnt_qposadr)
    jbody = np.asarray(lay.jnt_bodyid)
    is_free = jt == int(JointType.FREE)
    is_ball = jt == int(JointType.BALL)
    is_slide = jt == int(JointType.SLIDE)
    is_hinge = jt == int(JointType.HINGE)
    # absolute-pose bodies compose with nothing: free-jointed (qpos IS the
    # world pose) and, when mocap arrays are supplied, mocap bodies
    absolute = np.zeros(nb, dtype=bool)
    absolute[jbody[is_free]] = True
    mocap_sel = np.asarray(lay.body_mocapid) >= 0
    if mocap_on:
        absolute |= mocap_sel
    P = parent.copy()
    P[absolute] = 0
    P[0] = 0
    mats = []
    Pk = P
    while np.any(Pk != 0):
        M = np.zeros((nb, nb))
        M[np.arange(nb), Pk] = 1.0
        mats.append(M)
        Pk = Pk[Pk]
    # per-slot body<-joint one-hot selectors
    jntnum = np.asarray(lay.body_jntnum)
    jntadr = np.asarray(lay.body_jntadr)
    slots = []
    maxslots = int(jntnum.max()) if nb else 0
    for k in range(maxslots):
        has = jntnum > k
        B = np.zeros((nb, max(njnt, 1)))
        B[np.nonzero(has)[0], jntadr[has] + k] = 1.0
        slots.append((B, has.astype(np.float64)[:, None]))
    # qpos gather indices (clipped so non-applicable types read safely)
    scal_idx = np.clip(qadr, 0, nq - 1)
    qstart = qadr + np.where(is_free, 3, 0)
    quat_idx = np.clip(qstart[:, None] + np.arange(4), 0, nq - 1)
    pos3_idx = np.clip(qadr[:, None] + np.arange(3), 0, nq - 1)
    # original-parent and joint<-body one-hot selectors for anchors
    par_oh = np.zeros((nb, nb))
    par_oh[np.arange(nb), parent] = 1.0
    j2b = np.zeros((max(njnt, 1), nb))
    j2b[np.arange(njnt), jbody[:njnt]] = 1.0
    # mocap body <- mocap id one-hot
    mc_oh = None
    if mocap_on and m.nmocap:
        mc_oh = np.zeros((nb, m.nmocap))
        mids = np.asarray(lay.body_mocapid)
        mc_oh[np.nonzero(mocap_sel)[0], mids[mocap_sel]] = 1.0
    abs_free = absolute & ~(mocap_sel if mocap_on else np.zeros(nb, bool))
    return dict(mats=mats, slots=slots, scal_idx=scal_idx, quat_idx=quat_idx,
                pos3_idx=pos3_idx, par_oh=par_oh, j2b=j2b, mc_oh=mc_oh,
                is_free=is_free, is_ball=is_ball, is_slide=is_slide,
                is_hinge=is_hinge, abs_free=abs_free,
                any_abs_free=bool(abs_free.any()),
                mocap_sel=mocap_sel,
                f2b=(j2b * is_free[:, None]).T if njnt else None)


def _fk_plan(m: Model, mocap_on: bool, dtype) -> dict:
    """Static pointer-doubling FK plan, as tensors (cached per Layout).

    Every body's LOCAL transform (offset + its joints) is computed in one
    type-masked batched pass, then world poses come from ceil(log2(depth))
    pointer-doubling composition steps — each a constant one-hot matmul +
    quaternion compose over ALL bodies at once.
    """
    return m.layout.const(("fkplan", mocap_on),
                          lambda: _fk_plan_np(m, mocap_on), dtype)


def kinematics(m: Model, qpos: torch.Tensor, mocap_pos=None, mocap_quat=None):
    """Forward kinematics: body/geom/site frames (mj_kinematics equivalent).

    qpos (B, nq); mocap_pos/mocap_quat (B, nmocap, 3/4).  Mocap bodies take
    their pose from (mocap_pos, mocap_quat) directly.  World poses via
    batched local transforms + pointer-doubling composition (_fk_plan)."""
    lay = m.layout
    dev = lay.dev
    dtype = qpos.dtype
    B = qpos.shape[0]
    nb = m.nbody
    njnt = m.njnt
    mocap_on = bool(mocap_pos is not None and m.nmocap)
    plan = _fk_plan(m, mocap_on, dtype)
    ident4 = torch.zeros((1, 4), dtype=dtype, device=qpos.device)
    ident4[0, 0].fill_(1.0)
    body_pos = m.body_pos.to(dtype)
    body_quat = m.body_quat.to(dtype)

    if njnt:
        # ---- per-joint local transforms, one type-masked batched pass
        jpos = m.jnt_pos.to(dtype)
        jaxis = m.jnt_axis.to(dtype)
        val = qpos[:, plan["scal_idx"]] - m.jnt_ref.to(dtype)   # (B, njnt)
        q4 = mm.quat_normalize(qpos[:, plan["quat_idx"]])        # ball/free
        q_h = mm.axis_angle_to_quat(jaxis, val)
        is_h = plan["is_hinge"][:, None]
        is_b = plan["is_ball"][:, None]
        is_s = plan["is_slide"][:, None]
        is_f = plan["is_free"][:, None]
        qloc = torch.where(is_h, q_h, torch.where(is_b, q4, ident4))
        # rotation about the anchor: p_F = jpos - R(qloc) jpos
        p_rot = jpos - mm.rot_vec_quat(jpos, qloc)
        p_f = torch.where(is_s, jaxis * val[..., None],
                          torch.where(is_f, 0.0, p_rot))
        free_pos = qpos[:, plan["pos3_idx"]]                     # (B, njnt, 3)

        # ---- per-body joint composition (runs in the post-offset L0
        # frame; anchors/axes recorded pre-joint, MuJoCo convention)
        run_p = torch.zeros((B, nb, 3), dtype=dtype, device=qpos.device)
        run_q = ident4.expand(B, nb, 4)
        anchor_l = torch.zeros((B, njnt, 3), dtype=dtype, device=qpos.device)
        axis_l = torch.zeros((B, njnt, 3), dtype=dtype, device=qpos.device)
        for (Bk, has) in plan["slots"]:
            jp_b = Bk @ jpos
            ja_b = Bk @ jaxis
            anc_b = run_p + mm.rot_vec_quat(jp_b, run_q)
            axw_b = mm.rot_vec_quat(ja_b, run_q)
            anchor_l = anchor_l + Bk.T @ (anc_b * has)
            axis_l = axis_l + Bk.T @ (axw_b * has)
            qloc_b = Bk @ qloc
            qloc_b = torch.where(has > 0.5, qloc_b, ident4)
            pf_b = Bk @ p_f
            run_p = run_p + mm.rot_vec_quat(pf_b, run_q) * has
            run_q = mm.quat_mul(run_q, qloc_b)
        lp = body_pos + mm.rot_vec_quat(run_p, body_quat)
        lq = mm.quat_normalize(mm.quat_mul(body_quat, run_q))
        # free-jointed bodies: qpos is the absolute world pose
        if plan["any_abs_free"]:
            F2B = plan["f2b"]                          # (nbody, njnt)
            absf = plan["abs_free"][:, None]
            lp = torch.where(absf, F2B @ free_pos, lp)
            lq = torch.where(absf, F2B @ q4, lq)
    else:
        lp = body_pos.expand(B, nb, 3)
        lq = body_quat.expand(B, nb, 4)

    if mocap_on and plan["mc_oh"] is not None:
        MC = plan["mc_oh"]
        mcm = plan["mocap_sel"][:, None]
        lp = torch.where(mcm, MC @ mocap_pos.to(dtype), lp)
        lq = torch.where(mcm, mm.quat_normalize(MC @ mocap_quat.to(dtype)),
                         lq)

    # ---- pointer doubling: world = prod of ancestor locals
    for Mk in plan["mats"]:
        G = Mk @ torch.cat([lp, lq], dim=-1)
        gp, gq = G[..., :3], G[..., 3:]
        lp = gp + mm.rot_vec_quat(lp, gq)
        lq = mm.quat_normalize(mm.quat_mul(gq, lq))
    xpos, xquat = lp, lq

    # ---- joint anchors/axes in world (pre-joint L0 frame per body)
    if njnt:
        PAR = plan["par_oh"]
        Gp = PAR @ torch.cat([xpos, xquat], dim=-1)
        p_par, q_par = Gp[..., :3], Gp[..., 3:]
        p_l0 = p_par + mm.rot_vec_quat(body_pos, q_par)
        q_l0 = mm.quat_mul(q_par, body_quat)
        J2B = plan["j2b"]
        Gj = J2B @ torch.cat([p_l0, q_l0], dim=-1)
        xanchor = Gj[..., :3] + mm.rot_vec_quat(anchor_l, Gj[..., 3:])
        xaxis = mm.rot_vec_quat(axis_l, Gj[..., 3:])
        xanchor = torch.where(is_f, free_pos, xanchor)
        zaxis = torch.zeros_like(xaxis)
        zaxis[..., 2].fill_(1.0)
        xaxis = torch.where(is_f, zaxis, xaxis)
    else:
        xanchor = torch.zeros((B, 0, 3), dtype=dtype, device=qpos.device)
        xaxis = torch.zeros((B, 0, 3), dtype=dtype, device=qpos.device)

    xmat = mm.quat_to_mat(xquat)
    xipos = xpos + mm.rot_vec_quat(m.body_ipos.to(dtype), xquat)
    ximat = mm.quat_to_mat(mm.quat_mul(xquat, m.body_iquat.to(dtype)))
    gq_b = xquat[:, dev.geom_bodyid]
    geom_q = mm.quat_mul(gq_b, m.geom_quat.to(dtype))
    geom_xpos = (xpos[:, dev.geom_bodyid]
                 + mm.rot_vec_quat(m.geom_pos.to(dtype), gq_b))
    geom_xmat = mm.quat_to_mat(geom_q)
    sq_b = xquat[:, dev.site_bodyid]
    site_q = mm.quat_mul(sq_b, m.site_quat.to(dtype))
    site_xpos = (xpos[:, dev.site_bodyid]
                 + mm.rot_vec_quat(m.site_pos.to(dtype), sq_b))
    site_xmat = mm.quat_to_mat(site_q)
    return dict(xpos=xpos, xquat=xquat, xmat=xmat, xipos=xipos, ximat=ximat,
                xanchor=xanchor, xaxis=xaxis, geom_xpos=geom_xpos,
                geom_xmat=geom_xmat, site_xpos=site_xpos, site_xmat=site_xmat)


def _cdof_plan_np(m: Model):
    """Static (joint type, dof adr, body) groups for com_pos's cdof."""
    lay = m.layout
    out = []
    for jt in (JointType.FREE, JointType.BALL, JointType.SLIDE,
               JointType.HINGE):
        jsel = np.nonzero(lay.jnt_type == int(jt))[0]
        if len(jsel):
            out.append((int(jt), jsel, lay.jnt_dofadr[jsel],
                        lay.jnt_bodyid[jsel]))
    return out


def com_pos(m: Model, kin: dict, mass=None, inertia=None):
    """Subtree COM, c-frame body inertias, dof axes (mj_comPos equivalent).

    mass/inertia (B, nbody[, 3]) default to the compiled model values; the
    engine passes the Data-resident copies so spawn-time inertial
    overrides take effect."""
    dev = m.layout.dev
    xipos = kin["xipos"]
    ximat = kin["ximat"]
    dtype = xipos.dtype
    B = xipos.shape[0]
    mass = (m.body_mass.to(dtype).expand(B, -1) if mass is None
            else mass.to(dtype))
    body_inertia = (m.body_inertia.to(dtype).expand(B, -1, -1)
                    if inertia is None else inertia.to(dtype))

    # subtree com: one subtree-mask matmul (see _tree_masks)
    S = _tree_masks(m, dtype)["sub"]
    momm = torch.cat([mass[..., None] * xipos, mass[..., None]], dim=-1)
    sub = S @ momm                                   # (B, nbody, 4)
    sub_mass = sub[..., 3]
    subtree_com = sub[..., :3] / torch.clamp(sub_mass, min=1e-12)[..., None]

    # c-frame origin per body: subtree_com of its root
    origin = subtree_com[:, dev.body_rootid]

    # spatial inertia of each body about its c-frame origin
    # R diag(I) R^T as mul+reduce (the JAX package's form)
    RI = ximat * body_inertia[..., None, :]
    inert_world = (RI[..., :, None, :] * ximat[..., None, :, :]).sum(-1)
    cinert = mm.spatial_inertia(mass, inert_world, xipos - origin)

    # cdof
    cdof = torch.zeros((B, m.nv, 6), dtype=dtype, device=xipos.device)
    for jt, jsel, dadr, b in m.layout.const("cdofplan",
                                            lambda: _cdof_plan_np(m), dtype):
        O = origin[:, b]
        anchor = kin["xanchor"][:, jsel]
        if jt == int(JointType.SLIDE):
            ax = kin["xaxis"][:, jsel]
            cdof[:, dadr] = torch.cat([torch.zeros_like(ax), ax], dim=-1)
        elif jt == int(JointType.HINGE):
            ax = kin["xaxis"][:, jsel]
            lin = mm.cross(ax, O - anchor)
            cdof[:, dadr] = torch.cat([ax, lin], dim=-1)
        elif jt == int(JointType.BALL):
            R = kin["xmat"][:, b]  # child frame columns: local-frame qvel
            for i in range(3):
                ax = R[..., :, i]
                lin = mm.cross(ax, O - anchor)
                cdof[:, dadr + i] = torch.cat([ax, lin], dim=-1)
        else:  # FREE: 3 world translations + 3 local-frame rotations @ origin
            for i in range(3):
                col = torch.zeros((B, len(jsel), 6), dtype=dtype,
                                  device=xipos.device)
                col[..., 3 + i].fill_(1.0)
                cdof[:, dadr + i] = col
            R = kin["xmat"][:, b]
            for i in range(3):
                ax = R[..., :, i]
                lin = mm.cross(ax, O - anchor)
                cdof[:, dadr + 3 + i] = torch.cat([ax, lin], dim=-1)
    return dict(subtree_com=subtree_com, cinert=cinert, cdof=cdof,
                origin=origin)


def com_vel(m: Model, com: dict, qvel: torch.Tensor):
    """Body spatial velocities + cdof time-derivatives (mj_comVel).

    cvel[b] = sum of cdof_d qvel_d over ancestor-or-self dofs, and
    cdof_dot[d] = v_pre(d) x* cdof[d] with v_pre the velocity accumulated
    strictly before d's joint (free-joint rotational dofs also see their
    own translations — MuJoCo convention).  Both prefixes are static tree
    sums, evaluated as two constant-mask matmuls (_tree_masks)."""
    cdof = com["cdof"]
    dtype = cdof.dtype
    masks = _tree_masks(m, dtype)
    contrib = cdof * qvel[..., None]                   # (B, nv, 6)
    v_pre = masks["pre"] @ contrib                     # (B, nv, 6)
    cdof_dot = mm.motion_cross(v_pre, cdof)
    cvel = m.ancestor_mask.to(dtype) @ contrib         # (B, nbody, 6)
    return dict(cvel=cvel, cdof_dot=cdof_dot)


def _tree_masks_np(m: Model):
    lay = m.layout
    nb, nv = m.nbody, m.nv
    parent = np.asarray(lay.body_parentid)
    # ancestor-or-self body matrix
    anc = np.zeros((nb, nb))
    for c in range(nb):
        b = c
        while b >= 0:
            anc[b, c] = 1.0
            b = parent[b] if b != 0 else -1
    # dof -> joint, joint slot order
    jnt_of_dof = np.zeros(nv, dtype=int)
    ndof_of = {int(JointType.FREE): 6, int(JointType.BALL): 3,
               int(JointType.SLIDE): 1, int(JointType.HINGE): 1}
    for j in range(len(lay.jnt_type)):
        a = lay.jnt_dofadr[j]
        jnt_of_dof[a:a + ndof_of[int(lay.jnt_type[j])]] = j
    dof_body = np.asarray(lay.dof_bodyid)
    pre = np.zeros((nv, nv))
    for d in range(nv):
        jd = jnt_of_dof[d]
        bd = dof_body[d]
        for e in range(nv):
            je = jnt_of_dof[e]
            be = dof_body[e]
            if be == bd:
                if je < jd:          # earlier joint slot on the same body
                    pre[d, e] = 1.0
                elif je == jd and int(lay.jnt_type[jd]) == int(JointType.FREE):
                    # free joint: rotational dofs (3..5) see translations
                    if (d - lay.jnt_dofadr[jd]) >= 3 and \
                            (e - lay.jnt_dofadr[jd]) < 3:
                        pre[d, e] = 1.0
            elif anc[be, bd] and be != bd:
                pre[d, e] = 1.0
    return dict(sub=anc, pre=pre)


def _tree_masks(m: Model, dtype) -> dict:
    """Static 0/1 masks that turn tree accumulations into single matmuls
    (cached per Layout).

      sub  (nbody, nbody): sub[b, c] = 1 iff b is ancestor-or-self of c
                           (X_subtree = sub @ X)
      pre  (nv, nv): pre[d, e] = 1 iff dof e belongs to a joint processed
                     strictly before dof d's joint along d's kinematic
                     chain (ancestor bodies' joints + earlier joint slots
                     on the same body), PLUS the free-joint convention
                     that rotational dofs see their own joint's
                     translational dofs.
    """
    return m.layout.const("treemasks", lambda: _tree_masks_np(m), dtype)


def _dof_ancestor_upper_np(m: Model) -> np.ndarray:
    lay = m.layout
    A = np.zeros((m.nv, m.nv), dtype=bool)
    for j in range(m.nv):
        i = j
        while i >= 0:
            A[i, j] = True
            i = lay.dof_parentid[i]
    return np.triu(A)


def crb(m: Model, com: dict):
    """Dense joint-space inertia matrix via composite-rigid-body (mj_crb).

    M_ij = cdof_i^T IC_{body(j)} cdof_j for i ancestor-or-self of j, where
    IC is the subtree composite inertia; batched over envs as matmuls.
    """
    cinert = com["cinert"]
    cdof = com["cdof"]
    dtype = cdof.dtype
    B = cdof.shape[0]

    # composite inertia: one subtree-mask matmul (see _tree_masks)
    S = _tree_masks(m, dtype)["sub"]
    IC = (S @ cinert.reshape(B, m.nbody, 36)).reshape(B, m.nbody, 6, 6)

    # F_j = IC_{body(j)} @ cdof_j
    F = torch.einsum("zjuv,zjv->zju", IC[:, m.layout.dev.dof_bodyid], cdof)
    W = cdof @ F.transpose(-1, -2)  # (B, nv, nv): W_ij = cdof_i . F_j
    Au = m.layout.const("ancupper", lambda: _dof_ancestor_upper_np(m), dtype)
    Wu = torch.where(Au, W, 0.0)
    qM = Wu + Wu.transpose(-1, -2) - torch.diag_embed(
        torch.diagonal(Wu, dim1=-2, dim2=-1))
    qM = qM + torch.diag(m.dof_armature.to(dtype))
    return qM


def rne(m: Model, com: dict, vel: dict, qvel: torch.Tensor,
        gravity_on=True):
    """Bias force C(q,qvel)·qvel + gravity (mj_rne with qacc=0)."""
    cdof, cinert = com["cdof"], com["cinert"]
    cvel, cdof_dot = vel["cvel"], vel["cdof_dot"]
    dtype = cdof.dtype

    # qacc=0 spatial accelerations: a_b = a_parent + sum cdof_dot_d qvel_d,
    # with the gravity trick a_world = [0; -g]
    g = m.opt.gravity.to(dtype)
    a0 = torch.cat([torch.zeros_like(g), -g]) if gravity_on else \
        torch.zeros(6, dtype=dtype, device=cdof.device)
    # cacc[b] = a0 + sum of cdof_dot_d qvel_d over ancestor-or-self dofs:
    # one ancestor-mask matmul (see _tree_masks)
    mask = m.ancestor_mask.to(dtype)  # (nbody, nv)
    cacc = a0 + mask @ (cdof_dot * qvel[..., None])

    # per-body bias force: f = I a + v x* (I v)
    Iv = torch.einsum("zbuv,zbv->zbu", cinert, cvel)
    f = torch.einsum("zbuv,zbv->zbu", cinert, cacc) + mm.force_cross(cvel, Iv)
    # project through ancestors: qfrc_bias_d = cdof_d . sum_{b in subtree} f_b
    qfrc_bias = torch.einsum("zdu,zbu,bd->zd", cdof, f, mask)
    return qfrc_bias


def mul_m(m: Model, qM: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """M @ v per env (mj_mulM equivalent)."""
    return (qM @ vec[..., None])[..., 0]


def factor_chol(qM: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of qM: the hand-written kernel for a CUDA
    tensor, ops/linalg.cholesky for a CPU tensor (ops/chol_factor.py)."""
    from refsim.ops import chol_factor
    return chol_factor.chol_factor(qM)


def solve_chol(L: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    from refsim.ops import linalg
    return linalg.cho_solve(L, rhs)
