"""Collision: static pair list + batched primitive narrowphase.

Port of the primitive part of mujoco_sim_tpu/ops/collision.py.  Broadphase
is compile-time: the candidate pair list is frozen in the model
(models/compile.py), and every pair owns fixed contact slots so shapes
never change.  Narrowphase runs vectorized per pair-type group over
(env, pair) leading axes; inactive slots are masked, not absent.

Mesh pairs (the top-P hull groups, ``_plane_mesh``) are ROADMAP §A.6 and
heightfields §A.7: both raise NotImplementedError here.

Contact frame convention matches MuJoCo: normal points from geom1 to geom2,
frame rows = [normal, tangent1, tangent2], pos = midpoint between surfaces.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from mujoco_sim_tpu_torch.models.model import (Model, Data, GeomType,
                                                contact_rows_per)
from mujoco_sim_tpu_torch.ops.math import cross, norm


def _rows_per(m: Model) -> int:
    return contact_rows_per(m.max_condim, m.opt.cone)


def _top_k_small(x: torch.Tensor, k: int):
    """(values, indices) of the k LARGEST of x along the last axis.

    k argmax/mask passes: ties resolve to the lowest index (torch.argmax
    returns the first maximum), the tie order of the JAX package.  Never
    torch.topk/sort here: their tie order is not fixed.
    """
    n = x.shape[-1]
    if k >= n:
        # every element is selected; callers mask by value, so identity
        # order suffices
        idx = torch.arange(n, device=x.device).expand(x.shape)
        return x, idx
    iota = torch.arange(n, device=x.device)
    cur = x
    vals, idxs = [], []
    for _ in range(k):
        i = torch.argmax(cur, dim=-1)
        v = torch.amax(cur, dim=-1)
        vals.append(v)
        idxs.append(i)
        cur = torch.where(iota == i[..., None], -torch.inf, cur)
    return torch.stack(vals, dim=-1), torch.stack(idxs, dim=-1)


def _make_tangents(n: torch.Tensor):
    """Two unit tangents orthogonal to n (batch-safe)."""
    # pick the world axis least aligned with n: x if |n_x| < 0.5 else y
    small = (n[..., 0:1].abs() < 0.5).to(n.dtype)
    a = torch.cat([small, 1.0 - small, torch.zeros_like(small)], dim=-1)
    t1 = cross(n, a)
    t1 = t1 / torch.clamp(norm(t1, keepdim=True), min=1e-12)
    t2 = cross(n, t1)
    return t1, t2


def _corners(like: torch.Tensor) -> torch.Tensor:
    """(8, 3) box corner signs in the order
    [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]."""
    i = torch.arange(8, device=like.device)
    bits = torch.stack([(i >> 2) & 1, (i >> 1) & 1, i & 1], dim=-1)
    return (2 * bits - 1).to(like.dtype)


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    return F.one_hot(idx.long(), n).to(dtype)


def _plane_sphere(pp, pR, s1, sp, sR, size2):
    """1 contact: (dist, pos, normal). pp/pR plane frame; sp sphere center."""
    n = pR[..., :, 2]
    h = (n * (sp - pp)).sum(-1)
    r = size2[..., 0]
    dist = h - r
    pos = sp - n * (r + 0.5 * dist)[..., None]
    return dist[..., None], pos[..., None, :], n[..., None, :]


def _plane_capsule(pp, pR, s1, cp, cR, size2):
    """2 contacts at the capsule end-sphere centers."""
    n = pR[..., :, 2]
    axis = cR[..., :, 2]
    r = size2[..., 0]
    hh = size2[..., 1]
    ends = torch.stack([cp + axis * hh[..., None], cp - axis * hh[..., None]],
                       dim=-2)  # (...,2,3)
    h = (n[..., None, :] * (ends - pp[..., None, :])).sum(-1)
    dist = h - r[..., None]
    pos = ends - n[..., None, :] * (r[..., None] + 0.5 * dist)[..., None]
    nrm = n[..., None, :].expand(pos.shape)
    return dist, pos, nrm


def _plane_box(pp, pR, s1, bp, bR, size2):
    """4 deepest corners."""
    n = pR[..., :, 2]
    pts = bp[..., None, :] + _rotate_rows_fwd(
        bR, _corners(bp) * size2[..., None, :])
    h = (n[..., None, :] * (pts - pp[..., None, :])).sum(-1)
    # 4 smallest heights (lowest corner index on ties)
    neg_h, idx = _top_k_small(-h, 4)
    dist = -neg_h
    pos = _select_rows(pts, idx)
    pos = pos - n[..., None, :] * (0.5 * dist)[..., None]
    nrm = n[..., None, :].expand(pos.shape)
    return dist, pos, nrm


def _plane_cylinder(pp, pR, s1, cp, cR, size2):
    """4 candidate support points (both rim extremes of both caps)."""
    n = pR[..., :, 2]
    axis = cR[..., :, 2]
    r = size2[..., 0]
    hh = size2[..., 1]
    # downhill direction in cap plane
    proj = (n * axis).sum(-1)
    u = n - axis * proj[..., None]
    un = norm(u, keepdim=True)
    # if axis || n, pick arbitrary radial dir
    alt = cR[..., :, 0]
    u = torch.where(un > 1e-8, u / torch.clamp(un, min=1e-12), alt)
    caps = torch.stack([cp + axis * hh[..., None], cp - axis * hh[..., None]],
                       dim=-2)
    pts = torch.cat([
        caps - u[..., None, :] * r[..., None, None],
        caps + u[..., None, :] * r[..., None, None],
    ], dim=-2)  # (...,4,3)
    h = (n[..., None, :] * (pts - pp[..., None, :])).sum(-1)
    pos = pts - n[..., None, :] * (0.5 * h)[..., None]
    nrm = n[..., None, :].expand(pos.shape)
    return h, pos, nrm


def _plane_ellipsoid(pp, pR, s1, ep, eR, size2):
    n = pR[..., :, 2]
    # support point in -n direction: x = -E^2 R^T n / |E R^T n|
    nl = (eR * n[..., :, None]).sum(-2)        # n in ellipsoid frame
    en = size2 * nl
    denom = norm(en, keepdim=True)
    xl = -(size2 * en) / torch.clamp(denom, min=1e-12)
    x = ep + (eR * xl[..., None, :]).sum(-1)
    h = (n * (x - pp)).sum(-1)
    pos = x - n * (0.5 * h)[..., None]
    return h[..., None], pos[..., None, :], n[..., None, :]


def _sphere_sphere(p1, R1, s1, p2, R2, s2):
    d = p2 - p1
    dist_c = norm(d)
    n = d / torch.clamp(dist_c[..., None], min=1e-12)
    r1, r2 = s1[..., 0], s2[..., 0]
    dist = dist_c - r1 - r2
    pos = p1 + n * (r1 + 0.5 * dist)[..., None]
    return dist[..., None], pos[..., None, :], n[..., None, :]


def _sphere_capsule(p1, R1, s1, p2, R2, s2):
    axis = R2[..., :, 2]
    hh = s2[..., 1]
    t = torch.clamp(((p1 - p2) * axis).sum(-1), -hh, hh)
    cp = p2 + axis * t[..., None]
    d = cp - p1
    dist_c = norm(d)
    n = d / torch.clamp(dist_c[..., None], min=1e-12)
    r1, r2 = s1[..., 0], s2[..., 0]
    dist = dist_c - r1 - r2
    pos = p1 + n * (r1 + 0.5 * dist)[..., None]
    return dist[..., None], pos[..., None, :], n[..., None, :]


def _capsule_capsule(p1, R1, s1, p2, R2, s2):
    """2 contacts from closest points between the two segments (the second
    candidate probes the opposite end for near-parallel capsules)."""
    a1 = R1[..., :, 2]
    a2 = R2[..., :, 2]
    h1 = s1[..., 1]
    h2 = s2[..., 1]
    r1 = s1[..., 0]
    r2 = s2[..., 0]
    # closed-form segment-segment closest parameters (clamped)
    d12 = p2 - p1
    A = torch.ones_like(h1)                   # a1.a1
    B = (a1 * a2).sum(-1)
    C = (a1 * d12).sum(-1)
    E = (a2 * d12).sum(-1)
    den = torch.clamp(A - B * B, min=1e-9)
    t1 = torch.clamp((C - B * E) / den, -h1, h1)
    t2 = torch.clamp(B * t1 - E, -h2, h2)
    # refine t1 against the clamped t2 (Ericson's closest-segment scheme)
    t1 = torch.clamp(C + B * t2, -h1, h1)

    def contact_at(t1_, t2_):
        q1 = p1 + a1 * t1_[..., None]
        q2 = p2 + a2 * t2_[..., None]
        dd = q2 - q1
        dist_c = norm(dd)
        n = dd / torch.clamp(dist_c[..., None], min=1e-12)
        dist = dist_c - r1 - r2
        pos = q1 + n * (r1 + 0.5 * dist)[..., None]
        return dist, pos, n

    dA, posA, nA = contact_at(t1, t2)
    dB, posB, nB = contact_at(-t1, -t2)
    dist = torch.stack([dA, dB], dim=-1)
    pos = torch.stack([posA, posB], dim=-2)
    nrm = torch.stack([nA, nB], dim=-2)
    return dist, pos, nrm


def _capsule_box(p1, R1, s1, p2, R2, s2):
    """3 contacts: sphere-box queries at both capsule ends + midpoint."""
    axis = R1[..., :, 2]
    hh = s1[..., 1]
    outs = []
    for f in (-1.0, 0.0, 1.0):
        c = p1 + axis * (f * hh)[..., None]
        sz = torch.cat([s1[..., 0:1], torch.zeros_like(s1[..., 1:3])],
                       dim=-1)
        outs.append(_sphere_box(c, R1, sz, p2, R2, s2))
    dist = torch.cat([o[0] for o in outs], dim=-1)
    pos = torch.cat([o[1] for o in outs], dim=-2)
    nrm = torch.cat([o[2] for o in outs], dim=-2)
    return dist, pos, nrm


def _sphere_box(p1, R1, s1, p2, R2, s2):
    # sphere center in box frame
    cl = (R2 * (p1 - p2)[..., :, None]).sum(-2)
    clamped = torch.minimum(torch.maximum(cl, -s2), s2)
    inside = torch.all(cl.abs() < s2, dim=-1)
    # outside: closest point on surface
    d_out = cl - clamped
    dist_out = norm(d_out)
    n_out = -d_out / torch.clamp(dist_out[..., None], min=1e-12)  # toward box
    # inside: push out along min-penetration face
    depth = s2 - cl.abs()
    ax = torch.argmin(depth, dim=-1)
    sign = torch.sign(_oh_pick(cl, ax))
    n_in = -(_one_hot(ax, 3, cl.dtype) * sign[..., None])
    dist_in = -_oh_pick(depth, ax)
    surf = torch.where(inside[..., None],
                       clamped + n_in * dist_in[..., None], clamped)
    nl = torch.where(inside[..., None], n_in, n_out)
    dist_l = torch.where(inside, dist_in, dist_out)
    r1 = s1[..., 0]
    dist = dist_l - r1
    # back to world: normal from sphere toward box
    n = (R2 * nl[..., None, :]).sum(-1)
    surf_w = p2 + (R2 * surf[..., None, :]).sum(-1)
    pos = 0.5 * (surf_w + p1 + n * r1[..., None])
    return dist[..., None], pos[..., None, :], n[..., None, :]


def _box_box(p1, R1, s1, p2, R2, s2):
    """8 contacts via full SAT (6 face + 9 edge-edge axes).

    The separating axis is chosen among all 15 (max separation / min
    penetration) with a small bias toward face normals for stable
    face-on-face stacking.  Face axis -> corner candidates of each box
    measured as penetration past the other box's support plane along the
    axis, gated by lateral containment.  Edge-edge axis -> one contact at
    the closest point between the two support edges.
    """
    dtype = p1.dtype
    corners = _corners(p1)
    t = p2 - p1  # (...,3)

    # candidate face axes: columns of R1 and R2 -> (..., 6, 3)
    axes = torch.cat([R1.transpose(-1, -2), R2.transpose(-1, -2)], dim=-2)
    # projection radii of each box onto each axis
    proj1 = (axes[..., :, :, None] * R1[..., None, :, :]).sum(-2).abs()
    ra = (proj1 * s1[..., None, :]).sum(-1)
    proj2 = (axes[..., :, :, None] * R2[..., None, :, :]).sum(-2).abs()
    rb = (proj2 * s2[..., None, :]).sum(-1)
    ta = (axes * t[..., None, :]).sum(-1)
    sep = ta.abs() - ra - rb             # (...,6), >0 = separated
    k = torch.argmax(sep, dim=-1)
    sep_face = torch.amax(sep, dim=-1)
    a_k = _oh_pick_rows(axes, k)
    ta_k = _oh_pick(ta, k)
    n = a_k * torch.sign(ta_k)[..., None]  # points from box1 toward box2
    ra_k = _oh_pick(ra, k)
    rb_k = _oh_pick(rb, k)

    # ---- edge-edge axes: cross(R1[:,i], R2[:,j]), 9 candidates
    e1 = R1.transpose(-1, -2)            # (...,3,3) rows = box1 axes
    e2 = R2.transpose(-1, -2)
    cr = cross(e1[..., :, None, :], e2[..., None, :, :])  # (...,3,3,3)
    cr = cr.reshape(cr.shape[:-3] + (9, 3))
    crn = norm(cr)
    ok = crn > 1e-6                       # near-parallel edges degenerate
    cru = cr / torch.clamp(crn[..., None], min=1e-12)
    ra_e = ((cru[..., :, :, None] * R1[..., None, :, :]).sum(-2).abs()
            * s1[..., None, :]).sum(-1)
    rb_e = ((cru[..., :, :, None] * R2[..., None, :, :]).sum(-2).abs()
            * s2[..., None, :]).sum(-1)
    ta_e = (cru * t[..., None, :]).sum(-1)
    sep_e = torch.where(ok, ta_e.abs() - ra_e - rb_e, -1e9)
    ke = torch.argmax(sep_e, dim=-1)
    sep_edge = torch.amax(sep_e, dim=-1)
    # face bias: the edge axis must beat the best face axis by a margin to
    # be chosen (avoids flip-flopping on near-degenerate configurations)
    edge_wins = sep_edge > sep_face + 1e-4
    a_e = _oh_pick_rows(cru, ke)
    ta_ke = _oh_pick(ta_e, ke)
    n_e = a_e * torch.sign(ta_ke)[..., None]   # from box1 toward box2
    # support edges: box1 edge along axis i shifted maximally along +n_e,
    # box2 edge along axis j shifted along -n_e
    i_idx = torch.div(ke, 3, rounding_mode="floor")
    j_idx = ke % 3
    dir1 = _oh_pick_rows(e1, i_idx)
    dir2 = _oh_pick_rows(e2, j_idx)
    sgn1 = torch.sign((e1 * n_e[..., None, :]).sum(-1))
    sgn2 = -torch.sign((e2 * n_e[..., None, :]).sum(-1))
    mask1 = 1.0 - _one_hot(i_idx, 3, dtype)   # off-axis dims
    mask2 = 1.0 - _one_hot(j_idx, 3, dtype)
    c1 = p1 + ((sgn1 * mask1 * s1)[..., :, None] * e1).sum(-2)
    c2 = p2 + ((sgn2 * mask2 * s2)[..., :, None] * e2).sum(-2)
    h1 = _oh_pick(s1, i_idx)
    h2 = _oh_pick(s2, j_idx)
    # closest points between segments (c1 +- h1 dir1), (c2 +- h2 dir2)
    d12 = c2 - c1
    Bd = (dir1 * dir2).sum(-1)
    Cd = (dir1 * d12).sum(-1)
    Ed = (dir2 * d12).sum(-1)
    den = torch.clamp(1.0 - Bd * Bd, min=1e-9)
    t1 = torch.clamp((Cd - Bd * Ed) / den, -h1, h1)
    t2 = torch.clamp(Bd * t1 - Ed, -h2, h2)
    t1 = torch.clamp(Cd + Bd * t2, -h1, h1)
    q1 = c1 + dir1 * t1[..., None]
    q2 = c2 + dir2 * t2[..., None]
    pos_edge = 0.5 * (q1 + q2)
    dist_edge = torch.where(edge_wins, sep_edge, 1e9)

    def corner_candidates(pc, Rc, sc, p_other, R_other, s_other,
                          depth_fn):
        pts = pc[..., None, :] + _rotate_rows_fwd(Rc,
                                                  corners * sc[..., None, :])
        dist = depth_fn(pts)
        # lateral containment in the other box (slack = 5% of size)
        loc = _rotate_rows(R_other, pts - p_other[..., None, :])
        inside = loc.abs() <= (s_other * 1.05 + 1e-4)[..., None, :]
        # only require the two axes orthogonal to the contact normal; the
        # normal-axis containment is what `dist` measures.  Approximate by
        # requiring at least 2 of 3 axes inside.
        n_inside = inside.sum(dim=-1)
        ok_ = n_inside >= 2
        dist = torch.where(ok_, dist, 1e9)
        return dist, pts

    # corners of box2 vs box1's far support plane along n:
    # depth = (c - p1).n - ra  (negative = penetrating past the plane)
    d2c, pts2 = corner_candidates(
        p2, R2, s2, p1, R1, s1,
        lambda pts: ((pts - p1[..., None, :]) * n[..., None, :]).sum(-1)
        - ra_k[..., None])
    # corners of box1 vs box2's near support plane:
    # depth = (p2 - c).n - rb
    d1c, pts1 = corner_candidates(
        p1, R1, s1, p2, R2, s2,
        lambda pts: (n[..., None, :] * (p2[..., None, :] - pts)).sum(-1)
        - rb_k[..., None])
    dist = torch.cat([d2c, d1c], dim=-1)
    # corners are bogus when the separating axis is edge-edge
    dist = torch.where(edge_wins[..., None], 1e9, dist)
    dist = torch.cat([dist, dist_edge[..., None]], dim=-1)  # (...,17)
    pts = torch.cat([pts2, pts1, pos_edge[..., None, :]], dim=-2)
    nrms = torch.cat(
        [n[..., None, :].expand(pts2.shape),
         n[..., None, :].expand(pts1.shape),
         n_e[..., None, :]], dim=-2)
    neg, idx = _top_k_small(-dist, 8)
    dist8 = -neg
    pos8 = _select_rows(pts, idx)
    nrm8 = _select_rows(nrms, idx)
    return dist8, pos8, nrm8


def _rotate_rows(R, pts):
    """world->local: (..., 3, 3) x (..., k, 3) -> R^T pts (..., k, 3)."""
    return (R[..., None, :, :] * pts[..., :, :, None]).sum(-2)


def _rotate_rows_fwd(R, pts):
    """local->world: (..., 3, 3) x (..., k, 3) -> R pts (..., k, 3)."""
    return (R[..., None, :, :] * pts[..., :, None, :]).sum(-1)


def _oh_pick(vals, idx):
    """vals (..., n) picked at idx (...,) via one-hot reduce (the JAX
    package's form, kept for identical NaN/inf semantics)."""
    oh = _one_hot(idx, vals.shape[-1], vals.dtype)
    return (vals * oh).sum(-1)


def _oh_pick_rows(rows, idx):
    """rows (..., n, 3) picked at idx (...,) -> (..., 3) via one-hot."""
    oh = _one_hot(idx, rows.shape[-2], rows.dtype)
    return (rows * oh[..., None]).sum(-2)


def _select_rows(pts, idx):
    """pts (..., n, 3) at idx (..., k) -> (..., k, 3) via one-hot reduce."""
    oh = _one_hot(idx, pts.shape[-2], pts.dtype)
    return (oh[..., :, :, None] * pts[..., None, :, :]).sum(-2)


# primitive dispatch: (type1, type2) -> narrowphase fn
_DISPATCH = {
    (GeomType.PLANE, GeomType.SPHERE): _plane_sphere,
    (GeomType.PLANE, GeomType.CAPSULE): _plane_capsule,
    (GeomType.PLANE, GeomType.BOX): _plane_box,
    (GeomType.PLANE, GeomType.CYLINDER): _plane_cylinder,
    (GeomType.PLANE, GeomType.ELLIPSOID): _plane_ellipsoid,
    (GeomType.SPHERE, GeomType.SPHERE): _sphere_sphere,
    (GeomType.SPHERE, GeomType.CAPSULE): _sphere_capsule,
    (GeomType.SPHERE, GeomType.BOX): _sphere_box,
    (GeomType.CAPSULE, GeomType.CAPSULE): _capsule_capsule,
    (GeomType.CAPSULE, GeomType.BOX): _capsule_box,
    (GeomType.BOX, GeomType.BOX): _box_box,
}


def _plan_np(m: Model):
    """Static per-group index arrays, pair attributes and slot constants."""
    from mujoco_sim_tpu_torch.ops.colgroups import (build_groups, pair_key,
                                                    EXPENSIVE)
    lay = m.layout
    keys = [pair_key(GeomType(lay.geom_type[a]), GeomType(lay.geom_type[b]))[0]
            for a, b in zip(lay.pair_geom1, lay.pair_geom2)]
    groups, ncand = build_groups(keys)
    assert ncand == m.ncand, (ncand, m.ncand)
    out = []
    cursor = 0
    for g in groups:
        assert g.cand_adr == cursor, (g.cand_adr, cursor)
        cursor += g.ncand
        if g.key in EXPENSIVE or g.key not in _DISPATCH:
            section = ("§A.7 (heightfields)" if g.key[0] == GeomType.HFIELD
                       else "§A.6 (mesh narrowphase)")
            raise NotImplementedError(
                f"collision pair {g.key[0].name}-{g.key[1].name} is not "
                f"ported yet (ROADMAP {section})")
        sel = g.pair_idx
        g1 = lay.pair_geom1[sel]
        g2 = lay.pair_geom2[sel]
        out.append(dict(key=g.key, sel=sel, cap=g.cap, g1=g1, g2=g2,
                        b1=lay.geom_bodyid[g1], b2=lay.geom_bodyid[g2]))
    return dict(
        groups=out,
        cand_pair=np.concatenate([np.repeat(g["sel"], g["cap"])
                                  for g in out]),
        efc_address=(m.contact_efcadr
                     + np.arange(m.ncon_max) * _rows_per(m)).astype(np.int64),
        pair_geom1=lay.pair_geom1.astype(np.float64),
        pair_geom2=lay.pair_geom2.astype(np.float64),
        pair_condim=lay.pair_condim.astype(np.float64))


def collision(m: Model, d: Data) -> Data:
    """Narrowphase -> candidates -> top-K compaction into the fixed contact
    budget.  All primitive groups process all their pairs."""
    if m.npair == 0 or m.ncon_max == 0:
        return d
    dtype = d.qpos.dtype
    B = d.qpos.shape[0]
    BIG = 1e9
    plan = m.layout.const("collision", lambda: _plan_np(m), dtype)

    body_act = d.body_active
    sizes = d.geom_size.to(dtype)
    margin_all = m.pair_margin.to(dtype)
    if m.opt.override_contacts:
        # mjENBL_OVERRIDE: o_margin replaces every pair's margin
        margin_all = m.opt.o_margin.to(dtype).expand(margin_all.shape)

    blk_dist, blk_pos, blk_nrm, blk_act = [], [], [], []
    for g in plan["groups"]:
        g1, g2 = g["g1"], g["g2"]
        p1, R1 = d.geom_xpos[:, g1], d.geom_xmat[:, g1]
        p2, R2 = d.geom_xpos[:, g2], d.geom_xmat[:, g2]
        s1 = sizes[:, g1]
        s2 = sizes[:, g2]
        dist, pos, nrm = _DISPATCH[g["key"]](p1, R1, s1, p2, R2, s2)
        marg = margin_all[g["sel"]][..., None]
        act = dist < marg
        act = act & body_act[:, g["b1"]][..., None] & body_act[:, g["b2"]][
            ..., None]
        blk_dist.append(dist.reshape(B, -1))
        blk_pos.append(pos.reshape(B, -1, 3))
        blk_nrm.append(nrm.reshape(B, -1, 3))
        blk_act.append(act.reshape(B, -1))

    cand_dist = torch.cat(blk_dist, dim=1)
    cand_pos = torch.cat(blk_pos, dim=1)
    cand_nrm = torch.cat(blk_nrm, dim=1)
    cand_act = torch.cat(blk_act, dim=1)
    assert cand_dist.shape[1] == m.ncand

    # per-candidate pair attributes: primitive groups have STATIC pair ids
    npair_ = m.npair
    if m.opt.override_contacts:
        # mjENBL_OVERRIDE: o_margin/o_solref/o_solimp replace the mixed
        # per-pair contact parameters (gap is not overridden)
        marg_col = (m.opt.o_margin.to(dtype).expand(npair_)
                    - m.pair_gap.to(dtype))[:, None]
        solref_cols = m.opt.o_solref.to(dtype).expand(npair_, 2)
        solimp_cols = m.opt.o_solimp.to(dtype).expand(npair_, 5)
    else:
        marg_col = (m.pair_margin - m.pair_gap).to(dtype)[:, None]
        solref_cols = m.pair_solref.to(dtype)
        solimp_cols = m.pair_solimp.to(dtype)
    pair_attrs = torch.cat([
        plan["pair_geom1"][:, None],
        plan["pair_geom2"][:, None],
        marg_col,
        plan["pair_condim"][:, None],
        m.pair_friction.to(dtype),
        solref_cols,
        solimp_cols,
    ], dim=1)                                       # (npair, 4+5+2+5)
    cand_attr = pair_attrs[plan["cand_pair"]]       # (ncand, nattr)

    # ---- compaction into the K contact slots, as ONE one-hot matmul over
    # the candidates.  Two static variants:
    #   small scenes (ncand <= 2K): depth-ordered argmax passes — keeps the
    #     deepest-first slot order;
    #   large scenes: cumulative-rank selection — slot order becomes
    #     candidate order, and if MORE than K candidates are active the
    #     later ones drop.
    # Both rank within each env (the env axis is kept).
    K = m.ncon_max
    act_i = cand_act.to(torch.int32)
    if m.ncand <= 2 * K:
        score = torch.where(cand_act, cand_dist, BIG)
        _, idx = _top_k_small(-score, K)
        oh = idx[..., :, None] == torch.arange(m.ncand, device=idx.device)
        valid = (oh & cand_act[:, None, :]).any(dim=-1)
    else:
        rank = torch.cumsum(act_i, dim=-1) * act_i   # 1..n active, 0 else
        oh = rank[:, None, :] == torch.arange(
            1, K + 1, dtype=torch.int32, device=rank.device)[:, None]
        valid = oh.any(dim=-1)
    ohf = oh.to(dtype)

    dist_k = (ohf @ cand_dist[..., None])[..., 0]
    pos_k = ohf @ cand_pos
    nrm_k = ohf @ cand_nrm
    attr_k = ohf @ cand_attr
    # empty slots got all-zero rows; give them a unit normal and dim 1
    up = torch.zeros_like(nrm_k)
    up[..., 2] = 1.0
    nrm_k = torch.where(valid[..., None], nrm_k, up)
    t1k, t2k = _make_tangents(nrm_k)
    frame = torch.stack([nrm_k, t1k, t2k], dim=-2)

    con = d.contact.replace(
        dist=dist_k,
        pos=pos_k,
        frame=frame,
        active=valid,
        geom1=torch.round(attr_k[..., 0]).to(torch.int32),
        geom2=torch.round(attr_k[..., 1]).to(torch.int32),
        includemargin=attr_k[..., 2],
        dim=torch.clamp(torch.round(attr_k[..., 3]).to(torch.int32), min=1),
        friction=attr_k[..., 4:9],
        solref=attr_k[..., 9:11],
        solimp=attr_k[..., 11:16],
        efc_address=plan["efc_address"].to(torch.int32).expand(B, K),
    )
    ncon = act_i.sum(dim=-1).to(torch.int32)
    return d.replace(contact=con, ncon=ncon)
