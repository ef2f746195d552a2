"""Collision: static pair list + batched primitive narrowphase.

Port of mujoco_sim_tpu/ops/collision.py.  Broadphase is compile-time: the
candidate pair list is frozen in the model (models/compile.py), and every
pair owns fixed contact slots so shapes never change.  Narrowphase runs
vectorized per pair-type group over (env, pair) leading axes; inactive
slots are masked, not absent.  Primitive groups process all their pairs;
hull groups (sphere/capsule/box/mesh against a convex mesh or a cylinder
prism) prefilter to the top-P closest pairs per env.

Where the JAX package selects rows with one-hot matmuls (a TPU workaround
for slow gathers), index gathers do the same here; a slot that selected
nothing reads zeros, as the all-zero one-hot row did.  The hull queries
``hull_ref_face_depth`` (ops/hull_sat.py) and the exact MTV of the
deep-pair manifold (ops/mtv_query.py via ops/manifold.py) are hand-written
CUDA kernels on the card.  No gate asks the host: the top-P fallback and
the deep-pair manifold are always computed and selected with
``torch.where``.

Heightfield pairs probe points of the other geom against the grid's
triangulated surface; the height table is read as one flat (nhfield,
nrow * ncol) tensor with per-(env, pair, point) indices, never copied per
env.

Contact frame convention matches MuJoCo: normal points from geom1 to geom2,
frame rows = [normal, tangent1, tangent2], pos = midpoint between surfaces.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from mujoco_sim_tpu_torch.models.model import (Model, Data, GeomType,
                                                contact_rows_per)
from mujoco_sim_tpu_torch.ops import manifold
from mujoco_sim_tpu_torch.ops.gjk import point_hull_closest
from mujoco_sim_tpu_torch.ops.hull_sat import (
    _pts_vs_planes, hull_ref_face_depth, top_k_largest as _top_k_small)
from mujoco_sim_tpu_torch.ops.math import cross, norm


def _rows_per(m: Model) -> int:
    return contact_rows_per(m.max_condim, m.opt.cone)


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


def _pick(vals, idx):
    """vals (..., n) at idx (..., k) -> (..., k)."""
    return torch.take_along_dim(vals, idx, dim=-1)


def _pick_rows(rows, idx):
    """rows (..., n, c) at idx (..., k) -> (..., k, c)."""
    c = rows.shape[-1]
    return torch.take_along_dim(
        rows, idx[..., None].expand(idx.shape + (c,)), dim=-2)


def _rank_slots(score: torch.Tensor, nslot: int) -> torch.Tensor:
    """Indices (..., nslot) of the nslot LARGEST of score (..., n), in
    descending order, ties to the lowest index: what nslot serial
    argmax-and-mask passes pick, computed as one rank count (entry i's
    rank = how many entries come before it) and its inverse permutation.
    No torch.topk / sort: their tie order is not fixed."""
    n = score.shape[-1]
    iota = torch.arange(n, device=score.device)
    a, b = score[..., :, None], score[..., None, :]
    before = (b > a) | ((b == a) & (iota[None, :] < iota[:, None]))
    rank = before.sum(-1)                                    # a permutation
    inv = torch.zeros_like(rank).scatter(-1, rank, iota.expand_as(rank))
    return inv[..., :nslot]


def _plane_mesh(pp, pR, s1, mp, mR, verts, vmask, margin=0.0):
    """<= 3 contacts replicating mjc_PlaneConvex's emission rule: only
    vertices BELOW the plane (+margin) emit; c0 = deepest vertex, c1 =
    below vertex furthest from c0, c2 = below vertex furthest from the
    line (c0, c1).  A flat 4+-vertex resting face thus gets the exact
    3-point support polygon.  verts padded; vmask masks padding."""
    big = 1e9
    n = pR[..., :, 2]
    pts = mp[..., None, :] + _rotate_rows_fwd(mR, verts)
    h = (n[..., None, :] * (pts - pp[..., None, :])).sum(-1)
    h = torch.where(vmask > 0.5, h, big)
    below = h < margin
    nbelow = below.sum(-1)
    # c0: deepest vertex (always computed; act masks it when separated)
    i0 = torch.argmin(h, dim=-1, keepdim=True)
    p0 = _pick_rows(pts, i0)[..., 0, :]
    d0 = _pick(h, i0)[..., 0]
    # c1: furthest below vertex from c0, scanning only STORED indices
    # AFTER c0 (mjc_PlaneConvex's c1 loop starts at i0+1, so a farther
    # below vertex stored BEFORE c0 is never picked)
    dist0 = norm(pts - p0[..., None, :])
    after0 = torch.arange(h.shape[-1], device=h.device) > i0
    below1 = below & after0
    has1 = below1.sum(-1) >= 1
    i1 = torch.argmax(torch.where(below1, dist0, -1.0), dim=-1, keepdim=True)
    p1 = _pick_rows(pts, i1)[..., 0, :]
    d1 = torch.where(has1, _pick(h, i1)[..., 0], big)
    # c2: furthest below vertex from the line (c0, c1)
    u = (p1 - p0) / torch.clamp(norm(p1 - p0, keepdim=True), min=1e-12)
    dv = pts - p0[..., None, :]
    perp = dv - (dv * u[..., None, :]).sum(-1)[..., None] * u[..., None, :]
    i2 = torch.argmax(torch.where(below, norm(perp), -1.0), dim=-1,
                      keepdim=True)
    # c2 needs the (c0, c1) line, so it also needs c1 to exist
    d2 = torch.where((nbelow >= 3) & has1, _pick(h, i2)[..., 0], big)
    dist = torch.stack([d0, d1, d2], dim=-1)
    pos = torch.stack([p0, p1, _pick_rows(pts, i2)[..., 0, :]], dim=-2)
    pos = pos - n[..., None, :] * (0.5 * dist)[..., None]
    nrm = n[..., None, :].expand(pos.shape)
    return dist, pos, nrm


# ---------------------------------------------------------------------------
# Hull (convex mesh) narrowphase: points vs padded face planes.
# Convention reminder: contact normal points geom1 -> geom2; a vertex of
# geom1 penetrating geom2's face F (outward normal nf) gets n = -nf, a vertex
# of geom2 penetrating geom1 gets n = +nf (cf. _box_box SAT orientation).
# ---------------------------------------------------------------------------

def _hull_sdf(pts_local, planes):
    """pts_local (..., k, 3), planes (..., f, 4) -> (sdf (..., k), face idx)."""
    vals = _pts_vs_planes(pts_local, planes)
    return vals.amax(dim=-1), vals.argmax(dim=-1)


def _local_face_normals(planes, fidx):
    """planes (..., f, 4) at fidx (..., k) -> local outward normals
    (..., k, 3)."""
    return _pick_rows(planes, fidx)[..., :3]


def _face_normal_world(R, planes, fidx):
    return _rotate_rows_fwd(R, _local_face_normals(planes, fidx))


def _point_hull_refine(q, sdf, nref_l, verts, planes, vmask,
                       near_window=0.01):
    """Corner/edge-region exact distance for probe points OUTSIDE a hull.

    The max-plane sdf is the distance to the reference face's PLANE; for
    points whose projection leaves the face polygon (edge/vertex Voronoi
    regions) it underestimates the Euclidean hull distance, spawning
    phantom contacts.  Runs the GJK closest-point query (ops/gjk.py) only
    for outside points that are near-contact AND whose face projection
    exits the hull.

    q (..., 3) local probe points, sdf (...,) their max-plane sdf,
    nref_l (..., 3) their reference-face local normal; verts/planes/
    vmask must broadcast against q's batch dims.  near_window bounds the
    plane sdf for which refinement can matter; callers add the probe
    radius (a sphere's plane sdf sits at r + dist).
    Returns (dist (...,), dir (..., 3) unit probe->hull local, enabled).
    """
    qp = q - sdf[..., None] * nref_l
    psdf_qp = _pts_vs_planes(qp[..., None, :], planes)[..., 0, :].amax(-1)
    enabled = (sdf > 0.0) & (psdf_qp > 1e-6) & (sdf < near_window)
    gd, gp = point_hull_closest(q, verts, vmask, enabled)
    direc = (gp - q) / torch.clamp(gd, min=1e-12)[..., None]
    return gd, direc, enabled


def _sphere_mesh(p1, R1, s1, p2, R2, verts2, planes2, vmask2):
    cl0 = (R2 * (p1 - p2)[..., :, None]).sum(-2)    # (..., 3) local center
    cl = cl0[..., None, :]
    sdf, fidx = _hull_sdf(cl, planes2)              # (..., 1)
    r = s1[..., 0:1]
    dist = sdf - r
    n_w = -_face_normal_world(R2, planes2, fidx)
    nref_l = _local_face_normals(planes2, fidx)     # (..., 1, 3)
    gd, gdir_l, en = _point_hull_refine(cl0, sdf[..., 0],
                                        nref_l[..., 0, :],
                                        verts2, planes2, vmask2,
                                        near_window=r[..., 0] + 0.01)
    dist = torch.where(en[..., None], gd[..., None] - r, dist)
    n_w = torch.where(en[..., None, None],
                      _rotate_rows_fwd(R2, gdir_l[..., None, :]), n_w)
    pos = p1[..., None, :] + n_w * (r + 0.5 * dist)[..., None]
    return dist, pos, n_w


def _capsule_mesh(p1, R1, s1, p2, R2, verts2, planes2, vmask2):
    """3 sphere probes along the axis: both ends + the mid point.

    The mid probe supplies side contacts when the capsule lies across a hull
    face/edge; a refinement step slides each probe toward its face's deepest
    axis point, and outside-corner-region probes get the exact GJK hull
    distance (_point_hull_refine: the plane sdf spawned phantom contacts
    there)."""
    axis = R1[..., :, 2]
    hh = s1[..., 1]
    probes = torch.stack([p1 + axis * hh[..., None],
                          p1 - axis * hh[..., None],
                          p1], dim=-2)  # (...,3,3)
    cl = _rotate_rows(R2, probes - p2[..., None, :])
    sdf, fidx = _hull_sdf(cl, planes2)
    # refine: move each probe along the capsule axis to the deepest point
    # against its current face plane (linear in the axis parameter), then
    # re-evaluate the sdf there: catches edge contacts between the probes
    nf = _local_face_normals(planes2, fidx)
    axis_l = (R2 * axis[..., :, None]).sum(-2)          # axis in hull frame
    slope = (nf * axis_l[..., None, :]).sum(-1)         # d sdf / d t
    t0 = torch.stack([hh, -hh, torch.zeros_like(hh)], dim=-1)
    t_ref = torch.minimum(torch.maximum(
        t0 - torch.sign(slope) * hh[..., None], -hh[..., None]),
        hh[..., None])
    cl_ref = cl + axis_l[..., None, :] * (t_ref - t0)[..., None]
    sdf_r, fidx_r = _hull_sdf(cl_ref, planes2)
    better = sdf_r < sdf
    sdf = torch.where(better, sdf_r, sdf)
    fidx = torch.where(better, fidx_r, fidx)
    t_best = torch.where(better, t_ref, t0)
    centers = p1[..., None, :] + axis[..., None, :] * t_best[..., None]
    r = s1[..., 0:1]
    dist = sdf - r
    n_w = -_face_normal_world(R2, planes2, fidx)
    cl_best = torch.where(better[..., None], cl_ref, cl)
    nref_l = _local_face_normals(planes2, fidx)        # (..., 3, 3)
    gd, gdir_l, en = _point_hull_refine(
        cl_best, sdf, nref_l, verts2[..., None, :, :],
        planes2[..., None, :, :], vmask2[..., None, :],
        near_window=r + 0.01)
    dist = torch.where(en, gd - r, dist)
    n_w = torch.where(en[..., None], _rotate_rows_fwd(R2, gdir_l), n_w)
    pos = centers + n_w * (r + 0.5 * dist)[..., None]
    return dist, pos, n_w


def _box_mesh(p1, R1, s1, p2, R2, verts2, planes2, vmask2):
    dtype = p1.dtype
    # box corners vs hull planes (shared reference face)
    pts = p1[..., None, :] + _rotate_rows_fwd(
        R1, _corners(p1) * s1[..., None, :])
    loc2 = _rotate_rows(R2, pts - p2[..., None, :])
    # ops/hull_sat: the CUDA kernel on the card, its twin on the CPU; every
    # operand here is contiguous as built (the kernel's wrapper checks)
    d_a, top, nref, sep_h = hull_ref_face_depth(loc2, planes2, 2)
    pos_a = _pick_rows(pts, top)
    n_a = -((R2 * nref[..., None, :]).sum(-1))[..., None, :]
    n_a = n_a.expand(pos_a.shape)
    # hull verts vs box (point-in-box)
    vw = p2[..., None, :] + _rotate_rows_fwd(R2, verts2)
    loc1 = _rotate_rows(R1, vw - p1[..., None, :])
    # SAT over the BOX's 6 face axes: a separating box face must deactivate
    # the hull-face candidates too (face-only SAT on one hull gave phantom
    # contacts)
    big = 1e9
    real = vmask2[..., :, None] > 0.5
    lo_min = torch.where(real, loc1, big).amin(dim=-2)
    lo_max = torch.where(real, loc1, -big).amax(dim=-2)
    sep_box = torch.maximum(lo_min - s1, -lo_max - s1).amax(dim=-1)
    depth = s1[..., None, :] - loc1.abs()
    pen = depth.amin(dim=-1)           # >0 inside box
    ax = depth.argmin(dim=-1)
    oh_ax = _one_hot(ax, 3, dtype)
    sign = torch.sign((loc1 * oh_ax).sum(-1))
    n_loc = oh_ax * sign[..., None]
    n_w = _rotate_rows_fwd(R1, n_loc)  # outward of box=geom1
    dist_b = torch.where(vmask2 > 0.5, -pen, big)
    neg2, top2 = _top_k_small(-dist_b, 2)
    d_b = -neg2
    pos_b = _pick_rows(vw, top2)
    n_b = _pick_rows(n_w, top2)
    # the pair's true separation is at least max over BOTH face sets;
    # lift the hull-face candidate distances by it (kills phantoms, and
    # sharpens depth to the two-set MTV when penetrating)
    sep = torch.maximum(sep_h, sep_box)
    d_a = torch.maximum(d_a, sep[..., None])
    dist = torch.cat([d_a, d_b], dim=-1)
    pos = torch.cat([pos_a, pos_b], dim=-2)
    nrm = torch.cat([n_a, n_b], dim=-2)
    return dist, pos, nrm


_DEEP_SLOTS = 8     # deep-pair budget: the exact query runs on <= 8 slots


def _mesh_mesh(p1, R1, verts1, planes1, vmask1,
               p2, R2, verts2, planes2, vmask2, extras=None):
    """Leading dims (..., P): P pairs per env.  ``extras`` (the full-hull
    tables, the pairs' hull indices hidA/hidB with -1 for an empty slot,
    and exact_all) switches the deep-pair exact manifold on."""
    # lateral slack = 15% of the other hull's bounding radius: keeps the
    # near-overlap overhang corners that support face-face stacks while
    # rejecting far-away corners (phantom lever arms)
    rb1 = torch.sqrt(((verts1 * verts1).sum(-1) * vmask1).amax(-1))
    rb2 = torch.sqrt(((verts2 * verts2).sum(-1) * vmask2).amax(-1))
    # verts of 1 in hull 2 (shared reference face), and verts of 2 in
    # hull 1: BOTH directions ride ONE ref-face-depth call by stacking
    # along the pair axis (one launch instead of two)
    vw1 = p1[..., None, :] + _rotate_rows_fwd(R1, verts1)
    loc2 = _rotate_rows(R2, vw1 - p2[..., None, :])
    vw2 = p2[..., None, :] + _rotate_rows_fwd(R2, verts2)
    loc1 = _rotate_rows(R1, vw2 - p1[..., None, :])
    locs = torch.cat([loc2, loc1], dim=-3)
    plns = torch.cat([planes2, planes1], dim=-3)
    msks = torch.cat([vmask1, vmask2], dim=-2)
    slk = torch.cat([0.15 * rb2, 0.15 * rb1], dim=-1)
    d2, top2s, nref, sep2 = hull_ref_face_depth(locs, plns, 2, msks,
                                                lateral_filter=True,
                                                lateral_slack=slk)
    P = loc2.shape[-3]
    d_a, d_b = d2[..., :P, :], d2[..., P:, :]
    top, top2 = top2s[..., :P, :], top2s[..., P:, :]
    nref2, nref1 = nref[..., :P, :], nref[..., P:, :]
    sepA, sepB = sep2[..., :P], sep2[..., P:]
    pos_a = _pick_rows(vw1, top)
    n_a = -((R2 * nref2[..., None, :]).sum(-1))
    pos_b = _pick_rows(vw2, top2)
    n_b = (R1 * nref1[..., None, :]).sum(-1)
    # joint face-SAT over BOTH hulls: one separating face on either side
    # deactivates everything (face-only SAT per side gave phantom contacts).
    # ALL manifold points share the joint-MTV normal (the face with the
    # larger min-support), while the losing side's laterally-contained
    # verts are still needed: face-face stacks take their overlap corners
    # from BOTH hulls.
    sep = torch.maximum(sepA, sepB)
    d_a = torch.maximum(d_a, sep[..., None])
    d_b = torch.maximum(d_b, sep[..., None])
    n_mtv = torch.where((sepA >= sepB)[..., None], n_a, n_b)[..., None, :]
    dist = torch.cat([d_a, d_b], dim=-1)
    pos = torch.cat([pos_a, pos_b], dim=-2)
    nrm = n_mtv.expand(pos.shape)
    if extras is None:
        return dist, pos, nrm

    # ---- deep-pair exact manifold.  A penetrating convex pair is
    # resolved by the reference with the exact MTV and a contact-feature
    # manifold; the 2+2 SAT vertex manifolds diverge from that exactly
    # when penetration is deep, so pairs beyond the threshold are replaced
    # by ops/manifold.exact_pair_contacts.
    # Gate on the emitted manifold depth (dist rows), NOT on -sep: the
    # face-only joint SAT cannot prove separation along edge-cross axes,
    # so -sep reads "deep" for corner-region SEPARATED pairs.  The dist
    # rows are the laterally-contained vertex depths: a separated corner
    # pair has no contained verts, so its rows read 1e9 and the gate stays
    # off.  Pairs that DO read deep but are edge-cross-separated still
    # fire the query; its complete-SAT separation certificate (sepd > 0)
    # then CLEARS their phantom SAT rows below.
    depth_sat = -dist.amin(dim=-1)
    deep_thr = torch.clamp(0.25 * torch.minimum(rb1, rb2), max=5e-3)
    if extras["exact_all"]:
        # accuracy mode (opt.exact_meshcollide): oracle-form manifolds for
        # EVERY contacting mesh pair, not just deep ones
        deep_thr = torch.zeros_like(deep_thr)
    use_exact = depth_sat > deep_thr

    # ---- deep-pair COMPACTION: the exact query is expensive per lane and
    # deep pairs are rare, so the deepest <= D are compacted into D slots,
    # queried there, and scattered back; overflow pairs keep the SAT
    # manifold.  The D slots are always computed (no host round trip to
    # ask whether any pair is deep); an empty slot is a disabled lane.
    D = min(_DEEP_SLOTS, P)
    score = torch.where(use_exact, depth_sat, -torch.inf)
    k = _rank_slots(score, D)                                # (..., D)
    en = torch.isfinite(_pick(score, k))                     # slot in use

    def sel(x):
        g = torch.take_along_dim(
            x, k.reshape(k.shape + (1,) * (x.dim() - k.dim())).expand(
                k.shape + x.shape[k.dim():]), dim=k.dim() - 1)
        return torch.where(en.reshape(en.shape + (1,) * (x.dim() - k.dim())),
                           g, 0.0)

    # full-fidelity hull tables (vert_hi): decimation error rotates the
    # exact MTV at deep penetration
    hidA = torch.where(en, _pick(extras["hidA"], k), -1)
    hidB = torch.where(en, _pick(extras["hidB"], k), -1)
    cyl = extras["cyl"]
    d4, p4, n1, ok, sepd = manifold.exact_pair_contacts(
        sel(p1), sel(R1), hidA, manifold.gather_hull(hidA, cyl),
        sel(p2), sel(R2), hidB, manifold.gather_hull(hidB, cyl),
        en, extras["tables"])
    # scatter back to pair slots: OH[..., d, p] = slot d holds pair p
    OH = ((k[..., :, None] == torch.arange(P, device=k.device))
          & en[..., :, None])
    OHt = OH.transpose(-1, -2).to(dist.dtype)                # (..., P, D)
    hit = (OH & ok[..., :, None]).any(dim=-2)                # (..., P)
    d_x = OHt @ torch.where(ok[..., None], d4, 0.0)
    p_x = (OHt @ torch.where(ok[..., None, None], p4, 0.0).reshape(
        p4.shape[:-2] + (12,))).reshape(hit.shape + (4, 3))
    n_x = OHt @ torch.where(ok[..., None], n1, 0.0)
    # separation certificate: the complete SAT proved the pair separated
    # even though the contained-vertex rows read deep (edge-cross-region
    # phantoms): raise the phantom rows to the certified separation lower
    # bound (positive => inactive; a margin-activated row keeps a sound
    # positive dist)
    sep_x = (OHt @ sepd[..., None])[..., 0]                  # (..., P)
    dist = torch.where((sep_x > 0.0)[..., None],
                       torch.maximum(dist, sep_x[..., None]), dist)
    dist = torch.where(hit[..., None], d_x, dist)
    pos = torch.where(hit[..., None, None], p_x, pos)
    nrm = torch.where(hit[..., None, None], n_x[..., None, :], nrm)
    return dist, pos, nrm


# primitive dispatch: (type1, type2) -> (narrowphase fn, needs geom2 verts)
_DISPATCH = {
    (GeomType.PLANE, GeomType.SPHERE): (_plane_sphere, False),
    (GeomType.PLANE, GeomType.CAPSULE): (_plane_capsule, False),
    (GeomType.PLANE, GeomType.BOX): (_plane_box, False),
    (GeomType.PLANE, GeomType.CYLINDER): (_plane_cylinder, False),
    (GeomType.PLANE, GeomType.ELLIPSOID): (_plane_ellipsoid, False),
    (GeomType.PLANE, GeomType.MESH): (_plane_mesh, True),
    (GeomType.SPHERE, GeomType.SPHERE): (_sphere_sphere, False),
    (GeomType.SPHERE, GeomType.CAPSULE): (_sphere_capsule, False),
    (GeomType.SPHERE, GeomType.BOX): (_sphere_box, False),
    (GeomType.CAPSULE, GeomType.CAPSULE): (_capsule_capsule, False),
    (GeomType.CAPSULE, GeomType.BOX): (_capsule_box, False),
    (GeomType.BOX, GeomType.BOX): (_box_box, False),
}

# ---------------------------------------------------------------------------
# Heightfield narrowphase: probe points against the triangulated surface.
# Grid layout (the JAX package's, probed against MuJoCo): data row 0 =
# min-y, each cell split along the (low,low)->(high,high) diagonal, point
# depth measured against the triangle's plane.  ``hf`` carries the group's
# static tables: the flat height table (nhfield, R * C) with its padded
# row length C, and per pair (P,) the hfield id, nrow, ncol and size (P, 4).
# ---------------------------------------------------------------------------

def _hfield_point_dist(hf, pts):
    """pts (B, P, k, 3) in the hfield's LOCAL frame -> (dist (B, P, k),
    normal (B, P, k, 3) local)."""
    size = hf["size"]
    rx = size[:, None, 0]
    ry = size[:, None, 1]
    zt = size[:, None, 2]
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    nr = hf["nrow"][:, None]
    nc = hf["ncol"][:, None]
    gx = (x + rx) / (2.0 * rx) * (nc - 1.0)
    gy = (y + ry) / (2.0 * ry) * (nr - 1.0)
    i0 = torch.minimum(torch.clamp(torch.floor(gx), min=0.0), nc - 2.0)
    j0 = torch.minimum(torch.clamp(torch.floor(gy), min=0.0), nr - 2.0)
    fx = gx - i0
    fy = gy - j0
    i0 = i0.long()
    j0 = j0.long()
    C_ = hf["C"]
    hid = hf["hid"][:, None]

    def take(jj, ii):
        return hf["flat"][hid, jj * C_ + ii] * zt

    z00 = take(j0, i0)
    z10 = take(j0, i0 + 1)
    z01 = take(j0 + 1, i0)
    z11 = take(j0 + 1, i0 + 1)
    lowtri = fx >= fy                      # (low,low)-(high,high) diagonal
    surf = torch.where(lowtri,
                       z00 + fx * (z10 - z00) + fy * (z11 - z10),
                       z00 + fx * (z11 - z01) + fy * (z01 - z00))
    cw = 2.0 * rx / (nc - 1.0)             # world cell extents
    ch = 2.0 * ry / (nr - 1.0)
    dzdx = torch.where(lowtri, z10 - z00, z11 - z01) / cw
    dzdy = torch.where(lowtri, z11 - z10, z01 - z00) / ch
    n = torch.stack([-dzdx, -dzdy, torch.ones_like(dzdx)], dim=-1)
    n = n / torch.linalg.norm(n, dim=-1, keepdim=True)
    dist = (z - surf) * n[..., 2]          # signed distance to the plane
    inside = (x.abs() <= rx) & (y.abs() <= ry)
    return torch.where(inside, dist, 1e9), n


def _hfield_probe(hp, hR, hf, pts_world, radius):
    """shared tail: world probe points with an inflation radius ->
    (dist, pos, nrm) world."""
    loc = _rotate_rows(hR, pts_world - hp[..., None, :])
    dist, n_loc = _hfield_point_dist(hf, loc)
    nrm = _rotate_rows_fwd(hR, n_loc)
    dist = dist - radius
    pos = pts_world - nrm * (radius + 0.5 * dist)[..., None]
    return dist, pos, nrm


def _hfield_sphere(hp, hR, hf, sp, sR, size2):
    return _hfield_probe(hp, hR, hf, sp[..., None, :], size2[..., 0:1])


def _hfield_capsule(hp, hR, hf, cp, cR, size2):
    axis = cR[..., :, 2]
    r = size2[..., 0:1]
    hh = size2[..., 1:2]
    ends = torch.stack([cp + axis * hh, cp - axis * hh, cp], dim=-2)
    return _hfield_probe(hp, hR, hf, ends, r)


def _hfield_ellipsoid(hp, hR, hf, ep, eR, size2):
    # support point along the hfield's -z axis (plane-ellipsoid style)
    up = hR[..., :, 2]
    u_loc = (eR * up[..., :, None]).sum(-2)                  # R2^T up
    s = size2
    denom = torch.sqrt(((s * u_loc) ** 2).sum(-1) + 1e-30)
    p_loc = -(s * s * u_loc) / denom[..., None]
    p = ep + (eR * p_loc[..., None, :]).sum(-1)
    return _hfield_probe(hp, hR, hf, p[..., None, :],
                         torch.zeros_like(s[..., 0:1]))


def _pick4(d, pos, nrm):
    """The four deepest probes, ties to the lowest index (a rank count,
    never torch.topk)."""
    idx = _rank_slots(-d, 4)
    return _pick(d, idx), _pick_rows(pos, idx), _pick_rows(nrm, idx)


def _hfield_box(hp, hR, hf, bp, bR, size2):
    corners = _corners(bp)                                   # (8, 3)
    pw = bp[..., None, :] + _rotate_rows_fwd(bR, corners * size2[..., None, :])
    d, pos, nrm = _hfield_probe(hp, hR, hf, pw,
                                torch.zeros_like(size2[..., 0:1]))
    return _pick4(d, pos, nrm)


def _hfield_mesh(hp, hR, hf, mp, mR, verts, vmask):
    pw = mp[..., None, :] + _rotate_rows_fwd(mR, verts)
    d, pos, nrm = _hfield_probe(hp, hR, hf, pw,
                                torch.zeros_like(mp[..., 0:1]))
    d = torch.where(vmask > 0.5, d, 1e9)
    return _pick4(d, pos, nrm)


_DISPATCH_HF = {
    (GeomType.HFIELD, GeomType.SPHERE): (_hfield_sphere, False),
    (GeomType.HFIELD, GeomType.CAPSULE): (_hfield_capsule, False),
    (GeomType.HFIELD, GeomType.ELLIPSOID): (_hfield_ellipsoid, False),
    (GeomType.HFIELD, GeomType.BOX): (_hfield_box, False),
    (GeomType.HFIELD, GeomType.MESH): (_hfield_mesh, True),
}

# hull dispatch (two-level top-P groups): needs planes of geom2 (+1 for m-m)
_DISPATCH_MESH = {
    (GeomType.SPHERE, GeomType.MESH): _sphere_mesh,
    (GeomType.CAPSULE, GeomType.MESH): _capsule_mesh,
    (GeomType.BOX, GeomType.MESH): _box_mesh,
    (GeomType.MESH, GeomType.MESH): _mesh_mesh,
}


def _geom_aabb_static(m: Model):
    """Static per-geom local AABB pieces for the mesh-group prefilter.

    Returns numpy (aabb_c (ngeom, 3) local center, C (ngeom, 3, 3) such
    that the dynamic half extents are C @ geom_size + base (spawn-time
    size overrides ride through d.geom_size), base (ngeom, 3)).  Hull-
    backed geoms (mesh, cylinder prisms) take the FULL undecimated hull
    AABB: the candidate SAT runs on the decimated hulls (subsets), so a
    full-hull AABB prune can never drop a pair the SAT could activate.
    Types that never reach a mesh group (plane, hfield) get huge extents.
    """
    lay = m.layout
    ngeom = m.ngeom
    aabb_c = np.zeros((ngeom, 3))
    C = np.zeros((ngeom, 3, 3))
    base = np.zeros((ngeom, 3))
    hull_aabb = np.asarray(lay.hull_aabb)      # static (nhull, 2, 3)
    for g0 in range(ngeom):
        t = GeomType(int(lay.geom_type[g0]))
        h = int(lay.geom_hullid[g0])
        if t in (GeomType.MESH, GeomType.CYLINDER) and h >= 0:
            aabb_c[g0] = hull_aabb[h, 0]
            base[g0] = hull_aabb[h, 1]
        elif t == GeomType.SPHERE:
            C[g0, :, 0] = 1.0
        elif t == GeomType.CAPSULE:
            C[g0, :, 0] = 1.0
            C[g0, 2, 1] = 1.0
        elif t == GeomType.CYLINDER:
            C[g0, 0, 0] = C[g0, 1, 0] = C[g0, 2, 1] = 1.0
        elif t in (GeomType.BOX, GeomType.ELLIPSOID):
            C[g0] = np.eye(3)
        else:
            base[g0] = 1e9
    return aabb_c, C, base


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
    any_hull = False
    for g in groups:
        assert g.cand_adr == cursor, (g.cand_adr, cursor)
        cursor += g.ncand
        hull = g.key in EXPENSIVE
        any_hull |= hull
        assert hull or g.key in _DISPATCH or g.key in _DISPATCH_HF, g.key
        sel = g.pair_idx
        g1 = lay.pair_geom1[sel]
        g2 = lay.pair_geom2[sel]
        grp = dict(key=g.key, hull=hull, sel=sel, cap=g.cap,
                   top_p=g.top_p, g1=g1, g2=g2,
                   b1=lay.geom_bodyid[g1], b2=lay.geom_bodyid[g2],
                   h2=lay.geom_hullid[g2].astype(np.int64))
        if g.key[0] == GeomType.HFIELD:
            hid = lay.geom_hfieldid[g1].astype(np.int64)
            # grid counts are static per pair
            grp.update(hfid=hid, hf_nrow=lay.hf_nrow[hid].astype(np.float64),
                       hf_ncol=lay.hf_ncol[hid].astype(np.float64))
        out.append(grp)
    plan = dict(
        groups=out,
        efc_address=(m.contact_efcadr
                     + np.arange(m.ncon_max) * _rows_per(m)).astype(np.int64),
        pair_geom1=lay.pair_geom1.astype(np.float64),
        pair_geom2=lay.pair_geom2.astype(np.float64),
        pair_condim=lay.pair_condim.astype(np.float64))
    if any_hull:
        aabb_c, aabb_C, aabb_base = _geom_aabb_static(m)
        plan.update(aabb_c=aabb_c, aabb_C=aabb_C, aabb_base=aabb_base,
                    geom_hullid=lay.geom_hullid.astype(np.int64),
                    geom_bodyid=lay.geom_bodyid.astype(np.int64))
    else:
        # every group narrowphases all its pairs: static candidate -> pair
        plan["cand_pair"] = np.concatenate(
            [np.repeat(g["sel"], g["cap"]) for g in out])
    return plan


def _select_pairs(g, B, geom_cw, geom_ew, rbound, body_act, mrg):
    """Which pair each of a hull group's P slots narrowphases, per env:
    (idx (B, P) into the group's pair list, valid (B, P)).

    A pair can only activate if its TRUE distance < margin; the world-AABB
    per-axis gap lower-bounds true distance, so AABB-separated pairs are
    pruned outright.  The survivors (typically << P) are rank-compacted
    into the P slots in candidate order (the solver is order-invariant).
    Only an env where MORE than P survive takes the deepest-first top-P by
    bound distance instead; both selections are computed and chosen per
    env, without asking the host."""
    P, npg = g["top_p"], g["sel"].shape[0]
    dev = geom_cw.device
    if P >= npg:
        # every pair owns a slot: selection is the identity
        return (torch.arange(npg, device=dev).expand(B, npg),
                torch.ones((B, npg), dtype=torch.bool, device=dev))
    pg1, pg2 = g["g1"], g["g2"]
    c1, c2 = geom_cw[:, pg1], geom_cw[:, pg2]
    gap = (c2 - c1).abs() - (geom_ew[:, pg1] + geom_ew[:, pg2])
    alive = body_act[:, g["b1"]] & body_act[:, g["b2"]]
    active = (gap < mrg[:, None]).all(dim=-1) & alive          # (B, npg)
    act_i = active.to(torch.long)
    cnt = act_i.sum(-1, keepdim=True)
    ranks = torch.cumsum(act_i, dim=-1) * act_i      # 1..cnt active, 0 else
    iota = torch.arange(npg, device=dev)
    # slot j <- the pair of rank j + 1 (position 0 collects the inactive)
    inv = torch.zeros((B, npg + 1), dtype=torch.long, device=dev).scatter(
        -1, ranks, iota.expand(B, npg))
    slot = torch.arange(1, P + 1, device=dev)
    valid_fast = slot <= cnt
    idx_fast = torch.where(valid_fast, inv[:, 1:P + 1], 0)
    bd = norm(c2 - c1) - rbound[:, pg1] - rbound[:, pg2] - mrg
    idx_top = _rank_slots(-torch.where(active, bd, 1e9), P)
    over = cnt > P
    return torch.where(over, idx_top, idx_fast), over | valid_fast


def collision(m: Model, d: Data) -> Data:
    """Narrowphase -> candidates -> top-K compaction into the fixed contact
    budget.  Primitive groups process all pairs; hull groups prefilter to
    the top-P closest pairs by bound distance (two-level, shapes static)."""
    if m.npair == 0 or m.ncon_max == 0:
        return d
    dtype = d.qpos.dtype
    B = d.qpos.shape[0]
    BIG = 1e9
    plan = m.layout.const("collision", lambda: _plan_np(m), dtype)
    any_hull = "aabb_c" in plan

    body_act = d.body_active
    sizes = d.geom_size.to(dtype)
    margin_all = m.pair_margin.to(dtype)
    if m.opt.override_contacts:
        # mjENBL_OVERRIDE: o_margin replaces every pair's margin
        margin_all = m.opt.o_margin.to(dtype).expand(margin_all.shape)

    # per-candidate pair attributes: [geom1, geom2, margin - gap, condim,
    # friction(5), solref(2), solimp(5)] per pair
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

    if any_hull:
        # per-geom dynamic payload shared by every hull group:
        # [xpos(3) | xmat(9) | size(3)], and the world AABB of every geom
        # for the prefilter
        geom_pay = torch.cat([d.geom_xpos, d.geom_xmat.reshape(B, m.ngeom, 9),
                              sizes], dim=-1)
        geom_alive = body_act[:, plan["geom_bodyid"]]
        half = ((plan["aabb_C"] * sizes[:, :, None, :]).sum(-1)
                + plan["aabb_base"])
        geom_ew = (d.geom_xmat.abs() * half[:, :, None, :]).sum(-1)
        geom_cw = d.geom_xpos + (d.geom_xmat
                                 * plan["aabb_c"][:, None, :]).sum(-1)
        rbound = d.geom_rbound.to(dtype)
        vert_pad = m.mesh_vert_pad.to(dtype)
        face_pad = m.mesh_face_pad.to(dtype)
        vert_mask = m.mesh_vert_mask.to(dtype)

    blk_dist, blk_pos, blk_nrm, blk_act, blk_attr = [], [], [], [], []
    for g in plan["groups"]:
        g1, g2 = g["g1"], g["g2"]
        cap = g["cap"]
        mrg = margin_all[g["sel"]]
        if not g["hull"]:
            p1, R1 = d.geom_xpos[:, g1], d.geom_xmat[:, g1]
            p2, R2 = d.geom_xpos[:, g2], d.geom_xmat[:, g2]
            s1 = sizes[:, g1]
            s2 = sizes[:, g2]
            if g["key"][0] == GeomType.HFIELD:
                fn, needs_mesh = _DISPATCH_HF[g["key"]]
                hdata = m.hfield_data.to(dtype)        # (nhfield, R, C)
                hf = dict(flat=hdata.reshape(hdata.shape[0], -1),
                          C=hdata.shape[-1], hid=g["hfid"],
                          nrow=g["hf_nrow"], ncol=g["hf_ncol"],
                          size=m.hfield_size.to(dtype)[g["hfid"]])
                if needs_mesh:
                    dist, pos, nrm = fn(p1, R1, hf, p2, R2,
                                        m.mesh_vert_pad.to(dtype)[g["h2"]],
                                        m.mesh_vert_mask.to(dtype)[g["h2"]])
                else:
                    dist, pos, nrm = fn(p1, R1, hf, p2, R2, s2)
            else:
                fn, needs_mesh = _DISPATCH[g["key"]]
                if needs_mesh:
                    # mjc_PlaneConvex's below-plane test includes the pair
                    # margin
                    dist, pos, nrm = fn(p1, R1, s1, p2, R2,
                                        m.mesh_vert_pad.to(dtype)[g["h2"]],
                                        m.mesh_vert_mask.to(dtype)[g["h2"]],
                                        margin=mrg[:, None])
                else:
                    dist, pos, nrm = fn(p1, R1, s1, p2, R2, s2)
            act = dist < mrg[..., None]
            act = act & body_act[:, g["b1"]][..., None] & body_act[
                :, g["b2"]][..., None]
            if any_hull:
                blk_attr.append(pair_attrs[g["sel"]].repeat_interleave(
                    cap, dim=0).expand(B, -1, -1))
        else:
            idx, valid = _select_pairs(g, B, geom_cw, geom_ew, rbound,
                                       body_act, mrg)
            P = idx.shape[1]
            g1s, g2s = g1[idx], g2[idx]                       # (B, P)
            v1 = valid[..., None]

            def payload(gs):
                pay = torch.where(v1, torch.take_along_dim(
                    geom_pay, gs[..., None], dim=1), 0.0)
                alive = valid & torch.take_along_dim(geom_alive, gs, dim=1)
                return (pay[..., 0:3], pay[..., 3:12].reshape(B, P, 3, 3),
                        pay[..., 12:15], alive)

            def hull_tables(gs):
                hid = torch.where(valid, plan["geom_hullid"][gs], -1)
                return (hid,) + tuple(manifold.gather_hull(hid, t)
                                      for t in (vert_pad, face_pad,
                                                vert_mask))

            p1, R1, s1, alive1 = payload(g1s)
            p2, R2, _, alive2 = payload(g2s)
            marg = torch.where(valid, mrg[idx], 0.0)[..., None]
            hidB, verts2, planes2, vmask2 = hull_tables(g2s)
            fn = _DISPATCH_MESH[g["key"]]
            if fn is _mesh_mesh:
                hidA, verts1, planes1, vmask1 = hull_tables(g1s)
                # full-hull merged-face/edge tables for the deep-pair
                # exact manifold, gathered per deep slot inside it
                extras = dict(
                    tables=dict(vert=m.mesh_vert_hi.to(dtype),
                                vmask=m.mesh_vert_hi_mask.to(dtype),
                                fplane=m.mesh_fplane.to(dtype),
                                fmask=m.mesh_fmask.to(dtype),
                                fpoly=m.mesh_fpoly.to(dtype),
                                hedge=m.mesh_hedge.to(dtype),
                                hemask=m.mesh_hedge_mask.to(dtype)),
                    cyl=m.mesh_cyl.to(dtype), hidA=hidA, hidB=hidB,
                    exact_all=bool(m.opt.exact_meshcollide))
                dist, pos, nrm = fn(p1, R1, verts1, planes1, vmask1,
                                    p2, R2, verts2, planes2, vmask2,
                                    extras=extras)
            else:
                dist, pos, nrm = fn(p1, R1, s1, p2, R2, verts2, planes2,
                                    vmask2)
            act = (dist < marg) & (alive1 & alive2)[..., None]
            # the selected pairs' attributes, one row per candidate
            blk_attr.append(torch.where(
                v1, pair_attrs[g["sel"]][idx], 0.0).repeat_interleave(
                    cap, dim=1))
        blk_dist.append(dist.reshape(B, -1))
        blk_pos.append(pos.reshape(B, -1, 3))
        blk_nrm.append(nrm.reshape(B, -1, 3))
        blk_act.append(act.reshape(B, -1))

    cand_dist = torch.cat(blk_dist, dim=1)
    cand_pos = torch.cat(blk_pos, dim=1)
    cand_nrm = torch.cat(blk_nrm, dim=1)
    cand_act = torch.cat(blk_act, dim=1)
    assert cand_dist.shape[1] == m.ncand
    if any_hull:
        cand_attr = torch.cat(blk_attr, dim=1)          # (B, ncand, nattr)
    else:
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
    up[..., 2].fill_(1.0)
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
