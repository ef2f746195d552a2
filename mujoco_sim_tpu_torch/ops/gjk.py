"""Point-vs-convex-hull closest-point query (GJK / Gilbert distance).

Port of mujoco_sim_tpu/ops/gjk.py, batched over arbitrary leading dims.
The hull narrowphase measures a probe point against the hull's face
planes; for points OUTSIDE the hull near an edge/vertex region the
max-plane signed distance UNDERESTIMATES the true Euclidean distance (it
is the distance to the supporting plane, not to the hull), which made
sphere-vs-mesh report phantom penetrations near corners.  This module
computes the exact distance with a 3-slot simplex GJK:

  point_hull_closest(q, verts, mask, enabled) -> (dist, closest_point)

The JAX package's ``lax.while_loop`` (cap 24 iterations) goes through
ops/loops.while_loop over the lanes, with the cap as a per-lane iteration
count in the carry: a finished or disabled lane keeps its state while the
others iterate, and the loop leaves as soon as every lane is done.  Eagerly
that is one host sync an iteration; inside a captured step it is a
conditional WHILE node with its predicate reduced on the card, so a replay
runs only the iterations its lanes need and syncs nowhere.
"""

from __future__ import annotations

import torch

from mujoco_sim_tpu_torch.ops import loops
from mujoco_sim_tpu_torch.ops.math import cross, norm

_EPS = 1e-12
_TOL = 1e-9
_MAX_IT = 24


def _support(verts, mask, d):
    """Masked support vertex along d: first maximum of verts . d."""
    score = (verts * d[..., None, :]).sum(-1)
    score = torch.where(mask > 0.5, score, -1e30)
    i = torch.argmax(score, dim=-1)
    return torch.take_along_dim(
        verts, i[..., None, None].expand(i.shape + (1, 3)), dim=-2)[..., 0, :]


def _closest_on_segment(q, a, b):
    d = b - a
    t = ((q - a) * d).sum(-1) / torch.clamp((d * d).sum(-1), min=_EPS)
    return a + torch.clamp(t, 0.0, 1.0)[..., None] * d


def _closest_on_triangle(q, a, b, c):
    """Closest point to q on triangle abc, branchless min-over-candidates:
    the three clamped edge projections plus the (validity-gated) interior
    plane projection.  Distance-based selection cannot misroute on the
    exactly-zero region determinants of degenerate (duplicate-vertex)
    triangles; argmin takes the lowest candidate index on ties."""
    p_ab = _closest_on_segment(q, a, b)
    p_ac = _closest_on_segment(q, a, c)
    p_bc = _closest_on_segment(q, b, c)
    n = cross(b - a, c - a)
    nn = (n * n).sum(-1)
    qa = q - a
    p_in = q - n * ((n * qa).sum(-1) / torch.clamp(nn, min=_EPS))[..., None]
    # interior validity: real triangle + projection inside (barycentric
    # via signed sub-areas against the face normal)
    u = (cross(c - b, q - b) * n).sum(-1)
    v = (cross(a - c, q - c) * n).sum(-1)
    w = (cross(b - a, q - a) * n).sum(-1)
    ok_in = (nn > _EPS) & (u >= 0.0) & (v >= 0.0) & (w >= 0.0)
    cands = torch.stack([p_ab, p_ac, p_bc, p_in], dim=-2)     # (..., 4, 3)
    dists = norm(q[..., None, :] - cands)
    dists = torch.cat([dists[..., :3],
                       torch.where(ok_in, dists[..., 3], torch.inf)[..., None]],
                      dim=-1)
    k = torch.argmin(dists, dim=-1)
    p = torch.take_along_dim(
        cands, k[..., None, None].expand(k.shape + (1, 3)), dim=-2)[..., 0, :]
    return p, dists.amin(dim=-1)


def _center(verts, mask):
    w = torch.clamp(mask.sum(-1), min=1.0)
    return (verts * mask[..., :, None]).sum(-2) / w[..., None]


def point_hull_closest(q, verts, mask, enabled=None):
    """(dist, point): Euclidean distance from q (..., 3) to the masked
    vertex cloud's convex hull (verts (..., V, 3), mask (..., V)) and the
    closest hull point.  Exact for points outside; for q inside the hull
    returns dist ~0 at some boundary-ish point (callers gate on the
    face-plane sdf to detect containment).

    enabled: optional bool (...,); disabled lanes never iterate and return
    their initial support point (callers mask)."""
    lead = torch.broadcast_shapes(q.shape[:-1], verts.shape[:-2])
    q = q.expand(lead + (3,))
    verts = verts.expand(lead + verts.shape[-2:])
    mask = mask.expand(lead + mask.shape[-1:])

    s0 = _support(verts, mask, q - _center(verts, mask))
    # simplex slots start collapsed on s0; duplicates are handled by the
    # degeneracy-guarded triangle routine
    if enabled is None:
        done = torch.zeros(lead, dtype=torch.bool, device=q.device)
    else:
        done = ~enabled.expand(lead)

    def cond(c):
        *_, done, it = c
        return ~done & (it < _MAX_IT)

    def body(c):
        a, b, c_, p_best, d_best, _, it = c
        d = q - p_best
        dn = torch.clamp(norm(d), min=_EPS)
        w = _support(verts, mask, d)
        # duality gap: the support plane through w bounds the hull, so
        # the distance improvement left is at most (d/|d|).(w - p)
        gap = (d * (w - p_best)).sum(-1) / dn
        done_new = (gap < _TOL) | (dn <= 2 * _EPS)
        # the new simplex is the best of the three triangles containing w
        p1, _ = _closest_on_triangle(q, a, b, w)
        p2, _ = _closest_on_triangle(q, a, c_, w)
        p3, _ = _closest_on_triangle(q, b, c_, w)
        n1 = norm(q - p1)
        n2 = norm(q - p2)
        n3 = norm(q - p3)
        # argmin tie-breaking (lowest index): a strict-< pick stalled on
        # exact ties, re-selecting the degenerate (a,b,w) triangle forever
        k = torch.argmin(torch.stack([n1, n2, n3], dim=-1), dim=-1)
        pick2 = (k == 1)[..., None]
        pick3 = (k == 2)[..., None]
        a2 = torch.where(pick3, b, a)
        b2 = torch.where(pick2 | pick3, c_, b)
        p_new = torch.where(pick2, p2, torch.where(pick3, p3, p1))
        d_new = torch.minimum(torch.minimum(n1, n2), n3)
        better = d_new < d_best
        p_best = torch.where(better[..., None], p_new, p_best)
        d_best = torch.where(better, d_new, d_best)
        return a2, b2, w, p_best, d_best, done_new, it + 1

    _, _, _, p_best, d_best, _, _ = loops.while_loop(cond, body, (
        s0, s0, s0, s0, norm(q - s0), done,
        torch.zeros(lead, dtype=torch.int32, device=q.device)))
    return d_best, p_best
