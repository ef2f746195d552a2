"""Exact-MTV + feature-clip contact manifolds for deep convex pairs.

Port of mujoco_sim_tpu/ops/manifold.py, batched over arbitrary leading
lane dims (the JAX package vmaps a per-pair query).

MuJoCo 3.x's native narrowphase resolves a penetrating convex pair with
GJK/EPA (exact minimum-translation vector) and emits a multi-point
manifold by re-running the query under small (~1e-3 rad) tilts of the
pair ("multiCCD").  That lands on the corners of the CONTACT-FEATURE
INTERSECTION:

  face-face   -> up to 4 overlap-polygon corners
  edge-face   -> the clipped segment endpoints
  edge-edge   -> crossing point (or overlap endpoints when parallel)
  vertex-*    -> the single EPA witness point

with every point sharing the unperturbed penetration depth and the EPA
normal, positioned on the mid-surface plane.

The exact MTV comes from ops/mtv_query.py (a complete separating-axis
scan: face normals of both hulls, then edge-cross refinement rounds; the
hand-written CUDA kernel on the card).  The feature-clip stage classifies
each hull's contact feature (verts within ~1e-3*rbound of its support
plane along the MTV), represents it as an ordered polygon (the hull's
merged-face polygon when a face aligns, a thin rectangle around the
extreme-vertex segment otherwise), intersects the two projected features
(vectorized corner set: verts-inside + edge crossings, the exact
Sutherland-Hodgman vertex set without its sequential clip passes), and
reduces the intersection to <= 4 spread points.

Nothing here asks the host: the query is computed for every lane it is
given and disabled lanes are replaced by the miss tuple with
``torch.where`` (callers compact the few deep pairs into a few lanes).
"""

from __future__ import annotations

import torch

from mujoco_sim_tpu_torch.ops import mtv_query as mtv_mod
from mujoco_sim_tpu_torch.ops import support_minmax as support_mod
from mujoco_sim_tpu_torch.ops.math import cross, norm

# feature window as a fraction of hull bounding radius (the ~1e-3 rad
# multiCCD tilt; calibrated on cube probes: 0.05 deg tilt keeps the face
# feature, 0.1 deg drops it)
_FEAT_WINDOW = 1.5e-3
# a hull face only carries the ordered-polygon feature when its normal
# is within ~5e-3 rad of the MTV axis
_COS_FACE = 1.0 - 1.25e-5


def _rot(R, pts):
    """local->world rotate (..., 3, 3) x (..., k, 3) -> (..., k, 3)."""
    return (R[..., None, :, :] * pts[..., :, None, :]).sum(-1)


def _cross2(a, b):
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def _pick_rows(rows, idx):
    """rows (..., n, k) at idx (...,) -> (..., k)."""
    k = rows.shape[-1]
    return torch.take_along_dim(
        rows, idx[..., None, None].expand(idx.shape + (1, k)),
        dim=-2)[..., 0, :]


def _masked_max(x, m):
    return torch.where(m, x, -torch.inf).amax(dim=-1)


def _masked_min(x, m):
    return torch.where(m, x, torch.inf).amin(dim=-1)


def _staged_scan(axes, w):
    """Support scan of the staged query: the support_minmax kernel for
    CUDA tensors with at least 32 axes, the plain product otherwise."""
    if axes.shape[-2] >= 32:
        return support_mod.support_minmax(axes.contiguous(), w.contiguous())
    return support_mod.support_minmax_plain(axes, w)


def mtv_staged(wA, wB, heA, heB, hmA, hmB, nfA, nfB, fmA, fmB,
               RA, RB, pA, pB, cylA, cylB, K=mtv_mod.K_EDGE,
               rounds=mtv_mod.REFINE_ROUNDS):
    """The exact-MTV query of ops/mtv_query.mtv_query computed stage by
    stage in tensor ops, with every wide support scan (the coarse face
    axes and each round's K*K cross axes) going through
    ops/support_minmax.support_minmax.  Same arguments and result as
    mtv_query; engine.step does not call it."""
    return mtv_mod.mtv_rounds(wA, wB, heA, heB, hmA, hmB, nfA, nfB, fmA, fmB,
                              RA, RB, pA, pB, cylA, cylB, K, rounds,
                              scan=_staged_scan)


def _any_perp(v):
    small = (v[..., 0:1].abs() < 0.5).to(v.dtype)
    a = torch.cat([small, 1.0 - small, torch.zeros_like(small)], dim=-1)
    p = cross(v, a)
    return p / torch.clamp(norm(p, keepdim=True), min=1e-12)


def _feature_poly(w, vm, n, s_ext, sign, fpl_w, fm, hid, hvalid, fpoly_tab,
                  p, R, rb, cen, aw, cyl):
    """Ordered 2D-able feature polygon (..., 16, 3) world for one hull.

    fpoly_tab is the SHARED (nh, F, 16, 3) local face-polygon table and
    hid/hvalid the lane's hull index and its validity: only the single
    best-aligned face's 16 verts are gathered and rotated to world.

    sign=+1: feature maximizes dot(v, n) at s_ext (hull A);
    sign=-1: feature minimizes it (hull B).  Face feature when the
    best-aligned merged face is within the face window; otherwise a
    thin rectangle around the extreme-vertex segment (degenerates to a
    point for vertex features).

    Cylinder hulls (cyl[..., 0] > 0.5, axis aw, center cen) get analytic
    features: the smooth side can never be a face, so the feature is
    the tangent LINE segment (side contact), the cap polygon (cap
    contact) or the rim point."""
    is_cyl = cyl[..., 0] > 0.5
    proj = (w * n[..., None, :]).sum(-1)
    window = _FEAT_WINDOW * rb
    feat = (vm > 0.5) & (sign * (proj - s_ext[..., None])
                         > -window[..., None])
    cnt = feat.sum(-1)

    # best aligned face: outward normal ~ sign * n
    nn = sign * n
    fdot = (fpl_w * nn[..., None, :]).sum(-1)
    fok = fm > 0.5
    fbest = torch.argmax(torch.where(fok, fdot, -torch.inf), dim=-1)
    ca = (nn * aw).sum(-1)
    face_ok = (cnt >= 3) & (_masked_max(fdot, fok) > _COS_FACE)
    # cylinders: only a CAP may be a face feature
    face_ok = torch.where(is_cyl, ca.abs() > _COS_FACE, face_ok)
    # the one face's local polygon from the shared table, then transform
    poly_l = fpoly_tab[hid, fbest]                            # (..., 16, 3)
    poly_l = torch.where(hvalid[..., None, None], poly_l, 0.0)
    poly_face = p[..., None, :] + _rot(R, poly_l)

    # segment feature: extremes of the window verts
    cw = feat.to(w.dtype)
    c = (w * cw[..., None]).sum(-2) / torch.clamp(cw.sum(-1),
                                                  min=1.0)[..., None]
    d2c = torch.where(feat, ((w - c[..., None, :]) ** 2).sum(-1), -1.0)
    p0 = _pick_rows(w, torch.argmax(d2c, dim=-1))
    d2p = torch.where(feat, ((w - p0[..., None, :]) ** 2).sum(-1), -1.0)
    p1 = _pick_rows(w, torch.argmax(d2p, dim=-1))
    # cylinder overrides: tangent segment (side), rim point otherwise
    u_raw = nn - ca[..., None] * aw
    un = norm(u_raw, keepdim=True)
    u_rad = torch.where(un > 1e-9, u_raw / torch.clamp(un, min=1e-12),
                        _any_perp(aw))
    r_, hh = cyl[..., 1:2], cyl[..., 2:3]
    tangent = cen + r_ * u_rad
    is_side = (hh[..., 0] * ca.abs() < window)[..., None]
    rim = tangent + hh * torch.sign(ca)[..., None] * aw
    cylm = is_cyl[..., None]
    p0 = torch.where(cylm, torch.where(is_side, tangent - hh * aw, rim), p0)
    p1 = torch.where(cylm, torch.where(is_side, tangent + hh * aw, rim), p1)
    # thin rectangle in the contact plane around (p0, p1): cap edges
    # bound the segment extent when it clips the other feature
    u = p1 - p0
    un2 = norm(u, keepdim=True)
    ex = torch.zeros_like(u)
    ex[..., 0].fill_(1.0)
    uu = torch.where(un2 > 1e-9, u / torch.clamp(un2, min=1e-12), ex)
    side = cross(n, uu)
    delta = (1e-6 * rb)[..., None]
    rect = torch.stack([p0 - delta * side, p1 - delta * side,
                        p1 + delta * side, p0 + delta * side], dim=-2)
    nfv = poly_face.shape[-2]
    rect16 = torch.cat(
        [rect, rect[..., 3:4, :].expand(rect.shape[:-2] + (nfv - 4, 3))],
        dim=-2)
    return torch.where(face_ok[..., None, None], poly_face, rect16)


def _ring_pad_mask(poly):
    """True for the first occurrence of each vertex of a repeat-padded
    ring (pads repeat the last real vertex and would otherwise weight
    centroids / duplicate candidates)."""
    prev = torch.roll(poly, 1, dims=-2)
    diff = (poly - prev).abs().sum(-1) > 0
    first = torch.ones_like(diff[..., :1])
    return torch.cat([first, diff[..., 1:]], dim=-1)


def _convex_clip_points(pa, pb, eps):
    """Corner set of the intersection of two convex CCW (repeat-padded)
    2D polygons (..., NA, 2), (..., NB, 2), fully VECTORIZED: {A verts
    inside B} u {B verts inside A} u {edge-edge crossings}, the exact
    vertex set of the Sutherland-Hodgman result.  Downstream (_reduce4)
    only needs the point SET, not ring order.  eps (...,) is a length.

    Returns (pts (..., N, 2), mask (..., N)) with N = NA + NB + NA*NB."""
    ea = torch.roll(pa, -1, dims=-2) - pa               # (..., NA, 2) edges
    eb = torch.roll(pb, -1, dims=-2) - pb
    # point-in-polygon: left of (or on, within eps) every edge.  The
    # tolerance scales with EDGE LENGTH (eps is a length; cross2 is an
    # area = dist * |e|).  Pad self-edges are zero-length -> cross == 0
    # >= -0 -> always pass, and the ring-closing edge constrains.
    lb = torch.sqrt((eb * eb).sum(-1))
    la = torch.sqrt((ea * ea).sum(-1))
    e_ = eps[..., None, None]
    in_b = (_cross2(eb[..., None, :, :],
                    pa[..., :, None, :] - pb[..., None, :, :])
            >= -e_ * lb[..., None, :]).all(dim=-1)      # (..., NA)
    in_a = (_cross2(ea[..., None, :, :],
                    pb[..., :, None, :] - pa[..., None, :, :])
            >= -e_ * la[..., None, :]).all(dim=-1)      # (..., NB)
    in_b = in_b & _ring_pad_mask(pa)
    in_a = in_a & _ring_pad_mask(pb)
    # edge-edge crossings: segment params s (on A edge), t (on B edge)
    d = pa[..., :, None, :] - pb[..., None, :, :]       # (..., NA, NB, 2)
    den = _cross2(ea[..., :, None, :], eb[..., None, :, :])
    ok_den = den.abs() > 1e-30
    dsafe = torch.where(ok_den, den, 1.0)
    s = _cross2(eb[..., None, :, :], d) / dsafe         # along A edge
    t = _cross2(ea[..., :, None, :], d) / dsafe         # along B edge
    hit = ok_den & (s >= 0.0) & (s <= 1.0) & (t >= 0.0) & (t <= 1.0)
    xpt = pa[..., :, None, :] + s[..., None] * ea[..., :, None, :]
    lead = pa.shape[:-2]
    pts = torch.cat([pa, pb, xpt.reshape(lead + (-1, 2))], dim=-2)
    mask = torch.cat([in_b, in_a, hit.reshape(lead + (-1,))], dim=-1)
    return pts, mask


def _seg_closest2(p1, q1, p2, q2):
    """Closest points between 2D segments [p1,q1] and [p2,q2]
    (broadcasting; Ericson 5.1.9 with degenerate guards).
    Returns (cA, cB, d2)."""
    d1 = q1 - p1
    d2s = q2 - p2
    r = p1 - p2
    a = (d1 * d1).sum(-1)
    e = (d2s * d2s).sum(-1)
    f = (d2s * r).sum(-1)
    c = (d1 * r).sum(-1)
    b = (d1 * d2s).sum(-1)
    denom = a * e - b * b
    s = torch.where(denom > 1e-30, (b * f - c * e) / torch.where(
        denom > 1e-30, denom, 1.0), 0.0)
    s = torch.clamp(s, 0.0, 1.0)
    t = torch.where(e > 1e-30, (b * s + f) / torch.where(e > 1e-30, e, 1.0),
                    0.0)
    t = torch.clamp(t, 0.0, 1.0)
    s = torch.where(a > 1e-30, torch.clamp((b * t - c) / torch.where(
        a > 1e-30, a, 1.0), 0.0, 1.0), 0.0)
    cA = p1 + s[..., None] * d1
    cB = p2 + t[..., None] * d2s
    return cA, cB, ((cA - cB) ** 2).sum(-1)


def _closest_poly_mid(pa, pb):
    """Midpoint of the closest boundary points of two (repeat-padded)
    2D polygons (..., N, 2); pad self-edges are zero-length segments the
    degenerate guards reduce to points."""
    a0 = pa[..., :, None, :]
    a1 = torch.roll(pa, -1, dims=-2)[..., :, None, :]
    b0 = pb[..., None, :, :]
    b1 = torch.roll(pb, -1, dims=-2)[..., None, :, :]
    cA, cB, d2 = _seg_closest2(a0, a1, b0, b1)
    lead = pa.shape[:-2]
    k = torch.argmin(d2.reshape(lead + (-1,)), dim=-1)
    mid = (0.5 * (cA + cB)).reshape(lead + (-1, 2))
    return _pick_rows(mid, k)


def _reduce4(pts, m, rb):
    """<=4 spread points from the (unordered, masked) intersection
    corner set.  Returns (pts4 (..., 4, 2), mask4 (..., 4))."""
    w = m.to(pts.dtype)
    c = (pts * w[..., None]).sum(-2) / torch.clamp(w.sum(-1),
                                                   min=1.0)[..., None]
    d2c = torch.where(m, ((pts - c[..., None, :]) ** 2).sum(-1), -1.0)
    p0 = _pick_rows(pts, torch.argmax(d2c, dim=-1))
    d2p = torch.where(m, ((pts - p0[..., None, :]) ** 2).sum(-1), -1.0)
    p1 = _pick_rows(pts, torch.argmax(d2p, dim=-1))
    area = _cross2((p1 - p0)[..., None, :], pts - p0[..., None, :])
    a_hi = torch.where(m, area, -torch.inf)
    a_lo = torch.where(m, area, torch.inf)
    p2 = _pick_rows(pts, torch.argmax(a_hi, dim=-1))
    p3 = _pick_rows(pts, torch.argmin(a_lo, dim=-1))
    out = torch.stack([p0, p1, p2, p3], dim=-2)
    any_pt = m.any(dim=-1)
    ok = torch.stack([any_pt, any_pt,
                      a_hi.amax(dim=-1) > 1e-12 * rb * rb,
                      a_lo.amin(dim=-1) < -1e-12 * rb * rb], dim=-1)
    # dedup: later points within 1e-4*rb of an earlier kept point drop
    # (collapsed features emit coincident corners)
    tol2 = ((1e-4 * rb) ** 2)[..., None, None]
    dij = ((out[..., :, None, :] - out[..., None, :, :]) ** 2).sum(-1)
    ar4 = torch.arange(4, device=pts.device)
    earlier = ar4[None, :] < ar4[:, None]
    dup = ((dij < tol2) & earlier & ok[..., None, :]).any(dim=-1)
    return out, ok & ~dup


def gather_hull(hid, tab):
    """tab (nh, ...) at the lanes' hull index hid (...,); a lane with
    hid < 0 (an empty slot) reads zeros, as the all-zero one-hot row of
    the JAX package's matmul gather does."""
    valid = hid >= 0
    out = tab[hid.clamp(min=0)]
    return torch.where(valid.reshape(valid.shape + (1,) * (tab.dim() - 1)),
                       out, 0.0)


def exact_pair_contacts(pA, RA, hidA, cylA, pB, RB, hidB, cylB, enabled,
                        tables, mtv=mtv_mod.mtv_query):
    """Oracle-form manifold for (possibly deep) convex pairs, one per lane.

    Per-lane inputs (any leading dims): the world poses pA/pB (..., 3),
    RA/RB (..., 3, 3), the hull indices hidA/hidB (...,) long with -1 for
    an empty slot (its tables read as zeros), and the cylinder
    descriptors cylA/cylB (..., 3); the hull tables ride in ``tables``
    (dict of SHARED stacked tensors: vert (nh, V, 3), vmask, fplane
    (nh, F, 4), fmask, fpoly (nh, F, 16, 3), hedge (nh, E, 2, 3), hemask)
    and are gathered here.  ``mtv`` is the exact-MTV query (the kernel
    wrapper by default).

    Returns (dist (..., 4), pos (..., 4, 3), n (..., 3), ok (...,), sepd
    (...,)): up to 4 active rows (dist < 0, the others 1e9), every active
    row sharing the exact MTV depth and normal (geom1 -> geom2), positions
    on the mid-surface plane.  ``sepd`` is a SEPARATION CERTIFICATE: > 0
    iff the lane is enabled and the query proved the pair separated (max
    SAT separation, a lower bound on the true distance).  A lane with
    ``enabled`` false returns exactly the miss tuple (1e9, 0, +z, False,
    0), whatever its inputs hold."""
    dtype = pA.dtype
    validA, validB = hidA >= 0, hidB >= 0
    iA, iB = hidA.clamp(min=0), hidB.clamp(min=0)

    def tabs(hid):
        return [gather_hull(hid, tables[k]) for k in
                ("vert", "vmask", "fplane", "fmask", "hedge", "hemask")]

    vertsA, vmaskA, fplaneA, fmaskA, hedgeA, hmaskA = tabs(hidA)
    vertsB, vmaskB, fplaneB, fmaskB, hedgeB, hmaskB = tabs(hidB)
    wA = pA[..., None, :] + _rot(RA, vertsA)
    wB = pB[..., None, :] + _rot(RB, vertsB)
    nfA = _rot(RA, fplaneA[..., :3])
    nfB = _rot(RB, fplaneB[..., :3])
    awA = RA[..., :, 2]            # cylinder axis = local +z
    awB = RB[..., :, 2]
    depth, n = mtv(wA, wB, hedgeA, hedgeB, hmaskA, hmaskB, nfA, nfB,
                   fmaskA, fmaskB, RA.contiguous(), RB.contiguous(),
                   pA.contiguous(), pB.contiguous(), cylA.contiguous(),
                   cylB.contiguous())
    ok = enabled & (depth > 0.0) & (depth < 1e8)

    rbA = torch.sqrt(_masked_max((vertsA ** 2).sum(-1), vmaskA > 0.5))
    rbB = torch.sqrt(_masked_max((vertsB ** 2).sum(-1), vmaskB > 0.5))
    rb = torch.minimum(rbA, rbB)

    projA = (wA * n[..., None, :]).sum(-1)
    projB = (wB * n[..., None, :]).sum(-1)
    sA = _masked_max(projA, vmaskA > 0.5)
    sB = _masked_min(projB, vmaskB > 0.5)
    extA = mtv_mod.cyl_ext(n[..., None, :], awA, cylA[..., 1],
                           cylA[..., 2])[..., 0]
    extB = mtv_mod.cyl_ext(n[..., None, :], awB, cylB[..., 1],
                           cylB[..., 2])[..., 0]
    sA = torch.where(cylA[..., 0] > 0.5, (n * pA).sum(-1) + extA, sA)
    sB = torch.where(cylB[..., 0] > 0.5, (n * pB).sum(-1) - extB, sB)
    c_mid = 0.5 * (sA + sB)

    polyA = _feature_poly(wA, vmaskA, n, sA, 1.0, nfA, fmaskA, iA, validA,
                          tables["fpoly"], pA, RA, rbA, pA, awA, cylA)
    polyB = _feature_poly(wB, vmaskB, n, sB, -1.0, nfB, fmaskB, iB, validB,
                          tables["fpoly"], pB, RB, rbB, pB, awB, cylB)

    # 2D frame on the contact plane; A's polygon is CCW about +n (fpoly
    # winds CCW about the outward face normal ~ +n for A); B's winds CW
    small = (n[..., 0:1].abs() < 0.5).to(dtype)
    a = torch.cat([small, 1.0 - small, torch.zeros_like(small)], dim=-1)
    t1 = cross(n, a)
    t1 = t1 / torch.clamp(norm(t1, keepdim=True), min=1e-12)
    t2 = cross(n, t1)

    def to2d(pts):
        return torch.stack([(pts * t1[..., None, :]).sum(-1),
                            (pts * t2[..., None, :]).sum(-1)], dim=-1)

    # B's feature polygon projects CW about the frame; reverse it so both
    # rings read CCW for the vectorized intersection (reversal keeps the
    # repeat-pad invariant: the pad block moves to the front, its
    # self-edges stay zero-length)
    polyB2f = to2d(polyB)
    polyB2 = torch.flip(polyB2f, dims=(-2,))
    polyA2 = to2d(polyA)
    pts2, msk2 = _convex_clip_points(polyA2, polyB2, 1e-6 * rb)
    pts4, m4 = _reduce4(pts2, msk2, rb)

    # empty intersection (features laterally disjoint: axis residual or
    # degenerate geometry): fall back to the midpoint of the two feature
    # polygons' closest boundary points.  With the exact MTV the touching
    # features intersect, so this only fires at eps scale; the midpoint
    # then IS the touching point.
    fall2 = _closest_poly_mid(polyA2, polyB2f)
    empty = ~m4.any(dim=-1)
    pts4 = torch.where(empty[..., None, None], fall2[..., None, :], pts4)
    first = torch.arange(4, device=pA.device) == 0
    m4 = m4 | (empty[..., None] & first)

    # cylinder SIDE (tangent-line) contacts: the oracle's multiCCD emits 3
    # points: the unperturbed EPA witness (somewhere on the segment) plus
    # the two segment ends from the tilted re-queries.  The clip yields the
    # two ends; add the midpoint as the interior witness so the force
    # count matches the oracle.
    window = _FEAT_WINDOW * rb
    sideA = (cylA[..., 0] > 0.5) & (cylA[..., 2] * (n * awA).sum(-1).abs()
                                    < window)
    sideB = (cylB[..., 0] > 0.5) & (cylB[..., 2] * (n * awB).sum(-1).abs()
                                    < window)
    cyl_side = (sideA | sideB) & m4[..., 0] & m4[..., 1] & ~empty
    midp = 0.5 * (pts4[..., 0, :] + pts4[..., 1, :])
    pts4 = torch.where(
        cyl_side[..., None, None],
        torch.stack([pts4[..., 0, :], pts4[..., 1, :], midp, midp], dim=-2),
        pts4)
    m4 = torch.where(cyl_side[..., None],
                     torch.arange(4, device=pA.device) < 3, m4)

    pos = (pts4[..., 0:1] * t1[..., None, :] + pts4[..., 1:2] * t2[..., None, :]
           + c_mid[..., None, None] * n[..., None, :])
    dist = torch.where(m4 & ok[..., None], -depth[..., None], 1e9)
    sepd = torch.where(enabled & (depth <= 0.0) & (depth > -1e8), -depth, 0.0)

    # disabled lanes return exactly the miss tuple (their inputs may be
    # empty-slot zeros or table pads; nothing of them passes the selects)
    en = enabled
    up = torch.zeros_like(n)
    up[..., 2].fill_(1.0)
    dist = torch.where(en[..., None], dist, 1e9)
    pos = torch.where(en[..., None, None], pos, 0.0)
    n = torch.where(en[..., None], n, up)
    return dist, pos, n, ok, sepd
