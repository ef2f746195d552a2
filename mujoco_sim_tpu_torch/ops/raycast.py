"""Batched ray-geom intersection (mj_ray equivalent) for rangefinders.

Port of mujoco_sim_tpu/ops/raycast.py over an explicit leading env axis.
Each primitive intersector works in the geom's LOCAL frame on a dense
(B envs x R rays x n geoms) grid and returns the smallest non-negative ray
parameter, or +INF on a miss.  Geoms are grouped by STATIC type
(`ray_all`), so the step never branches on data.  Convex meshes are
intersected against their compile-time hull half-spaces (zero-padding
rows are neutral: n=0, d=1e9).  Heightfields are not ported yet (ROADMAP
§A.7) and raise.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_sim_tpu_torch.models.model import Model, Data, GeomType

INF = 1e30


def _local(pnt, vec, pos, mat):
    """world rays (B, R, 3) vs geom frames (B, n, 3)/(B, n, 3, 3) ->
    local (B, R, n, 3) points and directions (R^T form)."""
    rel = pnt[:, :, None, :] - pos[:, None]
    p = (mat[:, None] * rel[..., :, None]).sum(-2)
    v = (mat[:, None] * vec[:, :, None, :, None]).sum(-2)
    return p, v


def _quadratic(a, b, c):
    """smallest t >= 0 with a t^2 + 2b t + c = 0, INF on miss."""
    det = b * b - a * c
    ok = (det >= 0.0) & (a.abs() > 1e-15)
    sq = torch.sqrt(torch.clamp(det, min=0.0))
    safe = torch.where(a.abs() > 1e-15, a, 1.0)
    t0 = (-b - sq) / safe
    t1 = (-b + sq) / safe
    t = torch.where(t0 >= 0.0, t0, torch.where(t1 >= 0.0, t1, INF))
    return torch.where(ok, t, INF)


def _plane(p, v, size):
    vz = v[..., 2]
    t = -p[..., 2] / torch.where(vz.abs() > 1e-15, vz, 1.0)
    x = p[..., 0] + t * v[..., 0]
    y = p[..., 1] + t * v[..., 1]
    ok = (vz.abs() > 1e-15) & (t >= 0.0)
    ok = ok & ((size[..., 0] <= 0.0) | (x.abs() <= size[..., 0]))
    ok = ok & ((size[..., 1] <= 0.0) | (y.abs() <= size[..., 1]))
    return torch.where(ok, t, INF)


def _sphere(p, v, size):
    r = size[..., 0]
    a = (v * v).sum(-1)
    b = (p * v).sum(-1)
    c = (p * p).sum(-1) - r * r
    return _quadratic(a, b, c)


def _capsule(p, v, size):
    r, hh = size[..., 0], size[..., 1]
    # infinite cylinder in xy
    a = (v[..., :2] ** 2).sum(-1)
    b = (p[..., :2] * v[..., :2]).sum(-1)
    c = (p[..., :2] ** 2).sum(-1) - r * r
    t_side = _quadratic(a, b, c)
    z = p[..., 2] + t_side * v[..., 2]
    t_side = torch.where(z.abs() <= hh, t_side, INF)
    # end spheres
    best = t_side
    zero = torch.zeros_like(hh)
    for sgn in (1.0, -1.0):
        pc = p - torch.stack([zero, zero, sgn * hh], -1)
        bc = (pc * v).sum(-1)
        cc = (pc * pc).sum(-1) - r * r
        tc = _quadratic(a + v[..., 2] ** 2, bc, cc)
        zc = pc[..., 2] + tc * v[..., 2]
        tc = torch.where(sgn * zc >= 0.0, tc, INF)
        best = torch.minimum(best, tc)
    return best


def _cylinder(p, v, size):
    r, hh = size[..., 0], size[..., 1]
    a = (v[..., :2] ** 2).sum(-1)
    b = (p[..., :2] * v[..., :2]).sum(-1)
    c = (p[..., :2] ** 2).sum(-1) - r * r
    t_side = _quadratic(a, b, c)
    z = p[..., 2] + t_side * v[..., 2]
    best = torch.where(z.abs() <= hh, t_side, INF)
    vz = v[..., 2]
    safe = torch.where(vz.abs() > 1e-15, vz, 1.0)
    for sgn in (1.0, -1.0):
        t = (sgn * hh - p[..., 2]) / safe
        x = p[..., 0] + t * v[..., 0]
        y = p[..., 1] + t * v[..., 1]
        ok = ((vz.abs() > 1e-15) & (t >= 0.0)
              & (x * x + y * y <= r * r))
        best = torch.minimum(best, torch.where(ok, t, INF))
    return best


def _box(p, v, size):
    safe = torch.where(v.abs() > 1e-15, v, 1.0)
    t1 = (-size - p) / safe
    t2 = (size - p) / safe
    lo3 = torch.minimum(t1, t2)
    hi3 = torch.maximum(t1, t2)
    # rays parallel to an axis: that slab constrains only via |p| <= size
    par = v.abs() <= 1e-15
    inside = p.abs() <= size
    lo3 = torch.where(par, torch.where(inside, -INF, INF), lo3)
    hi3 = torch.where(par, torch.where(inside, INF, -INF), hi3)
    t_in = lo3.amax(-1)
    t_out = hi3.amin(-1)
    t = torch.where(t_in >= 0.0, t_in, t_out)
    ok = (t_in <= t_out) & (t_out >= 0.0) & (t < INF / 2)
    return torch.where(ok, t, INF)


def _ellipsoid(p, v, size):
    # anisotropic scale to the unit sphere preserves the ray parameter
    return _sphere(p / size, v / size, torch.ones_like(size))


def _hull(p, v, planes):
    """convex half-space intersection.  planes (..., F, 4) [n, d] with
    n.x <= d inside; zero-pad rows (n=0, d=1e9) are neutral."""
    n = planes[..., :3]
    dd = planes[..., 3]
    den = (n * v[..., None, :]).sum(-1)             # (..., F)
    num = dd - (n * p[..., None, :]).sum(-1)
    par_miss = (den.abs() <= 1e-15) & (num < 0.0)
    tt = num / torch.where(den.abs() > 1e-15, den, 1.0)
    t_in = torch.where(den < -1e-15, tt, -INF).amax(-1)
    t_out = torch.where(den > 1e-15, tt, INF).amin(-1)
    t = torch.clamp(t_in, min=0.0)
    ok = (~par_miss.any(-1)) & (t <= t_out) & (t_out < INF / 2)
    return torch.where(ok, t, INF)


def _hfield(*_):
    raise NotImplementedError(
        "heightfield rays are not ported yet (ROADMAP §A.7)")


_PRIMITIVES = {
    int(GeomType.PLANE): _plane, int(GeomType.SPHERE): _sphere,
    int(GeomType.CAPSULE): _capsule, int(GeomType.CYLINDER): _cylinder,
    int(GeomType.ELLIPSOID): _ellipsoid, int(GeomType.BOX): _box,
}


def _ray_plan_np(m: Model, geom_mask: np.ndarray):
    """Per static geom type with any unmasked geom: (type, geom ids, their
    hull ids, mask columns)."""
    lay = m.layout
    out = []
    for t in np.unique(lay.geom_type):
        idx = np.nonzero(lay.geom_type == t)[0]
        sub_mask = geom_mask[:, idx]
        if not sub_mask.any():
            continue
        hull = (lay.geom_hullid[idx] if int(t) == int(GeomType.MESH)
                else np.zeros(0, dtype=np.int64))
        out.append((int(t), idx, hull, sub_mask))
    return out


def ray_all(m: Model, d: Data, pnt: torch.Tensor, vec: torch.Tensor,
            geom_mask: np.ndarray, key="rays") -> torch.Tensor:
    """min distance per ray over all statically-unmasked geoms.

    pnt/vec (B, R, 3) world rays; geom_mask (R, G) static numpy bool
    (False = geom excluded for that ray), named by ``key`` for the plan
    cache.  Inactive (destroyed) bodies are masked dynamically.  Returns
    (B, R) distances, INF on miss.
    """
    dtype = pnt.dtype
    plan = m.layout.const(("rayplan", key),
                          lambda: _ray_plan_np(m, geom_mask), dtype)
    best = torch.full(pnt.shape[:2], INF, dtype=dtype, device=pnt.device)
    alive = d.body_active[:, m.layout.dev.geom_bodyid]     # (B, G)
    for t, idx, hull, sub_mask in plan:
        p, v = _local(pnt, vec, d.geom_xpos[:, idx], d.geom_xmat[:, idx])
        if t in _PRIMITIVES:
            dist = _PRIMITIVES[t](p, v, d.geom_size[:, idx][:, None])
        elif t == int(GeomType.MESH):
            dist = _hull(p, v, m.mesh_face_pad.to(dtype)[hull])
        elif t == int(GeomType.HFIELD):
            dist = _hfield()
        else:
            continue
        dist = torch.where(sub_mask & alive[:, idx][:, None], dist, INF)
        best = torch.minimum(best, dist.amin(-1))
    return best
