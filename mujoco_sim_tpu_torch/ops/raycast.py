"""Batched ray-geom intersection (mj_ray equivalent) for rangefinders.

Port of mujoco_sim_tpu/ops/raycast.py over an explicit leading env axis.
Each primitive intersector works in the geom's LOCAL frame on a dense
(B envs x R rays x n geoms) grid and returns the smallest non-negative ray
parameter, or +INF on a miss.  Geoms are grouped by STATIC type
(`ray_all`), so the step never branches on data.  Convex meshes are
intersected against their compile-time hull half-spaces (zero-padding
rows are neutral: n=0, d=1e9).  Heightfields are swept cell by cell with
Moller-Trumbore over the grid's two triangles a cell, in chunks of rays
so the (B, rays, R-1, C-1) temporaries stay bounded.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_sim_tpu_torch.models.model import Model, Data, GeomType
from mujoco_sim_tpu_torch.ops.math import cross

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


def hfield_tables_np(nrow, ncol, R_, C_) -> dict:
    """Static tables of the heightfield sweep for grids of nrow x ncol
    (n,) samples padded to R_ x C_: the counts as floats and which of the
    (R_-1, C_-1) cells are real."""
    nrow, ncol = np.asarray(nrow), np.asarray(ncol)
    return dict(nr=nrow.astype(np.float64), nc=ncol.astype(np.float64),
                cell_ok=((np.arange(C_ - 1) < ncol[:, None] - 1)[:, None, :]
                         & (np.arange(R_ - 1) < nrow[:, None] - 1)[:, :,
                                                                    None]))


def _hfield(p, v, hfdata, hfsize, tab):
    """ray vs the triangulated surface (two tris per cell, split along
    the (low,low)->(high,high) diagonal, the narrowphase's convention).
    p, v (B, R, n, 3) local rays; hfdata (n, R_, C_) padded heights;
    hfsize (n, 4); tab: hfield_tables_np as tensors on the rays'
    device."""
    R_, C_ = hfdata.shape[-2:]
    dev = p.device
    rx = hfsize[..., 0]
    ry = hfsize[..., 1]
    zt = hfsize[..., 2]
    nr, nc, cell_ok = tab["nr"], tab["nc"], tab["cell_ok"]
    cw = 2.0 * rx / torch.clamp(nc - 1.0, min=1.0)     # cell extents
    ch = 2.0 * ry / torch.clamp(nr - 1.0, min=1.0)
    ii = torch.arange(C_ - 1, device=dev)
    jj = torch.arange(R_ - 1, device=dev)
    x0 = -rx[..., None] + ii * cw[..., None]           # (n, C_-1)
    y0 = -ry[..., None] + jj * ch[..., None]           # (n, R_-1)
    z = hfdata * zt[..., None, None]                   # (n, R_, C_)
    z00 = z[..., :-1, :-1]
    z10 = z[..., :-1, 1:]
    z01 = z[..., 1:, :-1]
    z11 = z[..., 1:, 1:]
    xg = x0[..., None, :].expand(z00.shape)
    yg = y0[..., :, None].expand(z00.shape)
    cwb = cw[..., None, None]
    chb = ch[..., None, None]
    # lower tri: (x0,y0,z00) (x0+cw,y0,z10) (x0+cw,y0+ch,z11);
    # upper tri: (x0,y0,z00) (x0+cw,y0+ch,z11) (x0,y0+ch,z01)
    tris = [(xg, yg, z00, xg + cwb, yg, z10, xg + cwb, yg + chb, z11),
            (xg, yg, z00, xg + cwb, yg + chb, z11, xg, yg + chb, z01)]

    def tri_hit(pc, vc, ax, ay, az, bx, by, bz, cx, cy, cz):
        # Moller-Trumbore on (n, R_-1, C_-1) grids vs rays (B, r, n)
        e1 = torch.stack([bx - ax, by - ay, bz - az], -1)
        e2 = torch.stack([cx - ax, cy - ay, cz - az], -1)
        a3 = torch.stack([ax, ay, az], -1)
        o = pc[..., None, None, :]
        dvec = vc[..., None, None, :]
        h = cross(dvec, e2)
        det = (e1 * h).sum(-1)
        safe = torch.where(det.abs() > 1e-15, det, 1.0)
        s = o - a3
        u = (s * h).sum(-1) / safe
        q = cross(s, e1)
        w = (dvec * q).sum(-1) / safe
        t = (e2 * q).sum(-1) / safe
        ok = ((det.abs() > 1e-15) & (u >= -1e-9) & (w >= -1e-9)
              & (u + w <= 1.0 + 1e-9) & (t >= 0.0) & cell_ok)
        return torch.where(ok, t, INF).amin((-1, -2))

    # a ray at a time: each temporary is (B, 1, n, R-1, C-1) -- 1024 envs
    # over a 64 x 64 grid is ~16 MB in f32
    out = []
    for r in range(p.shape[1]):
        pc, vc = p[:, r:r + 1], v[:, r:r + 1]
        out.append(torch.minimum(tri_hit(pc, vc, *tris[0]),
                                 tri_hit(pc, vc, *tris[1])))
    return torch.cat(out, dim=1)


_PRIMITIVES = {
    int(GeomType.PLANE): _plane, int(GeomType.SPHERE): _sphere,
    int(GeomType.CAPSULE): _capsule, int(GeomType.CYLINDER): _cylinder,
    int(GeomType.ELLIPSOID): _ellipsoid, int(GeomType.BOX): _box,
}


def _ray_plan_np(m: Model, geom_mask: np.ndarray):
    """Per static geom type with any unmasked geom: (type, geom ids, their
    hull ids or, for heightfields, their hfield ids and sweep tables, mask
    columns)."""
    lay = m.layout
    out = []
    for t in np.unique(lay.geom_type):
        idx = np.nonzero(lay.geom_type == t)[0]
        sub_mask = geom_mask[:, idx]
        if not sub_mask.any():
            continue
        if int(t) == int(GeomType.MESH):
            table = lay.geom_hullid[idx]
        elif int(t) == int(GeomType.HFIELD):
            hid = lay.geom_hfieldid[idx]
            table = dict(hid=hid, **hfield_tables_np(
                lay.hf_nrow[hid], lay.hf_ncol[hid], *m.hfield_data.shape[1:]))
        else:
            table = np.zeros(0, dtype=np.int64)
        out.append((int(t), idx, table, sub_mask))
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
    for t, idx, table, sub_mask in plan:
        p, v = _local(pnt, vec, d.geom_xpos[:, idx], d.geom_xmat[:, idx])
        if t in _PRIMITIVES:
            dist = _PRIMITIVES[t](p, v, d.geom_size[:, idx][:, None])
        elif t == int(GeomType.MESH):
            dist = _hull(p, v, m.mesh_face_pad.to(dtype)[table])
        elif t == int(GeomType.HFIELD):
            hid = table["hid"]
            dist = _hfield(p, v, m.hfield_data.to(dtype)[hid],
                           m.hfield_size.to(dtype)[hid], table)
        else:
            continue
        dist = torch.where(sub_mask & alive[:, idx][:, None], dist, INF)
        best = torch.minimum(best, dist.amin(-1))
    return best
