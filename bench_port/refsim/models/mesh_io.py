"""Frozen copy of mujoco_sim_tpu_torch's CPU path for the benchmark's
plain reference (bench_port/refsim): imports rewritten, CUDA wrappers
and graph capture removed.  Do not import the program from here.

Mesh loading + convex-hull mass properties (host side).

The reference feeds STL meshes to libmujoco which qhulls them internally
(the reference's model/test/*/stl).  Here we parse STL
ourselves, take the convex hull (same qhull default as MuJoCo 2.3.7's
non-exact mesh inertia path), and integrate volume/COM/inertia over the hull
via the divergence theorem.

A native C++ fast path (native/geomlib) is used when built; scipy's qhull is
the fallback.
"""

from __future__ import annotations

import struct as _struct

import numpy as np


def load_stl(path: str) -> np.ndarray:
    """Parse binary or ASCII STL -> (ntri, 3, 3) float array of triangles."""
    with open(path, "rb") as f:
        head = f.read(5)
        f.seek(0)
        if head == b"solid":
            # could still be binary with a 'solid' header; sniff for 'facet'
            data = f.read()
            if b"facet" in data[:500]:
                return _parse_ascii_stl(data.decode("ascii", errors="ignore"))
            f.seek(0)
        f.seek(80)
        (ntri,) = _struct.unpack("<I", f.read(4))
        raw = np.frombuffer(f.read(ntri * 50), dtype=np.uint8)
        if len(raw) < ntri * 50:
            raise ValueError(f"truncated STL: {path}")
        tri = raw.reshape(ntri, 50)[:, 12:48].copy().view("<f4").reshape(ntri, 3, 3)
        return tri.astype(np.float64)


def _parse_ascii_stl(text: str) -> np.ndarray:
    verts = []
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("vertex"):
            verts.append([float(x) for x in line.split()[1:4]])
    v = np.array(verts)
    return v.reshape(-1, 3, 3)


def load_mesh_vertices(path: str, scale: np.ndarray) -> np.ndarray:
    """Load mesh file -> deduplicated vertex array, scaled."""
    if path.lower().endswith(".stl"):
        from refsim.models import native
        nv = native.load_stl(path) if native.available() else None
        if nv is not None:
            verts = nv
        else:
            verts = np.unique(load_stl(path).reshape(-1, 3), axis=0)
    elif path.lower().endswith(".obj"):
        verts = np.unique(_load_obj_vertices(path), axis=0)
    else:
        raise NotImplementedError(f"mesh format: {path}")
    return verts * np.asarray(scale)


def _load_obj_vertices(path: str) -> np.ndarray:
    verts = []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
    return np.array(verts)


def _load_obj_mesh(path: str):
    """OBJ -> (verts (n, 3), tri faces (m, 3) 0-based).  Polygon faces
    are fan-triangulated; v/vt/vn index syntax and negative (relative)
    indices are handled; only geometry is read."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                idx = []
                for tok in line.split()[1:]:
                    i = int(tok.split("/")[0])
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(verts, float), np.asarray(faces, dtype=int)


def load_visual_mesh(path: str, scale: np.ndarray):
    """Mesh file -> RAW indexed triangle surface (verts (n, 3), faces
    (m, 3)), scaled — the VISUAL-fidelity mesh (may be non-convex).

    Collision uses convex hulls, but the USD exporter and the viewer
    must show the true surface (the reference renders and exports real
    triangle meshes, script/mujoco_to_usd.py:95-125); through r4 both
    emitted hulls, misrepresenting non-convex assets like the cup
    (VERDICT r4 missing #3).  STL triangle soups are vertex-deduped to
    an indexed mesh (the oracle's mesh_face count = the STL triangle
    count, matched here)."""
    if path.lower().endswith(".stl"):
        tris = load_stl(path)
        uverts, inv = np.unique(tris.reshape(-1, 3), axis=0,
                                return_inverse=True)
        faces = inv.reshape(-1, 3)
        return uverts * np.asarray(scale), faces
    if path.lower().endswith(".obj"):
        verts, faces = _load_obj_mesh(path)
        if len(faces) == 0:
            return None
        return verts * np.asarray(scale), faces
    return None


def convex_hull(verts: np.ndarray):
    """(hull_vertices (n,3), hull_faces (m,3) outward-oriented indices)."""
    from scipy.spatial import ConvexHull

    hull = ConvexHull(verts)
    used = hull.vertices  # indices into verts
    remap = np.full(len(verts), -1)
    remap[used] = np.arange(len(used))
    faces = remap[hull.simplices]
    hv = verts[used]
    # orient faces outward (qhull simplices are not consistently oriented)
    centroid = hv.mean(axis=0)
    a, b, c = hv[faces[:, 0]], hv[faces[:, 1]], hv[faces[:, 2]]
    n = np.cross(b - a, c - a)
    flip = np.einsum("ij,ij->i", n, a - centroid) < 0
    faces[flip] = faces[flip][:, [0, 2, 1]]
    return hv, faces


def mass_properties(verts: np.ndarray, faces: np.ndarray):
    """(volume, com, inertia 3x3 about com) of a closed triangle surface.

    Signed-tetrahedra integration (divergence theorem), exact for the hull.
    """
    a = verts[faces[:, 0]]
    b = verts[faces[:, 1]]
    c = verts[faces[:, 2]]
    vols = np.einsum("ij,ij->i", a, np.cross(b, c)) / 6.0  # signed tet volumes
    volume = vols.sum()
    com = ((a + b + c) / 4.0 * vols[:, None]).sum(axis=0) / volume
    # inertia of each tet about origin, canonical formula
    a_, b_, c_ = a - com, b - com, c - com

    def f(p, q, r, i, j):
        return (
            p[:, i] * p[:, j] + q[:, i] * q[:, j] + r[:, i] * r[:, j]
            + 0.5 * (p[:, i] * q[:, j] + q[:, i] * p[:, j]
                     + p[:, i] * r[:, j] + r[:, i] * p[:, j]
                     + q[:, i] * r[:, j] + r[:, i] * q[:, j])
        )

    scale = vols / 10.0 * 2.0  # 6V/30 * 2  => V/5... kept explicit below
    # integral of x_i x_j over tet = (6*signedvol) /120 * sum-terms*...
    # Use standard result: ∫ x_i x_j dV = detJ/120 * (Σ_k Σ_l a_ki a_lj + Σ_k a_ki a_kj)
    # with detJ = 6*vol.  f() above computes Σ terms.
    ixx = (vols * f(a_, b_, c_, 1, 1)).sum() + (vols * f(a_, b_, c_, 2, 2)).sum()
    iyy = (vols * f(a_, b_, c_, 0, 0)).sum() + (vols * f(a_, b_, c_, 2, 2)).sum()
    izz = (vols * f(a_, b_, c_, 0, 0)).sum() + (vols * f(a_, b_, c_, 1, 1)).sum()
    ixy = -(vols * f(a_, b_, c_, 0, 1)).sum()
    ixz = -(vols * f(a_, b_, c_, 0, 2)).sum()
    iyz = -(vols * f(a_, b_, c_, 1, 2)).sum()
    inertia = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]]) / 10.0
    return volume, com, inertia


def legacy_mass_properties(tris: np.ndarray, iters: int = 8):
    """MuJoCo's 'legacy' mesh inertia: tetrahedra from each surface triangle
    to an apex, ABSOLUTE volumes (robust to the misoriented windings the
    reference STLs contain), apex iterated to the center of mass.

    Empirically bit-matches the mujoco 3.10 oracle's mesh body mass to
    ~1e-4 relative on the tiago/hsrb4s meshes (r2 experiment); the r1
    hull-based value was off by up to 1.7x on non-convex parts.
    Returns (volume, com, inertia 3x3 about com).
    """
    apex = np.unique(tris.reshape(-1, 3), axis=0).mean(axis=0)
    for _ in range(iters):
        a = tris[:, 0] - apex
        b = tris[:, 1] - apex
        c = tris[:, 2] - apex
        vols = np.abs(np.einsum("ij,ij->i", a, np.cross(b, c))) / 6.0
        V = vols.sum()
        if V <= 0:
            return 0.0, apex, np.zeros((3, 3))
        cent = apex + (a + b + c) / 4.0
        com_new = (vols[:, None] * cent).sum(axis=0) / V
        if np.linalg.norm(com_new - apex) < 1e-12:
            apex = com_new
            break
        apex = com_new
    # inertia about the apex (== com at convergence): canonical tet formula
    a = tris[:, 0] - apex
    b = tris[:, 1] - apex
    c = tris[:, 2] - apex
    vols = np.abs(np.einsum("ij,ij->i", a, np.cross(b, c))) / 6.0
    V = vols.sum()

    def f(p, q, r, i, j):
        return (
            p[:, i] * p[:, j] + q[:, i] * q[:, j] + r[:, i] * r[:, j]
            + 0.5 * (p[:, i] * q[:, j] + q[:, i] * p[:, j]
                     + p[:, i] * r[:, j] + r[:, i] * p[:, j]
                     + q[:, i] * r[:, j] + r[:, i] * q[:, j])
        )

    ixx = (vols * (f(a, b, c, 1, 1) + f(a, b, c, 2, 2))).sum()
    iyy = (vols * (f(a, b, c, 0, 0) + f(a, b, c, 2, 2))).sum()
    izz = (vols * (f(a, b, c, 0, 0) + f(a, b, c, 1, 1))).sum()
    ixy = -(vols * f(a, b, c, 0, 1)).sum()
    ixz = -(vols * f(a, b, c, 0, 2)).sum()
    iyz = -(vols * f(a, b, c, 1, 2)).sum()
    inertia = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz],
                        [ixz, iyz, izz]]) / 10.0
    return V, apex, inertia


def decimate_hull(hv: np.ndarray, max_verts: int) -> np.ndarray:
    """Reduce a convex hull to <= max_verts vertices by greedy
    farthest-point sampling (seeded with the 6 axis extremes), then
    re-hulling.  The padded collision tensors scale with the LARGEST hull
    in the model (P pairs x V verts x F faces), so capping vertex count
    bounds the whole mesh-narrowphase cost (MuJoCo's own maxhullvert
    default is 64).  Max surface deviation is checked by the PR2 contact
    parity test."""
    if len(hv) <= max_verts:
        return hv
    chosen = list({int(np.argmin(hv[:, i])) for i in range(3)}
                  | {int(np.argmax(hv[:, i])) for i in range(3)})
    d2 = np.full(len(hv), np.inf)
    for c in chosen:
        d2 = np.minimum(d2, ((hv - hv[c]) ** 2).sum(axis=1))
    while len(chosen) < max_verts:
        nxt = int(np.argmax(d2))
        if not np.isfinite(d2[nxt]) or d2[nxt] <= 0:
            break
        chosen.append(nxt)
        d2 = np.minimum(d2, ((hv - hv[nxt]) ** 2).sum(axis=1))
    sub = hv[np.asarray(sorted(set(chosen)))]
    # re-hull: sampling can leave interior points after subsetting
    hv2, _ = convex_hull(sub)
    return hv2


def process_mesh(verts: np.ndarray, max_hull_verts: int = 0,
                 tris: np.ndarray | None = None):
    """verts -> (hull_verts, (volume, com, inertia_mat_about_com), full_hull).

    Mass properties come from the RAW triangle surface via the oracle's
    legacy algorithm when `tris` is given; otherwise (vertex-only formats)
    from the convex hull.  The hull itself (for collision) uses the native
    geomlib quickhull when built; scipy qhull otherwise.

    `full_hull` is the UNDECIMATED hull: the deep-pair exact manifold
    (ops/manifold.py) needs full-fidelity geometry — a 32-vert decimation
    of e.g. the hsrb4s base hull loses ~9 mm near the wheel wells, enough
    to rotate the exact MTV onto a wrong (tilted) axis at 5.6 cm depth.
    The hot shallow-SAT tables keep the decimated hull (perf)."""
    from refsim.models import native
    hv = faces = None
    if native.available():
        res = native.convex_hull(verts)
        if res is not None:
            hv, faces = res
    if hv is None:
        hv, faces = convex_hull(verts)
    if tris is not None and len(tris):
        props = legacy_mass_properties(tris)
    else:
        vol, com, imat = mass_properties(hv, faces)
        props = (vol, com, imat)
    full = hv
    if max_hull_verts and len(hv) > max_hull_verts:
        hv = decimate_hull(hv, max_hull_verts)
    return hv, props, full


def face_polygons(verts: np.ndarray, planes: np.ndarray, maxfv_cap: int = 16):
    """Merged (coplanar) face polygons of a convex hull.

    verts (V, 3), planes (F, 4) per-triangle [normal, offset] (as built by
    compile._plane_eqs) -> (fplanes (Fm, 4) deduped planes, fpoly
    (Fm, maxfv, 3) face vertices ordered CCW around each face's outward
    normal and PADDED BY REPEATING THE LAST VERTEX (so circular adjacency
    stays intact for clipping), nfv (Fm,) real vertex counts).

    The exact deep-pair manifold (ops/manifold.exact_pair_contacts)
    consumes these: MuJoCo 3.x's multiCCD emits the corners of the overlap
    polygon of the two touching faces for face-aligned contacts (probed on
    the mesh-stack fixture; reference behavior behind mj_step1's implicit
    narrowphase, SURVEY.md section 2.2), which requires ordered face
    polygons the per-triangle plane table cannot provide."""
    scale = float(np.abs(verts).max()) if len(verts) else 1.0
    ntol = 1e-5
    return _face_polygons_impl(verts, planes, maxfv_cap, scale, ntol)


def edge_directions(fpoly: np.ndarray, nfv: np.ndarray,
                    max_dirs: int = 0) -> np.ndarray:
    """Unique (parallel/antiparallel-deduped) unit edge directions of a
    hull, from its merged face polygons (face_polygons output).

    The complete-SAT exact-MTV query (ops/manifold.py) enumerates
    cross(edgeA, edgeB) axes: only DIRECTIONS matter there, and merging
    parallel edges (a cube's 12 edges -> 3 directions, a 16-gon prism's
    48 -> 9) shrinks the axis set quadratically.  `max_dirs` > 0 further
    caps the set by greedy farthest-direction selection (max |dot| to the
    kept set minimized) — the cross-axis count is |EA| x |EB| per pair,
    and edge-cross MTVs on the deep-start robots are rare enough that a
    near-miss axis (sub-degree after capping a ~180-vert hull to 48
    directions) only slightly overestimates depth."""
    dirs: list[np.ndarray] = []
    for poly, k in zip(fpoly, nfv):
        for i in range(int(k)):
            d = poly[(i + 1) % int(k)] - poly[i]
            n = np.linalg.norm(d)
            if n < 1e-12:
                continue
            d = d / n
            if not any(abs(float(d @ e)) > 1.0 - 1e-8 for e in dirs):
                dirs.append(d)
    if not dirs:
        return np.zeros((1, 3))
    out = np.asarray(dirs)
    if max_dirs and len(out) > max_dirs:
        adot = np.abs(out @ out.T)
        keep = [0]
        best = adot[0].copy()
        while len(keep) < max_dirs:
            nxt = int(np.argmin(best))
            keep.append(nxt)
            best = np.maximum(best, adot[nxt])
        out = out[np.asarray(sorted(keep))]
    return out


def hull_edges(fpoly: np.ndarray, nfv: np.ndarray) -> np.ndarray:
    """Unique undirected hull edges as endpoint pairs (E, 2, 3), from the
    merged face polygons (face_polygons output).

    The exact-MTV refinement (ops/manifold._mtv) selects the top-K edges
    nearest each hull's support plane along the coarse axis and crosses
    them for the refined axis set — that needs endpoint POSITIONS (to
    score plane distance), not just the deduped directions the coarse
    pass uses."""
    seen = set()
    out: list[np.ndarray] = []
    for poly, k in zip(fpoly, nfv):
        k = int(k)
        for i in range(k):
            a = poly[i]
            b = poly[(i + 1) % k]
            if np.linalg.norm(b - a) < 1e-12:
                continue
            key = tuple(sorted((tuple(np.round(a, 9)), tuple(np.round(b, 9)))))
            if key in seen:
                continue
            seen.add(key)
            out.append(np.stack([a, b]))
    if not out:
        return np.zeros((1, 2, 3))
    return np.asarray(out)


def _hull2d_ccw(pts: np.ndarray) -> np.ndarray:
    """Indices of the 2D convex hull of pts (k, 2), CCW order (monotone
    chain).  Collinear boundary points are kept only at the corners."""
    order = np.lexsort((pts[:, 1], pts[:, 0]))

    def half(idx):
        out: list[int] = []
        for i in idx:
            while len(out) >= 2:
                o, a = pts[out[-2]], pts[out[-1]]
                if (a[0] - o[0]) * (pts[i][1] - o[1]) - \
                   (a[1] - o[1]) * (pts[i][0] - o[0]) <= 1e-18:
                    out.pop()
                else:
                    break
            out.append(int(i))
        return out

    lower = half(order)
    upper = half(order[::-1])
    hull = lower[:-1] + upper[:-1]
    if len(hull) < 3:          # degenerate (collinear face) — keep ends
        hull = list(dict.fromkeys(lower + upper))[:3]
        while len(hull) < 3:
            hull.append(hull[-1])
    return np.asarray(hull)


def _face_polygons_impl(verts, planes, maxfv_cap, scale, ntol):
    dtol = 1e-6 * max(scale, 1e-6)
    merged: list[np.ndarray] = []
    for p in planes:
        dup = False
        for q in merged:
            if (p[:3] @ q[:3] > 1.0 - ntol) and abs(p[3] - q[3]) < dtol:
                dup = True
                break
        if not dup:
            merged.append(p.copy())
    fplanes = np.asarray(merged)
    polys = []
    nfv = []
    for p in fplanes:
        on = np.abs(verts @ p[:3] - p[3]) <= dtol
        fv = verts[on]
        # a sliver/degenerate plane (normal ~0 after the guarded
        # normalize) can select <3 on-plane verts; fail loudly at compile
        # rather than emit a NaN-centroid polygon the clipper trips on
        assert len(fv) >= 3, (
            f"degenerate hull face: {len(fv)} on-plane verts for plane {p}")
        # order CCW around the outward normal via the 2D convex hull in
        # the (t1, t2, n) right-handed basis (t1 = n x a normalized,
        # t2 = n x t1 => t1 x t2 = +n, so CCW in (t1, t2) is CCW about
        # the outward normal).  A plain angular sort is NOT enough:
        # decimated hulls can carry a degenerate vertex INTERIOR to a
        # merged face (qhull keeps coplanar points occasionally), and an
        # interior point in the ring makes the polygon self-intersecting
        # — the SH feature clip then rejects everything (ridgeback base
        # bottom face, r3 diagnosis).  The hull pass drops it.
        n = p[:3]
        a = np.array([1.0, 0.0, 0.0]) if abs(n[0]) < 0.9 else \
            np.array([0.0, 1.0, 0.0])
        t1 = np.cross(n, a)
        t1 /= max(np.linalg.norm(t1), 1e-30)
        t2 = np.cross(n, t1)
        assert np.dot(np.cross(t1, t2), n) > 0  # basis is right-handed
        pts2 = np.stack([fv @ t1, fv @ t2], axis=1)
        fv = fv[_hull2d_ccw(pts2)]
        if len(fv) > maxfv_cap:  # angular subsample, keeps spread corners
            keep = np.round(np.linspace(0, len(fv), maxfv_cap,
                                        endpoint=False)).astype(int)
            fv = fv[keep]
        nfv.append(len(fv))
        pad = np.concatenate([fv, np.repeat(fv[-1:], maxfv_cap - len(fv),
                                            axis=0)], axis=0)
        polys.append(pad)
    return fplanes, np.asarray(polys), np.asarray(nfv)
