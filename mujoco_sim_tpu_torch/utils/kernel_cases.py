"""Seeded edge-case inputs of the Cholesky, MTV and face-SAT kernels.

One set of cases, made with numpy from a seed, so that the same inputs go
through three comparisons: the plain twins against the JAX package on the
CPU (tests/test_torch_kernels_twins.py), the CUDA kernels against their
twins on a card (tests/test_torch_cuda.py), and the same in chip_smoke.py.
The cases pin what the kernels' designs lean on: the size classes of the
register-resident Cholesky (8, 16, 32, 48, 64: both sides of every edge),
batches that fill no warp evenly, a stiff row, a pivot at the 1e-30 floor;
for the MTV query the edge ranking's corner cases (fewer edges than K, a
hull with every edge masked, exactly tied scores), the analytic
cylinder support on either side, and tables as large as the compiler
builds from full hulls (the 256-vertex pebble of
tests/fixtures/manip_bin6_bighull.xml, and a 1200-vertex one whose
vertices the kernel scans tile by tile), with the compaction's empty
slots; for the face-SAT queries (hull_sat and
face_sat) the layouts of csrc/face_sat.cuh (V <= 8, <= 32 and the tiled
V > 32; F past a multiple of the face groups), K = V - 1, an instance with
every point masked, exactly tied reference faces and depths, a lateral
filter that drops every point, per-instance and scalar slack, no mask; and
systems above the register classes of the Cholesky kernels.

Everything is float64 numpy; callers cast.
"""

from __future__ import annotations

import functools

import numpy as np

from mujoco_sim_tpu_torch.ops.mtv_query import ARG_NAMES as MTV_ORDER

CHOL_BATCH = 37          # a multiple of nothing the kernels tile by
CHOL_EDGE_SIZES = (1, 2, 8, 9, 16, 17, 32, 33, 48, 49, 63, 64)
CHOL_CASES = tuple(f"n{n}" for n in CHOL_EDGE_SIZES) + ("stiff_n33", "floor")

# above the register-resident classes: one block a system (n <= 239 in
# shared memory on the H100, beyond in device memory)
CHOL_BIG_SIZES = (65, 96, 128, 238, 300)
CHOL_BIG_CASES = tuple(f"n{n}" for n in CHOL_BIG_SIZES) + ("stiff_n96",
                                                         "floor_n72")

MTV_BATCH = 37
MTV_CASES = ("e_lt_k", "masked_A", "masked_B", "duplicates", "cyl_A", "cyl_B",
             "cyl_both")


def _spd(rng, N, n):
    A = rng.standard_normal((N, n, n))
    return A @ A.transpose(0, 2, 1) + n * np.eye(n)


def chol_big_case(name: str, seed: int = 0):
    """(A (N, n, n), b (N, n)) of one of CHOL_BIG_CASES, N = 7 (a batch
    that is no multiple of anything; one block a system).  ``stiff_n96``: a
    1e9 diagonal entry in row 40.  ``floor_n72``: the leading 2 x 2 block
    of ``floor`` (chol_case) in a 72 x 72 system, so its second pivot is
    floored."""
    rng = np.random.default_rng([seed, 100 + CHOL_BIG_CASES.index(name)])
    N = 7
    if name == "stiff_n96":
        A = _spd(rng, N, 96)
        A[:, 40, 40] += 1e9
        return A, rng.standard_normal((N, 96))
    if name == "floor_n72":
        n = 72
        s = 4.0 ** (np.arange(N) % 3)
        A = np.zeros((N, n, n))
        A[:, 0, 0], A[:, 0, 1], A[:, 1, 0] = 4 * s, 2 * s, 2 * s
        A[:, 1, 1] = s * (1.0 - 2.0 ** -10)
        A[:, 2:, 2:] = _spd(rng, N, n - 2)
        b = rng.standard_normal((N, n))
        b[:, 0] = 0.0
        b[:, 1] = (1.0 + np.arange(N)) * 2.0 ** -84
        return A, b
    n = int(name[1:])
    return _spd(rng, N, n), rng.standard_normal((N, n))


def chol_case(name: str, seed: int = 0):
    """(A (37, n, n), b (37, n)) of one of CHOL_CASES.

    ``stiff_n33``: a 1e9 diagonal entry in row 5 of a 33 x 33 system (two
    rows a lane).  ``floor``: the leading 2 x 2 block [[4 s, 2 s], [2 s,
    s (1 - 2^-10)]] has a second pivot of -s 2^-10, clearly below zero in
    any rounding, so every implementation floors its square root to
    sqrt(1e-30) and stores the diagonal entry as pivot / sqrt(1e-30)
    (~ -1e12 s); the solution stays finite and x_2 is ~ 0.
    """
    rng = np.random.default_rng([seed, CHOL_CASES.index(name)])
    N = CHOL_BATCH
    if name == "stiff_n33":
        A = _spd(rng, N, 33)
        A[:, 5, 5] += 1e9
        return A, rng.standard_normal((N, 33))
    if name == "floor":
        n = 5
        s = 4.0 ** (np.arange(N) % 3)
        A = np.zeros((N, n, n))
        A[:, 0, 0], A[:, 0, 1], A[:, 1, 0] = 4 * s, 2 * s, 2 * s
        A[:, 1, 1] = s * (1.0 - 2.0 ** -10)
        A[:, 2:, 2:] = _spd(rng, N, 3)
        b = rng.standard_normal((N, n))
        b[:, 0] = 0.0
        b[:, 1] = (1.0 + np.arange(N)) * 2.0 ** -84
        return A, b
    n = int(name[1:])
    return _spd(rng, N, n), rng.standard_normal((N, n))


def mtv_case(name: str, seed: int = 0):
    """{tensor name: array} (the 16 of MTV_ORDER, 37 instances) of one of
    MTV_CASES, from the random-hull generator of tests/test_pallas_refine.py.

    ``e_lt_k``: 10 edges a hull, fewer than K = 16.  ``masked_A`` /
    ``masked_B``: every edge of that hull masked (all its directions zero,
    every cross axis invalid).  ``duplicates``: each hull's edges 1, 5 and
    9 repeat edge 0, 4 and 8 exactly, so their scores tie and the lower
    index must come first.  ``cyl_*``: that hull takes the analytic
    cylinder support.
    """
    rng = np.random.default_rng([seed, MTV_CASES.index(name)])
    N = MTV_BATCH
    V, E, F = (9, 10, 5) if name == "e_lt_k" else (24, 56, 34)

    def hull(masked, cyl):
        pts = rng.normal(size=(N, V, 3)) * 0.3
        R = np.linalg.qr(rng.normal(size=(N, 3, 3)))[0]
        R[:, :, 0] *= np.sign(np.linalg.det(R))[:, None]
        p = rng.normal(size=(N, 3)) * 0.1
        w = p[:, None] + pts @ R.transpose(0, 2, 1)
        he = rng.normal(size=(N, E, 2, 3)) * 0.3
        hm = (rng.uniform(size=(N, E)) > 0.2).astype(np.float64)
        if name == "duplicates":
            he[:, 1], he[:, 5], he[:, 9] = he[:, 0], he[:, 4], he[:, 8]
            hm[:, [0, 1, 4, 5, 8, 9]] = 1.0
        if masked:
            hm[:] = 0.0
        nf = rng.normal(size=(N, F, 3))
        nf /= np.linalg.norm(nf, axis=-1, keepdims=True)
        fm = (rng.uniform(size=(N, F)) > 0.15).astype(np.float64)
        fm[:, 0] = 1.0
        cylv = np.zeros((N, 3))
        if cyl:
            cylv[:] = [1.0, 0.2, 0.35]
        return dict(w=w, he=he, hm=hm, nf=nf, fm=fm, R=R, p=p, cyl=cylv)

    A = hull(name == "masked_A", name in ("cyl_A", "cyl_both"))
    B = hull(name == "masked_B", name in ("cyl_B", "cyl_both"))
    out = {k + "A": v for k, v in A.items()}
    out.update({k + "B": v for k, v in B.items()})
    return out


# MTV tables compiled from the full hull of a Fibonacci ellipsoid of n
# vertices (the recipe of tests/fixtures/manip_bin6_bighull.xml): (V, E, F)
# = (256, 762, 508) and (1200, 3594, 2396), over the 47 KB of shared memory
# a block has without an opt-in (8 V + ~16 E + 8 F floats a pair), the
# second also over the 227 KB a block can opt into
MTV_BIG_CASES = ("pebble256", "pebble1200")
_PEBBLES = {"pebble256": 256, "pebble1200": 1200}
PEBBLE_AXES = (0.034, 0.030, 0.024)


def fibonacci_ellipsoid(n: int, a: float, b: float, c: float) -> np.ndarray:
    """n Fibonacci points on the ellipsoid of semi-axes (a, b, c), (n, 3)."""
    i = np.arange(n) + 0.5
    z = 1.0 - 2.0 * i / n
    r = np.sqrt(1.0 - z * z)
    phi = np.pi * (3.0 - np.sqrt(5.0)) * np.arange(n)
    return np.stack([a * r * np.cos(phi), b * r * np.sin(phi), c * z], 1)


@functools.lru_cache(maxsize=None)
def pebble_tables(n: int):
    """The exact-manifold tables the port's compiler builds for one mesh of
    n Fibonacci-ellipsoid vertices (rounded to 5 decimals, as written into
    the fixture): vert (V, 3) repeat-padded, fplane (F, 4), fmask (F,),
    hedge (E, 2, 3), hemask (E,), all local and read-only."""
    from mujoco_sim_tpu_torch.models import compile as mcompile
    from mujoco_sim_tpu_torch.models import mjcf
    v = np.round(fibonacci_ellipsoid(n, *PEBBLE_AXES), 5)
    xml = ('<mujoco><asset><mesh name="p" vertex="'
           + " ".join(f"{x:.5f}" for x in v.ravel())
           + '"/></asset><worldbody><body><freejoint/>'
           '<geom type="mesh" mesh="p"/></body></worldbody></mujoco>')
    m = mcompile.compile_spec(mjcf.parse_mjcf_string(xml))
    out = {k: np.array(getattr(m, src))[0] for k, src in (
        ("vert", "mesh_vert_hi"), ("fplane", "mesh_fplane"),
        ("fmask", "mesh_fmask"), ("hedge", "mesh_hedge"),
        ("hemask", "mesh_hedge_mask"))}
    for v in out.values():          # shared by every caller: read-only
        v.setflags(write=False)
    return out


def mtv_big_case(name: str, N: int = 5, seed: int = 0):
    """{tensor name: array} (the 16 of MTV_ORDER, N instances) of one of
    MTV_BIG_CASES, laid out as the deep-pair compaction hands them to the
    query (ops/manifold.exact_pair_contacts): two copies of the pebble at
    random orientations, centres 0.3-1.2 of its smallest semi-axis apart
    (deep interpenetration), world vertices and face normals, local edges.
    Instance 2, 7, 12, ... is an empty slot (every table, pose and mask
    zero); instance 3, 8, ... flags hull A as a cylinder (analytic
    support)."""
    rng = np.random.default_rng([seed, 300 + MTV_BIG_CASES.index(name)])
    t = pebble_tables(_PEBBLES[name])
    c = PEBBLE_AXES[2]
    each = lambda x: np.broadcast_to(x, (N,) + x.shape).copy()

    def hull(offset):
        R = np.linalg.qr(rng.normal(size=(N, 3, 3)))[0]
        R[:, :, 0] *= np.sign(np.linalg.det(R))[:, None]
        d = rng.normal(size=(N, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        p = offset * d * rng.uniform(0.3, 1.2, (N, 1)) * c
        w = p[:, None] + t["vert"][None] @ R.transpose(0, 2, 1)
        nf = t["fplane"][None, :, :3] @ R.transpose(0, 2, 1)
        return dict(w=w, he=each(t["hedge"]), hm=each(t["hemask"]), nf=nf,
                    fm=each(t["fmask"]), R=R, p=p, cyl=np.zeros((N, 3)))

    A, B = hull(0.5), hull(-0.5)
    A["cyl"][3::5] = [1.0, 0.03, 0.02]
    for h in (A, B):
        for v in h.values():
            v[2::5] = 0.0
    out = {k + "A": v for k, v in A.items()}
    out.update({k + "B": v for k, v in B.items()})
    return out


SAT_BATCH = 37            # not a multiple of the instances a warp holds
SAT_SIZES = tuple((V, F) for V in (8, 24, 32, 33) for F in (44, 60, 65))
SAT_CASES = tuple(f"v{V}_f{F}" for V, F in SAT_SIZES) + (
    "v8_f44_nomask", "v24_f44_nomask")


def sat_case(name: str, seed: int = 0):
    """dict(pts (37, V, 3), planes (37, F, 4), mask (37, V) or None, slack
    (37,) or a float, K = V - 1) of one of SAT_CASES.

    Points and unit face normals are random (offsets U(0.3, 1.2), so the
    points straddle the planes); a quarter of the points masked.  Instance
    1 has every point masked.  Instances 0, 3, 6, ...: face F - 1 repeats
    the reference face (an exact tie of the per-face minima: the lower
    index wins) and point V - 1 repeats point 2, both live (exactly tied
    depths).  Slack U(0, 0.3) per instance, except instances 2, 7, 12, ...
    at -10, where the lateral filter drops every point (and so keeps all).
    ``*_nomask``: no mask (None) and a scalar slack of 0.05.
    """
    rng = np.random.default_rng([seed, 200 + SAT_CASES.index(name)])
    V, F = (int(x[1:]) for x in name.split("_")[:2])
    N = SAT_BATCH
    pts = rng.standard_normal((N, V, 3))
    n = rng.standard_normal((N, F, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    planes = np.concatenate([n, rng.uniform(0.3, 1.2, (N, F, 1))], axis=-1)
    nomask = name.endswith("_nomask")
    mask = (rng.uniform(size=(N, V)) > 0.25).astype(np.float64)
    mask[:, 0] = 1.0
    if not nomask:
        mask[1] = 0.0
    tie = np.arange(N) % 3 == 0
    pts[tie, V - 1] = pts[tie, 2]
    mask[tie, V - 1] = mask[tie, 2] = 1.0
    # the reference face of each tie instance, in float32 as the kernels
    # see it, repeated as face F - 1
    p32, n32 = pts.astype(np.float32), planes.astype(np.float32)
    vals = ((p32[:, :, None, :] * n32[:, None, :, :3]).sum(-1)
            - n32[:, None, :, 3])
    vals = np.where(mask[:, :, None] > 0.5, vals, np.float32(1e9))
    ref = vals.min(1)[:, : F - 1].argmax(-1)
    planes[tie, F - 1] = planes[tie, ref[tie]]
    slack = rng.uniform(0.0, 0.3, N)
    slack[2::5] = -10.0
    return dict(pts=pts, planes=planes, mask=None if nomask else mask,
                slack=0.05 if nomask else slack, K=V - 1)
