"""Exact minimum-translation-vector query: hand-written CUDA kernel + twin.

Port of mujoco_sim_tpu/ops/pallas_refine.py (kernel) and of
mujoco_sim_tpu/ops/manifold.py ``_support_minmax`` / ``_best_axis`` /
``_topk_edge_dirs`` / ``refine_rounds_xla`` (twin).  The exact MTV of two
convex hulls comes from a coarse SAT over both hulls' merged-face normals
followed by ``rounds`` rounds that cross the K edges nearest each hull's
support plane along the current axis and re-minimize the support gap over
the K x K normalized cross axes.  The true MTV axis is a face normal or a
cross of two edges on the touching features, and those edges converge into
the top-K window as the axis improves.

Every function takes arbitrary leading instance dims.  Per instance:
wA/wB (V, 3) WORLD verts (repeat-padded: reductions run unmasked), heA/heB
(E, 2, 3) LOCAL edge endpoints, hmA/hmB (E,) edge masks, nfA/nfB (F, 3)
WORLD merged-face normals, fmA/fmB (F,) face masks, RA/RB (3, 3), pA/pB
(3,) world poses, cylA/cylB (3,) [flag, radius, half-height] (a flagged
hull takes its exact analytic support: axis = R[:, 2], centre = p).

``mtv_query`` picks its path from the tensor's device: a CUDA tensor
launches csrc/mtv_query.cu (built by ops/cuda_build.py at first use; the
K nearest edges taken in the twin's (score, index) order; tables that fit
a warp's share of 47 KB of shared memory: one warp per instance, four axes
scanned per vertex load; larger tables, of any size: one block of eight
warps per instance, its tables staged where they fit half the card's
shared memory and read from device memory where they do not) or raises; a
CPU tensor takes the plain twin.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mujoco_sim_tpu_torch.ops import cuda_build
from mujoco_sim_tpu_torch.ops.support_minmax import support_minmax_plain
from mujoco_sim_tpu_torch.runtime import profiler

K_EDGE = 16         # refinement edges per hull per round
REFINE_ROUNDS = 2


def cyl_ext(axes, aw, r, hh):
    """Analytic cylinder support extent along unit axes (..., C, 3): the
    cylinder (center-symmetric, axis aw (..., 3), radius r, half-height hh
    (...,)) spans [c.d - ext, c.d + ext] along each axis d."""
    da = (axes * aw[..., None, :]).sum(-1)
    dperp = torch.sqrt(torch.clamp(1.0 - da * da, min=0.0))
    return hh[..., None] * da.abs() + r[..., None] * dperp


def support_extents(axes, hull, scan=support_minmax_plain):
    """Support extents [min, max] of one hull along unit axes (..., C, 3).
    hull = (w, cen, aw, cyl).  ``scan`` does the vertex-cloud reductions;
    cylinder-flagged hulls (cyl[..., 0] > 0.5) use the exact analytic
    support instead of their prism vertex cloud."""
    w, cen, aw, cyl = hull
    mn, mx = scan(axes, w)
    ext = cyl_ext(axes, aw, cyl[..., 1], cyl[..., 2])
    dc = (axes * cen[..., None, :]).sum(-1)
    is_cyl = cyl[..., 0:1] > 0.5
    return torch.where(is_cyl, dc - ext, mn), torch.where(is_cyl, dc + ext, mx)


def best_axis(axes, amask, A, B, scan=support_minmax_plain):
    """(depth (...,), n (..., 3)) minimizing the support gap over +-axes
    (..., C, 3) with validity amask (..., C).  The pick is the first
    minimum of the flattened (C, 2) [forward, reverse] table.  n points
    from A toward B."""
    minA, maxA = support_extents(axes, A, scan)
    minB, maxB = support_extents(axes, B, scan)
    h_fwd = maxA - minB            # penetration along +axis
    h_rev = maxB - minA            # penetration along -axis
    h2 = torch.stack([torch.where(amask, h_fwd, torch.inf),
                      torch.where(amask, h_rev, torch.inf)], dim=-1)
    hflat = h2.reshape(h2.shape[:-2] + (-1,))
    k = torch.argmin(hflat, dim=-1)
    depth = torch.take_along_dim(hflat, k[..., None], dim=-1)[..., 0]
    kax = torch.div(k, 2, rounding_mode="floor")
    axis = torch.take_along_dim(
        axes, kax[..., None, None].expand(kax.shape + (1, 3)), dim=-2)[..., 0, :]
    n = torch.where((k % 2 == 0)[..., None], axis, -axis)
    return depth, n


def topk_edge_dirs(he_l, hm, n, s, sign, K, p, R):
    """WORLD directions (..., K, 3) of the K edges nearest one hull's
    support plane along n.  he_l (..., E, 2, 3) LOCAL endpoints, hm
    (..., E) mask; plane offset s (...,) (world support extent along n);
    sign=+1 when the hull supports at max (hull A), -1 at min (hull B).

    Scoring stays in the LOCAL frame (dot with R^T n + p.n).  Selection is
    K serial argmin passes (first minimum = lowest index on ties); a pass
    that finds no finite score selects nothing and gives a zero direction.
    """
    nloc = (R * n[..., :, None]).sum(-2)                      # R^T n
    pn = (p * n).sum(-1)
    pe = ((he_l * nloc[..., None, None, :]).sum(-1)
          + pn[..., None, None])                              # (..., E, 2)
    s_ = s[..., None, None]
    dist = s_ - pe if sign > 0 else pe - s_
    score = torch.maximum(dist[..., 0], dist[..., 1])
    score = torch.where(hm > 0.5, score, torch.inf)
    E = score.shape[-1]
    kk = min(K, E)   # small hulls: fewer edges than K
    iota = torch.arange(E, device=score.device)
    dls = []
    sc = score
    for _ in range(kk):
        i = torch.argmin(sc, dim=-1)
        valid = torch.isfinite(sc.amin(dim=-1))
        e = torch.take_along_dim(
            he_l, i[..., None, None, None].expand(i.shape + (1, 2, 3)),
            dim=-3)[..., 0, :, :]
        dls.append(torch.where(valid[..., None], e[..., 1, :] - e[..., 0, :],
                               0.0))
        sc = torch.where(iota == i[..., None], torch.inf, sc)
    dl = torch.stack(dls, dim=-2)                             # (..., kk, 3)
    d = (R[..., None, :, :] * dl[..., :, None, :]).sum(-1)    # local->world
    if kk < K:
        d = torch.cat([d, d.new_zeros(d.shape[:-2] + (K - kk, 3))], dim=-2)
    return d


def mtv_rounds(wA, wB, heA, heB, hmA, hmB, nfA, nfB, fmA, fmB,
               RA, RB, pA, pB, cylA, cylB, K, rounds,
               scan=support_minmax_plain):
    """The query in plain PyTorch ops, every support scan through ``scan``
    (axes (..., C, 3), w (..., V, 3)) -> (mn, mx)."""
    A = (wA, pA, RA[..., :, 2], cylA)
    B = (wB, pB, RB[..., :, 2], cylB)
    axes = torch.cat([nfA, -nfB], dim=-2)                     # (..., C, 3)
    amask = torch.cat([fmA > 0.5, fmB > 0.5], dim=-1)
    depth, n = best_axis(axes, amask, A, B, scan)
    for _ in range(rounds):
        _, maxA = support_extents(n[..., None, :], A)
        minB, _ = support_extents(n[..., None, :], B)
        dA = topk_edge_dirs(heA, hmA, n, maxA[..., 0], 1.0, K, pA, RA)
        dB = topk_edge_dirs(heB, hmB, n, minB[..., 0], -1.0, K, pB, RB)
        # the K x K cross table, component by component and the norm as
        # sqrt of the sum of squares: separate multiplies and adds, as the
        # kernel computes them (a fused cross or norm rounds differently,
        # and near-parallel edges amplify that)
        a, b = dA[..., :, None, :], dB[..., None, :, :]
        cr = torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                          a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                          a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]],
                         dim=-1)
        cr = cr.reshape(cr.shape[:-3] + (-1, 3))              # (..., K*K, 3)
        crn = torch.sqrt((cr * cr).sum(-1))
        cru = cr / torch.clamp(crn[..., None], min=1e-12)
        depthR, nR = best_axis(cru, crn > 1e-12, A, B, scan)
        better = depthR < depth
        depth = torch.where(better, depthR, depth)
        n = torch.where(better[..., None], nR, n)
    return depth, n


def mtv_query_plain(wA, wB, heA, heB, hmA, hmB, nfA, nfB, fmA, fmB,
                    RA, RB, pA, pB, cylA, cylB, K=K_EDGE,
                    rounds=REFINE_ROUNDS):
    """Plain PyTorch version (any device, any float dtype)."""
    return mtv_rounds(wA, wB, heA, heB, hmA, hmB, nfA, nfB, fmA, fmB,
                      RA, RB, pA, pB, cylA, cylB, K, rounds)


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    lib = cuda_build.load("mtv_query")
    lib.mtv_query_f32.restype = ctypes.c_int
    lib.mtv_query_f32.argtypes = ([ctypes.c_void_p] * 19 + [ctypes.c_int] * 6
                                  + [ctypes.c_void_p])
    lib.mtv_query_block_layout.restype = ctypes.c_int
    lib.mtv_query_block_layout.argtypes = [ctypes.c_int] * 4
    return lib


# the query's tensor arguments, in call order
ARG_NAMES = ("wA", "wB", "heA", "heB", "hmA", "hmB", "nfA", "nfB", "fmA",
             "fmB", "RA", "RB", "pA", "pB", "cylA", "cylB")


def mtv_query_cuda(wA, wB, heA, heB, hmA, hmB, nfA, nfB, fmA, fmB,
                   RA, RB, pA, pB, cylA, cylB, K=K_EDGE,
                   rounds=REFINE_ROUNDS):
    """Launch the CUDA kernel; every tensor float32, contiguous, on one
    CUDA device, with the same leading instance dims."""
    fn = "mtv_query_cuda"
    lead = wA.shape[:-2]
    V, E, F = wA.shape[-2], heA.shape[-3], nfA.shape[-2]
    got = (wA, wB, heA, heB, hmA, hmB, nfA, nfB, fmA, fmB, RA, RB, pA, pB,
           cylA, cylB)
    want = ((V, 3), (V, 3), (E, 2, 3), (E, 2, 3), (E,), (E,), (F, 3), (F, 3),
            (F,), (F,), (3, 3), (3, 3), (3,), (3,), (3,), (3,))
    dev = wA.device
    for name, t, shape in zip(ARG_NAMES, got, want):
        if t.shape != lead + shape:
            raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(lead + shape)}")
        if (t.device != dev or t.dtype != torch.float32
                or not t.is_contiguous() or not t.is_cuda):
            # the slow path names the fault
            cuda_build.check_f32_cuda(fn, **{"wA": wA, name: t})
    K, rounds = int(K), int(rounds)
    if not 1 <= K <= 1024 or rounds < 0:
        raise ValueError(f"{fn}: K={K}, rounds={rounds}")
    lib = _load()
    depth = torch.empty(lead, dtype=torch.float32, device=dev)
    n = torch.empty(lead + (3,), dtype=torch.float32, device=dev)
    # the block layout's two turn counters, zero at the launch
    turns = (torch.zeros(2, dtype=torch.int64, device=dev)
             if lib.mtv_query_block_layout(V, E, F, K) else None)
    cuda_build.launch(
        dev, lib.mtv_query_f32, *[t.data_ptr() for t in got],
        depth.data_ptr(), n.data_ptr(),
        None if turns is None else turns.data_ptr(), depth.numel(), V, E, F,
        K, rounds)
    profiler.count("mtv_query", dev)
    return depth, n


def mtv_query(wA, wB, heA, heB, hmA, hmB, nfA, nfB, fmA, fmB,
              RA, RB, pA, pB, cylA, cylB, K=K_EDGE, rounds=REFINE_ROUNDS):
    """Exact MTV (depth (...,), n (..., 3) unit from A toward B); depth < 0
    means a separating axis exists.  CUDA tensors launch the kernel (or
    raise); CPU tensors take the plain twin."""
    args = (wA, wB, heA, heB, hmA, hmB, nfA, nfB, fmA, fmB,
            RA, RB, pA, pB, cylA, cylB, K, rounds)
    if wA.device.type == "cuda":
        return mtv_query_cuda(*args)
    if wA.device.type == "cpu":
        return mtv_query_plain(*args)
    raise ValueError(f"mtv_query: unsupported device {wA.device}")
