"""Card tests of the port (marked ``cuda``; they skip without a CUDA
device).  This file imports no jax: the machine with the card has none.
There, run it without the jax-importing conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import pathlib

import numpy as np
import pytest
import torch

import mujoco_sim_tpu_torch as mst
from mujoco_sim_tpu_torch.ops import (chol, chol_factor, face_sat, hull_sat,
                                      manifold, mtv_query, support_minmax)
from mujoco_sim_tpu_torch.parallel.rollout import rollout_eager
from mujoco_sim_tpu_torch.runtime import profiler
from mujoco_sim_tpu_torch.utils import kernel_cases

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _spd_batch(rng, N, n):
    A = rng.standard_normal((N, n, n))
    return A @ A.transpose(0, 2, 1) + n * np.eye(n)


def _case(name):
    """The cases of tests/test_pallas_chol.py, and one env's solves."""
    rng = np.random.default_rng(0)
    if name == "n49_N130":
        return _spd_batch(rng, 130, 49), rng.standard_normal((130, 49))
    if name in ("n24_N1", "n36_N1"):     # the one-env server's solves
        n = int(name[1:3])
        return _spd_batch(rng, 1, n), rng.standard_normal((1, n))
    if name == "stiff_1e9":
        A = _spd_batch(rng, 4, 12)
        A[:, 0, 0] += 1e9                # stiff Newton-Hessian rows
        return A, rng.standard_normal((4, 12))
    A = _spd_batch(rng, 15, 7).reshape(5, 3, 7, 7)     # batched E x B
    return A, rng.standard_normal((5, 3, 7))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["n49_N130", "stiff_1e9", "batched_ExB",
                                  "n24_N1", "n36_N1"])
def test_kernel_matches_plain_twin(case, cuda_device):
    """f32 kernel vs f32 plain twin on the same CUDA tensors: the two round
    differently (FMA, multiply by the pivot's inverse), hence 2e-5 as in
    tests/test_pallas_chol.py."""
    A, b = _case(case)
    At = torch.tensor(A, dtype=torch.float32, device=cuda_device)
    bt = torch.tensor(b, dtype=torch.float32, device=cuda_device)
    before = chol.LAUNCHES
    x = chol.chol_solve(At, bt)
    torch.cuda.synchronize()
    assert chol.LAUNCHES == before + 1
    assert bool(torch.isfinite(x).all())
    torch.testing.assert_close(x, chol.chol_solve_plain(At, bt),
                               rtol=2e-5, atol=2e-5)
    r = (At @ x[..., None])[..., 0] - bt
    assert float(r.abs().max()) < 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("case", kernel_cases.CHOL_CASES)
def test_chol_kernels_edge_cases(case, cuda_device):
    """chol_solve and chol_factor against their twins on the cases of
    tests/test_torch_kernels_twins.py: both sides of every size class at a
    batch of 37, a stiff row at n = 33, a pivot at the 1e-30 floor."""
    A, b = kernel_cases.chol_case(case)
    At = torch.tensor(A, dtype=torch.float32, device=cuda_device)
    bt = torch.tensor(b, dtype=torch.float32, device=cuda_device)
    x = chol.chol_solve(At, bt)
    L = chol_factor.chol_factor(At)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(x).all()) and bool(torch.isfinite(L).all())
    torch.testing.assert_close(x, chol.chol_solve_plain(At, bt),
                               rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(L, chol_factor.chol_factor_plain(At),
                               rtol=2e-5, atol=2e-5)
    assert bool((torch.triu(L, 1) == 0).all())
    if case == "stiff_n33":
        r = (At @ x[..., None])[..., 0] - bt
        assert float(r.abs().max()) < 1e-2


@pytest.mark.cuda
def test_kernel_wrapper_rejects_what_it_cannot_take(cuda_device):
    A = torch.eye(3, device=cuda_device).expand(2, 3, 3)
    b = torch.ones(2, 3, device=cuda_device)
    with pytest.raises(ValueError):                     # not contiguous
        chol.chol_solve(A, b)
    with pytest.raises(TypeError):                      # not float32
        chol.chol_solve(A.double().contiguous(), b.double())
    with pytest.raises(ValueError):                     # n < 1
        chol.chol_solve(torch.ones(1, 0, 0, device=cuda_device),
                        torch.ones(1, 0, device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("case", kernel_cases.CHOL_BIG_CASES)
def test_chol_kernels_above_the_size_classes(case, cuda_device):
    """n > 64: one block a system, factored in panels of 32 columns in
    shared memory up to n = 236 and in device memory beyond, both sides of
    every panel, thread-count and memory edge (utils/kernel_cases
    CHOL_BIG_SIZES), a batch of 1031 at n = 66, a stiff 1e9 row and a
    floored pivot: chol_solve and chol_factor launch their kernels and
    agree with their twins at the band of the size classes (2e-5)."""
    A, b = kernel_cases.chol_big_case(case)
    At = torch.tensor(A, dtype=torch.float32, device=cuda_device)
    bt = torch.tensor(b, dtype=torch.float32, device=cuda_device)
    before = chol.LAUNCHES, chol_factor.LAUNCHES
    x = chol.chol_solve(At, bt)
    L = chol_factor.chol_factor(At)
    torch.cuda.synchronize()
    assert (chol.LAUNCHES, chol_factor.LAUNCHES) == (before[0] + 1,
                                                     before[1] + 1)
    assert bool(torch.isfinite(x).all()) and bool(torch.isfinite(L).all())
    torch.testing.assert_close(x, chol.chol_solve_plain(At, bt),
                               rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(L, chol_factor.chol_factor_plain(At),
                               rtol=2e-5, atol=2e-5)
    assert bool((torch.triu(L, 1) == 0).all())
    if case == "stiff_n96":
        r = (At @ x[..., None])[..., 0] - bt
        assert float(r.abs().max()) < 1e-2
    if case == "floor_n72":
        assert float(x[:, 1].abs().max()) < 1e-20


@pytest.mark.cuda
def test_step_on_card_runs_the_kernel(cuda_device):
    """f32 on the card: every SPD solve is a kernel launch (two per step
    plus one per Newton iteration) and qLD stays zero."""
    m = mst.put_model(mst.load_model(str(FIXTURES / "floor_box.xml")),
                      torch.float32, cuda_device)
    assert not torch.backends.cuda.matmul.allow_tf32
    d = mst.make_data(m, 64)
    qpos = d.qpos.clone()
    qpos[:, 2] = 0.1                         # start just above the floor
    before = chol.LAUNCHES
    # the eager rollout: a graph replay runs without the wrappers
    d = rollout_eager(m, d.replace(qpos=qpos), 20)
    torch.cuda.synchronize()
    assert chol.LAUNCHES - before > 2 * 20
    assert bool((d.qLD == 0).all())
    assert bool(torch.isfinite(d.qpos).all() & torch.isfinite(d.qvel).all())
    assert int(d.ncon.min()) > 0


def _hull_inputs(rng, N, V, F, dev):
    pts = rng.standard_normal((N, V, 3))
    n = rng.standard_normal((N, F, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    planes = np.concatenate([n, rng.uniform(0.3, 1.2, (N, F, 1))], axis=-1)
    mask = (rng.uniform(size=(N, V)) > 0.25).astype(np.float64)
    mask[:, 0] = 1.0
    t = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    return t(pts), t(planes), t(mask), t(rng.uniform(0.0, 0.3, (N,)))


@pytest.mark.cuda
@pytest.mark.parametrize("V,F", [(8, 12), (24, 44), (80, 144)])
@pytest.mark.parametrize("K,lateral", [(2, False), (2, True), (4, True)])
def test_hull_sat_kernel_matches_plain_twin(V, F, K, lateral, cuda_device):
    """f32 kernel (built without FMA contraction) vs f32 twin on the same
    CUDA tensors: values to 1e-6 + 1e-5 rel, indices equal on these
    tie-free random inputs."""
    rng = np.random.default_rng(0)
    pts, planes, mask, slack = _hull_inputs(rng, 1000, V, F, cuda_device)
    before = hull_sat.LAUNCHES
    out = hull_sat.hull_ref_face_depth(pts, planes, K, mask, lateral, slack)
    torch.cuda.synchronize()
    assert hull_sat.LAUNCHES == before + 1
    ref = hull_sat.hull_ref_face_depth_plain(pts, planes, K, mask, lateral,
                                             slack)
    torch.testing.assert_close(out[0], ref[0], rtol=1e-5, atol=1e-6)
    assert torch.equal(out[1], ref[1])
    torch.testing.assert_close(out[2], ref[2], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(out[3], ref[3], rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("C,V", [(68, 24), (256, 24), (288, 80)])
def test_support_minmax_kernel_matches_plain_twin(C, V, cuda_device):
    rng = np.random.default_rng(1)
    axes = torch.tensor(rng.normal(size=(500, C, 3)), dtype=torch.float32,
                        device=cuda_device)
    w = torch.tensor(rng.normal(size=(500, V, 3)), dtype=torch.float32,
                     device=cuda_device)
    before = support_minmax.LAUNCHES
    mn, mx = support_minmax.support_minmax(axes, w)
    torch.cuda.synchronize()
    assert support_minmax.LAUNCHES == before + 1
    rn, rx = support_minmax.support_minmax_plain(axes, w)
    torch.testing.assert_close(mn, rn, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(mx, rx, rtol=1e-5, atol=1e-6)


def _mtv_inputs(rng, N, V, E, F, dev):
    def hull(cyl_every):
        pts = rng.normal(size=(N, V, 3)) * 0.3
        R = np.linalg.qr(rng.normal(size=(N, 3, 3)))[0]
        R[:, :, 0] *= np.sign(np.linalg.det(R))[:, None]
        p = rng.normal(size=(N, 3)) * 0.1
        w = p[:, None] + pts @ R.transpose(0, 2, 1)
        he = rng.normal(size=(N, E, 2, 3)) * 0.3
        hm = (rng.uniform(size=(N, E)) > 0.2).astype(np.float64)
        nf = rng.normal(size=(N, F, 3))
        nf /= np.linalg.norm(nf, axis=-1, keepdims=True)
        fm = (rng.uniform(size=(N, F)) > 0.15).astype(np.float64)
        fm[:, 0] = 1.0
        cyl = np.zeros((N, 3))
        cyl[::cyl_every] = [1.0, 0.2, 0.35]
        return w, he, hm, nf, fm, R, p, cyl
    A, B = hull(2), hull(3)
    order = (0, 1, 2, 3, 4, 5, 6, 7)
    t = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    # wA wB heA heB hmA hmB nfA nfB fmA fmB RA RB pA pB cylA cylB
    return [t(x) for i in order for x in (A[i], B[i])]


@pytest.mark.cuda
@pytest.mark.parametrize("V,E,F", [(8, 12, 6), (24, 56, 34), (80, 216, 144)])
def test_mtv_query_kernel_matches_plain_twin(V, E, F, cuda_device):
    """Depth to 2e-5 (the band of tests/test_pallas_refine.py: cross axes
    of nearly parallel edges are ill-conditioned in f32), axes agreeing in
    all but a few near-tied lanes; mtv_staged (support_minmax inside)
    likewise."""
    rng = np.random.default_rng(2)
    args = _mtv_inputs(rng, 1000, V, E, F, cuda_device)
    before = mtv_query.LAUNCHES, support_minmax.LAUNCHES
    dep, n = mtv_query.mtv_query(*args)
    dep_s, n_s = manifold.mtv_staged(*args)
    torch.cuda.synchronize()
    assert mtv_query.LAUNCHES == before[0] + 1
    assert support_minmax.LAUNCHES > before[1]
    rd, rn = mtv_query.mtv_query_plain(*args)
    for d_, n_ in ((dep, n), (dep_s, n_s)):
        torch.testing.assert_close(d_, rd, rtol=1e-5, atol=2e-5)
        assert int(((n_ * rn).sum(-1) < 1 - 1e-5).sum()) <= 10


@pytest.mark.cuda
@pytest.mark.parametrize("case", kernel_cases.MTV_CASES)
def test_mtv_query_kernel_edge_cases(case, cuda_device):
    """The kernel's edge ranking against the twin's K argmin passes: fewer
    edges than K, every edge of a hull masked, exactly tied scores, and
    the cylinder support on either side.  Depth to 2e-5; random hulls tie
    nowhere else, so the axes agree."""
    b = kernel_cases.mtv_case(case)
    args = [torch.tensor(b[k], dtype=torch.float32, device=cuda_device)
            for k in kernel_cases.MTV_ORDER]
    dep, n = mtv_query.mtv_query(*args)
    torch.cuda.synchronize()
    rd, rn = mtv_query.mtv_query_plain(*args)
    assert bool(torch.isfinite(dep).all())
    torch.testing.assert_close(dep, rd, rtol=1e-5, atol=2e-5)
    assert int(((n * rn).sum(-1) < 1 - 1e-5).sum()) <= 1
    if case.startswith("masked"):
        d0, n0 = mtv_query.mtv_query(*args, rounds=0)
        assert torch.equal(dep, d0) and torch.equal(n, n0)


def _big_case(case, N, dev):
    b = kernel_cases.mtv_big_case(case, N)
    return [torch.tensor(b[k], dtype=torch.float32, device=dev)
            for k in kernel_cases.MTV_ORDER]


# the live lanes of the 8192-slot batch with few live: where the bighull
# step's deep-pair compaction puts a handful of pairs among empty slots
FEW_LIVE = (0, 17, 1000, 4095, 5001, 7777, 8191)


def _big_batch(case, N, live, dev):
    """The query's arguments over N lanes, the twin's result on each lane
    (from the distinct instances only: the twin's supports over every lane
    of an 8192 batch would not fit the card), and the mask of empty slots.
    live None: mtv_big_case at N.  "few": FEW_LIVE lanes live, the rest
    empty slots (every table zero).  "all": every lane live, the live
    instances of mtv_big_case(case, 40) repeated."""
    if live is None:
        args = _big_case(case, N, dev)
        empty = torch.zeros(N, dtype=torch.bool, device=dev)
        empty[2::5] = True
        rd, rn = mtv_query.mtv_query_plain(*args)
        return args, rd, rn, empty
    base = _big_case(case, 40, dev)
    keep = torch.tensor([i for i in range(40) if i % 5 != 2], device=dev)
    base = [a[keep] for a in base]
    rd0, rn0 = mtv_query.mtv_query_plain(*base)
    if live == "all":
        idx = torch.arange(N, device=dev) % len(keep)
        args = [a[idx].contiguous() for a in base]
        return (args, rd0[idx], rn0[idx],
                torch.zeros(N, dtype=torch.bool, device=dev))
    lanes = torch.tensor(FEW_LIVE, device=dev)
    args = [a.new_zeros((N,) + a.shape[1:]) for a in base]
    for a, src in zip(args, base):
        a[lanes] = src[: len(FEW_LIVE)]
    empty = torch.ones(N, dtype=torch.bool, device=dev)
    empty[lanes] = False
    # an empty slot's twin: (inf, A's first face normal), zeros here
    rd_e, rn_e = mtv_query.mtv_query_plain(*[a[1:2] for a in args])
    rd = rd_e.expand(N).clone()
    rn = rn_e.expand(N, 3).clone()
    rd[lanes], rn[lanes] = rd0[: len(FEW_LIVE)], rn0[: len(FEW_LIVE)]
    return args, rd, rn, empty


@pytest.mark.cuda
@pytest.mark.parametrize("case", kernel_cases.MTV_BIG_CASES)
@pytest.mark.parametrize("N,live", [(5, None), (130, None), (8192, "few"),
                                    (8192, "all")])
def test_mtv_query_kernel_big_tables(case, N, live, cuda_device):
    """Tables compiled from full hulls, over the 47 KB a block gets without
    an opt-in (pebble256) and past half the 227 KB a block can opt into
    (pebble1200: edges and faces read from device memory): one launch of
    the block layout, depth to 2e-5 of the twin, axes equal but at a
    near-tie of the twin's, and every empty slot bit for bit; at 8192
    lanes with the bighull step's pattern (a few live among empty slots)
    and with every lane live."""
    args, rd, rn, empty = _big_batch(case, N, live, cuda_device)
    before = mtv_query.LAUNCHES
    dep, n = mtv_query.mtv_query(*args)
    torch.cuda.synchronize()
    assert mtv_query.LAUNCHES == before + 1
    assert torch.equal(dep[empty], rd[empty])
    assert torch.equal(n[empty], rn[empty])
    assert bool(torch.isfinite(dep[~empty]).all())
    torch.testing.assert_close(dep, rd, rtol=1e-5, atol=2e-5)
    axis_off = ((n * rn).sum(-1) < 1 - 1e-5) & ~empty
    assert int(axis_off.sum()) <= max(1, N // 100)


def _random_hull_pairs(rng, N, V, E, F):
    """Random hull pairs of any table size (utils/kernel_cases.mtv_case's
    generator): clouds of V points, E random local edges (a fifth masked),
    F unit face normals (some masked), as the query's 16 arguments."""
    out = {}
    for side in "AB":
        R = np.linalg.qr(rng.normal(size=(N, 3, 3)))[0]
        R[:, :, 0] *= np.sign(np.linalg.det(R))[:, None]
        p = rng.normal(size=(N, 3)) * 0.1
        nf = rng.normal(size=(N, F, 3))
        nf /= np.linalg.norm(nf, axis=-1, keepdims=True)
        fm = (rng.uniform(size=(N, F)) > 0.15).astype(np.float64)
        fm[:, 0] = 1.0
        out.update({
            "w" + side: p[:, None] + (rng.normal(size=(N, V, 3)) * 0.3)
            @ R.transpose(0, 2, 1),
            "he" + side: rng.normal(size=(N, E, 2, 3)) * 0.3,
            "hm" + side: (rng.uniform(size=(N, E)) > 0.2).astype(np.float64),
            "nf" + side: nf, "fm" + side: fm, "R" + side: R, "p" + side: p,
            "cyl" + side: np.zeros((N, 3))})
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("V,E,F", [(4000, 56, 34), (24, 8000, 34)])
def test_mtv_query_kernel_tables_in_device_memory(V, E, F, cuda_device):
    """Tables past half the card's shared memory that the block layout
    reads from device memory: 4000-vertex clouds (the vertices scanned from
    device memory), 8000 edges (the edge keys computed again each pass):
    depth to 2e-5 of the twin, axes equal but at a near-tie."""
    b = _random_hull_pairs(np.random.default_rng(7), 9, V, E, F)
    args = [torch.tensor(b[k], dtype=torch.float32, device=cuda_device)
            for k in kernel_cases.MTV_ORDER]
    dep, n = mtv_query.mtv_query(*args)
    torch.cuda.synchronize()
    rd, rn = mtv_query.mtv_query_plain(*args)
    assert bool(torch.isfinite(dep).all())
    torch.testing.assert_close(dep, rd, rtol=1e-5, atol=2e-5)
    assert int(((n * rn).sum(-1) < 1 - 1e-5).sum()) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["duplicates", "e_lt_k", "cyl_both"])
def test_mtv_query_kernel_empty_slots(case, cuda_device):
    """The tables a layout of PR 4 size takes, with the compaction's empty
    slots (every third lane all zero) and lanes whose faces are all masked
    and one hull's edges too: those return (+inf, A's first face normal)
    without scanning, bit for bit the twin's; the rest as before."""
    b = kernel_cases.mtv_case(case)
    for v in b.values():
        v[::3] = 0.0
    b["fmA"][1::3] = b["fmB"][1::3] = b["hmB"][1::3] = 0.0
    args = [torch.tensor(b[k], dtype=torch.float32, device=cuda_device)
            for k in kernel_cases.MTV_ORDER]
    dep, n = mtv_query.mtv_query(*args)
    torch.cuda.synchronize()
    rd, rn = mtv_query.mtv_query_plain(*args)
    skip = torch.arange(dep.shape[0], device=cuda_device) % 3 < 2
    assert bool(torch.isinf(rd[skip]).all())
    assert torch.equal(dep[skip], rd[skip]) and torch.equal(n[skip],
                                                            rn[skip])
    torch.testing.assert_close(dep, rd, rtol=1e-5, atol=2e-5)
    assert int((((n * rn).sum(-1) < 1 - 1e-5) & ~skip).sum()) <= 1


# widths about the launcher's two layouts: 8-lane teams of 9 axes up to
# C = 72, then warps of 32 lanes x 8 axes in chunks of 256 (257 and 1016:
# two and four chunks)
SUPPORT_WIDTHS = (1, 9, 68, 72, 73, 200, 256, 257, 1016)


@pytest.mark.cuda
@pytest.mark.parametrize("V", [24, 256, 5000])
def test_support_minmax_kernel_every_layout(V, cuda_device):
    """Both layouts the launcher picks, at their edges and in chunks,
    vertex clouds within one stage, over several tiles (256) and past the
    old cap of 4096: the kernel equals its twin bit for bit (both round
    every multiply and add; min and max are exact)."""
    rng = np.random.default_rng(V)
    N = 37 if V < 5000 else 9
    w = torch.tensor(rng.normal(size=(N, V, 3)), dtype=torch.float32,
                     device=cuda_device)
    for C in SUPPORT_WIDTHS:
        axes = torch.tensor(rng.normal(size=(N, C, 3)), dtype=torch.float32,
                            device=cuda_device)
        before = support_minmax.LAUNCHES
        mn, mx = support_minmax.support_minmax(axes, w)
        torch.cuda.synchronize()
        assert support_minmax.LAUNCHES == before + 1
        rn, rx = support_minmax.support_minmax_plain(axes, w)
        assert torch.equal(mn, rn) and torch.equal(mx, rx), (C, V)


@pytest.mark.cuda
def test_collision_wrappers_reject_what_they_cannot_take(cuda_device):
    pts = torch.zeros(4, 8, 3, device=cuda_device)
    planes = torch.zeros(4, 12, 4, device=cuda_device)
    with pytest.raises(TypeError):                      # not float32
        hull_sat.hull_ref_face_depth(pts.double(), planes.double(), 2)
    with pytest.raises(ValueError):                     # k_out >= V
        hull_sat.hull_ref_face_depth(pts, planes, 8)
    with pytest.raises(ValueError):                     # not contiguous
        hull_sat.hull_ref_face_depth(pts.transpose(0, 1).contiguous()
                                     .transpose(0, 1), planes, 2)
    with pytest.raises(ValueError):                     # shapes
        support_minmax.support_minmax(pts, planes)


@pytest.mark.cuda
def test_manip_rollout_on_card_runs_the_collision_kernels(cuda_device):
    """20 stirred steps of manip_bin6 at 64 envs, f32 on the card: both
    hull_ref_face_depth calls and the exact-MTV query launch every step,
    nothing goes non-finite, the objects stay in the bin."""
    m = mst.put_model(mst.load_model(str(FIXTURES / "manip_bin6.xml")))
    assert m.device.type == "cuda" and m.dtype == torch.float32
    d = mst.make_data(m, 64)
    phase = torch.tensor(np.random.default_rng(1).uniform(0, 6.28, (64, m.nu)),
                         dtype=torch.float32, device=cuda_device)
    before = hull_sat.LAUNCHES, mtv_query.LAUNCHES, chol.LAUNCHES
    # the eager rollout: a graph replay runs without the wrappers
    d = rollout_eager(m, d, 20,
                      ctrl_fn=lambda d_: torch.sin(4.0 * d_.time[:, None]
                                                   + phase))
    torch.cuda.synchronize()
    assert hull_sat.LAUNCHES - before[0] == 2 * 20
    assert mtv_query.LAUNCHES - before[1] == 20
    assert chol.LAUNCHES - before[2] > 2 * 20
    assert bool(torch.isfinite(d.qpos).all() & torch.isfinite(d.qvel).all())
    pos = torch.stack([d.qpos[:, 6 + 7 * i:9 + 7 * i] for i in range(6)], 1)
    assert bool((pos[..., :2].abs() < 0.34).all() & (pos[..., 2] > 0).all())
    assert int(d.ncon.min()) >= 8


# ------------------------------------------- chol_factor, face_sat_depth

@pytest.mark.cuda
@pytest.mark.parametrize("N,n", [(4096, 6), (1024, 42), (256, 49), (130, 64),
                                 (1, 1)])
def test_chol_factor_kernel_matches_plain_twin(N, n, cuda_device):
    """f32 kernel vs f32 twin (ops/linalg.cholesky): 2e-5 absolute plus
    relative, the band of chol_solve; zeros above the diagonal."""
    rng = np.random.default_rng(n)
    A = torch.tensor(_spd_batch(rng, N, n), dtype=torch.float32,
                     device=cuda_device)
    before = chol_factor.LAUNCHES
    L = chol_factor.chol_factor(A)
    torch.cuda.synchronize()
    assert chol_factor.LAUNCHES == before + 1
    assert bool((torch.triu(L, 1) == 0).all())
    torch.testing.assert_close(L, chol_factor.chol_factor_plain(A),
                               rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(L, torch.linalg.cholesky(A), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.cuda
def test_chol_factor_kernel_stiff_and_batched(cuda_device):
    rng = np.random.default_rng(0)
    A = _spd_batch(rng, 15, 12)
    A[:, 0, 0] += 1e9                        # stiff Newton-Hessian rows
    At = torch.tensor(A.reshape(5, 3, 12, 12), dtype=torch.float32,
                      device=cuda_device)
    L = chol_factor.chol_factor(At)
    assert L.shape == At.shape and bool(torch.isfinite(L).all())
    torch.testing.assert_close(L, chol_factor.chol_factor_plain(At),
                               rtol=2e-5, atol=2e-5)
    resid = (L @ L.transpose(-1, -2) - At).abs().amax((-1, -2)) / 1e9
    assert float(resid.max()) < 1e-5


@pytest.mark.cuda
def test_chol_factor_wrapper_rejects_what_it_cannot_take(cuda_device):
    A = torch.eye(3, device=cuda_device).expand(2, 3, 3)
    before = chol_factor.LAUNCHES
    with pytest.raises(ValueError):                     # not contiguous
        chol_factor.chol_factor(A)
    with pytest.raises(TypeError):                      # not float32
        chol_factor.chol_factor(A.double().contiguous())
    with pytest.raises(ValueError):                     # n < 1
        chol_factor.chol_factor(torch.ones(1, 0, 0, device=cuda_device))
    with pytest.raises(ValueError):                     # not square
        chol_factor.chol_factor(torch.ones(2, 3, 4, device=cuda_device))
    with pytest.raises(ValueError):                     # a CPU tensor
        chol_factor.chol_factor_cuda(torch.eye(3)[None])
    assert chol_factor.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("V,F", [(8, 12), (32, 60), (80, 144)])
@pytest.mark.parametrize("K", [2, 4])
def test_face_sat_kernel_matches_plain_twin(V, F, K, cuda_device):
    """Random, masked and exactly tied inputs (two identical faces, two
    identical vertices, an instance with every point masked): every index
    equal, values within 1e-6 + 1e-5 relative."""
    rng = np.random.default_rng(V + K)
    for N in (130, 8192):
        pts, planes, mask, _ = _hull_inputs(rng, N, V, F, cuda_device)
        planes[::3, F - 1] = planes[::3, 1]
        pts[::4, V - 1] = pts[::4, 2]
        mask[::4, V - 1] = mask[::4, 2] = 1.0
        mask[1] = 0.0
        before = face_sat.LAUNCHES
        out = face_sat.face_sat_depth(pts, planes, mask, K)
        torch.cuda.synchronize()
        assert face_sat.LAUNCHES == before + 1
        ref = face_sat.face_sat_depth_plain(pts, planes, mask, K)
        assert out[1].dtype == torch.int32
        assert bool((out[1] == ref[1]).all())
        for a, b in ((out[0], ref[0]), (out[2], ref[2]), (out[3], ref[3])):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        assert bool((out[1][1] == 0).all() & (out[0][1] == 1e9).all())


def _sat_case(case, dev):
    c = kernel_cases.sat_case(case)
    t = lambda x: None if x is None else torch.tensor(
        x, dtype=torch.float32, device=dev)
    slack = c["slack"] if isinstance(c["slack"], float) else t(c["slack"])
    return t(c["pts"]), t(c["planes"]), t(c["mask"]), slack, c["K"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", kernel_cases.SAT_CASES)
def test_sat_kernels_edge_cases(case, cuda_device):
    """Both face-SAT kernels (csrc/face_sat.cuh) against their twins on the
    edge cases of utils/kernel_cases.py: the three layouts and the tiled
    V > 32, K = V - 1, an all-masked instance, exactly tied reference faces
    and depths, a filter that drops every point, scalar slack, no mask.
    Indices and the reference face identical; depth, sep and the normal or
    plane within 1e-6 + 1e-5 relative, the band of the random cases above."""
    pts, planes, mask, slack, K = _sat_case(case, cuda_device)
    for lateral in (False, True):
        before = hull_sat.LAUNCHES
        out = hull_sat.hull_ref_face_depth(pts, planes, K, mask, lateral,
                                           slack)
        torch.cuda.synchronize()
        assert hull_sat.LAUNCHES == before + 1
        ref = hull_sat.hull_ref_face_depth_plain(pts, planes, K, mask,
                                                 lateral, slack)
        assert torch.equal(out[1], ref[1]) and torch.equal(out[2], ref[2])
        for a, b in ((out[0], ref[0]), (out[3], ref[3])):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    vm = torch.ones(pts.shape[:-1], device=cuda_device) if mask is None \
        else mask
    before = face_sat.LAUNCHES
    out = face_sat.face_sat_depth(pts, planes, vm, K)
    torch.cuda.synchronize()
    assert face_sat.LAUNCHES == before + 1
    ref = face_sat.face_sat_depth_plain(pts, planes, vm, K)
    assert torch.equal(out[1], ref[1]) and torch.equal(out[2], ref[2])
    for a, b in ((out[0], ref[0]), (out[3], ref[3])):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_face_sat_wrapper_rejects_what_it_cannot_take(cuda_device):
    pts = torch.zeros(4, 8, 3, device=cuda_device)
    planes = torch.zeros(4, 12, 4, device=cuda_device)
    mask = torch.ones(4, 8, device=cuda_device)
    before = face_sat.LAUNCHES
    with pytest.raises(TypeError):                      # not float32
        face_sat.face_sat_depth(pts.double(), planes.double(), mask.double())
    with pytest.raises(ValueError):                     # K > V
        face_sat.face_sat_depth(pts, planes, mask, 9)
    with pytest.raises(ValueError):                     # mask shape
        face_sat.face_sat_depth(pts, planes, mask[:, :7])
    with pytest.raises(ValueError):                     # not contiguous
        face_sat.face_sat_depth(pts.transpose(0, 1).contiguous()
                                .transpose(0, 1), planes, mask)
    with pytest.raises(ValueError):                     # a CPU tensor
        face_sat.face_sat_depth_cuda(pts.cpu(), planes.cpu(), mask.cpu())
    assert face_sat.LAUNCHES == before


@pytest.mark.cuda
def test_precise_rollout_on_card_factors_once_per_step(cuda_device):
    """20 stirred steps of manip_bin6_precise at 32 envs, f32 on the card:
    chol_factor launches once per step and qLD is the factor of qM; the
    sensors read finite values."""
    m = mst.put_model(mst.load_model(
        str(FIXTURES / "manip_bin6_precise.xml")))
    d = mst.make_data(m, 32)
    phase = torch.tensor(np.random.default_rng(1).uniform(0, 6.28, (32, m.nu)),
                         dtype=torch.float32, device=cuda_device)
    before = chol_factor.LAUNCHES, hull_sat.LAUNCHES, face_sat.LAUNCHES
    # the eager rollout: a graph replay runs without the wrappers, which
    # count only its warm-up call and its capture
    d = rollout_eager(m, d, 20,
                      ctrl_fn=lambda d_: torch.sin(4.0 * d_.time[:, None]
                                                   + phase))
    torch.cuda.synchronize()
    assert chol_factor.LAUNCHES - before[0] == 20
    assert hull_sat.LAUNCHES - before[1] == 2 * 20
    assert face_sat.LAUNCHES == before[2]          # no step calls it
    torch.testing.assert_close(d.qLD @ d.qLD.transpose(-1, -2), d.qM,
                               rtol=1e-4, atol=1e-5)
    assert d.sensordata.shape == (32, 31)
    assert bool(torch.isfinite(d.sensordata).all())
    assert bool(torch.isfinite(d.qpos).all() & torch.isfinite(d.qvel).all())


@pytest.mark.cuda
@pytest.mark.parametrize("integrator", ["RK4", "IMPLICIT", "IMPLICITFAST"])
def test_integrators_on_card(integrator, cuda_device):
    from mujoco_sim_tpu_torch.models.model import Integrator
    m = mst.put_model(mst.load_model(str(FIXTURES / "floor_box.xml")))
    m = m.replace(opt=m.opt.replace(
        integrator=int(getattr(Integrator, integrator))))
    d = mst.make_data(m, 64)
    qpos = d.qpos.clone()
    qpos[:, 2] = 0.1
    d = mst.rollout(m, d.replace(qpos=qpos), 20)
    assert bool(torch.isfinite(d.qpos).all() & torch.isfinite(d.qvel).all())
    assert float(d.qvel.abs().max()) < 0.5 and int(d.ncon.min()) > 0


# ------------------------------------------------ tendons, terrain, control

@pytest.mark.cuda
def test_terrain_rollout_on_card_runs_the_kernels(cuda_device):
    """20 stirred steps of tendon_terrain at 64 envs, f32 on the card
    (tendons with wraps, site and tendon transmissions, heightfield
    contacts, fluid drag): the Cholesky solve, both hull queries and the
    exact-MTV query launch, nothing goes non-finite, the muscles'
    activations stay in [0, 1]."""
    m = mst.put_model(mst.load_model(str(FIXTURES / "tendon_terrain.xml")))
    assert m.ntendon == 7 and m.opt.has_fluid
    d = mst.make_data(m, 64)
    phase = torch.tensor(np.random.default_rng(1).uniform(0, 6.28, (64, m.nu)),
                         dtype=torch.float32, device=cuda_device)
    cr = m.actuator_ctrlrange
    before = hull_sat.LAUNCHES, mtv_query.LAUNCHES, chol.LAUNCHES
    d = rollout_eager(m, d, 20, ctrl_fn=lambda d_: cr[:, 0] + (
        cr[:, 1] - cr[:, 0]) * (0.5 + 0.5 * torch.sin(
            4.0 * d_.time[:, None] + phase)))
    torch.cuda.synchronize()
    assert hull_sat.LAUNCHES - before[0] > 0
    assert mtv_query.LAUNCHES - before[1] == 20
    assert chol.LAUNCHES - before[2] > 2 * 20
    for v in (d.qpos, d.qvel, d.ten_length, d.ten_J, d.sensordata):
        assert bool(torch.isfinite(v).all())
    act = d.act[:, :6]
    assert bool(((act >= 0) & (act <= 1)).all())


@pytest.mark.cuda
def test_control_on_card(cuda_device):
    """step1 -> pd_accel -> apply_control -> step2 on the card; the
    effort hw_interface.read reports is the inverse dynamics at the
    solved state."""
    from mujoco_sim_tpu_torch.control import controllers as C
    from mujoco_sim_tpu_torch.control import hw_interface as HW
    m = mst.put_model(mst.load_model(str(FIXTURES / "arm.xml")))
    cfg = C.pd_config_for_joints(m, ["shoulder", "elbow"], kp=200.0,
                                 kd=30.0)
    d, st = mst.make_data(m, 64), C.make_pd_state(m, 64)
    des = torch.tensor([0.7, -0.4], device=cuda_device).expand(64, 2)

    def ctrl(m_, d_, st_):
        st2 = C.pd_accel(cfg, st_, d_, des, m_.opt.timestep)
        return C.apply_control(m_, d_, st2, cfg.ctrl_mask)

    for _ in range(1500):
        d, st = mst.step_with_control(m, d, ctrl, st)
    torch.testing.assert_close(d.qpos, des, rtol=0, atol=5e-3)
    d = mst.forward(m, d)
    _, _, eff = HW.read(m, d, np.arange(m.nv))
    torch.testing.assert_close(eff, mst.inverse(m, d, d.qacc), rtol=1e-4,
                               atol=1e-4)


def _dropped_boxes(m, nenv, seed=0):
    rng = np.random.default_rng(seed)
    d = mst.make_data(m, nenv)
    qpos = d.qpos.clone()
    qpos[:, 2] += torch.tensor(rng.uniform(0.0, 0.3, nenv),
                               dtype=qpos.dtype, device=qpos.device)
    return d.replace(qpos=qpos)


@pytest.mark.cuda
def test_sharded_rollout_on_one_card_matches_unsharded(cuda_device):
    """Four shards on cuda:0 step as their envs do in the whole batch
    (every loop is masked per env, chol_solve works per system), but for
    the rounding of the batched matmul J^T f (ops/solver.py:231), which
    cuBLAS may compute in another order at another batch size
    (scripts/torch_batch_bits.py): held to 5e-4, the band chip_smoke.py
    sets from its readings of box @4096.  The ring is exact."""
    from mujoco_sim_tpu_torch.parallel import mesh as pmesh
    m = mst.put_model(mst.load_model(str(FIXTURES / "floor_box.xml")))
    d = _dropped_boxes(m, 256)
    mesh = pmesh.make_env_mesh(["cuda:0"] * 4)
    mR = pmesh.replicate_model(m, mesh)
    before = chol.LAUNCHES
    out = pmesh.make_sharded_rollout(mR, mesh, 50)(
        mR, pmesh.shard_batch(d, mesh))
    # one step graph a shard: the wrappers count each shard's warm-up call
    # and capture (at least two solves each), not the replays
    assert chol.LAUNCHES - before >= 4 * 2 * 2
    ref = mst.rollout(m, d, 50)
    torch.testing.assert_close(out.gather().qpos, ref.qpos, rtol=0,
                               atol=5e-4)
    pos, quat = pmesh.exchange_body_state(pmesh.shard_batch(ref, mesh),
                                          mesh, 1)
    assert torch.equal(pos.gather(), torch.roll(ref.xpos[:, 1], 64, 0))
    assert torch.equal(quat.gather(), torch.roll(ref.xquat[:, 1], 64, 0))


@pytest.mark.cuda
def test_rollout_collect_on_card_equals_rollout_traj(cuda_device):
    """The chunked rollout with its copies on a side stream into pinned
    buffers gives rollout_traj's trajectory bit for bit, and so does a
    batch in four shards on one card (each shard's own buffers, one copy
    stream) against its shards' rollout_traj."""
    from mujoco_sim_tpu_torch.parallel import egress, mesh as pmesh
    m = mst.put_model(mst.load_model(str(FIXTURES / "floor_box.xml")))
    d = _dropped_boxes(m, 256, seed=1)
    final, traj = pmesh.rollout_traj(m, d, 48)
    cache = {}
    for _ in range(2):      # the second call reuses the pinned buffers
        got_final, got = egress.rollout_collect(m, d, 48, chunk=16,
                                                jit_cache=cache)
        np.testing.assert_array_equal(got, traj.cpu().numpy())
        assert torch.equal(got_final.qpos, final.qpos)
    assert any(k[0] == "pinned" for k in cache)
    mesh = pmesh.make_env_mesh(["cuda:0"] * 4)
    mR = pmesh.replicate_model(m, mesh)
    dS = pmesh.shard_batch(d, mesh)
    own = [pmesh.rollout_traj(m, s, 48) for s in dS.shards]
    for _ in range(2):
        profiler.clear_spans()
        with profiler.tracing():
            got_final, got = egress.rollout_collect(mR, dS, 48, chunk=16,
                                                    jit_cache=cache)
        np.testing.assert_array_equal(
            got, torch.cat([t for _, t in own], 1).cpu().numpy())
        for (f, _), g in zip(own, got_final.shards):
            assert torch.equal(g.qpos, f.qpos)
    assert len([s for s in profiler.spans() if s.name == "egress.read"]) == 3
    profiler.clear_spans()


# ----------------------------------------------------- the compiled step

def _stirred(m, nenv, seed=1):
    phase = torch.tensor(np.random.default_rng(seed).uniform(
        0, 6.28, (nenv, m.nu)), dtype=torch.float32, device="cuda")
    return (lambda d_: torch.sin(4.0 * d_.time[:, None] + phase)) \
        if m.nu else None


@pytest.mark.cuda
@pytest.mark.parametrize("scene,nenv", [("floor_box.xml", 64),
                                        ("manip_bin6.xml", 32)])
def test_step_graph_matches_eager_on_card(scene, nenv, cuda_device):
    """rollout (one CUDA graph a step, the solver's and GJK's loops as
    WHILE nodes) against rollout_eager over 15 steps: bit for bit, since
    both run the same kernels on the same inputs at the same shapes; and
    one replay under set_sync_debug_mode("error"), which raises at any
    host sync."""
    from mujoco_sim_tpu_torch.parallel.rollout import step_graph
    m = mst.put_model(mst.load_model(str(FIXTURES / scene)))
    d = _dropped_boxes(m, nenv) if scene == "floor_box.xml" else \
        mst.make_data(m, nenv)
    ctrl_fn = _stirred(m, nenv)
    ref = rollout_eager(m, d, 15, ctrl_fn=ctrl_fn)
    got = mst.rollout(m, d, 15, ctrl_fn=ctrl_fn)
    for k in ("qpos", "qvel", "qacc_warmstart", "time"):
        assert torch.equal(getattr(got, k), getattr(ref, k)), k
    torch.cuda.set_sync_debug_mode("error")
    try:
        step_graph(ctrl_fn)(m, got)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_replay_launches_counted_on_card(cuda_device):
    """runtime/profiler.counting: the replays of a manip step captured
    while counts are kept add the hand-written kernels' launches on the
    card (a WHILE body's once an iteration): as many as the eager steps
    from the same state make, by the wrappers' LAUNCHES and on the card;
    the WHILE predicate runs in the replays only.  Outside the block
    nothing counts, and a graph captured there adds nothing."""
    from mujoco_sim_tpu_torch.parallel.rollout import step_graph
    from mujoco_sim_tpu_torch.utils import graph
    m = mst.put_model(mst.load_model(str(FIXTURES / "manip_bin6.xml")))
    ctrl_fn = _stirred(m, 32)
    try:
        graph.clear_all()
        d = mst.rollout(m, mst.make_data(m, 32), 3, ctrl_fn=ctrl_fn)
        c_off = profiler.counts(cuda_device)
        mst.rollout(m, d, 2, ctrl_fn=ctrl_fn)
        assert profiler.counts(cuda_device) == c_off
        graph.clear_all()
        with profiler.counting(cuda_device):
            mst.rollout(m, d, 1, ctrl_fn=ctrl_fn)      # the capture
            g = step_graph(ctrl_fn)
            c0 = profiler.counts(cuda_device)
            g.run(m, d, n=4)
            c1 = profiler.counts(cuda_device)
            mods = dict(chol_solve=chol, hull_ref_face_depth=hull_sat,
                        mtv_query=mtv_query)
            before = {k: mod.LAUNCHES for k, mod in mods.items()}
            rollout_eager(m, d, 4, ctrl_fn=ctrl_fn)
            c2 = profiler.counts(cuda_device)
        for k, mod in mods.items():
            assert (c1[k] - c0[k] == mod.LAUNCHES - before[k]
                    == c2[k] - c1[k] > 0), k
        assert c1["graph_loop"] > c0["graph_loop"]
        assert c2["graph_loop"] == c1["graph_loop"]
        rollout_eager(m, d, 2, ctrl_fn=ctrl_fn)
        assert profiler.counts(cuda_device) == c2
    finally:
        graph.clear_all()


@pytest.mark.cuda
def test_nested_while_nodes_captured(cuda_device):
    """A while loop inside a while loop's body, as the line search runs
    inside a Newton iteration, captured as nested WHILE nodes: the replay
    equals the eager loops on two inputs, with per-env trip counts that
    differ, and each node launches the predicate kernel twice at
    capture."""
    from mujoco_sim_tpu_torch.ops import loops
    from mujoco_sim_tpu_torch.utils.graph import StepGraph
    rng = np.random.default_rng(0)
    x0 = torch.tensor(rng.uniform(0, 1, (300, 3)), dtype=torch.float32,
                      device=cuda_device)
    lim = torch.tensor(rng.integers(0, 30, 300), dtype=torch.int32,
                       device=cuda_device)

    def fn(_, x, lim):
        def body(c):
            x, i = c
            y, k = loops.while_loop(
                lambda cc: (cc[0].sum(-1) > 0.01) & (cc[1] < 5),
                lambda cc: (cc[0] * 0.5, cc[1] + 1),
                (x + 1.0, torch.zeros_like(i)))
            return y + k[:, None].float(), i + 1
        return loops.while_loop(lambda c: c[1] < lim, body,
                                (x, torch.zeros_like(lim)))

    g = StepGraph(fn)
    before = loops.LAUNCHES
    for x in (x0, 2.0 * x0):
        got, ref = g(None, x, lim), fn(None, x, lim)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert torch.equal(got[1], lim)
    assert g.captures == 1 and g.replays == 2
    assert loops.LAUNCHES - before == 4


@pytest.mark.cuda
def test_graph_loop_predicate_matches_any(cuda_device):
    from mujoco_sim_tpu_torch.ops import loops
    for n in (1, 255, 256, 4096, 40960):
        for k in (None, 0, n - 1):
            mask = torch.zeros(n, dtype=torch.bool, device=cuda_device)
            if k is not None:
                mask[k] = True
            assert int(loops.any_cuda(mask)) == int(loops.any_plain(mask))
