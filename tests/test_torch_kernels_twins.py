"""Port parity of the plain PyTorch twins of the collision kernels and of
the two prototype kernels
(mujoco_sim_tpu_torch/ops/{hull_sat,mtv_query,support_minmax,chol_factor,
face_sat}.py) in float32: against the JAX package's function, and against the Pallas
kernel that the CUDA kernel replaces, run in interpret mode as the JAX
package's own tests run it on the CPU.  On the CPU the wrappers take the
twins, so the wrappers are what is called here.

Tolerances: values 1e-6 (f32, same arithmetic, summation order aside),
indices equal.  The MTV query compares at 2e-5 as
tests/test_pallas_refine.py does: its cross axes are normalised in f32,
and the Pallas kernel multiplies by a reciprocal where the twin divides.

The two prototype kernels (benchmarks/pallas_{chol,sat}_proto.py) have
wrappers that pin TPU memory spaces and take no interpret flag, so their
kernel BODIES (make_chol_kernel, make_kernel) are run here through
``pl.pallas_call(..., interpret=True)`` on lane-last blocks of 128
instances.  The factor twin is held to 2e-6 of the row's largest entry
(the prototype multiplies by rsqrt(pivot), the twin divides by
sqrt(pivot)); the face-SAT twin to 1e-6 with every index equal.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mujoco_sim_tpu.ops import linalg as jlinalg
from mujoco_sim_tpu.ops import manifold as jmanifold
from mujoco_sim_tpu.ops.collision import _hull_ref_face_depth as jax_hrfd
from mujoco_sim_tpu.ops.pallas_chol import chol_solve as pallas_chol_solve
from mujoco_sim_tpu.ops.pallas_refine import mtv_query as pallas_mtv
from mujoco_sim_tpu.ops.pallas_sat import hull_ref_face_depth as pallas_hrfd
from mujoco_sim_tpu.ops.pallas_support import support_minmax as pallas_smm
from mujoco_sim_tpu_torch.ops import (chol, chol_factor, face_sat, hull_sat,
                                      manifold, mtv_query)
from mujoco_sim_tpu_torch.ops import support_minmax as smm
from mujoco_sim_tpu_torch.utils import kernel_cases
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

F32 = np.float32


def _sat_case(rng, N, V, F, mask=True):
    pts = rng.standard_normal((N, V, 3)).astype(F32)
    n = rng.standard_normal((N, F, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    d = rng.uniform(0.3, 1.2, (N, F, 1))
    planes = np.concatenate([n, d], axis=-1).astype(F32)
    vm = None
    if mask:
        vm = (rng.uniform(size=(N, V)) > 0.25).astype(F32)
        vm[:, 0] = 1.0  # at least one live vert
    return pts, planes, vm


def _sat_check(pts, planes, vm, k=2, lateral=False, slack=0.0):
    t = lambda x: None if x is None else torch.tensor(x)
    j = lambda x: None if x is None else jnp.asarray(x)
    tslack = torch.tensor(slack) if isinstance(slack, np.ndarray) else slack
    jslack = jnp.asarray(slack) if isinstance(slack, np.ndarray) else slack
    out = hull_sat.hull_ref_face_depth(t(pts), t(planes), k, t(vm), lateral,
                                       tslack)
    for ref in (jax_hrfd(j(pts), j(planes), k, j(vm), lateral_filter=lateral,
                         lateral_slack=jslack),
                pallas_hrfd(j(pts), j(planes), k, j(vm),
                            lateral_filter=lateral, lateral_slack=jslack,
                            interpret=True)):
        dep, idx, nref, sep = (np.asarray(r) for r in ref)
        np.testing.assert_allclose(out[0].numpy(), dep, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(out[1].numpy(), idx)
        np.testing.assert_allclose(out[2].numpy(), nref, rtol=0, atol=1e-6)
        np.testing.assert_allclose(out[3].numpy(), sep, rtol=0, atol=1e-6)
    assert out[0].dtype == torch.float32 and out[1].dtype == torch.int64


@pytest.mark.parametrize("case", ["plain", "masked", "lateral", "lateral_k4",
                                  "tie"])
def test_hull_ref_face_depth_twin(case):
    rng = np.random.default_rng(0)
    if case == "plain":
        pts, planes, _ = _sat_case(rng, 50, 12, 20, mask=False)
        _sat_check(pts, planes, None)
    elif case == "masked":
        _sat_check(*_sat_case(rng, 37, 9, 14))
    elif case == "lateral":
        pts, planes, vm = _sat_case(rng, 41, 10, 16)
        _sat_check(pts, planes, vm, lateral=True,
                   slack=rng.uniform(0.0, 0.3, (41,)).astype(F32))
    elif case == "lateral_k4":
        pts, planes, vm = _sat_case(rng, 130, 24, 44)
        _sat_check(pts, planes, vm, k=4, lateral=True,
                   slack=rng.uniform(0.0, 0.3, (130,)).astype(F32))
    else:
        # duplicated vertices force exact depth ties, and a duplicated
        # face an exact reference-face tie: the lowest index wins
        pts, planes, _ = _sat_case(rng, 8, 6, 10, mask=False)
        pts[:, 3] = pts[:, 1]
        planes[:, 7] = planes[:, 2]
        _sat_check(pts, planes, None)


def test_hull_ref_face_depth_leading_dims():
    """(B, P) leading dims give the flattened result."""
    rng = np.random.default_rng(1)
    pts, planes, vm = _sat_case(rng, 15, 8, 12)
    flat = hull_sat.hull_ref_face_depth(torch.tensor(pts),
                                        torch.tensor(planes), 2,
                                        torch.tensor(vm), True, 0.1)
    nest = hull_sat.hull_ref_face_depth(
        torch.tensor(pts).reshape(3, 5, 8, 3),
        torch.tensor(planes).reshape(3, 5, 12, 4), 2,
        torch.tensor(vm).reshape(3, 5, 8), True, 0.1)
    for a, b in zip(flat, nest):
        assert torch.equal(a, b.reshape(a.shape))


@pytest.mark.parametrize("C,V,N", [(324, 24, 5), (68, 24, 128), (33, 7, 200),
                                   (256, 48, 1)])
def test_support_minmax_twin(C, V, N):
    rng = np.random.default_rng(0)
    axes = rng.normal(size=(N, C, 3)).astype(F32)
    w = rng.normal(size=(N, V, 3)).astype(F32)
    mn, mx = smm.support_minmax(torch.tensor(axes), torch.tensor(w))
    p = (axes[:, :, None, :] * w[:, None, :, :]).sum(-1)
    pn, px = pallas_smm(jnp.asarray(axes), jnp.asarray(w), interpret=True)
    for rn, rx in ((p.min(-1), p.max(-1)), (np.asarray(pn), np.asarray(px))):
        np.testing.assert_allclose(mn.numpy(), rn, rtol=0, atol=1e-6)
        np.testing.assert_allclose(mx.numpy(), rx, rtol=0, atol=1e-6)


def _rand_hull(rng, V, E, F, cyl=False):
    """Random vertex cloud + edge/face tables + pose for one lane (the
    generator of tests/test_pallas_refine.py)."""
    pts = rng.normal(size=(V, 3)) * 0.3
    q = rng.normal(size=(3, 3))
    R, _ = np.linalg.qr(q)
    if np.linalg.det(R) < 0:
        R[:, 0] *= -1
    p = rng.normal(size=(3,)) * 0.1
    w = p[None] + pts @ R.T                      # world verts
    he = rng.normal(size=(E, 2, 3)) * 0.3        # local endpoints
    hm = (rng.uniform(size=(E,)) > 0.2).astype(np.float64)
    nf = rng.normal(size=(F, 3))
    nf /= np.linalg.norm(nf, axis=-1, keepdims=True)
    fm = (rng.uniform(size=(F,)) > 0.15).astype(np.float64)
    fm[0] = 1.0                                  # at least one valid face
    cylv = np.array([1.0, 0.2, 0.35]) if cyl else np.zeros(3)
    return dict(w=w, vm=np.ones(V), he=he, hm=hm, nf=nf, fm=fm, p=p, R=R,
                cyl=cylv)


def _lanes(rng, V, E, F, N, cyl=False):
    lanes = []
    for i in range(N):
        A = _rand_hull(rng, V, E, F, cyl and i % 2 == 0)
        B = _rand_hull(rng, V, E, F, cyl and i % 3 == 0)
        lanes.append({**{k + "A": v for k, v in A.items()},
                      **{k + "B": v for k, v in B.items()}})
    return {k: np.stack([ln[k] for ln in lanes]).astype(F32)
            for k in lanes[0]}


_ORDER = ("wA", "wB", "heA", "heB", "hmA", "hmB", "nfA", "nfB", "fmA", "fmB",
          "RA", "RB", "pA", "pB", "cylA", "cylB")


def _jax_ref(b):
    b = {k: jnp.asarray(v) for k, v in b.items()}

    def one(wA, vmA, wB, vmB, heA, hmA, heB, hmB, nfA, fmA, nfB, fmB,
            pA, cylA, pB, cylB, RA, RB):
        A = (wA, vmA, pA, RA[:, 2], cylA)
        B = (wB, vmB, pB, RB[:, 2], cylB)
        axes = jnp.concatenate([nfA, -nfB], axis=0)
        amask = jnp.concatenate([fmA > 0.5, fmB > 0.5])
        depth, n = jmanifold._best_axis(axes, amask, A, B)
        return jmanifold.refine_rounds_xla(
            wA, vmA, wB, vmB, heA, hmA, heB, hmB,
            pA, RA[:, 2], cylA, pB, RB[:, 2], cylB, RA, RB, depth, n)

    return jax.vmap(one)(
        b["wA"], b["vmA"], b["wB"], b["vmB"], b["heA"], b["hmA"],
        b["heB"], b["hmB"], b["nfA"], b["fmA"], b["nfB"], b["fmB"],
        b["pA"], b["cylA"], b["pB"], b["cylB"], b["RA"], b["RB"])


@pytest.mark.parametrize("V,E,F,N,cyl", [(24, 56, 34, 7, False),
                                         (9, 10, 5, 3, False),
                                         (40, 90, 60, 130, False),
                                         (16, 20, 12, 6, True)])
def test_mtv_query_twin(V, E, F, N, cyl):
    """The twin, and mtv_staged (every wide scan through support_minmax),
    against the JAX package's XLA form and the Pallas kernel; E < K
    hulls, masked edges and faces, cylinder-flagged lanes."""
    rng = np.random.default_rng(0)
    b = _lanes(rng, V, E, F, N, cyl)
    args = [torch.tensor(b[k]) for k in _ORDER]
    dep, n = mtv_query.mtv_query(*args)
    dep_s, n_s = manifold.mtv_staged(*args)
    assert torch.equal(dep, dep_s) and torch.equal(n, n_s)
    dk, nk = pallas_mtv(*(jnp.asarray(b[k]) for k in _ORDER),
                        jmanifold._K_EDGE, jmanifold._REFINE_ROUNDS,
                        interpret=True)
    for rd, rn in (_jax_ref(b), (dk, nk)):
        np.testing.assert_allclose(dep.numpy(), np.asarray(rd), atol=2e-5)
        # the axis pick can differ only on exact ties; with random hulls
        # ties have measure zero, so the axes must agree
        np.testing.assert_allclose(n.numpy(), np.asarray(rn), atol=2e-5)


def test_wrappers_reject_other_devices():
    """A wrapper takes its twin only for a CPU tensor: anything that is
    neither CPU nor CUDA raises instead of falling back."""
    meta = torch.empty(2, 4, 3, device="meta")
    with pytest.raises(ValueError):
        smm.support_minmax(meta, meta)
    with pytest.raises(ValueError):
        hull_sat.hull_ref_face_depth(meta, torch.empty(2, 5, 4,
                                                       device="meta"), 2)


# ------------------------------------------ the two prototype kernels

def _proto(name):
    """Import benchmarks/<name>.py (a script, not a package module)."""
    path = (pathlib.Path(__file__).resolve().parent.parent / "benchmarks"
            / f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pallas_chol_interpret(A):
    """The prototype's factor kernel body on (n, n, 128) lane-last blocks,
    in interpret mode.  A (128, n, n) f32."""
    n = A.shape[-1]
    kernel = _proto("pallas_chol_proto").make_chol_kernel(n)
    At = jnp.transpose(jnp.asarray(A), (1, 2, 0))
    shape = jax.ShapeDtypeStruct((n, n, 128), At.dtype)

    def with_scratch(a_ref, o_ref, s_ref):
        kernel(a_ref, o_ref, s_ref)

    out, _ = pl.pallas_call(with_scratch, out_shape=(shape, shape),
                            interpret=True)(At)
    return np.transpose(np.asarray(out), (2, 0, 1))


@pytest.mark.parametrize("n,stiff", [(7, False), (17, False), (42, False),
                                     (12, True)])
def test_chol_factor_twin(n, stiff):
    rng = np.random.default_rng(0)
    M = rng.standard_normal((128, n, n))
    A = M @ M.transpose(0, 2, 1) + 3 * n * np.eye(n)
    if stiff:
        A[:, 0, 0] += 1e9                 # the stiff case of test_pallas_chol
    A = A.astype(F32)
    L = chol_factor.chol_factor(torch.tensor(A))       # CPU: the twin
    assert L.dtype == torch.float32
    assert bool((torch.triu(L, 1) == 0).all())
    refs = {"jax linalg.cholesky": np.asarray(jlinalg.cholesky(jnp.asarray(A))),
            "pallas prototype": _pallas_chol_interpret(A)}
    scale = np.abs(refs["jax linalg.cholesky"]).max(-1, keepdims=True)
    for name, r in refs.items():
        err = np.abs(L.numpy() - r) / scale
        assert err.max() < 2e-6, (name, err.max())
    # the factor reproduces the matrix
    LLt = L.double() @ L.double().transpose(-1, -2)
    rel = (LLt.numpy() - A).__abs__().max() / np.abs(A).max()
    assert rel < 1e-6, rel


@pytest.mark.parametrize("n", [65, 72])
def test_chol_twins_above_the_size_classes(n):
    """chol_solve's twin against the JAX package's linalg.cholesky +
    cho_solve (its Pallas kernel in interpret mode takes ~14 s a size on
    the CPU) at 2e-5, the band of tests/test_pallas_chol.py; chol_factor's twin
    against the prototype's kernel body in interpret mode at 2e-6 of the
    row's largest entry, as test_chol_factor_twin holds it."""
    rng = np.random.default_rng(n)
    A = kernel_cases._spd(rng, 128, n).astype(F32)
    b = rng.standard_normal((128, n)).astype(F32)
    x = chol.chol_solve(torch.tensor(A), torch.tensor(b)).numpy()
    ref = np.asarray(jlinalg.cho_solve(jlinalg.cholesky(jnp.asarray(A)),
                                       jnp.asarray(b)))
    np.testing.assert_allclose(x, ref, rtol=2e-5, atol=2e-5)
    L = chol_factor.chol_factor(torch.tensor(A)).numpy()
    Lp = _pallas_chol_interpret(A)
    scale = np.abs(Lp).max(-1, keepdims=True)
    assert (np.abs(L - Lp) / scale).max() < 2e-6


def _pallas_sat_interpret(pts, planes, vm, K):
    """The prototype's face-SAT kernel body on lane-last blocks of 128
    instances, in interpret mode (N padded to 128 with copies of the last
    instance, the padding dropped from the result)."""
    N, V, _ = pts.shape
    F_ = planes.shape[1]
    pad = (-N) % 128
    if pad:
        edge = lambda x: np.concatenate([x, np.repeat(x[-1:], pad, 0)], 0)
        pts, planes, vm = edge(pts), edge(planes), edge(vm)
    Np = N + pad
    kernel = _proto("pallas_sat_proto").make_kernel(V, F_, K)
    f32 = jnp.float32
    dep, idx, plane, sep = pl.pallas_call(
        kernel,
        out_shape=(jax.ShapeDtypeStruct((K, Np), f32),
                   jax.ShapeDtypeStruct((K, Np), jnp.int32),
                   jax.ShapeDtypeStruct((4, Np), f32),
                   jax.ShapeDtypeStruct((1, Np), f32)),
        interpret=True)(jnp.transpose(jnp.asarray(pts), (1, 2, 0)),
                        jnp.transpose(jnp.asarray(planes), (1, 2, 0)),
                        jnp.transpose(jnp.asarray(vm), (1, 0)))
    return (np.asarray(dep).T[:N], np.asarray(idx).T[:N],
            np.asarray(plane).T[:N], np.asarray(sep)[0, :N])


@pytest.mark.parametrize("case", ["random", "tie", "all_masked", "k4"])
def test_face_sat_depth_twin(case):
    rng = np.random.default_rng(2)
    V, F_, K = (12, 20, 4) if case == "k4" else (9, 14, 2)
    pts, planes, vm = _sat_case(rng, 128, V, F_)
    if case == "tie":
        pts[:, 3] = pts[:, 1]             # identical vertices
        planes[:, 7] = planes[:, 2]       # identical faces
        vm[:, 1] = vm[:, 3] = 1.0
    if case == "all_masked":
        vm[::2] = 0.0                     # nothing to pick: index 0 again
    out = face_sat.face_sat_depth(torch.tensor(pts), torch.tensor(planes),
                                  torch.tensor(vm), K)
    assert out[1].dtype == torch.int32 and out[2].shape == (128, 4)
    dep, idx, plane, sep = _pallas_sat_interpret(pts, planes, vm, K)
    np.testing.assert_array_equal(out[1].numpy(), idx)
    np.testing.assert_allclose(out[0].numpy(), dep, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(out[2].numpy(), plane, rtol=0, atol=1e-6)
    np.testing.assert_allclose(out[3].numpy(), sep, rtol=1e-6, atol=1e-6)
    if case == "all_masked":
        assert (out[1].numpy()[::2] == 0).all()
        assert (out[0].numpy()[::2] == 1e9).all()
        return
    # and the JAX package's query (which excludes a pick with +inf, so it
    # agrees wherever at least K points are live)
    jd, ji, jn, js = (np.asarray(r) for r in jax_hrfd(
        jnp.asarray(pts), jnp.asarray(planes), K, jnp.asarray(vm)))
    live = vm.sum(-1) >= K
    np.testing.assert_array_equal(out[1].numpy()[live], ji[live])
    np.testing.assert_allclose(out[0].numpy()[live], jd[live], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(out[2].numpy()[:, :3], jn, rtol=0, atol=1e-6)
    np.testing.assert_allclose(out[3].numpy(), js, rtol=0, atol=1e-6)


def _sat_case_f32(case):
    c = kernel_cases.sat_case(case)
    f = lambda x: None if x is None else x.astype(F32)
    slack = c["slack"] if isinstance(c["slack"], float) else f(c["slack"])
    return f(c["pts"]), f(c["planes"]), f(c["mask"]), slack, c["K"]


@pytest.mark.parametrize("case", kernel_cases.SAT_CASES)
def test_hull_ref_face_depth_twin_edge_cases(case):
    """The face-SAT edge cases of utils/kernel_cases.py (the layouts of
    csrc/face_sat.cuh, K = V - 1, an all-masked instance, tied reference
    faces and depths, a filter that drops every point, scalar slack and no
    mask): the twin against the JAX function and the Pallas kernel in
    interpret mode, values to 1e-6, indices equal.  With the lateral filter
    (the unfiltered query is its first half); the unmasked cases, which are
    the box-mesh call's form, also without it."""
    pts, planes, vm, slack, K = _sat_case_f32(case)
    for lateral in ((False, True) if vm is None else (True,)):
        _sat_check(pts, planes, vm, k=K, lateral=lateral, slack=slack)


@pytest.mark.parametrize("case", kernel_cases.SAT_CASES)
def test_face_sat_depth_twin_edge_cases(case):
    """The same cases through face_sat_depth (a missing mask is all ones)
    against the prototype's kernel body in interpret mode: indices equal,
    values to 1e-6."""
    pts, planes, vm, _, K = _sat_case_f32(case)
    if vm is None:
        vm = np.ones(pts.shape[:2], F32)
    out = face_sat.face_sat_depth(torch.tensor(pts), torch.tensor(planes),
                                  torch.tensor(vm), K)
    dep, idx, plane, sep = _pallas_sat_interpret(pts, planes, vm, K)
    np.testing.assert_array_equal(out[1].numpy(), idx)
    np.testing.assert_allclose(out[0].numpy(), dep, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(out[2].numpy(), plane, rtol=0, atol=1e-6)
    np.testing.assert_allclose(out[3].numpy(), sep, rtol=1e-6, atol=1e-6)


def test_prototype_wrappers_reject_other_devices():
    meta = torch.empty(2, 4, 4, device="meta")
    with pytest.raises(ValueError):
        chol_factor.chol_factor(meta)
    with pytest.raises(ValueError):
        face_sat.face_sat_depth(torch.empty(2, 4, 3, device="meta"), meta,
                                torch.empty(2, 4, device="meta"))


# ----------- the semantics the register-resident / ranking kernels lean on

@pytest.mark.parametrize("case", kernel_cases.CHOL_CASES)
def test_chol_solve_twin_edge_cases(case):
    """chol_solve's twin in float32 against the Pallas kernel in interpret
    mode at the band of tests/test_pallas_chol.py (2e-5 absolute + relative):
    both sides of every size-class edge of the CUDA kernel at a batch of 37,
    a stiff 1e9 row at n = 33, and a pivot that hits the 1e-30 floor."""
    A, b = kernel_cases.chol_case(case)
    A, b = A.astype(F32), b.astype(F32)
    x = chol.chol_solve(torch.tensor(A), torch.tensor(b)).numpy()
    ref = np.asarray(pallas_chol_solve(jnp.asarray(A), jnp.asarray(b),
                                       interpret=True))
    assert np.isfinite(x).all()
    np.testing.assert_allclose(x, ref, rtol=2e-5, atol=2e-5)
    if case == "stiff_n33":
        r = np.einsum("bij,bj->bi", A.astype(np.float64), x) - b
        assert np.abs(r).max() < 1e-2, np.abs(r).max()
    if case == "floor":
        # the floored pivot is stored as a_jj / sqrt(1e-30) ~ -1e12 s and
        # divided by as such: x_2 is b_2 over ~1e12 and more, not b_2 / ~0
        assert np.abs(x[:, 1]).max() < 1e-20


@pytest.mark.parametrize("case", kernel_cases.MTV_CASES)
def test_mtv_query_twin_edge_cases(case):
    """mtv_query's twin against the JAX package's XLA form and the Pallas
    kernel in interpret mode, depth and axis to 2e-5: fewer edges than K,
    every edge of one hull masked, exactly tied edge scores (the lower
    index first), a cylinder-flagged hull on either side."""
    b = {k: v.astype(F32) for k, v in kernel_cases.mtv_case(case).items()}
    V = b["wA"].shape[-2]
    b["vmA"] = b["vmB"] = np.ones(b["wA"].shape[:-2] + (V,), F32)
    args = [torch.tensor(b[k]) for k in _ORDER]
    dep, n = mtv_query.mtv_query(*args)
    dk, nk = pallas_mtv(*(jnp.asarray(b[k]) for k in _ORDER),
                        jmanifold._K_EDGE, jmanifold._REFINE_ROUNDS,
                        interpret=True)
    assert np.isfinite(dep.numpy()).all()
    for rd, rn in (_jax_ref(b), (dk, nk)):
        np.testing.assert_allclose(dep.numpy(), np.asarray(rd), atol=2e-5)
        np.testing.assert_allclose(n.numpy(), np.asarray(rn), atol=2e-5)
    if case.startswith("masked"):
        # no cross axis is valid: the coarse face-normal pick stands
        d0, n0 = mtv_query.mtv_query(*args, rounds=0)
        assert torch.equal(dep, d0) and torch.equal(n, n0)


def test_topk_edge_dirs_is_the_score_index_order():
    """The selection the CUDA kernel computes by ranking: direction r is
    that of the r-th edge in (score, index) order, zero where that edge's
    score is not finite and in slots past the hull's edges."""
    rng = np.random.default_rng(7)
    N, E, K = 5, 10, 16
    he = torch.tensor(rng.normal(size=(N, E, 2, 3)))
    he[:, 3] = he[:, 2]                      # an exact tie
    hm = torch.ones(N, E, dtype=torch.float64)
    hm[:, 7] = 0.0
    n = torch.tensor(rng.normal(size=(N, 3)))
    n = n / n.norm(dim=-1, keepdim=True)
    R = torch.eye(3, dtype=torch.float64).expand(N, 3, 3)
    p = torch.zeros(N, 3, dtype=torch.float64)
    s = (he @ n[:, None, :, None])[..., 0].amax((-1, -2))
    d = mtv_query.topk_edge_dirs(he, hm, n, s, 1.0, K, p, R)
    score = (s[:, None, None] - (he * n[:, None, None, :]).sum(-1)).amax(-1)
    score[:, 7] = torch.inf
    order = sorted(range(E), key=lambda e: (float(score[0, e]), e))
    assert order.index(2) + 1 == order.index(3)
    for r, e in enumerate(order):
        want = (he[0, e, 1] - he[0, e, 0]) if e != 7 else torch.zeros(3)
        torch.testing.assert_close(d[0, r], want.double())
    assert bool((d[:, E:] == 0).all())
