"""Port parity of the plain PyTorch twins of the three collision kernels
(mujoco_sim_tpu_torch/ops/{hull_sat,mtv_query,support_minmax}.py) in
float32: against the JAX package's function, and against the Pallas
kernel that the CUDA kernel replaces, run in interpret mode as the JAX
package's own tests run it on the CPU.  On the CPU the wrappers take the
twins, so the wrappers are what is called here.

Tolerances: values 1e-6 (f32, same arithmetic, summation order aside),
indices equal.  The MTV query compares at 2e-5 as
tests/test_pallas_refine.py does: its cross axes are normalised in f32,
and the Pallas kernel multiplies by a reciprocal where the twin divides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_sim_tpu.ops import manifold as jmanifold
from mujoco_sim_tpu.ops.collision import _hull_ref_face_depth as jax_hrfd
from mujoco_sim_tpu.ops.pallas_refine import mtv_query as pallas_mtv
from mujoco_sim_tpu.ops.pallas_sat import hull_ref_face_depth as pallas_hrfd
from mujoco_sim_tpu.ops.pallas_support import support_minmax as pallas_smm
from mujoco_sim_tpu_torch.ops import hull_sat, manifold, mtv_query
from mujoco_sim_tpu_torch.ops import support_minmax as smm

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
