"""Port parity of the MTV and support twins at table sizes the compiler
builds from full hulls, and of the support wrapper's CPU path
(mujoco_sim_tpu_torch/ops/{mtv_query,support_minmax}.py), in float32 on
the CPU, where the wrappers take the twins.

The MTV cases are utils/kernel_cases.MTV_BIG_CASES: tables compiled from
Fibonacci pebbles of 256 and 1200 vertices, posed in deep
interpenetration, with the deep-pair compaction's empty slots (every table
zero).  They are held to the JAX package's XLA form
(manifold.refine_rounds_xla after its coarse _best_axis) at the band of
tests/test_pallas_refine.py (2e-5), and the 256-vertex case also to the
Pallas kernel in interpret mode; at an empty slot the twin's result is
pinned exactly, since the CUDA kernel returns it without scanning.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_sim_tpu.ops import manifold as jmanifold
from mujoco_sim_tpu.ops.pallas_refine import mtv_query as pallas_mtv
from mujoco_sim_tpu.ops.pallas_support import support_minmax as pallas_smm
from mujoco_sim_tpu_torch.ops import mtv_query
from mujoco_sim_tpu_torch.ops import support_minmax as smm
from mujoco_sim_tpu_torch.runtime import profiler
from mujoco_sim_tpu_torch.utils import kernel_cases
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

F32 = np.float32
ORDER = kernel_cases.MTV_ORDER


def _jax_ref(b):
    """The JAX package's query, lane by lane: the coarse face pick, then the
    XLA refinement rounds."""
    b = {k: jnp.asarray(v) for k, v in b.items()}
    vm = jnp.ones(b["wA"].shape[:-1], b["wA"].dtype)

    def one(wA, wB, heA, hmA, heB, hmB, nfA, fmA, nfB, fmB, pA, cylA, pB,
            cylB, RA, RB, vm):
        A = (wA, vm, pA, RA[:, 2], cylA)
        B = (wB, vm, pB, RB[:, 2], cylB)
        axes = jnp.concatenate([nfA, -nfB], axis=0)
        amask = jnp.concatenate([fmA > 0.5, fmB > 0.5])
        depth, n = jmanifold._best_axis(axes, amask, A, B)
        return jmanifold.refine_rounds_xla(
            wA, vm, wB, vm, heA, hmA, heB, hmB, pA, RA[:, 2], cylA, pB,
            RB[:, 2], cylB, RA, RB, depth, n)

    return jax.vmap(one)(
        b["wA"], b["wB"], b["heA"], b["hmA"], b["heB"], b["hmB"], b["nfA"],
        b["fmA"], b["nfB"], b["fmB"], b["pA"], b["cylA"], b["pB"],
        b["cylB"], b["RA"], b["RB"], vm)


@pytest.mark.parametrize("case", kernel_cases.MTV_BIG_CASES)
def test_mtv_query_twin_big_tables(case):
    b = {k: v.astype(F32) for k, v in kernel_cases.mtv_big_case(case).items()}
    V, E, F = b["wA"].shape[-2], b["heA"].shape[-3], b["nfA"].shape[-2]
    assert (V, E, F) == {"pebble256": (256, 762, 508),
                         "pebble1200": (1200, 3594, 2396)}[case]
    args = [torch.tensor(b[k]) for k in ORDER]
    dep, n = mtv_query.mtv_query(*args)
    empty = np.zeros(dep.shape, bool)
    empty[2::5] = True
    live = ~empty
    # deep pairs: positive, finite depths on every live lane
    assert np.isfinite(dep.numpy()[live]).all() and (dep.numpy()[live]
                                                      > 0).all()
    refs = [_jax_ref(b)]
    if case == "pebble256":
        refs.append(pallas_mtv(*(jnp.asarray(b[k]) for k in ORDER),
                               jmanifold._K_EDGE, jmanifold._REFINE_ROUNDS,
                               interpret=True))
    for rd, rn in refs:
        np.testing.assert_allclose(dep.numpy()[live], np.asarray(rd)[live],
                                   rtol=0, atol=2e-5)
        np.testing.assert_allclose(n.numpy()[live], np.asarray(rn)[live],
                                   rtol=0, atol=2e-5)
    # an empty slot: no valid face or edge, so the pick is the first axis
    # (A's first face normal, all zeros here) at +inf, and no round moves
    # it; the JAX package agrees
    assert torch.equal(dep[empty], torch.full((int(empty.sum()),),
                                              torch.inf))
    assert torch.equal(n[empty], args[ORDER.index("nfA")][empty, 0])
    rd, rn = refs[0]
    assert np.isinf(np.asarray(rd)[empty]).all()
    np.testing.assert_array_equal(np.asarray(rn)[empty], 0.0)


def test_mtv_query_twin_no_valid_axis():
    """The result the CUDA kernel returns without scanning, for a lane with
    every face masked on both hulls and every edge masked on one: (+inf,
    A's first face normal) -- also when that normal is not zero and the
    other hull's edges are live."""
    b = {k: v.astype(F32) for k, v in kernel_cases.mtv_case("e_lt_k").items()}
    b["fmA"][:] = 0.0
    b["fmB"][:] = 0.0
    b["hmA"][::2] = 0.0          # even lanes: A has no valid edge
    b["hmB"][1::2] = 0.0         # odd lanes: B has none
    args = [torch.tensor(b[k]) for k in ORDER]
    dep, n = mtv_query.mtv_query(*args)
    assert bool(torch.isinf(dep).all()) and bool((dep > 0).all())
    assert torch.equal(n, args[ORDER.index("nfA")][:, 0])
    assert bool((n.norm(dim=-1) > 0.5).all())


@pytest.mark.parametrize("C,V,N", [(1, 24, 37), (1, 5000, 3), (68, 5000, 2),
                                   (256, 4100, 2)])
def test_support_minmax_twin_any_size(C, V, N):
    """The twin against numpy and the Pallas kernel in interpret mode at
    V past the old kernel's 4096 and at a single axis: equal to numpy,
    which rounds each multiply and add as the twin does; within 1e-6 of
    the Pallas kernel (the band of test_torch_kernels_twins.py: XLA's CPU
    backend may contract a product and a sum into one rounding)."""
    rng = np.random.default_rng(C + V)
    axes = rng.normal(size=(N, C, 3)).astype(F32)
    w = rng.normal(size=(N, V, 3)).astype(F32)
    mn, mx = smm.support_minmax(torch.tensor(axes), torch.tensor(w))
    p = ((axes[:, :, None, 0] * w[:, None, :, 0]
          + axes[:, :, None, 1] * w[:, None, :, 1])
         + axes[:, :, None, 2] * w[:, None, :, 2])
    pn, px = pallas_smm(jnp.asarray(axes), jnp.asarray(w), interpret=True)
    np.testing.assert_array_equal(mn.numpy(), p.min(-1))
    np.testing.assert_array_equal(mx.numpy(), p.max(-1))
    np.testing.assert_allclose(mn.numpy(), np.asarray(pn), rtol=0, atol=1e-6)
    np.testing.assert_allclose(mx.numpy(), np.asarray(px), rtol=0, atol=1e-6)


@pytest.mark.parametrize("C", [72, 73, 257])
def test_support_minmax_cpu_takes_the_twin(C):
    """On CPU tensors the wrapper returns the twin's result and launches
    nothing, at the widths where the CUDA kernel changes layout (72: the
    last of the 8-lane teams, 73: the first of the 32-lane warps, 257: the
    first with two chunks of axes)."""
    rng = np.random.default_rng(C)
    axes = torch.tensor(rng.normal(size=(3, C, 3)).astype(F32))
    w = torch.tensor(rng.normal(size=(3, 40, 3)).astype(F32))
    with profiler.counting("cpu"):
        before = profiler.counts("cpu")["support_minmax"]
        mn, mx = smm.support_minmax(axes, w)
        assert profiler.counts("cpu")["support_minmax"] == before
    rn, rx = smm.support_minmax_plain(axes, w)
    assert torch.equal(mn, rn) and torch.equal(mx, rx)
    assert mn.shape == (3, C) and bool((mn <= mx).all())