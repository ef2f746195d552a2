"""Port parity of ops/gjk.point_hull_closest (batched, masked iterations)
against the JAX package's while_loop form, f64, 1e-10: same arithmetic,
summation order aside."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mujoco_sim_tpu.ops.gjk import point_hull_closest as jax_phc
from mujoco_sim_tpu_torch.ops.gjk import point_hull_closest
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

TOL = 1e-10
CUBE = np.array([[sx, sy, sz] for sx in (-.5, .5) for sy in (-.5, .5)
                 for sz in (-.5, .5)])
_jax_batched = jax.jit(jnp.vectorize(jax_phc,
                                     signature='(d),(v,d),(v),()->(),(d)'))


def test_cube_regions_analytic():
    """Face, edge and vertex regions of the unit cube, one batch."""
    q = torch.tensor([[0.0, 0.0, 2.0], [1.0, 1.0, 0.0], [2.0, 2.0, 2.0]])
    q = q.double()
    d, p = point_hull_closest(q, torch.tensor(CUBE), torch.ones(8).double())
    want = [1.5, np.sqrt(2) * 0.5, np.sqrt(3) * 1.5]
    np.testing.assert_allclose(d.numpy(), want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        p.numpy(), [[0, 0, .5], [.5, .5, 0], [.5, .5, .5]], atol=1e-12)


def test_random_hulls_match_jax():
    rng = np.random.default_rng(0)
    N = 96
    V = rng.standard_normal((N, 12, 3)) * 0.4
    q = rng.standard_normal((N, 3)) * 1.2
    mask = (rng.uniform(size=(N, 12)) > 0.2).astype(float)
    mask[:, :4] = 1.0
    en = rng.uniform(size=N) > 0.3
    rd, rp = _jax_batched(jnp.asarray(q), jnp.asarray(V), jnp.asarray(mask),
                          jnp.asarray(en))
    d, p = point_hull_closest(torch.tensor(q), torch.tensor(V),
                              torch.tensor(mask), torch.tensor(en))
    np.testing.assert_allclose(d.numpy(), np.asarray(rd), rtol=0, atol=TOL)
    np.testing.assert_allclose(p.numpy(), np.asarray(rp), rtol=0, atol=TOL)
    # the enabled outside lanes are support-optimal (the witness point's
    # own support plane certifies the distance), bar the rare lane that
    # stops at the iteration cap in both packages
    u = (q - p.numpy()) / np.maximum(d.numpy(), 1e-12)[:, None]
    score = np.where(mask > 0.5, np.einsum("nvd,nd->nv", V, u), -1e30)
    gap = score.max(-1) - (p.numpy() * u).sum(-1)
    outside = en & (d.numpy() > 1e-6)
    assert outside.sum() > 30
    assert (np.abs(gap[outside]) < 1e-8).mean() > 0.9


def test_disabled_lanes_do_not_touch_enabled_ones():
    rng = np.random.default_rng(1)
    V = torch.tensor(rng.standard_normal((16, 8, 3)))
    Q = torch.tensor(rng.standard_normal((16, 3)) * 2.0)
    ones = torch.ones(16, 8, dtype=torch.float64)
    en = torch.arange(16) % 2 == 0
    d_all, p_all = point_hull_closest(Q, V, ones)
    # poison the disabled lanes: nothing of them may reach the others
    Vbad = V.clone()
    Vbad[~en] = float("nan")
    d, p = point_hull_closest(Q, Vbad, ones, en)
    assert torch.equal(d[en], d_all[en]) and torch.equal(p[en], p_all[en])
    # an all-disabled batch returns at once, finite
    d0, _ = point_hull_closest(Q, V, ones, torch.zeros(16, dtype=torch.bool))
    assert bool(torch.isfinite(d0).all())
