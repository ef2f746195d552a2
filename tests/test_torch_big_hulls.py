"""Port parity of the stirred manip step on tests/fixtures/manip_bin6_bighull.xml:
manip_bin6.xml with two objects replaced by convex pebbles of 256 and 320
hull vertices, so the exact deep-pair manifold runs on full-hull tables of
(V, E, F) = (320, 954, 636), the size class of the reference robots'
~180-vertex hulls.  Against the JAX package's engine.step under jax.vmap
(CPU, f64), one jitted step shared by the file.

* One step from a crafted state in which the two pebbles interpenetrate by
  about a centimetre in mid-air: the deep gate fires on that pair (its hull
  indices ride a live deep slot), the contact sets agree (pairs and depths
  to 1e-9, points to 5e-7: the exact manifold's eps-wide features tie, as
  in tests/test_torch_manip_step.py), and qacc agrees to 1e-6 of its
  largest entry (converged Newton solves agree to ~1e-7, ROADMAP §C).
* A 30-step stirred rollout from the fixture's initial state on 4 envs
  stays inside the bands tests/test_torch_manip_step.py holds the manip
  rollout to: 90% of qpos within 2.5e-3, every object within 2 cm.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_sim_tpu import engine as jengine
from mujoco_sim_tpu.models.compile import load_model as jax_load_model
from mujoco_sim_tpu.parallel.mesh import make_batch
from mujoco_sim_tpu_torch import engine
from mujoco_sim_tpu_torch.models.compile import load_model
from mujoco_sim_tpu_torch.models.convert import from_jax_data, from_jax_model
from mujoco_sim_tpu_torch.ops import manifold
from mujoco_sim_tpu_torch.parallel.rollout import rollout
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

FIXTURE = str(pathlib.Path(__file__).resolve().parent / "fixtures"
              / "manip_bin6_bighull.xml")
NENV, NSTEPS = 4, 30
# hull indices of the two pebbles (one hull a mesh, in asset order)
PEBBLES = {4, 5}
# free-joint qpos of the two pebble bodies (t2, r2): after the arm's 6
# hinges, t1, t2, r1, r2 at 7 entries each
T2, R2 = 13, 27


def _jax_step(m, d, ph):
    return jengine.step(m, d.replace(ctrl=jnp.sin(4.0 * d.time + ph)))


@pytest.fixture(scope="module")
def run():
    """The models, the stir, the crafted state with both packages' step
    from it, and the JAX package's 30-step stirred trajectory, all through
    one jitted step."""
    mj = jax_load_model(FIXTURE)
    mt = engine.put_model(from_jax_model(mj), torch.float64, "cpu")
    ph = np.random.default_rng(1).uniform(0.0, 6.28, (NENV, mj.nu))
    step = jax.jit(jax.vmap(_jax_step, in_axes=(None, 0, 0)))
    jph = jnp.asarray(ph)
    d0 = make_batch(mj, NENV, dtype=jnp.float64)
    qpos = np.asarray(d0.qpos).copy()
    # the pebbles side by side 12 cm up, their centres 5.5 cm apart along
    # x, less 4 mm an env: 1-2 cm of overlap
    qpos[:, T2:T2 + 3] = [0.0, 0.1, 0.12]
    qpos[:, R2:R2 + 3] = np.stack([0.055 - 0.004 * np.arange(NENV),
                                   np.full(NENV, 0.1), np.full(NENV, 0.12)],
                                  -1)
    crafted = d0.replace(qpos=jnp.asarray(qpos))
    crafted_ref = step(mj, crafted, jph)
    traj = [d0]
    for _ in range(NSTEPS):
        traj.append(step(mj, traj[-1], jph))
    pht = torch.tensor(ph)
    return dict(mj=mj, mt=mt, crafted=crafted, crafted_ref=crafted_ref,
                traj=traj,
                stir=lambda d: torch.sin(4.0 * d.time[:, None] + pht))


def _contact_set(c):
    """Per env: the active contacts as rows [geom1, geom2, dist, pos],
    sorted."""
    act = np.asarray(c.active)
    rows = np.concatenate([np.asarray(c.geom1)[..., None],
                           np.asarray(c.geom2)[..., None],
                           np.asarray(c.dist)[..., None],
                           np.asarray(c.pos)], -1)
    out = []
    for e in range(act.shape[0]):
        r = rows[e][act[e]]
        out.append(r[np.lexsort(r.round(5).T[::-1])])
    return out


def test_fixture_tables_exceed_the_old_shared_memory_line():
    """The full-hull tables are larger than the 47 KB a block of the exact
    MTV kernel held before it took tables of any size: 8 V + 2 Ep + 14 E +
    8 F + 30 + 6 K floats a pair (Ep = E rounded up to 4, K = 16) against
    12 032."""
    m = load_model(FIXTURE)
    V, E, F = (m.mesh_vert_hi.shape[1], m.mesh_hedge.shape[1],
               m.mesh_fplane.shape[1])
    assert (V, E, F) == (320, 954, 636)
    Ep = (E + 3) & ~3
    assert 8 * V + 2 * Ep + 14 * E + 8 * F + 30 + 6 * 16 > 47 * 1024 // 4
    # the decimated SAT tables stay at the compiler's cap
    assert m.mesh_vert_pad.shape[1] == 32
    assert {int(h) for h in m.layout.geom_hullid if h >= 0} >= PEBBLES


def test_deep_pebble_pair_step_matches_jax(run):
    mt, crafted, ref = run["mt"], run["crafted"], run["crafted_ref"]
    seen = []
    real = manifold.exact_pair_contacts

    def probe(*args, **kw):
        seen.append((args[2], args[6], args[8]))      # hidA, hidB, enabled
        return real(*args, **kw)

    d = from_jax_data(crafted)
    manifold.exact_pair_contacts = probe
    try:
        out = engine.step(mt, d.replace(ctrl=run["stir"](d)))
    finally:
        manifold.exact_pair_contacts = real
    # the deep gate fired on the pebble pair in every env
    hidA, hidB, en = (torch.cat([s[i] for s in seen], -1) for i in range(3))
    for e in range(NENV):
        pairs = {frozenset((int(a), int(b)))
                 for a, b in zip(hidA[e][en[e]], hidB[e][en[e]])}
        assert frozenset(PEBBLES) in pairs, (e, pairs)
    for ours, theirs in zip(_contact_set(out.contact),
                            _contact_set(ref.contact)):
        assert ours.shape == theirs.shape
        np.testing.assert_allclose(ours[:, :3], theirs[:, :3], rtol=0,
                                   atol=1e-9)
        np.testing.assert_allclose(ours[:, 3:], theirs[:, 3:], rtol=0,
                                   atol=5e-7)
    # a pebble-pebble contact at least 5 mm deep in every env
    geoms = np.flatnonzero(np.isin(np.asarray(mt.layout.geom_hullid),
                                   list(PEBBLES)))
    peb = (np.isin(np.asarray(ref.contact.geom1), geoms)
           & np.isin(np.asarray(ref.contact.geom2), geoms)
           & np.asarray(ref.contact.active))
    assert (np.where(peb, np.asarray(ref.contact.dist), 0.0).min(-1)
            < -5e-3).all()
    qacc = np.asarray(ref.qacc)
    np.testing.assert_allclose(out.qacc.numpy(), qacc, rtol=0,
                               atol=1e-6 * np.abs(qacc).max())


def test_stirred_rollout_stays_in_band(run):
    traj = run["traj"]
    out = rollout(run["mt"], from_jax_data(traj[0]), NSTEPS,
                  ctrl_fn=run["stir"])
    dq = np.abs(out.qpos.numpy() - np.asarray(traj[-1].qpos))
    assert np.isfinite(out.qpos.numpy()).all()
    assert (dq <= 2.5e-3).mean() >= 0.9, dq.max()
    obj = np.stack([dq[:, 6 + 7 * k:9 + 7 * k] for k in range(6)])
    assert obj.max() <= 2e-2, obj.max()
    assert np.abs(out.qpos.numpy()[:, :6]).max() > 0.05
