"""Port parity for the seventh slice as a whole: the stirred Euler step of
tests/fixtures/tendon_terrain.xml (a muscle arm on six spatial tendons
with sphere and cylinder wraps and a pulley, a fixed tendon with a limit
and a deadband spring, a tendon equality, site actuators with and without
refsite, six loose objects on a 64 x 64 heightfield, a rock against a
cylinder prism, fluid drag with wind, tendon sensors and a rangefinder)
against the JAX package's engine.step under jax.vmap (CPU, f64), 8 envs.
The objects start 0.3 m above the ground and land after ~120 steps, so
the comparisons start from the JAX package's state after 150 stirred
steps, with every object on the ground.

Like the manip scene, the objects' contacts pick among candidates that
can tie in exact arithmetic (a box's four bottom corners on a flat cell, a
rock's hull vertices), and the objects tumble.  So: the first step agrees
on the contact set (pairs and depths to 1e-9, points to 5e-7) and on the
sensordata to 1e-9; the free-running 50-step rollout holds 95% of the
qpos entries within 2.5e-3 (the manip band, tests/test_step.py:339-356)
and every object within 2 cm.
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
from mujoco_sim_tpu_torch.models.convert import from_jax_data, from_jax_model
from mujoco_sim_tpu_torch.parallel.rollout import rollout
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

FIXTURE = str(pathlib.Path(__file__).resolve().parent / "fixtures"
              / "tendon_terrain.xml")
NENV, NWARM, NSTEPS = 8, 150, 50
NOBJ = 6


def _stir(t, ph, cr, sin):
    """bench.py's stir sin(4 t + phase), mapped into each actuator's
    ctrlrange (muscles: 0.5 + 0.5 sin)."""
    lo, hi = cr[:, 0], cr[:, 1]
    return lo + (hi - lo) * (0.5 + 0.5 * sin(4.0 * t + ph))


@pytest.fixture(scope="module")
def run():
    """The models, the stir, and the JAX package's first step from the
    initial state and its trajectory of 50 steps after 150 warm-up
    steps."""
    mj = jax_load_model(FIXTURE)
    mt = engine.put_model(from_jax_model(mj), torch.float64, "cpu")
    ph = np.random.default_rng(1).uniform(0.0, 6.28, (NENV, mj.nu))
    cr = np.asarray(mj.actuator_ctrlrange)

    def jstep(m, d, ph_env):
        return jengine.step(m, d.replace(
            ctrl=_stir(d.time, ph_env, jnp.asarray(cr), jnp.sin)))

    step = jax.jit(jax.vmap(jstep, in_axes=(None, 0, 0)))
    traj = [make_batch(mj, NENV, dtype=jnp.float64)]
    for _ in range(NWARM + NSTEPS):
        traj.append(step(mj, traj[-1], jnp.asarray(ph)))
    pht, crt = torch.tensor(ph), torch.tensor(cr)
    return mj, mt, (traj[:2], traj[NWARM:]), lambda d: _stir(
        d.time[:, None], pht, crt, torch.sin)


def _contact_set(c):
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


def test_first_step_contacts_and_sensors_match_jax(run):
    mj, mt, (_, traj), stir = run
    d0 = from_jax_data(traj[0])
    out = engine.step(mt, d0.replace(ctrl=stir(d0)))
    ref = traj[1]
    assert int(out.ncon.min()) >= NOBJ
    for ours, theirs in zip(_contact_set(out.contact),
                            _contact_set(ref.contact)):
        assert ours.shape == theirs.shape
        np.testing.assert_allclose(ours[:, :3], theirs[:, :3], rtol=0,
                                   atol=1e-9)
        np.testing.assert_allclose(ours[:, 3:], theirs[:, 3:], rtol=0,
                                   atol=5e-7)
    np.testing.assert_allclose(out.sensordata.numpy(),
                               np.asarray(ref.sensordata), rtol=0, atol=1e-9)
    for name in ("ten_length", "ten_J", "actuator_length",
                 "actuator_velocity", "qfrc_actuator", "qfrc_passive"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-9, atol=1e-9, err_msg=name)


def test_first_step_from_rest_matches_jax(run):
    """From the fixture's initial state (objects in the air, the arm at
    rest): every sensor, including the rangefinder's heightfield hit."""
    mj, mt, ((d0j, first), _), stir = run
    d0 = from_jax_data(d0j)
    out = engine.step(mt, d0.replace(ctrl=stir(d0)))
    np.testing.assert_allclose(out.sensordata.numpy(),
                               np.asarray(first.sensordata), rtol=0,
                               atol=1e-9)
    rf = out.sensordata.numpy()[:, -1]
    assert (rf > 1.0).all(), rf          # the ground, ~1.2 m below the hand
    np.testing.assert_allclose(out.qpos.numpy(), np.asarray(first.qpos),
                               rtol=0, atol=1e-9)


def test_free_running_rollout_stays_in_band(run):
    mj, mt, (_, traj), stir = run
    out = rollout(mt, from_jax_data(traj[0]), NSTEPS, ctrl_fn=stir)
    dq = np.abs(out.qpos.numpy() - np.asarray(traj[-1].qpos))
    assert np.isfinite(out.qpos.numpy()).all()
    assert (dq <= 2.5e-3).mean() >= 0.95, dq.max()
    obj = np.stack([dq[:, 7 * k:7 * k + 3] for k in range(NOBJ)])
    assert obj.max() <= 2e-2, obj.max()
    # the arm moved and the muscles' activations stayed in [0, 1]
    assert np.abs(out.qpos.numpy()[:, 7 * NOBJ:]).max() > 0.05
    act = out.act.numpy()[:, :6]
    assert (act >= 0).all() and (act <= 1).all()
