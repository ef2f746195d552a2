"""Port parity for the third slice as a whole: the stirred step of
tests/fixtures/manip_bin6_precise.xml (elliptic cone, three noslip sweeps,
the qLD factor, 16 sensors / 31 sensordata values) against the JAX
package's engine.step under jax.vmap (CPU, f64, 2 envs).

What can and cannot agree is what tests/test_torch_manip_step.py sets out
for the scene without the precise options: contact picks tie in exact
arithmetic and the scene is chaotic; the elliptic Newton solver adds its
own last-bit switch (it rejects a step whose cost rises by one ulp and
stops).  So:

* the first step from the fixture's tilted initial state agrees on the
  contact SETS (pairs and depths to 1e-9, points to the 5e-7 width of an
  eps feature), on qLD to 1e-12 and on sensordata to 1e-6 of each
  reading's scale (1e-9 for the readings that do not pass through the
  solver);
* the free-running 30-step rollout stays inside the manip band: 90% of
  the qpos entries within 2.5e-3, every object within 2 cm, and the
  position-like sensors (joint angles, the object's frame position, the
  subtree COM) within 2.5e-3 of the JAX package's.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_sim_tpu import engine as jengine
from mujoco_sim_tpu.models.compile import load_model as jax_load_model
from mujoco_sim_tpu.models.model import SensorType as S
from mujoco_sim_tpu.parallel.mesh import make_batch
from mujoco_sim_tpu_torch import engine
from mujoco_sim_tpu_torch.models.compile import load_model
from mujoco_sim_tpu_torch.models.convert import from_jax_data, from_jax_model
from mujoco_sim_tpu_torch.parallel.rollout import rollout
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

FIXTURE = str(pathlib.Path(__file__).resolve().parent / "fixtures"
              / "manip_bin6_precise.xml")
NENV, NSTEPS = 2, 30
SOLVED = {S.FORCE, S.TORQUE, S.TOUCH, S.ACCELEROMETER}


def _jax_step(m, d, ph):
    return jengine.step(m, d.replace(ctrl=jnp.sin(4.0 * d.time + ph)))


@pytest.fixture(scope="module")
def run():
    mj = jax_load_model(FIXTURE)
    mt = engine.put_model(from_jax_model(mj), torch.float64, "cpu")
    ph = np.random.default_rng(1).uniform(0.0, 6.28, (NENV, mj.nu))
    step = jax.jit(jax.vmap(_jax_step, in_axes=(None, 0, 0)))
    traj = [make_batch(mj, NENV, dtype=jnp.float64)]
    for _ in range(NSTEPS):
        traj.append(step(mj, traj[-1], jnp.asarray(ph)))
    pht = torch.tensor(ph)
    return mj, mt, traj, lambda d: torch.sin(4.0 * d.time[:, None] + pht)


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


def _sensors(m):
    lay = m.layout
    return [(S(int(lay.sensor_type[k])), int(lay.sensor_adr[k]),
             int(lay.sensor_dim[k])) for k in range(m.nsensor)]


def test_fixture_is_the_precise_configuration():
    """The port's own compiler reads the fixture as the precise
    configuration: elliptic cone, 3 noslip sweeps, 16 sensors and 31
    values, the manip scene's widths."""
    from mujoco_sim_tpu_torch.models.model import ConeType
    m = load_model(FIXTURE)
    assert m.opt.cone == int(ConeType.ELLIPTIC)
    assert m.opt.noslip_iterations == 3
    assert (m.nv, m.nu, m.ncon_max) == (42, 6, 32)
    assert (m.nsensor, m.nsensordata, m.nsite) == (16, 31, 3)
    assert m.nefc_max == 3 + 32 * 3          # limits + elliptic rows


def test_first_step_contacts_factor_and_sensors_match_jax(run):
    mj, mt, traj, stir = run
    d0 = from_jax_data(traj[0])
    out = engine.step(mt, d0.replace(ctrl=stir(d0)))
    ref = traj[1]
    assert int(out.ncon.min()) >= 8
    for ours, theirs in zip(_contact_set(out.contact),
                            _contact_set(ref.contact)):
        np.testing.assert_allclose(ours[:, :3], theirs[:, :3], rtol=0,
                                   atol=1e-9)
        np.testing.assert_allclose(ours[:, 3:], theirs[:, 3:], rtol=0,
                                   atol=5e-7)
    assert float(out.qLD.abs().max()) > 0
    np.testing.assert_allclose(out.qLD.numpy(), np.asarray(ref.qLD),
                               rtol=1e-12, atol=1e-12)
    sd, rd = out.sensordata.numpy(), np.asarray(ref.sensordata)
    assert sd.shape == (NENV, 31)
    for stype, adr, dim in _sensors(mj):
        r = rd[:, adr:adr + dim]
        tol = (1e-6 if stype in SOLVED else 1e-9) * max(1.0, np.abs(r).max())
        np.testing.assert_allclose(sd[:, adr:adr + dim], r, rtol=0, atol=tol,
                                   err_msg=stype.name)
    np.testing.assert_allclose(out.qpos.numpy(), np.asarray(ref.qpos),
                               rtol=0, atol=1e-7)


def test_first_step_noslip_changed_the_forces(run):
    """The precise options are live: without the noslip sweeps the first
    step's friction forces differ."""
    mj, mt, traj, stir = run
    d0 = from_jax_data(traj[0])
    d0 = d0.replace(ctrl=stir(d0))
    plain = mt.replace(opt=mt.opt.replace(noslip_iterations=0))
    a = engine.forward(mt, d0).efc_force
    b = engine.forward(plain, d0).efc_force
    assert float((a - b).abs().max()) > 1e-3


def test_free_running_rollout_stays_in_band(run):
    mj, mt, traj, stir = run
    out = rollout(mt, from_jax_data(traj[0]), NSTEPS, ctrl_fn=stir)
    ref = traj[-1]
    assert np.isfinite(out.qpos.numpy()).all()
    assert np.isfinite(out.sensordata.numpy()).all()
    dq = np.abs(out.qpos.numpy() - np.asarray(ref.qpos))
    assert (dq <= 2.5e-3).mean() >= 0.9, dq.max()
    obj = np.stack([dq[:, 6 + 7 * k:9 + 7 * k] for k in range(6)])
    assert obj.max() <= 2e-2, obj.max()
    sd, rd = out.sensordata.numpy(), np.asarray(ref.sensordata)
    for stype, adr, dim in _sensors(mj):
        if stype in (S.JOINTPOS, S.FRAMEPOS, S.SUBTREECOM):
            np.testing.assert_allclose(sd[:, adr:adr + dim],
                                       rd[:, adr:adr + dim], rtol=0,
                                       atol=2.5e-3, err_msg=stype.name)
        if stype == S.TOUCH:
            assert (sd[:, adr] >= 0).all()
        if stype == S.RANGEFINDER:
            assert ((sd[:, adr] >= 0) | (sd[:, adr] == -1.0)).all()
    assert float(out.time[0]) == pytest.approx(float(ref.time[0]))
    assert np.abs(out.qpos.numpy()[:, :6]).max() > 0.05
