"""Port parity for the second slice as a whole: the stirred Euler step of
tests/fixtures/manip_bin6.xml (six motors, capsule / box / mesh contacts,
the top-P prefilter, the deep-pair exact manifold) against the JAX
package's engine.step under jax.vmap (CPU, f64), with exact_meshcollide 0
and 1.

What can and cannot agree.  The scene's contact manifolds choose among
candidates that tie in exact arithmetic: the third plane-mesh contact of a
face with four corners under the floor (two corners equally far from the
line of the first two), and the corners of the 2e-6 * rbound wide rectangle
that stands for a vertex or edge feature in the exact manifold.  The last
bit of the two packages' arithmetic decides those, the chosen contact point
moves by a corner (centimetres) or by the rectangle's width (1e-7), and the
scene is chaotic.  So:

* the first step from the fixture's initial state (tilted so that nothing
  ties) agrees on every leaf to 1e-9;
* along the JAX package's trajectory, one port step from each of its states
  ("teacher forcing") agrees in qpos to 1e-6 wherever both packages found
  the same contact set.  Measured: the same set in 51 (SAT manifolds) and
  60 (exact manifolds) of the 120 (env, step) cells, qpos there within
  1.9e-8 and qvel within 9.9e-6; in the other cells a resting object has
  four or more corners under the floor and the third contact went to
  another corner.  At least 30% of the cells must agree;
* the free-running rollout stays inside the band that the JAX package's
  own manip test holds against the MuJoCo oracle (2.5e-3 on qpos over 50
  steps, tests/test_step.py:339-356) for 90% of the qpos entries, with
  every object within 2 cm of its JAX position after 30 steps (measured:
  97.4% and 97.9% of the entries inside the band, max 3.7e-3 and 4.9e-3 on
  a quaternion entry, objects within 4e-4 m).
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
from mujoco_sim_tpu_torch.utils.struct import leaf_names
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

FIXTURE = str(pathlib.Path(__file__).resolve().parent / "fixtures"
              / "manip_bin6.xml")
NENV, NSTEPS = 4, 30


def _jax_step(m, d, ph):
    return jengine.step(m, d.replace(ctrl=jnp.sin(4.0 * d.time + ph)))


@pytest.fixture(scope="module", params=[0, 1], ids=["sat", "exact_all"])
def run(request):
    """Per exact_meshcollide mode: the models, the stir phases, and the JAX
    package's 30-step trajectory (its step jitted once)."""
    mj = jax_load_model(FIXTURE)
    mj = mj.replace(opt=mj.opt.replace(exact_meshcollide=request.param))
    mt = engine.put_model(from_jax_model(mj), torch.float64, "cpu")
    ph = np.random.default_rng(1).uniform(0.0, 6.28, (NENV, mj.nu))
    step = jax.jit(jax.vmap(_jax_step, in_axes=(None, 0, 0)))
    traj = [make_batch(mj, NENV, dtype=jnp.float64)]
    for _ in range(NSTEPS):
        traj.append(step(mj, traj[-1], jnp.asarray(ph)))
    pht = torch.tensor(ph)
    return mj, mt, traj, lambda d: torch.sin(4.0 * d.time[:, None] + pht)


def _leaves(d, prefix=""):
    for name in leaf_names(d):
        v = getattr(d, name)
        if name == "contact":
            yield from _leaves(v, "contact.")
        else:
            yield prefix + name, v


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


def test_first_step_matches_jax(run):
    """The fixture's initial state is tilted so that no plane-mesh contact
    ties.  Every leaf that does not depend on a contact point agrees to
    1e-9.  One mesh pair starts 3 cm deep and takes the exact manifold
    (all touching pairs do with exact_meshcollide), whose vertex contacts'
    eps features can move a contact point by 1e-7; so contact points, the
    rows built from them and the solved state are compared at that
    width."""
    _, mt, traj, stir = run
    d0 = from_jax_data(traj[0])
    step = engine.step(mt, d0.replace(ctrl=stir(d0)))
    out, ref = dict(_leaves(step)), dict(_leaves(traj[1]))
    assert sorted(out) == sorted(ref)
    assert int(out["ncon"].min()) >= 8
    for name, r in ref.items():
        assert out[name].shape == r.shape, name
        assert out[name].numpy().dtype == np.asarray(r).dtype, name
    downstream = {"contact.pos", "qfrc_constraint", "qpos", "qvel"}
    for name, r in ref.items():
        if name not in downstream and not name.startswith(("efc_", "qacc")):
            np.testing.assert_allclose(out[name].numpy(), np.asarray(r),
                                       rtol=1e-9, atol=1e-9, err_msg=name)
    for ours, theirs in zip(_contact_set(step.contact),
                            _contact_set(traj[1].contact)):
        np.testing.assert_allclose(ours[:, :3], theirs[:, :3], rtol=0,
                                   atol=1e-9)
        np.testing.assert_allclose(ours[:, 3:], theirs[:, 3:], rtol=0,
                                   atol=5e-7)
    np.testing.assert_allclose(out["qpos"].numpy(), np.asarray(ref["qpos"]),
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(out["qvel"].numpy(), np.asarray(ref["qvel"]),
                               rtol=0, atol=1e-4)


def test_teacher_forced_steps_match_jax(run):
    _, mt, traj, stir = run
    same, dq_same, dv_same = 0, 0.0, 0.0
    for i in range(NSTEPS):
        d = from_jax_data(traj[i])
        out = engine.step(mt, d.replace(ctrl=stir(d)))
        ours, theirs = _contact_set(out.contact), _contact_set(
            traj[i + 1].contact)
        dq = np.abs(out.qpos.numpy() - np.asarray(traj[i + 1].qpos)).max(-1)
        dv = np.abs(out.qvel.numpy() - np.asarray(traj[i + 1].qvel)).max(-1)
        for e in range(NENV):
            # same contact set: same pairs, depths to 1e-9, points to the
            # width of an eps feature (5e-7)
            if ours[e].shape == theirs[e].shape and np.allclose(
                    ours[e][:, :3], theirs[e][:, :3], rtol=0, atol=1e-9) \
                    and np.allclose(ours[e][:, 3:], theirs[e][:, 3:],
                                    rtol=0, atol=5e-7):
                same += 1
                dq_same = max(dq_same, dq[e])
                dv_same = max(dv_same, dv[e])
        # whatever the ties did, one step cannot take the state far
        assert dq.max() < 2e-2, (i, dq)
    print(f"same contact set in {same} of {NENV * NSTEPS} cells; there "
          f"qpos within {dq_same:.1e}, qvel within {dv_same:.1e}")
    assert same >= 0.3 * NENV * NSTEPS, same
    # a contact point that moved by an eps feature's width (1e-7) under a
    # stiff deep contact moves qvel by ~1e-5 and qpos by ~4e-8 in one step
    assert dq_same < 1e-6, dq_same
    assert dv_same < 1e-3, dv_same


def test_free_running_rollout_stays_in_band(run):
    _, mt, traj, stir = run
    out = rollout(mt, from_jax_data(traj[0]), NSTEPS, ctrl_fn=stir)
    dq = np.abs(out.qpos.numpy() - np.asarray(traj[-1].qpos))
    assert np.isfinite(out.qpos.numpy()).all()
    assert (dq <= 2.5e-3).mean() >= 0.9, dq.max()
    obj = np.stack([dq[:, 6 + 7 * k:9 + 7 * k] for k in range(6)])
    assert obj.max() <= 2e-2, obj.max()
    assert float(out.time[0]) == pytest.approx(float(traj[-1].time[0]))
    # the arm really stirred and the objects really moved
    assert np.abs(out.qpos.numpy()[:, :6]).max() > 0.05
    assert int(out.ncon.min()) >= 8


def test_rollout_with_ctrl_fn_equals_stepping_by_hand(run):
    _, mt, traj, stir = run
    d0 = from_jax_data(traj[5])
    by_hand = d0
    for _ in range(4):
        by_hand = engine.step(mt, by_hand.replace(ctrl=stir(by_hand)))
    rolled = rollout(mt, d0, 4, ctrl_fn=stir)
    for (name, a), (_, b) in zip(_leaves(by_hand), _leaves(rolled)):
        assert torch.equal(a, b), name
    reduced = rollout(mt, d0, 4, full_final=False, ctrl_fn=stir)
    assert torch.equal(reduced.qpos, rolled.qpos)
    assert torch.equal(reduced.ctrl, rolled.ctrl)


def test_step_with_control_equals_step_with_that_ctrl(run):
    """step1 -> controller -> step2 is the step when the controller only
    writes ctrl (ctrl enters at fwd_actuation, in step2)."""
    _, mt, traj, stir = run
    d0 = from_jax_data(traj[3])
    want = engine.step(mt, d0.replace(ctrl=stir(d0)))
    got, aux = engine.step_with_control(
        mt, d0, lambda m, d, gain: (d.replace(ctrl=gain * stir(d)), "aux"),
        1.0)
    assert aux == "aux"
    for (name, a), (_, b) in zip(_leaves(want), _leaves(got)):
        assert torch.equal(a, b), name
