"""Port parity of the env mesh and the trajectory egress
(mujoco_sim_tpu_torch/parallel/{mesh,egress}.py) against the JAX
package's parallel/{mesh,egress}.py: CPU, f64, the port's shards on a mesh
of eight CPU devices, the JAX package's on its eight virtual devices
(tests/conftest.py)."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_sim_tpu.models.compile import load_model as jax_load_model
from mujoco_sim_tpu.parallel import mesh as jmesh
from mujoco_sim_tpu_torch import engine
from mujoco_sim_tpu_torch.models.convert import from_jax_data, from_jax_model
from mujoco_sim_tpu_torch.parallel import egress, mesh as pmesh
from mujoco_sim_tpu_torch.runtime import profiler as tprof
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
NSHARD = 8
# port vs JAX over a rollout: the band tests/test_torch_step.py holds
# rollouts to (the same f64 algorithm, last-bit differences through
# contacts)
ROLLOUT_ATOL = 1e-6


def _jax_mesh():
    devices = jax.devices()
    if len(devices) < NSHARD:
        pytest.skip("needs the 8 virtual devices of tests/conftest.py")
    return jmesh.make_env_mesh(devices[:NSHARD])


@pytest.fixture(scope="module")
def ball():
    """floor_ball at 16 envs, dropped from seeded heights as
    tests/test_parallel.py drops it: (JAX model, JAX batch, port model,
    port batch)."""
    mj = jax_load_model(str(FIXTURES / "floor_ball.xml"))
    nenv = 16
    dj = jmesh.make_batch(mj, nenv, dtype=jnp.float64)
    dz = np.random.default_rng(1).uniform(size=nenv)
    dj = dj.replace(qpos=dj.qpos.at[:, 2].add(jnp.asarray(dz)))
    mt = engine.put_model(from_jax_model(mj), torch.float64, "cpu")
    return mj, dj, mt, from_jax_data(dj)


def test_sharded_rollout_matches_unsharded(ball):
    _, _, mt, dt = ball
    mesh = pmesh.make_env_mesh(["cpu"] * NSHARD)
    mR = pmesh.replicate_model(mt, mesh)
    dS = pmesh.shard_batch(dt, mesh)
    assert [s.qpos.shape[0] for s in dS.shards] == [2] * NSHARD
    plain = pmesh.rollout(mt, dt, 10)
    sharded = pmesh.make_sharded_rollout(mR, mesh, 10)(mR, dS)
    np.testing.assert_allclose(sharded.gather().qpos.numpy(),
                               plain.qpos.numpy(),
                               rtol=0, atol=1e-12)
    # the step of each shard is the step of its envs in the whole batch
    step = pmesh.make_sharded_step(mR, mesh)
    assert torch.equal(step(mR, dS).gather().qvel,
                       pmesh.batched_step(mt, dt).qvel)


def test_sharded_rollout_matches_jax_sharded_rollout(ball):
    mj, dj, mt, dt = ball
    jm = _jax_mesh()
    dS = jax.device_put(dj, jax.sharding.NamedSharding(
        jm, jax.sharding.PartitionSpec("env")))
    mS = jmesh.replicate_model(mj, jm)
    ref = jmesh.make_sharded_rollout(mS, jm, 10)(mS, dS)
    mesh = pmesh.make_env_mesh(["cpu"] * NSHARD)
    mR = pmesh.replicate_model(mt, mesh)
    out = pmesh.make_sharded_rollout(mR, mesh, 10)(
        mR, pmesh.shard_batch(dt, mesh)).gather()
    np.testing.assert_allclose(out.qpos.numpy(), np.asarray(ref.qpos),
                               rtol=0, atol=ROLLOUT_ATOL)
    np.testing.assert_allclose(out.qvel.numpy(), np.asarray(ref.qvel),
                               rtol=0, atol=ROLLOUT_ATOL)


def test_ring_exchange_shifts_whole_blocks_as_jax_does(ball):
    """16 envs over 8 shards: ppermute moves each device's block of two
    envs to the next device, so env e receives env (e - 2) mod 16, not
    env e - 1.  The port's exchange on the same state gives the JAX
    function's output exactly."""
    mj, dj, mt, _ = ball
    jm = _jax_mesh()
    nenv = 16
    dj = dj.replace(qpos=dj.qpos.at[:, 0].set(jnp.arange(float(nenv))))
    dj = jax.jit(jmesh.batched_step)(mj, dj)
    ref_pos, ref_quat = jmesh.exchange_body_state(
        jax.device_put(dj, jax.sharding.NamedSharding(
            jm, jax.sharding.PartitionSpec("env"))), jm, body_id=1)
    mesh = pmesh.make_env_mesh(["cpu"] * NSHARD)
    pos, quat = pmesh.exchange_body_state(
        pmesh.shard_batch(from_jax_data(dj), mesh), mesh, body_id=1)
    np.testing.assert_array_equal(pos.gather().numpy(), np.asarray(ref_pos))
    np.testing.assert_array_equal(quat.gather().numpy(),
                                  np.asarray(ref_quat))
    x = np.asarray(dj.xpos[:, 1, 0])
    np.testing.assert_array_equal(pos.gather().numpy()[:, 0],
                                  np.roll(x, nenv // NSHARD))


@pytest.fixture(scope="module")
def box():
    mj = jax_load_model(str(FIXTURES / "floor_box.xml"))
    dj = jmesh.make_batch(mj, 16, dtype=jnp.float64)
    lift = np.random.default_rng(2).uniform(0.0, 0.3, 16)
    dj = dj.replace(qpos=dj.qpos.at[:, 2].add(jnp.asarray(lift)))
    mt = engine.put_model(from_jax_model(mj), torch.float64, "cpu")
    return mj, dj, mt, from_jax_data(dj)


def test_rollout_traj_matches_jax(box):
    mj, dj, mt, dt = box
    ref_final, ref_traj = jax.jit(
        lambda m, d: jmesh.rollout_traj(m, d, 32))(mj, dj)
    final, traj = pmesh.rollout_traj(mt, dt, 32)
    assert traj.shape == (32, 16, 7)
    np.testing.assert_allclose(traj.numpy(), np.asarray(ref_traj),
                               rtol=0, atol=ROLLOUT_ATOL)
    # the last entry is the final full step's
    assert torch.equal(traj[-1], final.qpos)
    np.testing.assert_allclose(final.xpos.numpy(), np.asarray(ref_final.xpos),
                               rtol=0, atol=ROLLOUT_ATOL)


def test_rollout_collect_equals_rollout_traj_bit_for_bit(box):
    _, _, mt, dt = box
    final, traj = pmesh.rollout_traj(mt, dt, 32)
    cache = {}
    tprof.clear_spans()
    with tprof.tracing():
        got_final, got = egress.rollout_collect(mt, dt, 32, chunk=8,
                                                jit_cache=cache)
    reads = [s for s in tprof.spans() if s.name == "egress.read"]
    tprof.clear_spans()
    assert isinstance(got, np.ndarray) and len(reads) == 4
    np.testing.assert_array_equal(got, traj.numpy())
    assert torch.equal(got_final.qpos, final.qpos)
    # a sharded batch egresses its shards into their env columns, and a
    # tuple of observables comes back as a tuple of arrays
    mesh = pmesh.make_env_mesh(["cpu"] * 4)
    mR = pmesh.replicate_model(mt, mesh)
    _, (q, v) = egress.rollout_collect(
        mR, pmesh.shard_batch(dt, mesh), 32, chunk=8,
        extract=lambda d: (d.qpos, d.qvel))
    np.testing.assert_array_equal(q, traj.numpy())
    assert v.shape == (32, 16, 6)
    with pytest.raises(ValueError, match="multiple"):
        egress.rollout_collect(mt, dt, 30, chunk=8)


def test_scan_reduced_runs_step_fn(box):
    _, _, mt, dt = box
    out = pmesh.scan_reduced(lambda d: engine.step(mt, d), dt, 5)
    assert torch.equal(out.qpos, pmesh.rollout(mt, dt, 5).qpos)
    # every leaf is fresh: the derived ones are the fifth step's
    assert torch.equal(out.xpos, pmesh.rollout(mt, dt, 5).xpos)


def test_make_env_mesh_raises_without_a_card():
    if torch.cuda.is_available():
        mesh = pmesh.make_env_mesh()
        assert mesh.size == torch.cuda.device_count()
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        pmesh.make_env_mesh()
    mesh = pmesh.make_env_mesh(["cpu"] * 3, axis="batch")
    assert mesh.size == 3 and mesh.axis == "batch"
    assert list(mesh.local) == [0, 1, 2]


def test_make_batch_shards_every_leaf(box):
    _, _, mt, _ = box
    mesh = pmesh.make_env_mesh(["cpu"] * 4)
    dS = pmesh.make_batch(pmesh.replicate_model(mt, mesh), 8, mesh)
    plain = pmesh.make_batch(mt, 8)
    for s in dS.shards:
        assert s.qpos.shape[0] == 2 and s.contact.dist.shape[0] == 2
        assert s.time.shape == (2,)
    assert torch.equal(dS.gather().qpos, plain.qpos)
    with pytest.raises(ValueError):
        pmesh.make_batch(mt, 6, mesh)
