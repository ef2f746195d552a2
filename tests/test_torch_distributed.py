"""Multi-process port: two gloo processes form one env mesh
(mujoco_sim_tpu_torch/parallel/distributed.py), each with two CPU shards,
and their sharded rollout and cross-process ring are held to the JAX
package's plain rollout of the same envs (f64) and to the block roll.

The workers import torch and the port only; the test process runs the
JAX side.  The process group's own timeout and ``communicate``'s bound a
hang."""

import os
import pathlib
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mujoco_sim_tpu.models.compile import load_model as jax_load_model
from mujoco_sim_tpu.parallel import mesh as jmesh
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent
NENV, NPROC, SHARDS, NSTEPS, DZ = 8, 2, 2, 5, 0.05
# port vs JAX over a rollout: the band of tests/test_torch_step.py
ROLLOUT_ATOL = 1e-6

_WORKER = r'''
import sys
sys.path.insert(0, %(repo)r)
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from mujoco_sim_tpu_torch import engine
from mujoco_sim_tpu_torch.models.compile import load_model
from mujoco_sim_tpu_torch.parallel import distributed as D, mesh as pmesh
pid = int(sys.argv[1])
D.initialize("127.0.0.1:%(port)d", %(nproc)d, pid, device="cpu",
             timeout=120)
mesh = D.global_env_mesh(local_devices=["cpu"] * %(shards)d)
assert mesh.size == %(nproc)d * %(shards)d and mesh.world == %(nproc)d
assert dist.get_backend() == "gloo"
m = engine.put_model(load_model(%(repo)r + "/tests/fixtures/floor_ball.xml"),
                     torch.float64, "cpu")
d0 = engine.make_data(m, 1)
def mk(i):
    qpos = d0.qpos.clone()
    qpos[:, 2] += %(dz)r * i
    return d0.replace(qpos=qpos)
dS = D.host_local_batch(mk, %(nenv)d, mesh)
assert len(dS.shards) == %(shards)d
mR = pmesh.replicate_model(m, mesh)
dS = pmesh.make_sharded_rollout(mR, mesh, %(nsteps)d)(mR, dS)
pos, quat = pmesh.exchange_body_state(dS, mesh, body_id=1)
d = dS.gather()
np.savez(%(out)r + "/rank%%d.npz" %% pid, qpos=d.qpos.numpy(),
         xpos=d.xpos[:, 1].numpy(), xquat=d.xquat[:, 1].numpy(),
         pos=pos.gather().numpy(), quat=quat.gather().numpy())
dist.destroy_process_group()
print("DIST_OK", pid, flush=True)
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_processes_roll_out_and_ring(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(_WORKER % dict(
        repo=str(ROOT), port=_free_port(), nproc=NPROC, shards=SHARDS,
        dz=DZ, nenv=NENV, nsteps=NSTEPS, out=str(tmp_path)))
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(i)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, env=env, text=True, cwd=str(tmp_path))
        for i in range(NPROC)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
        assert "DIST_OK" in out, out[-3000:]
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(NPROC)]

    # each rank holds its own envs: held to the JAX package's plain
    # rollout of the same eight envs
    mj = jax_load_model(str(ROOT / "tests" / "fixtures" / "floor_ball.xml"))
    dj = jmesh.make_batch(mj, NENV, dtype=jnp.float64)
    dj = dj.replace(qpos=dj.qpos.at[:, 2].add(DZ * jnp.arange(NENV)))
    ref = jax.jit(lambda m, d: jmesh.rollout(m, d, NSTEPS))(mj, dj)
    local = NENV // NPROC
    for r, got in enumerate(ranks):
        assert got["qpos"].shape == (local, 7)
        np.testing.assert_allclose(
            got["qpos"], np.asarray(ref.qpos)[r * local:(r + 1) * local],
            rtol=0, atol=ROLLOUT_ATOL)

    # the ring moves whole shard blocks, across the process boundary too:
    # env e receives env (e - NENV / shards) mod NENV, bit for bit
    xpos = np.concatenate([g["xpos"] for g in ranks])
    xquat = np.concatenate([g["xquat"] for g in ranks])
    block = NENV // (NPROC * SHARDS)
    np.testing.assert_array_equal(
        np.concatenate([g["pos"] for g in ranks]), np.roll(xpos, block, 0))
    np.testing.assert_array_equal(
        np.concatenate([g["quat"] for g in ranks]), np.roll(xquat, block, 0))
    np.testing.assert_allclose(xpos, np.asarray(ref.xpos)[:, 1], rtol=0,
                               atol=ROLLOUT_ATOL)


def test_initialize_without_a_card_or_a_peer(monkeypatch):
    """device "cuda" raises without a card (no switch to gloo); one
    process without a coordinator joins nothing; one gloo process forms a
    mesh whose ring brings its own last block back to its first shard."""
    import torch
    import torch.distributed as dist
    from mujoco_sim_tpu_torch import engine
    from mujoco_sim_tpu_torch.models.compile import load_model
    from mujoco_sim_tpu_torch.parallel import distributed as D
    from mujoco_sim_tpu_torch.parallel import mesh as pmesh
    from mujoco_sim_tpu_torch.utils.struct import map_leaves
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            D.initialize(device="cuda")
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    D.initialize(device="cpu")
    assert not dist.is_initialized()
    D.initialize(f"127.0.0.1:{_free_port()}", 1, 0, device="cpu",
                 timeout=60)
    try:
        assert dist.get_backend() == "gloo"
        mesh = D.global_env_mesh(local_devices=["cpu"] * 2)
        assert mesh.world == 1 and mesh.size == 2
        m = engine.put_model(load_model(str(
            ROOT / "tests" / "fixtures" / "floor_box.xml")), torch.float64,
            "cpu")
        d = engine.forward(m, engine.make_data(m, 4))
        lift = 0.01 * torch.arange(4, dtype=torch.float64)
        d = d.replace(qpos=d.qpos + lift[:, None])

        def env(i):
            return map_leaves(lambda x: x[i:i + 1], d)

        dS = D.host_local_batch(env, 4, mesh)
        assert torch.equal(dS.gather().qpos, d.qpos)
        pos, quat = pmesh.exchange_body_state(dS, mesh, 1)
        assert torch.equal(pos.gather(), torch.roll(d.xpos[:, 1], 2, 0))
        assert torch.equal(quat.gather(), torch.roll(d.xquat[:, 1], 2, 0))
    finally:
        dist.destroy_process_group()
