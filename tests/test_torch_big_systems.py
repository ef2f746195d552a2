"""Port parity above the register-resident size classes of the Cholesky
kernels (n > 64, where csrc/chol_solve.cu and chol_factor.cu take one
block a system): the whole slice on tests/fixtures/box_pile11.xml (11 free
boxes on a floor, nv = 66) against the JAX package's step, f64 on the CPU.
The twins at n = 65 and 72 are held in test_torch_kernels_twins.py."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mujoco_sim_tpu.models.compile import load_model as jax_load_model
from mujoco_sim_tpu.parallel import mesh as jmesh
from mujoco_sim_tpu_torch import engine
from mujoco_sim_tpu_torch.models.convert import from_jax_data, from_jax_model
from mujoco_sim_tpu_torch.parallel.rollout import rollout
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"


def test_box_pile11_rollout_matches_jax():
    """2 envs (one at rest, one spun), 10 steps: the port's rollout against
    the JAX package's jitted step applied ten times (what its rollout
    scans), f64.  The two Newton solvers stop on their own last-bit tests
    (ROADMAP C): converged accelerations agree to ~2e-7 (held to 1e-6, the
    band for converged states), positions and velocities after ten steps
    to ~1e-9 (held to 1e-8)."""
    mj = jax_load_model(str(FIXTURES / "box_pile11.xml"))
    assert mj.nv == 66
    mt = engine.put_model(from_jax_model(mj), torch.float64, "cpu")
    qvel = np.zeros((2, mj.nv))
    qvel[1, 3:6] = [0.3, -0.2, 0.1]
    dj = jmesh.make_batch(mj, 2, dtype=jnp.float64).replace(
        qvel=jnp.asarray(qvel))
    step = jax.jit(jmesh.batched_step)
    ref = dj
    for _ in range(10):
        ref = step(mj, ref)
    out = rollout(mt, from_jax_data(dj), 10)
    assert int(out.ncon.min()) > 0
    np.testing.assert_array_equal(out.ncon.numpy(), np.asarray(ref.ncon))
    for name, tol in (("qpos", 1e-8), ("qvel", 1e-8), ("qacc", 1e-6)):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=tol, atol=tol, err_msg=name)
