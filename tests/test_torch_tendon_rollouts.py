"""200-step rollouts of the contact-free tendon scenes of
tests/test_torch_tendons.py (fixed tendons with a limit and a tendon
actuator, a spatial site chain with a limit, cylinder and sphere wraps, a
wrap-inside sidesite, a pulley, a tendon equality): the port against the
JAX package's rollout (CPU, f64), qpos and tendon lengths within 1e-8.
Kept apart from the single-state checks so that neither file grows past a
few minutes on the CPU.
"""

import jax
import numpy as np
import pytest

from mujoco_sim_tpu.parallel import mesh as jmesh
from mujoco_sim_tpu_torch.models.convert import from_jax_data
from mujoco_sim_tpu_torch.parallel.rollout import rollout
from tests.test_torch_tendons import SCENES, _seeded
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

INLINE = [k for k, v in SCENES.items() if v is not None]


@pytest.mark.parametrize("name", INLINE)
def test_rollout_matches_jax(name):
    mj, mt, dj = _seeded(name)
    n = 200
    ref = jax.jit(jmesh.rollout, static_argnums=2)(mj, dj, n)
    out = rollout(mt, from_jax_data(dj), n)
    np.testing.assert_allclose(out.qpos.numpy(), np.asarray(ref.qpos),
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(out.ten_length.numpy(),
                               np.asarray(ref.ten_length), rtol=0, atol=1e-8)
