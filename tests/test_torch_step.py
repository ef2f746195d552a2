"""Port parity for the slice as a whole: the batched Euler step and the
rollout of mujoco_sim_tpu_torch against jax.vmap(engine.step) and
parallel/mesh.rollout of the JAX package (CPU, f64), on jittered batches
as bench.py makes them."""

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
from mujoco_sim_tpu_torch.parallel.rollout import rollout
from mujoco_sim_tpu_torch.utils.struct import leaf_names

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
# scene -> {qpos index: height} of a state a few mm above resting contact
SCENES = {
    "floor_box.xml": {2: 0.105},
    "stack.xml": {2: 0.105, 9: 0.287},          # upper box just above
    "capsule_drop.xml": {2: 0.06, 9: 0.07},     # capsule and ball
}
NENV = 8


@pytest.fixture(scope="module", params=list(SCENES))
def scene(request):
    """(JAX model, port model, jittered JAX batch, resting heights) per
    scene, built once."""
    mj = jax_load_model(str(FIXTURES / request.param))
    mt = engine.put_model(from_jax_model(mj), torch.float64, "cpu")
    rng = np.random.default_rng(0)
    qpos = np.tile(np.asarray(mj.qpos0), (NENV, 1))
    qvel = np.zeros((NENV, mj.nv))
    # bench.py's jitter: lift the (first) body and spin it; the stack's
    # upper box is lifted alike so the two never start interpenetrating
    lift = rng.uniform(0.0, 0.3, NENV)
    qpos[:, 2] += lift
    if request.param == "stack.xml":
        qpos[:, 9] += lift
    qvel[:, 3:6] = rng.uniform(-0.5, 0.5, (NENV, 3))
    dj = jmesh.make_batch(mj, NENV, dtype=jnp.float64).replace(
        qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel))
    return mj, mt, dj, SCENES[request.param]


def _leaves(d, prefix=""):
    for name in leaf_names(d):
        v = getattr(d, name)
        if name == "contact":
            yield from _leaves(v, "contact.")
        else:
            yield prefix + name, v


def test_one_step_matches_jax_on_every_leaf(scene):
    mj, mt, dj, _ = scene
    ref = dict(_leaves(jax.jit(jmesh.batched_step)(mj, dj)))
    out = dict(_leaves(engine.step(mt, from_jax_data(dj))))
    assert sorted(out) == sorted(ref)
    for name, r in ref.items():
        r = np.asarray(r)
        o = out[name].numpy()
        assert o.shape == r.shape and o.dtype == r.dtype, name
        # same f64 algorithm; 1e-9 absorbs summation order through the
        # solver (relative for the large regularization leaves)
        np.testing.assert_allclose(o, r, rtol=1e-9, atol=1e-9, err_msg=name)


def test_rollout_matches_jax(scene):
    mj, mt, dj, _ = scene
    n = 200          # the boxes fall, land, tumble and settle
    ref = jax.jit(jmesh.rollout, static_argnums=2)(mj, dj, n)
    out = rollout(mt, from_jax_data(dj), n)
    assert out.ncon.min() > 0
    # 200 steps through impacts amplify last-bit differences; 1e-6
    np.testing.assert_allclose(out.qpos.numpy(), np.asarray(ref.qpos),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(out.qvel.numpy(), np.asarray(ref.qvel),
                               rtol=0, atol=1e-6)


def test_reduced_carry_equals_full_data_loop(scene):
    """The hand-listed recurrent leaves give the same result as carrying
    all of Data, from a state already in contact and spinning."""
    _, mt, dj, heights = scene
    d0 = from_jax_data(dj)
    qpos = d0.qpos.clone()
    for i, z in heights.items():
        qpos[:, i] = z
    d0 = d0.replace(qpos=qpos)
    full = d0
    for _ in range(30):
        full = engine.step(mt, full)
    reduced = rollout(mt, d0, 30)
    assert full.ncon.min() > 0
    for (name, a), (_, b) in zip(_leaves(full), _leaves(reduced)):
        assert torch.equal(a, b), name

