"""Port parity: ops/smooth.py (kinematics, com_pos, crb, com_vel, rne)
and engine.set_const against the JAX package at random batched states
(f64, 1e-12).  The JAX side is its per-env code under jax.vmap."""

import pathlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_sim_tpu.engine import set_const as jax_set_const
from mujoco_sim_tpu.models.compile import compile_spec as jax_compile_spec
from mujoco_sim_tpu.models.mjcf import parse_mjcf as jax_parse_mjcf
from mujoco_sim_tpu.ops import constraint as jconstraint
from mujoco_sim_tpu.ops import smooth as jsmooth
from mujoco_sim_tpu.ops import support as jsupport
from mujoco_sim_tpu_torch import engine
from mujoco_sim_tpu_torch.models.compile import compile_spec
from mujoco_sim_tpu_torch.models.mjcf import parse_mjcf
from mujoco_sim_tpu_torch.ops import constraint as tconstraint
from mujoco_sim_tpu_torch.ops import smooth as tsmooth
from mujoco_sim_tpu_torch.ops import support as tsupport
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
SCENES = ["arm.xml", "floor_box.xml", "stack.xml", "capsule_drop.xml",
          "floor_ball.xml"]
TOL = 1e-12
B = 4


def _random_state(m, rng):
    """Batched qpos/qvel: free joints get random positions and unit
    quaternions, hinges random angles."""
    qpos = np.tile(np.asarray(m.qpos0), (B, 1))
    qvel = rng.standard_normal((B, m.nv)) * 0.5
    lay = m.layout
    for j in range(m.njnt):
        adr = lay.jnt_qposadr[j]
        if lay.jnt_type[j] == 0:            # free
            qpos[:, adr:adr + 3] += rng.standard_normal((B, 3)) * 0.5
            q = rng.standard_normal((B, 4))
            qpos[:, adr + 3:adr + 7] = q / np.linalg.norm(q, axis=1,
                                                          keepdims=True)
        else:                               # hinge in these scenes
            qpos[:, adr] += rng.standard_normal(B)
    return qpos, qvel


def _jax_pipeline(m):
    def one(qpos, qvel):
        kin = jsmooth.kinematics(m, qpos)
        com = jsmooth.com_pos(m, kin)
        qM = jsmooth.crb(m, com)
        vel = jsmooth.com_vel(m, com, qvel)
        bias = jsmooth.rne(m, com, vel, qvel)
        return dict(kin=kin, com=com, qM=qM, vel=vel, bias=bias)
    return jax.jit(jax.vmap(one))


def _torch_pipeline(m, qpos, qvel):
    kin = tsmooth.kinematics(m, qpos)
    com = tsmooth.com_pos(m, kin)
    qM = tsmooth.crb(m, com)
    vel = tsmooth.com_vel(m, com, qvel)
    bias = tsmooth.rne(m, com, vel, qvel)
    return dict(kin=kin, com=com, qM=qM, vel=vel, bias=bias)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


@pytest.mark.parametrize("scene", SCENES)
def test_smooth_matches_jax(scene):
    path = str(FIXTURES / scene)
    mj = jax_set_const(jax_compile_spec(jax_parse_mjcf(path)))
    mt = engine.put_model(engine.set_const(compile_spec(parse_mjcf(path))),
                          torch.float64, "cpu")
    qpos, qvel = _random_state(mj, np.random.default_rng(SCENES.index(scene)))
    ref = dict(_flat(_jax_pipeline(mj)(jnp.asarray(qpos),
                                       jnp.asarray(qvel))))
    out = dict(_flat(_torch_pipeline(mt, torch.as_tensor(qpos),
                                     torch.as_tensor(qvel))))
    assert sorted(out) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=TOL, err_msg=k)


@pytest.mark.parametrize("scene", ["arm.xml", "stack.xml"])
def test_unwired_helpers_match_jax(scene):
    """mul_m, apply_ft and the point/rot Jacobians are ported with the slice
    but only later modules call them (controllers, equality rows), so they
    are held to the JAX package here."""
    path = str(FIXTURES / scene)
    mj = jax_set_const(jax_compile_spec(jax_parse_mjcf(path)))
    mt = engine.put_model(engine.set_const(compile_spec(parse_mjcf(path))),
                          torch.float64, "cpu")
    rng = np.random.default_rng(11)
    qpos, _ = _random_state(mj, rng)
    body = np.arange(1, mj.nbody)                  # every non-world body
    fbody = mj.nbody - 1
    args = dict(vec=rng.standard_normal((B, mj.nv)),
                point=rng.standard_normal((B, len(body), 3)),
                force=rng.standard_normal((B, 3)),
                torque=rng.standard_normal((B, 3)),
                fpoint=rng.standard_normal((B, 3)))

    def one(qpos, a):
        com = jsmooth.com_pos(mj, jsmooth.kinematics(mj, qpos))
        d = SimpleNamespace(qpos=qpos, cdof=com["cdof"])
        return dict(
            mul_m=jsmooth.mul_m(mj, jsmooth.crb(mj, com), a["vec"]),
            apply_ft=jsupport.apply_ft(mj, com, a["force"], a["torque"],
                                       a["fpoint"], fbody),
            jacp=jconstraint._point_jacobian(mj, d, a["point"], body,
                                             com["origin"][body]),
            jacr=jconstraint._rot_jacobian(mj, d, body))

    ref = jax.jit(jax.vmap(one))(jnp.asarray(qpos),
                                 {k: jnp.asarray(v) for k, v in args.items()})
    a = {k: torch.as_tensor(v) for k, v in args.items()}
    com = tsmooth.com_pos(mt, tsmooth.kinematics(mt, torch.as_tensor(qpos)))
    out = dict(
        mul_m=tsmooth.mul_m(mt, tsmooth.crb(mt, com), a["vec"]),
        apply_ft=tsupport.apply_ft(mt, com, a["force"], a["torque"],
                                   a["fpoint"], fbody),
        jacp=tconstraint._point_jacobian(mt, com["cdof"], a["point"], body,
                                         com["origin"][:, body]),
        jacr=tconstraint._rot_jacobian(mt, com["cdof"], body))
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=TOL, err_msg=k)


@pytest.mark.parametrize("scene", SCENES)
def test_set_const_matches_jax(scene):
    path = str(FIXTURES / scene)
    mj = jax_set_const(jax_compile_spec(jax_parse_mjcf(path)))
    mt = engine.set_const(compile_spec(parse_mjcf(path)))
    for name in ("dof_invweight0", "body_invweight0", "ten_invweight0",
                 "ten_length0", "ten_springlength", "actuator_acc0"):
        np.testing.assert_allclose(getattr(mt, name),
                                   np.asarray(getattr(mj, name)),
                                   rtol=0, atol=TOL, err_msg=name)
