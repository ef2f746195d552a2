"""Port parity: contacts and efc rows after engine.fwd_position against the
JAX package (f64, 1e-10).

Tilted states make _plane_box and _box_box emit several contacts.  There,
box corners on the reference face tie in exact arithmetic and rounding
(XLA vs torch summation order) decides their slot order, so tilted states
compare the contact SET: slots in a canonical order, efc row blocks
permuted alike.  The axis-aligned state makes the four bottom corners of a
box tie exactly (no rounding), so it compares slot order as is: the
lowest-index tie-break of _top_k_small."""

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
from mujoco_sim_tpu_torch.models.model import contact_rows_per

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
# bit-level agreement is expected (same f64 arithmetic, summation order
# aside); 1e-10 leaves room for the order of the contact-frame sums
TOL = 1e-10
CONTACT_FIELDS = ("dist", "pos", "frame", "geom1", "geom2", "active")
EFC_FIELDS = ("efc_J", "efc_D", "efc_aref", "efc_R", "efc_active")


def _axis_quat(axis, angle):
    axis = np.asarray(axis, float) / np.linalg.norm(axis)
    return np.concatenate([[np.cos(angle / 2)], np.sin(angle / 2) * axis])


def _states(scene, kind):
    """(qpos, qvel) for 4 envs resting on / into the floor (and b1)."""
    rng = np.random.default_rng(7)
    qpos, qvel = [], []
    for _ in range(4):
        v = rng.uniform(-0.3, 0.3, 6 if scene == "floor_box.xml" else 12)
        if kind == "aligned":
            q1 = q2 = np.array([1.0, 0, 0, 0])
            tilt = 0.0
        else:
            tilt = rng.uniform(0.1, 0.4)
            q1 = _axis_quat(rng.standard_normal(3), tilt)
            q2 = _axis_quat(rng.standard_normal(3), rng.uniform(0.05, 0.15))
        if scene == "floor_box.xml":
            # the corners of a box with half-extents (.1,.12,.08) reach
            # below z=0 (aligned: all four bottom ones, tied)
            z = 0.078 if kind == "aligned" else 0.07 + 0.05 * tilt
            qpos.append(np.concatenate([[0.02, 0.01, z], q1]))
        else:
            z1 = 0.099
            z2 = z1 + 0.1 + 0.08 - (0.002 if kind == "aligned" else 0.005)
            qpos.append(np.concatenate([[0, 0, z1], q1, [0.03, 0.02, z2],
                                        q2]))
        qvel.append(v)
    return np.array(qpos), np.array(qvel)


def _slot_order(contact):
    """Per-env slot permutation sorting by (dist, pos) at 1e-9."""
    key = np.concatenate([np.asarray(contact.dist)[..., None],
                          np.asarray(contact.pos)], axis=-1).round(9)
    return np.stack([np.lexsort(k.T[::-1]) for k in key])


def _permuted(x, order, start=0, block=1):
    """x (B, n, ...) with the slot blocks [start + k*block, +block)
    reordered per env by order (B, K)."""
    x = np.array(x)
    B, K = order.shape
    rows = start + (order[:, :, None] * block
                    + np.arange(block)).reshape(B, K * block)
    x[:, start:start + K * block] = np.take_along_axis(
        x, rows.reshape(rows.shape + (1,) * (x.ndim - 2)), axis=1)
    return x


@pytest.mark.parametrize("kind", ["tilted", "aligned"])
@pytest.mark.parametrize("scene", ["floor_box.xml", "stack.xml"])
def test_contacts_and_rows_match_jax(scene, kind):
    mj = jax_load_model(str(FIXTURES / scene))
    mt = engine.put_model(from_jax_model(mj), torch.float64, "cpu")
    qpos, qvel = _states(scene, kind)
    dj = make_batch(mj, len(qpos), dtype=jnp.float64).replace(
        qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel))
    ref = jax.jit(jax.vmap(jengine.fwd_position, in_axes=(None, 0)))(mj, dj)
    out = engine.fwd_position(mt, from_jax_data(dj))

    ncon = out.ncon.numpy()
    np.testing.assert_array_equal(ncon, np.asarray(ref.ncon))
    # the states really exercise multi-contact manifolds
    assert ncon.min() >= (4 if kind == "aligned" else 2), ncon
    K = mt.ncon_max
    rp = contact_rows_per(mt.max_condim, mt.opt.cone)
    if kind == "aligned":
        o_out = o_ref = np.tile(np.arange(K), (len(qpos), 1))
    else:
        o_out, o_ref = _slot_order(out.contact), _slot_order(ref.contact)
    for name in CONTACT_FIELDS:
        np.testing.assert_allclose(
            _permuted(getattr(out.contact, name).numpy(), o_out),
            _permuted(getattr(ref.contact, name), o_ref), rtol=0, atol=TOL,
            err_msg=f"contact.{name}")
    for name in EFC_FIELDS:
        np.testing.assert_allclose(
            _permuted(getattr(out, name).numpy(), o_out,
                      mt.contact_efcadr, rp),
            _permuted(getattr(ref, name), o_ref, mt.contact_efcadr, rp),
            rtol=1e-12, atol=TOL, err_msg=name)
