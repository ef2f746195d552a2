"""Port parity of ops/manifold.exact_pair_contacts against the JAX package
(CPU, f64) on the cube probes of tests/test_manifold.py: face-face,
vertex-face, edge-edge and cylinder-side contacts, a separated pair (the
separation certificate) and disabled lanes, all mixed in one batch.

The hulls come from the in-repo cube.stl (half extent 0.1) and a cylinder
geom compiled by the JAX package; values to 1e-10, masks equal.  The rows
of one manifold share their depth, so they are compared as a set.  A vertex
or edge feature is a rectangle 2e-6 * rbound wide whose corners tie in
exact arithmetic; which corner survives is decided by the last bit of each
package's arithmetic, so points are held to that width (5e-7), depths,
normals and certificates to 1e-10.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_sim_tpu import engine as jengine
from mujoco_sim_tpu.models.compile import compile_spec
from mujoco_sim_tpu.models.mjcf import parse_mjcf_string
from mujoco_sim_tpu.ops.manifold import exact_pair_contacts as jax_epc
from mujoco_sim_tpu_torch.ops.manifold import exact_pair_contacts
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
TOL = 1e-10
POS_TOL = 5e-7
H = 0.1                                      # cube half extent
XML = """
<mujoco>
  <compiler meshdir="{meshdir}"/>
  <asset><mesh name="cube" file="cube.stl"/></asset>
  <worldbody>
    <body name="a" pos="0 0 0"><freejoint/>
      <geom type="mesh" mesh="cube"/></body>
    <body name="b" pos="0 0 0.5"><freejoint/>
      <geom type="mesh" mesh="cube"/></body>
    <body name="c" pos="0.5 0 0.5"><freejoint/>
      <geom type="cylinder" size="0.04 0.015"/></body>
  </worldbody>
</mujoco>
"""


def _quat(axis, angle):
    axis = np.asarray(axis, float) / np.linalg.norm(axis)
    return np.concatenate([[np.cos(angle / 2)], np.sin(angle / 2) * axis])


def _rotm(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])


# name -> (hull of B, pos of B, quat of B, enabled, expected active rows)
CASES = {
    "face_face": ("cube", [1.2 * H, 0.8 * H, 1.5 * H], [1, 0, 0, 0], True, 4),
    "vertex_face": ("cube", [0, 0, 2.5 * H],
                    _quat([1, 1, 0], np.arccos(1 / np.sqrt(3))), True, 1),
    "edge_edge": ("cube", [0, 1.9 * H, 1.9 * H], _quat([0, 0, 1], np.pi / 4),
                  True, None),
    "cyl_side": ("cyl", [0.03, 0.05, H + 0.02], _quat([1, 0, 0], np.pi / 2),
                 True, 3),
    "separated": ("cube", [0.3 * H, 0, 2.4 * H], _quat([0, 0, 1], 0.3), True,
                  0),
    "face_face_off": ("cube", [1.2 * H, 0.8 * H, 1.5 * H], [1, 0, 0, 0],
                      False, 0),
    "cyl_side_off": ("cyl", [0.03, 0.05, H + 0.02],
                     _quat([1, 0, 0], np.pi / 2), False, 0),
    "empty_slot": (None, [0, 0, 0], [1, 0, 0, 0], False, 0),
}


@pytest.fixture(scope="module")
def batch():
    m = jengine.set_const(compile_spec(parse_mjcf_string(
        XML.format(meshdir=FIXTURES))))
    hull = {"cube": int(m.layout.geom_hullid[0]),
            "cyl": int(m.layout.geom_hullid[2]), None: -1}
    tables = {k: np.asarray(getattr(m, f), np.float64) for k, f in (
        ("vert", "mesh_vert_hi"), ("vmask", "mesh_vert_hi_mask"),
        ("fplane", "mesh_fplane"), ("fmask", "mesh_fmask"),
        ("fpoly", "mesh_fpoly"), ("hedge", "mesh_hedge"),
        ("hemask", "mesh_hedge_mask"))}
    cyl = np.asarray(m.mesh_cyl, np.float64)
    nh = cyl.shape[0]
    L = len(CASES)
    hidA = np.array([hull["cube"] if c[0] else -1 for c in CASES.values()])
    hidB = np.array([hull[c[0]] for c in CASES.values()])
    pA = np.zeros((L, 3))
    RA = np.tile(np.eye(3), (L, 1, 1))
    RA[-1] = 0.0                             # an empty slot is all zeros
    pB = np.array([c[1] for c in CASES.values()], float)
    RB = np.stack([_rotm(np.asarray(c[2], float)) for c in CASES.values()])
    RB[-1] = 0.0
    en = np.array([c[3] for c in CASES.values()])
    moh = lambda hid: np.where((hid >= 0)[:, None],
                               np.eye(nh)[np.maximum(hid, 0)], 0.0)
    cylof = lambda hid: np.where((hid >= 0)[:, None],
                                 cyl[np.maximum(hid, 0)], 0.0)
    ref = jax.jit(jax.vmap(jax_epc, in_axes=(0,) * 9 + (None,)))(
        *(jnp.asarray(x) for x in (pA, RA, moh(hidA), cylof(hidA), pB, RB,
                                   moh(hidB), cylof(hidB), en)),
        {k: jnp.asarray(v) for k, v in tables.items()})
    t = torch.tensor
    out = exact_pair_contacts(
        t(pA), t(RA), t(hidA), t(cylof(hidA)), t(pB), t(RB), t(hidB),
        t(cylof(hidB)), t(en), {k: t(v) for k, v in tables.items()})
    return [np.asarray(r) for r in ref], [o.numpy() for o in out]


def _row_set(dist, pos):
    """Active rows (dist < 1e8) sorted by position."""
    act = dist < 1e8
    p = pos[act]
    return dist[act], p[np.lexsort(p.round(5).T[::-1])]


@pytest.mark.parametrize("i,name", list(enumerate(CASES)))
def test_exact_pair_contacts_matches_jax(batch, i, name):
    ref, out = batch
    want_rows = CASES[name][4]
    np.testing.assert_array_equal(out[3][i], ref[3][i])          # ok
    np.testing.assert_allclose(out[4][i], ref[4][i], rtol=0, atol=TOL)
    np.testing.assert_allclose(out[2][i], ref[2][i], rtol=0, atol=TOL)
    d_o, p_o = _row_set(out[0][i], out[1][i])
    d_r, p_r = _row_set(ref[0][i], ref[1][i])
    assert len(d_o) == len(d_r)
    if want_rows is not None:
        assert len(d_o) == want_rows
    np.testing.assert_allclose(d_o, d_r, rtol=0, atol=TOL)
    np.testing.assert_allclose(p_o, p_r, rtol=0, atol=POS_TOL)
    if name == "separated":
        assert out[4][i] > 0 and not out[3][i]    # certified separation
    if name == "face_face":
        np.testing.assert_allclose(out[2][i], [0, 0, 1], atol=1e-12)
        np.testing.assert_allclose(d_o, -0.5 * H, atol=1e-12)


def test_disabled_lanes_return_exactly_the_miss_tuple(batch):
    _, out = batch
    for i, c in enumerate(CASES.values()):
        if c[3]:
            continue
        assert (out[0][i] == 1e9).all() and (out[1][i] == 0).all()
        assert (out[2][i] == [0, 0, 1]).all()
        assert not out[3][i] and out[4][i] == 0
