"""Port parity of the heightfield narrowphase (ops/collision.py: the
``_hfield_*`` probes, ``_pick4`` and the heightfield group of collision())
with the JAX package (CPU, f64).

Probes: every ``_DISPATCH_HF`` entry (sphere, capsule, ellipsoid, box,
convex mesh -- the terrain fixture's rock and cylinder prism) on seeded
poses over two padded grids, tests/fixtures/tendon_terrain.xml's 64 x 64
ground and tests/test_hfield.py's 3 x 4 ramp, within 1e-10 in distance,
point and normal.  One case is a box lying flat on the fixture's flat
patch: its four bottom corners are equally deep bit for bit, and the same
four indices must win, in the same order (ties to the lowest index).

Contact sets: tests/test_hfield.py's sphere-on-ramp and bowl scenes and
the fixture, with objects lowered onto the ground, compared as sets
(pairs and depths to 1e-10, points to 1e-10).
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_sim_tpu import engine as jengine
from mujoco_sim_tpu.models.compile import compile_spec as jax_compile
from mujoco_sim_tpu.models.compile import load_model as jax_load_model
from mujoco_sim_tpu.models.mjcf import parse_mjcf_string as jax_parse
from mujoco_sim_tpu.ops import collision as jcol
from mujoco_sim_tpu.parallel import mesh as jmesh
from mujoco_sim_tpu_torch import engine
from mujoco_sim_tpu_torch.models.convert import from_jax_data, from_jax_model
from mujoco_sim_tpu_torch.models.model import GeomType
from mujoco_sim_tpu_torch.ops import collision
from mujoco_sim_tpu_torch.ops.math import quat_to_mat
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

FIXTURE = pathlib.Path(__file__).resolve().parent / "fixtures" \
    / "tendon_terrain.xml"
TOL = 1e-10
B, P = 4, 3

RAMP = " ".join(str(v) for v in [0, 0.2, 0.5, 1.0] * 3)
XML = f"""
<mujoco>
  <option timestep="0.002"/>
  <asset><hfield name="hf" nrow="3" ncol="4" size="2 1.5 0.8 0.1"
                 elevation="{RAMP}"/></asset>
  <worldbody>
    <geom name="terrain" type="hfield" hfield="hf"
          friction="1 0.005 0.0001"/>
    <body pos="0 0 1"><freejoint/>
      <geom type="sphere" size="0.1" mass="1"
            friction="1 0.005 0.0001"/></body>
  </worldbody>
</mujoco>
"""
_N = 9
_YY, _XX = np.meshgrid(np.linspace(-1, 1, _N), np.linspace(-1, 1, _N),
                       indexing="ij")
BOWL = f"""
<mujoco>
  <option timestep="0.002"/>
  <asset><hfield name="hf" nrow="{_N}" ncol="{_N}" size="1.5 1.5 0.4 0.1"
                 elevation="{' '.join(f'{v:.6f}' for v in
                                      ((_XX ** 2 + _YY ** 2) / 2).ravel())}"/>
  </asset>
  <worldbody>
    <geom type="hfield" hfield="hf"/>
    <body pos="0.2 0.1 0.7"><joint type="free" damping="2"/>
      <geom type="sphere" size="0.08" mass="1"/></body>
    <body pos="-0.4 0.3 0.8"><joint type="free" damping="2"/>
      <geom type="box" size="0.07 0.05 0.04" mass="0.5"/></body>
    <body pos="0.3 -0.5 0.9"><joint type="free" damping="2"/>
      <geom type="capsule" size="0.04 0.1" mass="0.4"/></body>
  </worldbody>
</mujoco>
"""


@pytest.fixture(scope="module")
def tables():
    """The fixture's ground and the 3 x 4 ramp as one padded table, and
    the fixture's rock and cylinder-prism hulls."""
    mj = jax_load_model(str(FIXTURE))
    ramp = jax_compile(jax_parse(XML))
    g = np.asarray(mj.hfield_data)[0]
    data = np.zeros((2,) + g.shape)
    data[0] = g
    data[1, :3, :4] = np.asarray(ramp.hfield_data)[0]
    size = np.stack([np.asarray(mj.hfield_size)[0],
                     np.asarray(ramp.hfield_size)[0]])
    lay = mj.layout
    hulls = [int(lay.geom_hullid[mj.names.geom_id(n)])
             for n in ("rock", "cylinder")]
    return dict(data=data, size=size, nrow=np.array([64, 3]),
                ncol=np.array([64, 4]), hid=np.array([0, 1, 0]),
                verts=np.asarray(mj.mesh_vert_pad)[hulls + hulls[:1]],
                vmask=np.asarray(mj.mesh_vert_mask)[hulls + hulls[:1]])


def _rot(rng, n, scale):
    """Random rotation matrices (n..., 3, 3) of up to `scale` rad."""
    ax = rng.normal(size=n + (3,))
    ax /= np.linalg.norm(ax, axis=-1, keepdims=True)
    ang = rng.uniform(-scale, scale, n)[..., None]
    q = np.concatenate([np.cos(ang / 2), ax * np.sin(ang / 2)], -1)
    return quat_to_mat(torch.tensor(q)).numpy()


def _poses(rng, t):
    """hfield frames (the first at the origin, the second moved and
    turned) and object poses above the two grids, near the surface."""
    hp = np.zeros((B, P, 3))
    hp[:, 1] = [0.3, -0.2, 0.1]
    hR = np.broadcast_to(np.eye(3), (B, P, 3, 3)).copy()
    hR[:, 1] = _rot(rng, (B,), 0.4)
    ext = np.where(t["hid"] == 0, 1.8, 0.5)[:, None]
    xy = rng.uniform(-1, 1, (B, P, 2)) * ext
    z = rng.uniform(0.0, 0.35, (B, P, 1))
    p = hp + np.einsum("bpij,bpj->bpi", hR,
                       np.concatenate([xy, z], -1))
    return hp, hR, p, _rot(rng, (B, P), np.pi)


def _port_hf(t):
    flat = torch.tensor(t["data"]).reshape(2, -1)
    return dict(flat=flat, C=t["data"].shape[-1],
                hid=torch.tensor(t["hid"]),
                nrow=torch.tensor(t["nrow"][t["hid"]], dtype=torch.float64),
                ncol=torch.tensor(t["ncol"][t["hid"]], dtype=torch.float64),
                size=torch.tensor(t["size"][t["hid"]]))


def _jax_probe(fn, t, hp, hR, p, R, *rest):
    hid = t["hid"]
    args = (jnp.asarray(t["data"][hid]), t["nrow"][hid], t["ncol"][hid],
            jnp.asarray(t["size"][hid]))

    def one(hp_, hR_, p_, R_, *r):
        return fn(hp_, hR_, *args, p_, R_, *r)

    in_axes = (0, 0, 0, 0) + tuple(0 if x.ndim == 3 and x.shape[0] == B
                                   else None for x in rest)
    return [np.asarray(x) for x in jax.vmap(one, in_axes=in_axes)(
        *(jnp.asarray(x) for x in (hp, hR, p, R) + rest))]


KEYS = [GeomType.SPHERE, GeomType.CAPSULE, GeomType.ELLIPSOID,
        GeomType.BOX, GeomType.MESH]


@pytest.mark.parametrize("kind", KEYS, ids=[k.name for k in KEYS])
def test_probe_matches_jax(kind, tables):
    t = tables
    rng = np.random.default_rng(int(kind))
    hp, hR, p, R = _poses(rng, t)
    key = (GeomType.HFIELD, kind)
    fn, needs_mesh = collision._DISPATCH_HF[key]
    jfn, _ = jcol._DISPATCH_HF[key]
    if needs_mesh:
        rest = (t["verts"], t["vmask"])
    else:
        rest = (rng.uniform(0.03, 0.12, (B, P, 3)),)
    got = fn(*(torch.tensor(x) for x in (hp, hR)), _port_hf(t),
             *(torch.tensor(x) for x in (p, R) + rest))
    want = _jax_probe(jfn, t, hp, hR, p, R, *rest)
    d = want[0]
    assert ((d < 0) & (d > -0.5)).any(), "no probe below the surface"
    for name, a, b in zip(("dist", "pos", "normal"), got, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, rtol=TOL, atol=TOL,
                                   err_msg=name)


def test_flat_box_ties_pick_the_same_corners(tables):
    """A level box on the flat patch: four corners tie bit for bit; the
    port keeps the JAX package's four, in its order."""
    t = tables
    data = t["data"][0]
    h = np.asarray(data[20:28, 36:44])
    assert np.ptp(h) == 0, "the fixture's flat patch moved"
    ztop = t["size"][0, 2]
    hp = np.zeros((B, P, 3))
    hR = np.broadcast_to(np.eye(3), (B, P, 3, 3)).copy()
    size = np.broadcast_to([0.08, 0.06, 0.05], (B, P, 3)).copy()
    p = np.zeros((B, P, 3))
    p[..., 0] = 0.51 + np.linspace(-0.05, 0.05, B)[:, None]
    p[..., 1] = -0.51
    p[..., 2] = h[0, 0] * ztop + 0.05 - 0.002
    R = np.broadcast_to(np.eye(3), (B, P, 3, 3)).copy()
    t0 = dict(t, hid=np.zeros(P, int))
    got = collision._hfield_box(*(torch.tensor(x) for x in (hp, hR)),
                                _port_hf(t0),
                                *(torch.tensor(x) for x in (p, R, size)))
    want = _jax_probe(jcol._hfield_box, t0, hp, hR, p, R, size)
    d = got[0].numpy()
    assert (d == d[..., :1]).all(), "the four picks should tie"
    np.testing.assert_allclose(d, -0.002, atol=1e-12)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)
    # the bottom corners (sz = -1) in index order: 0, 2, 4, 6
    bottom = p[..., None, :2] + np.array([[-1, -1], [-1, 1], [1, -1],
                                          [1, 1]]) * size[..., None, :2]
    np.testing.assert_allclose(got[1].numpy()[..., :2], bottom, atol=1e-12)


def _lowered(mj, nenv, rng, name):
    """A batch with every free body lowered onto the ground."""
    dj = jmesh.make_batch(mj, nenv, dtype=jnp.float64)
    qpos = np.array(dj.qpos)
    lay = mj.layout
    for j, (t, a) in enumerate(zip(lay.jnt_type, lay.jnt_qposadr)):
        if int(t) != 0:
            continue
        a = int(a)
        drop = 0.3 if name == "tendon_terrain" else 0.0
        qpos[:, a + 2] -= drop + rng.uniform(0.0, 0.02, nenv)
        q = np.concatenate([np.ones((nenv, 1)),
                            rng.uniform(-0.15, 0.15, (nenv, 3))], -1)
        qpos[:, a + 3:a + 7] = q / np.linalg.norm(q, axis=-1, keepdims=True)
    return dj.replace(qpos=jnp.asarray(qpos))


SCENES = {"ramp": XML, "bowl": BOWL, "tendon_terrain": None}


def _contact_set(c, e):
    act = np.asarray(c.active)[e]
    rows = np.concatenate([np.asarray(c.geom1)[e][:, None],
                           np.asarray(c.geom2)[e][:, None],
                           np.asarray(c.dist)[e][:, None],
                           np.asarray(c.pos)[e],
                           np.asarray(c.frame)[e][:, 0]], -1)[act]
    return rows[np.lexsort(rows.round(8).T[::-1])]


@pytest.mark.parametrize("name", list(SCENES))
def test_contact_sets_match_jax(name):
    xml = SCENES[name]
    mj = (jax_load_model(str(FIXTURE)) if xml is None
          else jengine.set_const(jax_compile(jax_parse(xml))))
    mt = engine.put_model(from_jax_model(mj), torch.float64, "cpu")
    rng = np.random.default_rng(3)
    dj = _lowered(mj, 4, rng, name)
    if name == "ramp":
        # sphere centres over the ramp's triangle interiors
        dj = dj.replace(qpos=dj.qpos.at[:, :3].set(jnp.asarray(
            [[0.3, 0.2, 0.33], [-1.0, -0.5, 0.18], [0.6, -0.4, 0.3],
             [-0.2, 0.7, 0.6]])))
    if name == "bowl":
        # each body's lowest point onto the bowl's surface below it
        dj = dj.replace(qpos=dj.qpos.at[:, 2::7].add(
            -jnp.asarray([0.612, 0.738, 0.73])))
    ref = jax.jit(jax.vmap(jengine.fwd_position, in_axes=(None, 0)))(mj, dj)
    out = engine.fwd_position(mt, from_jax_data(dj))
    n = 0
    for e in range(4):
        a, b = _contact_set(out.contact, e), _contact_set(ref.contact, e)
        assert a.shape == b.shape, e
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
        hf = np.asarray(mj.layout.geom_type)[a[:, 0].astype(int)] \
            == int(GeomType.HFIELD)
        n += int(hf.sum())
    assert n >= 3, "too few heightfield contacts"
