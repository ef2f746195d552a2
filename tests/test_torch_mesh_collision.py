"""Port parity of the mesh narrowphase and of collision() on mesh scenes
against the JAX package (CPU, f64).

Values to 1e-10 (same arithmetic, summation order aside), indices and
``active`` equal.  Poses are random (seeded numpy): no two candidates tie
exactly, so slot order is comparable as is.  collision() on whole scenes
compares the contact SET per env (slots in a canonical order): a resting
face or an eps-wide feature makes candidates tie in exact arithmetic, and
there the two packages' last-bit rounding picks the order.  Contact points
of whole scenes are held to the width of such a feature (2e-6 * rbound:
5e-7), everything else to 1e-10.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_sim_tpu import engine as jengine
from mujoco_sim_tpu.models.compile import load_model as jax_load_model
from mujoco_sim_tpu.ops import collision as jcol
from mujoco_sim_tpu.parallel.mesh import make_batch
from mujoco_sim_tpu_torch import engine
from mujoco_sim_tpu_torch.models.convert import from_jax_data, from_jax_model
from mujoco_sim_tpu_torch.ops import collision as tcol
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
TOL = 1e-10
POS_TOL = 5e-7
N = 48


@pytest.fixture(scope="module")
def manip():
    mj = jax_load_model(str(FIXTURES / "manip_bin6.xml"))
    mt = engine.put_model(from_jax_model(mj), torch.float64, "cpu")
    return mj, mt


def _rot(rng, n):
    q = rng.standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                  2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                  2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                  1 - 2 * (x * x + y * y)], -1)], -2)


def _hulls(mj, rng, n):
    """Random hull picks from the manip model's decimated tables."""
    hid = rng.integers(0, np.asarray(mj.mesh_vert_pad).shape[0], n)
    return (hid, np.asarray(mj.mesh_vert_pad)[hid],
            np.asarray(mj.mesh_face_pad)[hid],
            np.asarray(mj.mesh_vert_mask)[hid])


def _both(jfn, tfn, args, **kw):
    ref = jfn(*(jnp.asarray(a) for a in args),
              **{k: jnp.asarray(v) for k, v in kw.items()})
    out = tfn(*(torch.tensor(a) for a in args),
              **{k: torch.tensor(v) for k, v in kw.items()})
    return out, ref


def _assert_same(out, ref, names=("dist", "pos", "nrm")):
    for o, r, name in zip(out, ref, names):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0,
                                   atol=TOL, err_msg=name)


def test_plane_mesh(manip):
    mj, _ = manip
    rng = np.random.default_rng(0)
    _, verts, _, vmask = _hulls(mj, rng, N)
    pp = np.zeros((N, 3))
    pR = np.tile(np.eye(3), (N, 1, 1))
    mp = rng.uniform(-0.1, 0.1, (N, 3))
    mp[:, 2] = rng.uniform(0.0, 0.05, N)
    out, ref = _both(jcol._plane_mesh, tcol._plane_mesh,
                     (pp, pR, np.zeros((N, 3)), mp, _rot(rng, N), verts,
                      vmask), margin=np.full((N, 1), 0.002))
    _assert_same(out, ref)
    assert (out[0] < 0).sum() > N       # several contacts per hull happen


@pytest.mark.parametrize("kind", ["sphere", "capsule", "box"])
def test_primitive_vs_mesh(manip, kind):
    mj, _ = manip
    rng = np.random.default_rng(1)
    _, verts, planes, vmask = _hulls(mj, rng, N)
    p2 = rng.uniform(-0.1, 0.1, (N, 3))
    # probes from well inside to just outside the hull (radius ~0.04),
    # so faces, edges and corners (the GJK refinement) are all hit
    u = rng.standard_normal((N, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    p1 = p2 + u * rng.uniform(0.01, 0.075, (N, 1))
    s1 = np.stack([rng.uniform(0.01, 0.03, N), rng.uniform(0.02, 0.05, N),
                   rng.uniform(0.01, 0.03, N)], -1)
    jfn = getattr(jcol, f"_{kind}_mesh")
    tfn = getattr(tcol, f"_{kind}_mesh")
    out, ref = _both(jfn, tfn, (p1, _rot(rng, N), s1, p2, _rot(rng, N),
                                verts, planes, vmask))
    _assert_same(out, ref)
    assert (out[0].numpy() < 0).any() and (out[0].numpy() > 0).any()


def _mesh_mesh_inputs(mj, rng, B, P):
    hid1, verts1, planes1, vmask1 = _hulls(mj, rng, B * P)
    hid2, verts2, planes2, vmask2 = _hulls(mj, rng, B * P)
    p1 = rng.uniform(-0.1, 0.1, (B * P, 3))
    u = rng.standard_normal((B * P, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    # from deep overlap (a third of a hull) to clear separation
    p2 = p1 + u * rng.uniform(0.02, 0.09, (B * P, 1))
    sh = lambda x: x.reshape((B, P) + x.shape[1:])
    args = [sh(x) for x in (p1, _rot(rng, B * P), verts1, planes1, vmask1,
                            p2, _rot(rng, B * P), verts2, planes2, vmask2)]
    return args, sh(hid1), sh(hid2)


def test_mesh_mesh_sat_manifold(manip):
    mj, _ = manip
    rng = np.random.default_rng(2)
    args, _, _ = _mesh_mesh_inputs(mj, rng, 4, 12)
    out, ref = _both(jcol._mesh_mesh, tcol._mesh_mesh, args)
    _assert_same(out, ref)
    assert (out[0].numpy() < 0).any()


@pytest.mark.parametrize("exact_all", [False, True])
def test_mesh_mesh_with_deep_pair_manifold(manip, exact_all):
    """extras on: the deepest <= 8 pairs per env go through the exact
    manifold and scatter back; the others keep the SAT manifold."""
    mj, mt = manip
    rng = np.random.default_rng(3)
    B, P = 4, 12
    args, hid1, hid2 = _mesh_mesh_inputs(mj, rng, B, P)
    nh = np.asarray(mj.mesh_vert_pad).shape[0]
    f64 = lambda x: jnp.asarray(x, jnp.float64)
    tables = dict(vert=f64(mj.mesh_vert_hi), vmask=f64(mj.mesh_vert_hi_mask),
                  fplane=f64(mj.mesh_fplane), fmask=f64(mj.mesh_fmask),
                  fpoly=f64(mj.mesh_fpoly), hedge=f64(mj.mesh_hedge),
                  hemask=f64(mj.mesh_hedge_mask), cyl=f64(mj.mesh_cyl))

    def per_env(ohA, ohB, *a):
        return jcol._mesh_mesh(*a, extras=dict(tables, ohA=ohA, ohB=ohB,
                                               exact_all=exact_all))

    ref = jax.jit(jax.vmap(per_env))(
        jnp.asarray(np.eye(nh)[hid1]), jnp.asarray(np.eye(nh)[hid2]),
        *(jnp.asarray(a) for a in args))
    extras = dict(
        tables={k: torch.tensor(np.asarray(v)) for k, v in tables.items()
                if k != "cyl"},
        cyl=mt.mesh_cyl, hidA=torch.tensor(hid1), hidB=torch.tensor(hid2),
        exact_all=exact_all)
    out = tcol._mesh_mesh(*(torch.tensor(a) for a in args), extras=extras)
    plain = tcol._mesh_mesh(*(torch.tensor(a) for a in args))
    # the exact manifold really replaced some pairs' rows
    changed = (out[0] != plain[0]).any(-1).sum()
    assert changed >= 4, changed
    # rows of one exact manifold tie in depth; compare each pair's rows as
    # a set (sorted by depth, then position; a row at 1e9 is an unused
    # slot whose position means nothing)
    def canon(d, p, n):
        d, p, n = (np.array(x) for x in (d, p, n))
        p[d > 1e8] = 0.0
        order = np.lexsort(np.concatenate(
            [d[..., None], p], -1).round(5).transpose(3, 0, 1, 2)[::-1],
            axis=-1)
        take = lambda x: np.take_along_axis(
            x, order.reshape(order.shape + (1,) * (x.ndim - 3)), axis=2)
        return take(d), take(p), take(n)

    got, want = canon(*(o.numpy() for o in out)), canon(*ref)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=TOL)
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=TOL)
    # a vertex or edge feature is a rectangle 2e-6 * rbound wide whose
    # corners tie in exact arithmetic: which corner the reduction keeps is
    # decided by the last bit, so positions agree to that width (hulls of
    # radius < 0.08: 1.6e-7), not to 1e-10
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=POS_TOL)


def test_rank_slots_is_serial_argmax():
    """_rank_slots picks what k serial argmax-and-mask passes pick, ties
    to the lowest index, -inf entries last."""
    rng = np.random.default_rng(4)
    x = rng.integers(0, 5, (50, 9)).astype(float)       # many exact ties
    x[rng.uniform(size=x.shape) < 0.3] = -np.inf
    xt = torch.tensor(x)
    _, want = tcol._top_k_small(xt, 4)
    assert torch.equal(tcol._rank_slots(xt, 4), want)


SCENES = ["sphere_on_cube.xml", "box_on_cube.xml", "mesh_stack.xml",
          "cyl_stack.xml", "manip_bin6.xml"]
# how far each body is pushed down (m): the small manip hulls (square
# bases 5 cm wide) take less before a fourth corner goes under
PUSH = {s: (0.002, 0.006) for s in SCENES}
PUSH["manip_bin6.xml"] = (0.0005, 0.0015)
CONTACT_FIELDS = ("dist", "pos", "frame", "geom1", "geom2", "includemargin",
                  "friction", "solref", "solimp", "dim", "active")


def _canonical(contact):
    """Contact leaves as numpy with each env's slots sorted by (active
    first, geom1, geom2, pos, dist) at 1e-8."""
    get = lambda n: np.asarray(getattr(contact, n))
    act = get("active")
    key = np.concatenate([
        (~act)[..., None].astype(float), get("geom1")[..., None],
        get("geom2")[..., None], get("pos").round(5),
        get("dist")[..., None].round(8)], -1)
    order = np.stack([np.lexsort(k.T[::-1]) for k in key])
    out = {}
    for n in CONTACT_FIELDS:
        x = get(n)
        x = np.take_along_axis(
            x, order.reshape(order.shape + (1,) * (x.ndim - 2)), axis=1)
        # an empty slot's value leaves are whatever the compaction left
        # there; only its inactivity is part of the contract
        out[n] = x if n == "active" else np.where(
            np.take_along_axis(act, order, 1).reshape(
                act.shape + (1,) * (x.ndim - 2)), x, 0)
    return out


@pytest.mark.parametrize("scene", SCENES)
def test_collision_matches_jax(scene):
    mj = jax_load_model(str(FIXTURES / scene))
    mt = engine.put_model(from_jax_model(mj), torch.float64, "cpu")
    B = 4
    rng = np.random.default_rng(5)
    qpos = np.tile(np.asarray(mj.qpos0), (B, 1))
    # jitter every free body, push it 2-6 mm down and tilt it by 0.06-0.1
    # rad, so meshes touch what they rest on with at most three corners of
    # a face (four corners of a square face below a plane tie exactly for
    # the third plane-mesh contact, whatever the pose)
    for j in range(mj.njnt):
        if int(mj.layout.jnt_type[j]) == 0:
            a = int(mj.layout.jnt_qposadr[j])
            qpos[:, a:a + 2] += rng.uniform(-0.004, 0.004, (B, 2))
            qpos[:, a + 2] -= rng.uniform(*PUSH[scene], B)
            ax = rng.standard_normal((B, 3))
            ax *= rng.uniform(0.03, 0.05, (B, 1)) / np.linalg.norm(
                ax, axis=1, keepdims=True)
            dq = np.concatenate([np.ones((B, 1)), ax], 1)
            q = qpos[:, a + 3:a + 7]
            w0, x0, y0, z0 = q.T
            w1, x1, y1, z1 = dq.T
            q = np.stack([w0 * w1 - x0 * x1 - y0 * y1 - z0 * z1,
                          w0 * x1 + x0 * w1 + y0 * z1 - z0 * y1,
                          w0 * y1 - x0 * z1 + y0 * w1 + z0 * x1,
                          w0 * z1 + x0 * y1 - y0 * x1 + z0 * w1], 1)
            qpos[:, a + 3:a + 7] = q / np.linalg.norm(q, axis=1,
                                                      keepdims=True)
    dj = make_batch(mj, B, dtype=jnp.float64).replace(qpos=jnp.asarray(qpos))
    ref = jax.jit(jax.vmap(jengine.fwd_position, in_axes=(None, 0)))(mj, dj)
    out = engine.fwd_position(mt, from_jax_data(dj))
    np.testing.assert_array_equal(out.ncon.numpy(), np.asarray(ref.ncon))
    assert int(out.ncon.min()) > 0
    a, b = _canonical(out.contact), _canonical(ref.contact)
    for n in CONTACT_FIELDS:
        np.testing.assert_allclose(a[n], b[n], rtol=0,
                                   atol=POS_TOL if n == "pos" else TOL,
                                   err_msg=f"contact.{n}")


def test_top_p_fallback_runs_with_more_live_pairs_than_slots(manip):
    """34 capsule-mesh pairs into 32 slots: with every pair inside its
    AABB margin the deepest-first selection takes over from the rank
    compaction, per env; the other envs keep candidate order."""
    mj, mt = manip
    B = 3
    dj = make_batch(mj, B, dtype=jnp.float64)
    ref0 = jax.jit(jax.vmap(jengine.fwd_position, in_axes=(None, 0)))(mj, dj)
    # pile the arm's capsules and every mesh (geoms 5..) of env 0 and env 2
    # onto one spot above the floor: all their AABBs overlap
    xpos = np.array(ref0.geom_xpos)
    rng = np.random.default_rng(6)
    xpos[0, 5:] = rng.uniform(-0.02, 0.02, xpos[0, 5:].shape) + [0, 0, 0.3]
    xpos[2, 5:] = rng.uniform(-0.03, 0.03, xpos[2, 5:].shape) + [0.1, 0, 0.3]
    dj = ref0.replace(geom_xpos=jnp.asarray(xpos))
    ref = jax.jit(jax.vmap(jcol.collision, in_axes=(None, 0)))(mj, dj)
    out = tcol.collision(mt, from_jax_data(dj))
    # the fallback's condition holds in envs 0 and 2 only
    plan = mt.layout.const("collision", None, torch.float64)
    g = [g for g in plan["groups"] if g["hull"]
         and g["top_p"] < g["sel"].shape[0]][0]
    assert g["top_p"] == 32 and g["sel"].shape[0] == 34
    np.testing.assert_array_equal(out.ncon.numpy(), np.asarray(ref.ncon))
    a, b = _canonical(out.contact), _canonical(ref.contact)
    # capsule-mesh contacts (geom1 a capsule 5..9, geom2 a mesh 10..) fill
    # most of the 32 slots of the piled envs
    assert ((a["geom1"] >= 5) & (a["geom1"] <= 9) & (a["geom2"] >= 10)
            )[[0, 2]].sum() > 40
    for n in CONTACT_FIELDS:
        np.testing.assert_allclose(a[n], b[n], rtol=0,
                                   atol=POS_TOL if n == "pos" else TOL,
                                   err_msg=f"contact.{n}")
    d = tcol._select_pairs
    dd = from_jax_data(dj)
    # recompute the selection inputs to show which envs overflowed
    sizes = dd.geom_size
    half = (plan["aabb_C"] * sizes[:, :, None, :]).sum(-1) + plan["aabb_base"]
    ew = (dd.geom_xmat.abs() * half[:, :, None, :]).sum(-1)
    cw = dd.geom_xpos + (dd.geom_xmat * plan["aabb_c"][:, None, :]).sum(-1)
    idx, valid = d(g, B, cw, ew, dd.geom_rbound, dd.body_active,
                   mt.pair_margin[g["sel"]])
    assert valid[0].all() and valid[2].all() and not valid[1].all()
    assert not torch.equal(idx[0], torch.arange(32))   # not candidate order
