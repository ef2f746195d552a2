"""Port parity of the sensors (mujoco_sim_tpu_torch/ops/sensor.py) and of
the ray casts behind the rangefinder (ops/raycast.py) with the JAX package
(CPU, f64).

Every state compared is one the JAX package produced (its step run a few
times from a seeded start), so both packages' ``forward`` see the same
input.  Readings of positions and velocities agree to 1e-9 relative to the
reading's scale; readings that pass through the constraint solve (force,
torque, touch, accelerometer, joint-limit force) are held to 1e-6: the
Newton solver stops at its own tolerance (1e-8 on the cost) and the manip
scene's stiff contacts carry accelerations of 1e3 (measured: 1.6e-8 on a
wrist force of 3.4 N).  Scenes: the three force/torque
fixtures, the precise manip fixture (31 values), and a zoo scene written
here that holds every sensor type the slice ports, with contacts on a
touch pad of each site shape, a joint at its limit, frame sensors against
a moving reference frame, and cutoffs, and a second scene written here
with fixed tendons (one at its limit) and rangefinders over two
heightfields of different grid sizes.  One parametrised case per (scene,
sensor type).  The ray casts are compared per geom type.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_sim_tpu import engine as jengine
from mujoco_sim_tpu.models.compile import load_model as jax_load_model
from mujoco_sim_tpu.models.model import GeomType, SensorType
from mujoco_sim_tpu.ops import raycast as jraycast
from mujoco_sim_tpu.parallel import mesh as jmesh
from mujoco_sim_tpu_torch import engine
from mujoco_sim_tpu_torch.models.convert import from_jax_data, from_jax_model
from mujoco_sim_tpu_torch.ops import raycast
from tests import torch_threads

# The precise scene's FORCE, TORQUE and ACCELEROMETER cases sit on the
# elliptic solver's discontinuity (ROADMAP §C): one env may take either
# branch as sums round one way or the other.  So the module runs on the
# eight intra-op threads its cases were checked at (alone and in tier-1
# runs), whatever the host's core count.
eight_threads = torch_threads.pin_threads(8)

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
NENV = 3

ZOO = """
<mujoco>
  <compiler angle="radian"/>
  <option timestep="0.004" gravity="0 0 -9.81" magnetic="0.1 -0.4 0.3"/>
  <asset>
    <mesh name="wedge" vertex="-0.05 -0.05 -0.04  0.05 -0.05 -0.04
      -0.05 0.05 -0.04  0.05 0.05 -0.04  0 -0.05 0.05  0 0.05 0.05"/>
  </asset>
  <worldbody>
    <geom name="floor" type="plane" size="0 0 .05"/>
    <body name="arm" pos="0 0 0.6">
      <joint name="j1" type="hinge" axis="0 1 0" limited="true"
             range="-0.3 0.3" damping="0.05"/>
      <geom type="capsule" size=".03" fromto="0 0 0 .25 0 0"/>
      <site name="imu" pos="0.1 0 0.02" quat="0.92388 0 0.38268 0"/>
      <site name="eye" pos="0.2 0 -0.04" quat="0 1 0 0" size="0.005"/>
      <body name="fore" pos=".25 0 0">
        <joint name="jb" type="ball" damping="0.02"/>
        <geom type="capsule" size=".025" fromto="0 0 0 .2 0 0"/>
        <site name="wrist" pos="0.1 0 0" quat="0.7071 0.7071 0 0"/>
      </body>
    </body>
    <body name="box" pos="0.1 0.5 0.0795"><freejoint/>
      <geom name="boxg" type="box" size=".1 .1 .08" friction="0.7"/>
      <site name="pad_box" type="box" size=".12 .12 .1"/>
      <site name="pad_sphere" type="sphere" size=".2"/>
      <site name="pad_capsule" type="capsule" size=".15 .05"/>
      <site name="pad_cylinder" type="cylinder" size=".15 .1"/>
      <site name="pad_ellipsoid" type="ellipsoid" size=".3 .3 .15"/>
      <site name="pad_miss" type="box" size=".01 .01 .01" pos="0 0 0.05"/>
      <site name="ft_box" pos="0 0 0.02"/>
    </body>
    <body name="ball" pos="-0.4 0.3 0.0495"><freejoint/>
      <geom type="sphere" size=".05"/></body>
    <body name="cap" pos="-0.4 -0.3 0.2"><freejoint/>
      <geom type="capsule" size=".04 .08"/></body>
    <body name="cyl" pos="0.5 -0.4 0.3"><freejoint/>
      <geom type="cylinder" size=".05 .06"/></body>
    <body name="ell" pos="0.6 0.3 0.3"><freejoint/>
      <geom type="ellipsoid" size=".06 .04 .03"/></body>
    <body name="wedge" pos="0.2 0 0.2"><freejoint/>
      <geom type="mesh" mesh="wedge"/></body>
  </worldbody>
  <actuator>
    <motor name="m1" joint="j1" gear="3"/>
    <position name="p1" joint="j1" kp="5"/>
  </actuator>
  <sensor>
    <clock/>
    <jointpos joint="j1"/><jointvel joint="j1"/>
    <ballquat joint="jb"/><ballangvel joint="jb"/>
    <actuatorpos actuator="p1"/><actuatorvel actuator="p1"/>
    <actuatorfrc actuator="m1"/><actuatorfrc actuator="p1" cutoff="0.2"/>
    <jointlimitpos joint="j1"/><jointlimitvel joint="j1"/>
    <jointlimitfrc joint="j1"/>
    <magnetometer site="imu"/><gyro site="imu"/><velocimeter site="imu"/>
    <accelerometer site="imu"/><accelerometer site="wrist" cutoff="5"/>
    <force site="wrist"/><torque site="wrist"/>
    <force site="ft_box"/><torque site="ft_box"/>
    <touch site="pad_box"/><touch site="pad_sphere"/>
    <touch site="pad_capsule"/><touch site="pad_cylinder"/>
    <touch site="pad_ellipsoid"/><touch site="pad_miss"/>
    <touch site="pad_box" cutoff="3"/>
    <rangefinder site="eye"/><rangefinder site="eye" cutoff="0.1"/>
    <rangefinder site="imu"/>
    <framepos objtype="site" objname="wrist"/>
    <framepos objtype="body" objname="fore" reftype="site" refname="imu"/>
    <framequat objtype="geom" objname="boxg"/>
    <framequat objtype="xbody" objname="fore" reftype="body" refname="arm"/>
    <framexaxis objtype="site" objname="wrist"/>
    <frameyaxis objtype="body" objname="box" reftype="site" refname="imu"/>
    <framezaxis objtype="xbody" objname="fore"/>
    <framelinvel objtype="site" objname="wrist"/>
    <framelinvel objtype="body" objname="box" reftype="site" refname="wrist"/>
    <frameangvel objtype="xbody" objname="fore"/>
    <frameangvel objtype="site" objname="wrist" reftype="xbody"
                 refname="arm"/>
    <subtreecom body="arm"/><subtreelinvel body="arm"/>
    <subtreeangmom body="arm"/><subtreecom body="box"/>
  </sensor>
</mujoco>
"""

# a 9 x 9 bowl and a 3 x 4 ramp (tests/test_hfield.py's grids), a ball
# in the bowl, and a fixed-tendon arm above it with rangefinders
_BOWL = " ".join(f"{v:.6f}" for v in (
    (np.linspace(-1, 1, 9)[None, :] ** 2
     + np.linspace(-1, 1, 9)[:, None] ** 2) / 2.0).ravel())
TENDON_HF = f"""
<mujoco>
  <compiler angle="radian"/>
  <option timestep="0.004"/>
  <asset>
    <hfield name="bowl" nrow="9" ncol="9" size="1.5 1.5 0.4 0.1"
            elevation="{_BOWL}"/>
    <hfield name="ramp" nrow="3" ncol="4" size="0.6 0.5 0.3 0.1"
            elevation="{' '.join(str(v) for v in [0, 0.2, 0.5, 1.0] * 3)}"/>
  </asset>
  <worldbody>
    <geom name="bowl" type="hfield" hfield="bowl"/>
    <geom name="ramp" type="hfield" hfield="ramp" pos="2.5 0 0.1"
          euler="0 0 0.4"/>
    <body name="ball" pos="0.3 0.2 0.6"><freejoint/>
      <geom type="sphere" size="0.08"/></body>
    <body pos="-0.5 0 1.0">
      <joint name="j1" type="hinge" axis="0 1 0" damping="0.1"/>
      <geom type="capsule" size="0.03" fromto="0 0 0 0.3 0 0" mass="1"/>
      <site name="eye1" pos="0.2 0 0" quat="0 1 0 0"/>
      <body pos="0.3 0 0">
        <joint name="j2" type="hinge" axis="0 1 0" damping="0.05"/>
        <geom type="capsule" size="0.02" fromto="0 0 0 0.25 0 0"
              mass="0.4"/>
        <site name="eye2" pos="0.25 0 0" quat="0 1 0 0"/>
        <body pos="0.25 0 0">
          <joint name="j3" type="slide" axis="1 0 0" damping="0.2"/>
          <geom type="sphere" size="0.03" mass="0.2"/>
        </body>
      </body>
    </body>
    <site name="eye_ramp" pos="2.45 0.1 1" quat="0 1 0 0"/>
  </worldbody>
  <tendon>
    <fixed name="t1" stiffness="25" damping="1.5" springlength="0.05">
      <joint joint="j1" coef="1.0"/><joint joint="j2" coef="-0.7"/>
    </fixed>
    <fixed name="t2" limited="true" range="-0.15 0" solreflimit="0.01 1">
      <joint joint="j2" coef="0.5"/><joint joint="j3" coef="2.0"/>
    </fixed>
  </tendon>
  <actuator><general name="at" tendon="t1" gear="1.7" gainprm="3.0"/>
  </actuator>
  <sensor>
    <tendonpos tendon="t1"/><tendonpos tendon="t2"/>
    <tendonvel tendon="t1"/><tendonvel tendon="t2"/>
    <tendonlimitpos tendon="t2"/><tendonlimitvel tendon="t2"/>
    <tendonlimitfrc tendon="t2"/><actuatorfrc actuator="at"/>
    <rangefinder site="eye1"/><rangefinder site="eye2"/>
    <rangefinder site="eye_ramp"/>
  </sensor>
</mujoco>
"""

S = SensorType
# (scene, sensor type) cases; the scene's sensors are listed here so the
# parametrisation needs no model at import time
SCENE_TYPES = {
    "ft_arm.xml": [S.FORCE, S.TORQUE],
    "ft_contact.xml": [S.FORCE, S.TORQUE],
    "force_sensor_srv.xml": [S.FORCE, S.TORQUE, S.CLOCK],
    "manip_bin6_precise.xml": [
        S.JOINTPOS, S.JOINTVEL, S.ACTUATORFRC, S.FORCE, S.TORQUE, S.TOUCH,
        S.ACCELEROMETER, S.GYRO, S.FRAMEPOS, S.FRAMEQUAT, S.RANGEFINDER,
        S.SUBTREECOM],
    "zoo": [
        S.CLOCK, S.JOINTPOS, S.JOINTVEL, S.BALLQUAT, S.BALLANGVEL,
        S.ACTUATORPOS, S.ACTUATORVEL, S.ACTUATORFRC, S.JOINTLIMITPOS,
        S.JOINTLIMITVEL, S.JOINTLIMITFRC, S.MAGNETOMETER, S.GYRO,
        S.VELOCIMETER, S.ACCELEROMETER, S.FORCE, S.TORQUE, S.TOUCH,
        S.RANGEFINDER, S.FRAMEPOS, S.FRAMEQUAT, S.FRAMEXAXIS, S.FRAMEYAXIS,
        S.FRAMEZAXIS, S.FRAMELINVEL, S.FRAMEANGVEL, S.SUBTREECOM,
        S.SUBTREELINVEL, S.SUBTREEANGMOM],
    "tendon_hf": [
        S.TENDONPOS, S.TENDONVEL, S.TENDONLIMITPOS, S.TENDONLIMITVEL,
        S.TENDONLIMITFRC, S.ACTUATORFRC, S.RANGEFINDER],
}
SOLVED = {S.FORCE, S.TORQUE, S.TOUCH, S.ACCELEROMETER, S.JOINTLIMITFRC,
          S.TENDONLIMITFRC}
INLINE = {"zoo": ZOO, "tendon_hf": TENDON_HF}
CASES = [(scene, t) for scene, types in SCENE_TYPES.items() for t in types]
_CACHE = {}


def _scene(name, tmp_path_factory):
    """Per scene, once: models, the JAX package's state after a few stirred
    steps, and both packages' forward() of that state."""
    if name in _CACHE:
        return _CACHE[name]
    if name in INLINE:
        path = tmp_path_factory.mktemp(name) / f"{name}.xml"
        path.write_text(INLINE[name])
    else:
        path = FIXTURES / name
    mj = jax_load_model(str(path))
    mt = engine.put_model(from_jax_model(mj), torch.float64, "cpu")
    rng = np.random.default_rng(0)
    dj = jmesh.make_batch(mj, NENV, dtype=jnp.float64)
    dj = dj.replace(qvel=jnp.asarray(rng.uniform(-0.3, 0.3, (NENV, mj.nv))))
    if mj.nu:
        dj = dj.replace(ctrl=jnp.asarray(rng.uniform(-1, 1, (NENV, mj.nu))))
    step = jax.jit(jmesh.batched_step)
    for _ in range(25 if name == "zoo" else 8):
        dj = step(mj, dj)
    ref = jax.jit(jax.vmap(jengine.forward, in_axes=(None, 0)))(mj, dj)
    out = engine.forward(mt, from_jax_data(dj))
    _CACHE[name] = (mj, mt, dj, ref, out)
    return _CACHE[name]


@pytest.mark.parametrize("scene,stype", CASES,
                         ids=[f"{s.split('.')[0]}-{t.name}" for s, t in CASES])
def test_sensor_type_matches_jax(scene, stype, tmp_path_factory):
    mj, mt, _, ref, out = _scene(scene, tmp_path_factory)
    lay = mj.layout
    rows = [k for k in range(mj.nsensor)
            if int(lay.sensor_type[k]) == int(stype)]
    assert rows, f"{scene} has no {stype.name} sensor"
    assert sorted({int(t) for t in lay.sensor_type}) == sorted(
        int(t) for t in SCENE_TYPES[scene])
    assert out.sensordata.shape == (NENV, mj.nsensordata)
    for k in rows:
        adr, dim = int(lay.sensor_adr[k]), int(lay.sensor_dim[k])
        r = np.asarray(ref.sensordata)[:, adr:adr + dim]
        o = out.sensordata.numpy()[:, adr:adr + dim]
        scale = max(1.0, float(np.abs(r).max()))
        tol = 1e-6 if stype in SOLVED else 1e-9
        np.testing.assert_allclose(o, r, rtol=0, atol=tol * scale,
                                   err_msg=f"sensor {k}")


def test_zoo_readings_are_not_trivial(tmp_path_factory):
    """The zoo state exercises what it is meant to: contacts on the pads
    (and none on the pad that misses), the joint at its limit, a ray that
    hits and one that is cut off."""
    mj, _, _, ref, _ = _scene("zoo", tmp_path_factory)
    lay = mj.layout
    sd = np.asarray(ref.sensordata)

    def of(stype):
        return [sd[:, int(lay.sensor_adr[k]):int(lay.sensor_adr[k])
                   + int(lay.sensor_dim[k])]
                for k in range(mj.nsensor)
                if int(lay.sensor_type[k]) == int(stype)]
    touch = of(S.TOUCH)
    assert all((t > 0).all() for t in touch[:5]) and (touch[5] == 0).all()
    assert (touch[6] <= 3.0).all()
    assert (np.abs(of(S.JOINTLIMITFRC)[0]) > 0).any()
    rf = of(S.RANGEFINDER)
    assert (rf[0] > 0).all() and (rf[1] <= 0.1).all()
    assert (np.abs(of(S.FORCE)[0]) > 0.1).any()       # the wrist's load


def test_tendon_sensors_match_jax(tmp_path_factory):
    """Every tendon sensor of the tendon scene, with the limited tendon
    at its limit in some env, where the limit sensors read the efc row."""
    mj, _, _, ref, out = _scene("tendon_hf", tmp_path_factory)
    lay = mj.layout
    types = {int(t) for t in (S.TENDONPOS, S.TENDONVEL, S.TENDONLIMITPOS,
                              S.TENDONLIMITVEL, S.TENDONLIMITFRC)}
    cols = [int(lay.sensor_adr[k]) for k in range(mj.nsensor)
            if int(lay.sensor_type[k]) in types]
    assert len(cols) == 7
    np.testing.assert_allclose(out.sensordata.numpy()[:, cols],
                               np.asarray(ref.sensordata)[:, cols], rtol=0,
                               atol=1e-6)
    lim = int(lay.sensor_adr[list(lay.sensor_type).index(
        int(S.TENDONLIMITPOS))])
    assert (np.asarray(ref.sensordata)[:, lim] < 0).any()


GEOMS = [GeomType.PLANE, GeomType.SPHERE, GeomType.CAPSULE,
         GeomType.CYLINDER, GeomType.ELLIPSOID, GeomType.BOX, GeomType.MESH,
         GeomType.HFIELD]


@pytest.mark.parametrize("gtype", GEOMS, ids=[g.name for g in GEOMS])
def test_ray_all_matches_jax_per_geom_type(gtype, tmp_path_factory):
    """Seeded rays from above and from the side against the geoms of one
    type only (the static mask selects them); heightfields in the tendon
    scene, every other type in the zoo."""
    scene = "tendon_hf" if gtype == GeomType.HFIELD else "zoo"
    mj, mt, _, ref, out = _scene(scene, tmp_path_factory)
    rng = np.random.default_rng(int(gtype))
    R = 40
    sel = np.asarray(mj.layout.geom_type) == int(gtype)
    assert sel.any()
    # ray r aims near the centre of the (r mod n)-th geom of the type
    centres = np.asarray(ref.geom_xpos)[:, sel]                 # (B, n, 3)
    target = centres[:, np.arange(R) % centres.shape[1]]        # (B, R, 3)
    pnt = target + rng.uniform(-0.4, 0.4, (NENV, R, 3))
    pnt[..., 2] = np.abs(pnt[..., 2]) + 0.05
    vec = target - pnt + rng.uniform(-0.03, 0.03, (NENV, R, 3))
    vec[:, ::7] = [0.0, 0.0, -1.0]                # axis-parallel rays
    vec /= np.linalg.norm(vec, axis=-1, keepdims=True)
    mask = np.broadcast_to(sel, (R, len(sel))).copy()
    want = jax.vmap(lambda d, p, v: jraycast.ray_all(mj, d, p, v, mask))(
        ref, jnp.asarray(pnt), jnp.asarray(vec))
    got = raycast.ray_all(mt, out, torch.tensor(pnt), torch.tensor(vec),
                          mask, key=f"test_{gtype.name}")
    want = np.asarray(want)
    assert (want < raycast.INF / 2).sum() >= 10, "too few rays hit"
    assert (want > raycast.INF / 2).any() or gtype == GeomType.PLANE
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def test_hfield_rays_match_jax():
    """The heightfield sweep alone, against the JAX package's: seeded
    local rays over two padded grids (9 x 9 and 3 x 4), several rays an
    env so the sweep runs more than one chunk."""
    rng = np.random.default_rng(9)
    nrow, ncol = np.array([9, 3]), np.array([9, 4])
    data = np.zeros((2, 9, 9))
    data[0] = rng.uniform(0, 1, (9, 9))
    data[1, :3, :4] = rng.uniform(0, 1, (3, 4))
    size = np.array([[1.5, 1.5, 0.4, 0.1], [0.6, 0.5, 0.3, 0.1]])
    B, R = 3, 5
    p = rng.uniform(-1.0, 1.0, (B, R, 2, 3))
    p[..., 2] = rng.uniform(0.5, 1.0, (B, R, 2))
    v = rng.normal(size=(B, R, 2, 3))
    v[..., 2] = -np.abs(v[..., 2]) - 0.5
    v[:, 0] = [0.0, 0.0, -1.0]
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    want = np.stack([np.asarray(jraycast._hfield(
        jnp.asarray(p[b]), jnp.asarray(v[b]), jnp.asarray(data), nrow, ncol,
        jnp.asarray(size))) for b in range(B)])
    tab = {k: torch.tensor(x) for k, x in
           raycast.hfield_tables_np(nrow, ncol, 9, 9).items()}
    got = raycast._hfield(torch.tensor(p), torch.tensor(v),
                          torch.tensor(data), torch.tensor(size), tab)
    assert (want < raycast.INF / 2).sum() >= 10
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
