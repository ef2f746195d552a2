"""Port parity of the renderer, the USD/OWL exporters and the CLI's
`render` (mujoco_sim_tpu_torch/{viz/render,export/usd,export/owl,
__main__}.py) against the JAX package, on the CPU in f64.

The renderer and exporters are verbatim copies (tests/test_torch_compile.py
holds their text); the port hands them the host view of env 0
(utils/struct.host_env).  Here both packages draw and export the same
compiled scene at the same forward state."""

import os
import pathlib
import re

import jax
import numpy as np
import pytest
import torch

from mujoco_sim_tpu import engine as jengine
from mujoco_sim_tpu.export import owl as jowl, usd as jusd
from mujoco_sim_tpu.models.compile import load_model as jax_load_model
from mujoco_sim_tpu.viz import render as jrender
from mujoco_sim_tpu_torch import engine
from mujoco_sim_tpu_torch.__main__ import main
from mujoco_sim_tpu_torch.export import owl as towl, usd as tusd
from mujoco_sim_tpu_torch.models.convert import from_jax_model
from mujoco_sim_tpu_torch.utils.struct import host_env
from mujoco_sim_tpu_torch.viz import render as trender
from tests.test_mesh_contacts import write_box_stl
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
# the mesh-cube scene of tests/test_render.py
CUBE_SCENE = """
<mujoco>
  <asset><mesh name="cube" file="cube.stl"/></asset>
  <worldbody>
    <geom type="plane" size="0 0 .05"/>
    <body pos="0 0 0.2"><freejoint/>
      <geom type="mesh" mesh="cube"/></body>
    <body pos="0.5 0 0.2"><freejoint/>
      <geom type="cylinder" size=".05 .08"/></body>
  </worldbody>
</mujoco>"""
# a small TBox: classes with and without a parent
TBOX = """<?xml version="1.0"?>
<rdf:RDF xmlns:rdf="http://www.w3.org/1999/02/22-rdf-syntax-ns#"
         xmlns:owl="http://www.w3.org/2002/07/owl#"
         xmlns:rdfs="http://www.w3.org/2000/01/rdf-schema#"
         xml:base="http://example.org/box_scenario">
  <owl:Ontology rdf:about="http://example.org/box_scenario"/>
  <owl:Class rdf:about="http://example.org/box_scenario#PhysicalObject"/>
  <owl:Class rdf:about="http://example.org/box_scenario#Box">
    <rdfs:subClassOf rdf:resource="http://example.org/box_scenario#Container"/>
  </owl:Class>
  <owl:Class rdf:about="http://example.org/box_scenario#Container">
    <rdfs:subClassOf rdf:resource="http://example.org/box_scenario#PhysicalObject"/>
  </owl:Class>
  <owl:Class rdf:about="http://example.org/box_scenario#Link"/>
</rdf:RDF>
"""
_NUM = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?")


@pytest.fixture(scope="module")
def cube_xml(tmp_path_factory):
    root = tmp_path_factory.mktemp("cube")
    write_box_stl(str(root / "cube.stl"))
    (root / "scene.xml").write_text(CUBE_SCENE)
    return str(root / "scene.xml")


def _both(path):
    """(JAX model, JAX forward state, port host view of the same model and
    state): one compile, f64 forward in each package."""
    mj = jax_load_model(path)
    dj = jax.jit(jengine.forward)(mj, jengine.make_data(mj))
    mt = engine.put_model(from_jax_model(mj), torch.float64, "cpu")
    dt = engine.forward(mt, engine.make_data(mt, 1))
    hm, hd = host_env(mt, dt)
    return mj, dj, hm, hd


def _same_text_or_numbers(a, b, atol=1e-9):
    if a == b:
        return
    assert _NUM.sub("#", a) == _NUM.sub("#", b)
    x = np.array([float(v) for v in _NUM.findall(a)])
    y = np.array([float(v) for v in _NUM.findall(b)])
    np.testing.assert_allclose(x, y, rtol=0, atol=atol)


def test_render_frame_draws_the_jax_polygons(cube_xml, tmp_path,
                                             monkeypatch):
    """A PNG over 10 KB; every polygon collection (the plane, the cube's
    raw surface, the cylinder's sides and caps) equals the JAX renderer's
    within 1e-9.  The compiler stores the cube's STL surface, so the
    cube is drawn as its 12 triangles (two per face)."""
    mj, dj, hm, hd = _both(cube_xml)
    drawn = {}
    for key, mod in (("jax", jrender), ("port", trender)):
        real = mod.Poly3DCollection
        drawn[key] = []

        def spy(faces, *a, _real=real, _out=drawn[key], **kw):
            _out.append([np.asarray(f, float) for f in faces])
            return _real(faces, *a, **kw)

        monkeypatch.setattr(mod, "Poly3DCollection", spy)
    jrender.render_frame(mj, dj, str(tmp_path / "jax.png"), rtf=1.0)
    out = trender.render_frame(hm, hd, str(tmp_path / "port.png"), rtf=1.0)
    assert os.path.exists(out) and os.path.getsize(out) > 10_000
    assert [len(c) for c in drawn["port"]] == [len(c) for c in
                                                 drawn["jax"]]
    cube = drawn["port"][1]
    assert len(cube) == 12 and all(f.shape == (3, 3) for f in cube)
    for cj, ct in zip(drawn["jax"], drawn["port"]):
        for fj, ft in zip(cj, ct):
            np.testing.assert_allclose(ft, fj, rtol=0, atol=1e-9)


@pytest.mark.parametrize("scene", ["cube", "arm.xml"])
def test_export_usd_writes_the_jax_stage(scene, cube_xml, tmp_path):
    path = cube_xml if scene == "cube" else str(FIXTURES / scene)
    mj, dj, hm, hd = _both(path)
    a = jusd.export_usd(mj, dj, str(tmp_path / "jax.usda"))
    b = tusd.export_usd(hm, hd, str(tmp_path / "port.usda"))
    with open(a) as fa, open(b) as fb:
        ja, tb = fa.read(), fb.read()
    _same_text_or_numbers(tb, ja)
    # one prim per geom, the bodies at env 0's poses
    assert len(re.findall(r"def (?:Cube|Sphere|Cylinder|Capsule|Plane|"
                          r"Mesh) ", tb)) == hm.ngeom
    for b_ in range(1, hm.nbody):
        x = ", ".join(str(float(v)) for v in hd.xpos[b_])
        assert f"double3 xformOp:translate = ({x})" in tb


def test_owl_round_trips_write_the_jax_files(cube_xml, tmp_path):
    mj, dj, hm, hd = _both(str(FIXTURES / "arm.xml"))
    usda = tusd.export_usd(hm, hd, str(tmp_path / "arm.usda"))
    tbox = tmp_path / "tbox.owl"
    tbox.write_text(TBOX)
    for key, mod in (("jax", jowl), ("port", towl)):
        d = tmp_path / key
        d.mkdir()
        abox = mod.usd_to_abox(usda, str(d / "arm_ABox.owl"))
        mod.update_joint_states(abox, {"link1": 0.42},
                                str(d / "arm_ABox_q.owl"))
        mod.tbox_to_usd(str(tbox), str(d / "tbox.usda"))
        mod.auto_sem_tag(abox, str(tbox), str(d / "tagged.owl"),
                         name_to_class={"link1": "Box"})
    for name in ("arm_ABox.owl", "arm_ABox_q.owl", "tbox.usda",
                 "tagged.owl"):
        assert ((tmp_path / "port" / name).read_text()
                == (tmp_path / "jax" / name).read_text()), name
    text = (tmp_path / "port" / "arm_ABox.owl").read_text()
    for b in hm.names.body[1:]:
        assert f"#{b}\"" in text, b
    assert "0.42" in (tmp_path / "port" / "arm_ABox_q.owl").read_text()
    assert 'class "Box"' in (tmp_path / "port" / "tbox.usda").read_text()


def test_cli_render_writes_a_png(cube_xml, tmp_path, capsys):
    out = str(tmp_path / "frame.png")
    assert main(["render", cube_xml, out, "--steps", "3",
                 "--device", "cpu"]) == 0
    assert os.path.getsize(out) > 10_000
    assert "rendered" in capsys.readouterr().out
