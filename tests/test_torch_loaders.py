"""The port's scene loaders and the tools that read them
(embree_tpu_torch/render/{xmlloader,plyloader,coronaloader}.py,
render/tutorials/{convert,viewer,viewer_stream}.py, the table converters
of convert.py) against the JAX package's.

`load_xml`, `load_ply` (ascii and binary) and `load_corona` give
byte-equal arrays, the same materials, lights and camera on the fixtures
of tests/test_xml.py, test_corona.py and on glass_sphere.xml; `write_xml`
and the `convert` tool write byte-equal files
(tests/test_convert_viewers.py:35-73); `light_table_from_xml` and the
converters give equal tables; the viewer's frame of the XML fixture
equals the JAX viewer's, the viewer opens `.ply` and `.scn` scenes, and
`viewer_stream` equals the port's viewer."""
import os
import struct
import textwrap

import numpy as np
import pytest
import torch

import embree_tpu_torch as ett
from embree_tpu.render import coronaloader as jcorona
from embree_tpu.render import lights as jlights
from embree_tpu.render import materials as jmat
from embree_tpu.render import plyloader as jply
from embree_tpu.render import xmlloader as jxml
from embree_tpu.render.camera import Camera as JCamera
from embree_tpu.render.tutorials import convert as jconvert
from embree_tpu.render.tutorials import pathtracer as jpt
from embree_tpu.render.tutorials import viewer as jviewer
from embree_tpu_torch.convert import (light_table_from_reference,
                                      material_table_from_reference)
from embree_tpu_torch.render import coronaloader as tcorona
from embree_tpu_torch.render import lights as tlights
from embree_tpu_torch.render import materials as tmat
from embree_tpu_torch.render import plyloader as tply
from embree_tpu_torch.render import xmlloader as txml
from embree_tpu_torch.render.camera import Camera
from embree_tpu_torch.render.tutorials import convert as tconvert
from embree_tpu_torch.render.tutorials import pathtracer as tpt
from embree_tpu_torch.render.tutorials import viewer, viewer_stream
from test_torch_viewer import same

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
GLASS = os.path.join(GOLDEN, "glass_sphere.xml")

# tests/test_xml.py's scene, with a quad, a triangle and a directional
# light and an OBJ extern added so that every light kind and node reaches
# the tables
XML = """<?xml version="1.0"?>
<scene>
  <PerspectiveCamera from="0,0,-3" to="0,0,0" up="0,1,0" fov="45"/>
  <PointLight>
    <AffineSpace translate="1 2 3"/>
    <I>10 10 10</I>
  </PointLight>
  <AmbientLight><L>0.1 0.1 0.1</L></AmbientLight>
  <DirectionalLight><AffineSpace rotate_x="30"/><E>1 2 3</E></DirectionalLight>
  <QuadLight><AffineSpace>1 0 0 -0.5  0 0 1 3  0 1 0 -0.5</AffineSpace>
    <L>5 6 7</L></QuadLight>
  <TriangleLight><AffineSpace translate="0 4 0"/><L>1 1 1</L></TriangleLight>
  <Transform>
    <AffineSpace translate="0 0 2"/>
    <TriangleMesh>
      <material id="red">
        <code>"Matte"</code>
        <parameters><float3 name="reflectance">1 0 0</float3></parameters>
      </material>
      <positions>-1 -1 0  1 -1 0  0 1 0</positions>
      <triangles>0 1 2</triangles>
    </TriangleMesh>
  </Transform>
  <QuadMesh>
    <material><code>"OBJ"</code>
      <parameters><float3 name="Kd">0 1 0</float3></parameters></material>
    <positions>0 0 5  1 0 5  1 1 5  0 1 5</positions>
    <indices>0 1 2 3</indices>
  </QuadMesh>
  <SubdivisionMesh>
    <material id="red"><code>"Matte"</code><parameters/></material>
    <positions>0 0 0  1 0 0  1 1 0  0 1 0</positions>
    <faces>4</faces>
    <position_indices>0 1 2 3</position_indices>
    <edge_creases>0 1</edge_creases>
    <edge_crease_weights>2.5</edge_crease_weights>
  </SubdivisionMesh>
  <Transform>
    <AffineSpace translate="2.5 0 1"/>
    <Transform>
      <AffineSpace scale="0.5 0.5 0.5"/>
      <obj src="cube.obj"/>
    </Transform>
  </Transform>
</scene>
"""

CUBE_OBJ = textwrap.dedent("""\
    v -1 -1 -1
    v 1 -1 -1
    v 1 1 -1
    v -1 1 -1
    v -1 -1 1
    v 1 -1 1
    v 1 1 1
    v -1 1 1
    f 1 2 3 4
    f 5 8 7 6
    f 1 5 6 2
    f 2 6 7 3
    f 3 7 8 4
    f 5 1 4 8
    """)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The fixtures of tests/test_xml.py, test_corona.py and
    test_convert_viewers.py written once."""
    d = tmp_path_factory.mktemp("loaders")
    (d / "cube.obj").write_text(CUBE_OBJ)
    (d / "scene.xml").write_text(XML)
    (d / "a.ply").write_text(
        "ply\nformat ascii 1.0\nelement vertex 4\n"
        "property float x\nproperty float y\nproperty float z\n"
        "element face 2\nproperty list uchar int vertex_indices\n"
        "end_header\n0 0 0\n1 0 0\n1 1 0\n0 1 0\n3 0 1 2\n4 0 1 2 3\n")
    with open(d / "b.ply", "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n"
                b"element vertex 3\nproperty float x\nproperty float y\n"
                b"property float z\nproperty uchar red\n"
                b"element face 1\nproperty list uchar int vertex_indices\n"
                b"end_header\n")
        for v in [(0, 0, 0), (1, 0, 0), (0, 1, 0)]:
            f.write(struct.pack("<fffB", *v, 255))
        f.write(struct.pack("<Biii", 3, 0, 1, 2))
    (d / "tri.obj").write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    (d / "mats.mtl.xml").write_text(textwrap.dedent("""\
        <mtlLib>
          <materialDefinition name="red">
            <material class="Native"><diffuse>1 0 0</diffuse></material>
          </materialDefinition>
          <materialDefinition name="chrome">
            <material class="Native">
              <reflect><color>0.9 0.9 0.9</color></reflect>
            </material>
          </materialDefinition>
        </mtlLib>
        """))
    (d / "scene.scn").write_text(textwrap.dedent("""\
        <scene>
          <conffile>render.conf</conffile>
          <mtllib>mats.mtl.xml</mtllib>
          <camera>ignored</camera>
          <geometryGroup>
            <instance>
              <material class="Reference">red</material>
              <transform>1 0 0 0  0 1 0 0  0 0 1 0</transform>
              <transform>1 0 0 5  0 1 0 0  0 0 1 0</transform>
            </instance>
            <object class="file">tri.obj</object>
          </geometryGroup>
          <geometryGroup>
            <instance>
              <material class="Reference">chrome</material>
              <transform>2 0 0 0  0 2 0 0  0 0 2 1</transform>
            </instance>
            <object class="file">a.ply</object>
          </geometryGroup>
        </scene>
        """))
    return d


GEOM_FIELDS = ("vertices", "indices", "face_counts", "face_indices",
               "edge_creases", "edge_crease_weights", "vertex_creases",
               "vertex_crease_weights", "texcoords")


def same_geometry(a, b, what):
    assert type(a).__name__ == type(b).__name__, what
    for k in GEOM_FIELDS:
        if hasattr(a, k):
            x, y = getattr(a, k), getattr(b, k)
            if x is None:
                assert y is None, f"{what}.{k}"
            else:
                same(np.asarray(x), np.asarray(y), f"{what}.{k}")


def same_scene(a, b, what):
    assert len(a.geometries) == len(b.geometries), what
    for i, ((ga, ma), (gb, mb)) in enumerate(zip(a.geometries,
                                                 b.geometries)):
        assert ma == mb, f"{what} material of {i}"
        same_geometry(ga, gb, f"{what} geometry {i}")
    same(a.materials, b.materials, f"{what} materials")
    same(a.lights, b.lights, f"{what} lights")
    same(a.camera, b.camera, f"{what} camera")


def test_loaders_are_byte_equal(files):
    """load_xml (every node kind of the fixture, transforms, ids, an OBJ
    extern; glass_sphere.xml), load_ply ascii and binary, load_corona."""
    for path in (files / "scene.xml", GLASS):
        same_scene(jxml.load_xml(str(path)), txml.load_xml(str(path)),
                   str(path))
    sc = txml.load_xml(str(files / "scene.xml"))
    assert [type(g).__name__ for g, _ in sc.geometries] == [
        "TriangleMesh", "QuadMesh", "SubdivMesh", "TriangleMesh"]
    assert {l["type"] for l in sc.lights} == {
        "point", "ambient", "directional", "quad", "triangle"}
    for name in ("a.ply", "b.ply"):
        same_geometry(jply.load_ply(str(files / name)),
                      tply.load_ply(str(files / name)), name)
    assert tply.load_ply(str(files / "a.ply")).indices.shape == (3, 3)
    scn = str(files / "scene.scn")
    same_scene(jcorona.load_corona(scn), tcorona.load_corona(scn), scn)
    assert len(tcorona.load_corona(scn).geometries) == 3


def test_write_xml_and_convert_are_byte_equal(files, tmp_path):
    """write_xml of each loaded scene, and the convert tool's output for
    every flag (tests/test_convert_viewers.py:35-73, test_corona.py's
    convert), byte for byte the JAX package's."""
    for path in (files / "scene.xml", GLASS):
        a, b = tmp_path / "j.xml", tmp_path / "t.xml"
        jxml.write_xml(str(a), jxml.load_xml(str(path)))
        txml.write_xml(str(b), txml.load_xml(str(path)))
        assert a.read_bytes() == b.read_bytes(), path
    cube, scn = str(files / "cube.obj"), str(files / "scene.scn")
    runs = [["-i", cube],
            ["-i", cube, "-convert-triangles-to-quads"],
            ["-i", cube, "-convert-to-subdivs", "-centerScaleTranslate",
             "2", "1", "0", "0"],
            ["-i", scn],
            ["-i", str(files / "scene.xml"), "-i", str(files / "a.ply"),
             "-convert-triangles-to-quads", "-convert-to-subdivs"]]
    for k, args in enumerate(runs):
        a, b = tmp_path / f"j{k}.xml", tmp_path / f"t{k}.xml"
        assert jconvert.main(args + ["-o", str(a)]) == 0
        assert tconvert.main(args + ["-o", str(b)]) == 0
        assert a.read_bytes() == b.read_bytes(), args
    q = txml.load_xml(str(tmp_path / "t1.xml"))
    assert q.geometries[0][0].indices.shape == (6, 4)
    assert tconvert.main(["-i", cube]) == 1


def test_light_and_material_tables(files):
    """light_table_from_xml against the JAX package's, and the converters
    from the JAX package's tables against the port's own, on the XML
    fixture, glass_sphere.xml and the Cornell box."""
    for path in (files / "scene.xml", GLASS):
        jx, tx = jxml.load_xml(str(path)), txml.load_xml(str(path))
        jl = jxml.light_table_from_xml(jx)
        tl = txml.light_table_from_xml(tx, device="cpu")
        assert tl.type == jl.type
        arrays = {k: np.asarray(getattr(jl, k)) for k in (
            "pos", "e1", "e2", "radiance", "angles", "ambient")}
        for k, a in arrays.items():
            assert getattr(tl, k).numpy().tobytes() == a.tobytes(), k
        conv = light_table_from_reference(dict(arrays, type=jl.type), "cpu")
        assert conv.type == tl.type
        for k in arrays:
            assert torch.equal(getattr(conv, k), getattr(tl, k)), k
        jm = jmat.make_material_table(jx.materials)
        conv = material_table_from_reference(
            {k: np.asarray(v) for k, v in jm._asdict().items()}, "cpu")
        for k, a, b in zip(conv._fields, conv,
                           tmat.make_material_table(tx.materials,
                                                    device="cpu")):
            assert a.dtype == b.dtype and torch.equal(a, b), k
    # the triangle light is loaded and, as in the JAX package, left out
    # of the table (ROADMAP.md C.2)
    assert tlights.num_lights(txml.light_table_from_xml(
        txml.load_xml(str(files / "scene.xml")), device="cpu")) == 3
    js = jpt.build_cornell_scene()
    ts = tpt.build_cornell_scene(ett.Device("ignore_config_files=1",
                                            device="cpu"))
    lt = light_table_from_reference(
        {k: np.asarray(getattr(js["lights"], k)) for k in (
            "type", "pos", "e1", "e2", "radiance", "angles", "ambient")},
        "cpu")
    assert lt.type == ts["lights"].type == (jlights.LIGHT_QUAD,)
    assert torch.equal(lt.pos, ts["lights"].pos)
    mt = material_table_from_reference(
        {k: np.asarray(v) for k, v in js["materials"]._asdict().items()},
        "cpu")
    for a, b in zip(mt, ts["materials"]):
        assert torch.equal(a, b)
    assert ts["geom_mat"].tolist() == np.asarray(js["geom_mat"]).tolist()


def test_viewer_opens_xml_ply_and_scn(files):
    """The viewer's frame of the XML fixture against the JAX viewer's (32
    x 32, every pixel within 2/255 but 1 %; the red triangle fills the
    centre); `.ply` and `.scn` scenes open and render; `viewer_stream`'s
    frame of the cube OBJ equals the viewer's."""
    cam = dict(from_=(0, 0, -3), to=(0, 0, 0))
    xml = str(files / "scene.xml")
    st = viewer.build_scene(xml, rtcore="device=cpu")
    img, n = viewer.render_frame(st, Camera(**cam), (32, 32))
    ref, _ = jviewer.render_frame(jviewer.build_scene(xml), JCamera(**cam),
                                  (32, 32))
    ref = np.asarray(ref)
    assert n == 32 * 32 and img.shape == ref.shape == (32, 32, 3)
    bad = float((np.abs(img.numpy() - ref).max(-1) > 2 / 255).mean())
    assert bad <= 0.01, f"{bad:.4%} of the pixels differ"
    assert img[16, 16, 0] > 0.1 and img[16, 16, 1] == 0.0
    for name, cam, size in (
            ("a.ply", dict(from_=(0.5, 0.5, -2), to=(0.5, 0.5, 0)), (24, 16)),
            ("scene.scn", dict(from_=(2, 1, -5), to=(2, 0.3, 0)), (32, 24))):
        st = viewer.build_scene(str(files / name), rtcore="device=cpu")
        img, _ = viewer.render_frame(st, Camera(**cam), size)
        assert torch.isfinite(img).all() and float(img.max()) > 0.1, name
    st = viewer.build_scene(str(files / "cube.obj"), rtcore="device=cpu")
    cam = Camera(from_=(3, 3, -5), to=(0, 0, 0))
    a, _ = viewer.render_frame(st, cam, (64, 48))
    b, nb = viewer_stream.render_frame(st, cam, (64, 48))
    assert nb == 64 * 48 and float(a.max()) > 0.1
    np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-5)
