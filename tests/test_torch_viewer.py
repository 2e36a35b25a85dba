"""The port's `viewer` tutorial (the paper's bomberman demo) and what it
reads: the OBJ/MTL loader (byte-equal to the JAX package's), textures and
the material table (against the JAX package's), the viewer's frame
against the JAX package's on a small cube, the bomberman frame against
the reference binaries' render, and the command line."""
import os

import numpy as np
import pytest
import torch

from embree_tpu.render import materials as jmat
from embree_tpu.render import objloader as jobj
from embree_tpu.render import texture as jtex
from embree_tpu.render.camera import Camera as JCamera
from embree_tpu.render.tutorials import viewer as jviewer
from embree_tpu_torch.render import materials as tmat
from embree_tpu_torch.render import objloader as tobj
from embree_tpu_torch.render import texture as ttex
from embree_tpu_torch.render.camera import Camera
from embree_tpu_torch.render.image import read_pfm, read_ppm, write_png
from embree_tpu_torch.render.tutorials import viewer

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
BOMBERMAN = os.path.join(GOLDEN, "bomberman.obj")
CUBE_OBJ = "".join(
    f"v {x} {y} {z}\n" for x, y, z in
    [(-1, -1, -1), (1, -1, -1), (1, -1, 1), (-1, -1, 1), (-1, 1, -1),
     (1, 1, -1), (1, 1, 1), (-1, 1, 1)]) + "".join(
    "f " + " ".join(str(i + 1) for i in q) + "\n" for q in
    [(0, 4, 5, 1), (1, 5, 6, 2), (2, 6, 7, 3), (0, 3, 7, 4), (4, 7, 6, 5),
     (0, 1, 2, 3)])


def _quant(img):
    """The reference's float -> RGBA8 -> float pipeline."""
    return np.floor(255.0 * np.clip(np.asarray(img), 0.0, 1.0)) / 255.0


def textured_quad(tmp_path):
    """tests/test_texture.py's OBJ + MTL + PNG: a quad whose map_Kd is
    red on the left half and green on the right, with map_d and
    map_Displ images and the scalar keys."""
    tex = np.zeros((4, 4, 3), np.float32)
    tex[:, :2] = (1.0, 0.0, 0.0)
    tex[:, 2:] = (0.0, 1.0, 0.0)
    write_png(str(tmp_path / "checker.png"), tex)
    (tmp_path / "q.mtl").write_text(
        "newmtl c\nKd 1 1 1\nKs 0.5 0.4 0.3\nNs 20\nd 0.8\nNi 1.4\n"
        "Ke 0 0 0.1\nmap_Kd checker.png\nmap_d checker.png\n"
        "map_Displ checker.png\nnewmtl other\nKd 0.2 0.3 0.4\n")
    (tmp_path / "q.obj").write_text(
        "mtllib q.mtl\nusemtl c\n"
        "v -1 -1 0\nv 1 -1 0\nv 1 1 0\nv -1 1 0\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
        "f 1/1 2/2 3/3 4/4\nusemtl other\n"
        "v 1.2 -1 0\nv 2 -1 0\nv 2 1 0\nf -3 -2 -1\n")
    return str(tmp_path / "q.obj")


def same(a, b, what):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            same(a[k], b[k], f"{what}[{k}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), what
        for k, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{what}[{k}]")
    elif isinstance(a, np.ndarray):
        assert (a.dtype == b.dtype and a.shape == b.shape
                and a.tobytes() == b.tobytes()), what
    else:
        assert type(a) is type(b) and a == b, what


@pytest.fixture(scope="module")
def cube_obj(tmp_path_factory):
    path = tmp_path_factory.mktemp("viewer") / "cube.obj"
    path.write_text(CUBE_OBJ)
    return str(path)


@pytest.fixture(scope="module")
def cube_leaf(cube_obj):
    """The six-quad cube OBJ committed once in leaf mode at levels (3, 2)."""
    return viewer.build_scene(cube_obj, "bvh4.compressed.leaf", 3, 2,
                              rtcore="device=cpu")


@pytest.fixture(scope="module")
def bomberman():
    """The paper's demo configuration committed once: bomberman.obj as a
    SubdivMesh in bvh4.compressed.leaf at levels (6, 3)."""
    return viewer.build_scene(BOMBERMAN, "bvh4.compressed.leaf", 6, 3,
                              rtcore="device=cpu")


def test_loaders_are_byte_equal(tmp_path):
    """load_obj (triangles and subdiv mode) and load_mtl give the same
    geometries, arrays and material dicts as the JAX package's."""
    for path in (BOMBERMAN, textured_quad(tmp_path)):
        for subdiv_mode in (False, True):
            ga, ma = jobj.load_obj(path, subdiv_mode=subdiv_mode)
            gb, mb = tobj.load_obj(path, subdiv_mode=subdiv_mode)
            same(ma, mb, "materials")
            assert len(ga) == len(gb)
            for (a, ia), (b, ib) in zip(ga, gb):
                assert ia == ib and type(a).__name__ == type(b).__name__
                for k in ("vertices", "indices", "texcoords", "face_counts",
                          "face_indices"):
                    if hasattr(a, k):
                        same(getattr(a, k), getattr(b, k), k)
    same(jobj.load_mtl(str(tmp_path / "q.mtl")),
         tobj.load_mtl(str(tmp_path / "q.mtl")), "load_mtl")
    g, _ = tobj.load_obj(BOMBERMAN, subdiv_mode=True)
    assert len(g) == 1 and g[0][0].num_prims == 727
    assert g[0][0].vertices.shape == (742, 3)


def test_textures_and_materials_match_the_jax_package(tmp_path):
    """make_texture_set (padded stack), sample_texture (bilinear and
    nearest, repeat wrap, u and v outside [0, 1]), sample_bilinear and
    make_material_table against the JAX package's on seeded inputs."""
    rng = np.random.default_rng(0x7E7)
    images = [rng.random((3, 5, 3)).astype(np.float32),
              rng.random((6, 2, 3)).astype(np.float32),
              np.full((1, 1, 3), 0.5, np.float32)]
    ja, ta = jtex.make_texture_set(images), ttex.make_texture_set(
        images, device="cpu")
    np.testing.assert_array_equal(ta.data.numpy(), np.asarray(ja.data))
    np.testing.assert_array_equal(ta.size.numpy(), np.asarray(ja.size))
    n = 500
    tid = rng.integers(0, 3, n).astype(np.int32)
    u = rng.uniform(-2, 3, n).astype(np.float32)
    v = rng.uniform(-2, 3, n).astype(np.float32)
    for bil in (True, False):
        want = np.asarray(jtex.sample_texture(ja, tid, u, v, bilinear=bil))
        got = ttex.sample_texture(ta, torch.from_numpy(tid),
                                  torch.from_numpy(u), torch.from_numpy(v),
                                  bilinear=bil).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6)
    one = images[0]
    np.testing.assert_allclose(
        ttex.sample_bilinear(torch.from_numpy(one), torch.from_numpy(u),
                             torch.from_numpy(v)).numpy(),
        np.asarray(jtex.sample_bilinear(one, u, v)), atol=1e-6)
    np.testing.assert_allclose(
        ttex.sample_bilinear(torch.from_numpy(one[..., 0]),
                             torch.from_numpy(u), torch.from_numpy(v)).numpy(),
        np.asarray(jtex.sample_bilinear(one[..., 0], u, v)), atol=1e-6)
    # an empty set is one white texel
    assert ttex.make_texture_set([], device="cpu").data.tolist() == \
        [[[[1.0, 1.0, 1.0]]]]
    _, mats = tobj.load_obj(textured_quad(tmp_path))
    mats = mats + [{"type": tmat.MAT_METAL, "roughness": 0.3, "k": 2.0,
                    "transmission": (0.9, 0.8, 0.7), "eta_outside": 1.2}]
    for a, b in zip(jmat.make_material_table(mats),
                    tmat.make_material_table(mats, device="cpu")):
        same(np.asarray(a), b.numpy(), "material table")
    assert tmat.make_material_table([], device="cpu").kd.shape == (1, 3)


def test_viewer_matches_the_jax_package(tmp_path, cube_obj, cube_leaf):
    """The viewer's frame against the JAX package's: a six-quad cube OBJ
    as a subdivision surface in leaf mode at levels (3, 2), and the
    textured quad as triangles, at 32x24; every pixel within 2/255 but
    1 % (t ties on silhouettes). The textured quad is red on the left and
    green on the right (tests/test_texture.py's check)."""
    quad = textured_quad(tmp_path)
    for path, mode, cam in (
            (cube_obj, "bvh4.compressed.leaf",
             dict(from_=(1.2, 1.0, -1.5), to=(0, 0, 0))),
            (quad, None, dict(from_=(0, 0, 3), to=(0, 0, 0), fov=60))):
        st = (cube_leaf if mode else
              viewer.build_scene(path, mode, 3, 2, rtcore="device=cpu"))
        img, n = viewer.render_frame(st, Camera(**cam), (32, 24))
        ref, _ = jviewer.render_frame(jviewer.build_scene(path, mode, 3, 2),
                                      JCamera(**cam), (32, 24))
        ref = np.asarray(ref)
        assert n == 32 * 24 and img.shape == ref.shape == (24, 32, 3)
        bad = float((np.abs(img.numpy() - ref).max(-1) > 2 / 255).mean())
        assert bad <= 0.01, f"{path}: {bad:.4%} of the pixels differ"
        assert (img.amax(-1) > 0.05).float().mean() > 0.05
        if mode is None:
            assert img[12, 11, 0] > img[12, 11, 1]
            assert img[12, 21, 1] > img[12, 21, 0]
    # the raw Ng of a leaf hit is the dummy (1, 0, 0): shaded with it,
    # without the smooth-normal pass, the cube looks different
    cam = Camera(from_=(1.2, 1.0, -1.5), to=(0, 0, 0))
    smooth, _ = viewer.render_frame(cube_leaf, cam, (32, 24))
    st = cube_leaf
    kd, valid, d, _gid, _prim, _u, _v, ng = viewer._trace(
        st["cscene"], st["materials"], st["geom_mat"], st["textures"],
        st["kd_tex"], st["tri_uv"], st["prim_base"],
        *cam.ispc_camera(32, 24, device=torch.device("cpu")),
        width=32, height=24)
    assert valid.any()
    assert (ng[valid] == torch.tensor([1.0, 0.0, 0.0])).all()
    flat = viewer._shade(kd, valid, d, ng).reshape(24, 32, 3)
    assert not torch.equal(smooth, flat)


def test_bomberman_matches_the_reference_render(bomberman):
    """tests/test_ref_golden.py::test_ref_bomberman for the port: the
    paper's demo configuration (build/bomberman.ecs: OBJ as subdivision
    surface, bvh4.compressed.leaf, subdLvl 6 / compLvl 3, smooth
    limit-surface normals) at 160x96 against ref_bomberman_160.pfm; at
    most 2.5 % of the pixels more than 1.5/255 off (0.9 % on the CPU)."""
    cs = bomberman["cscene"]
    assert cs.compressed_kernel is not None
    assert cs.compressed.tiles.space is None         # the ids-only accel
    assert cs.compressed_kernel.num_tiles == 727 * (1 << 3) ** 2
    cam = Camera(from_=(18.21240425, 20.05745888, 15.46878433),
                 to=(0, 0, 0), fov=90)
    img, _ = viewer.render_frame(bomberman, cam, (160, 96))
    ref = read_pfm(os.path.join(GOLDEN, "ref_bomberman_160.pfm"))
    assert img.shape == ref.shape == (96, 160, 3)
    diff = np.abs(_quant(img.numpy()) - ref).max(-1)
    frac = float((diff > 1.5 / 255).mean())
    assert frac <= 0.025, f"{frac:.4%} of the pixels differ"
    assert (ref.max(-1) > 0).mean() > 0.3
    # smooth normals come from the SubdivEval that survived the commit
    assert ("nrm_fused", 0) in bomberman["scene"]._attr_cache


def test_viewer_command_line(tmp_path, cube_obj):
    """`-i`, `--compress.leaf`, `--subdLvl` and `--compLvl` reach the
    commit and a PPM is written; `-i` also takes a `.ply` scene."""
    out = tmp_path / "v.ppm"
    app = viewer.make_app()
    built, build = [], app.build_scene
    app.build_scene = lambda a: built.append(build(a)) or built[-1]
    assert app.run(["-i", cube_obj, "--compress.leaf", "--subdLvl", "3",
                    "--compLvl", "2", "--size", "24", "16", "-o", str(out),
                    "--benchmark", "0", "1", "-rtcore", "device=cpu"]) == 0
    assert read_ppm(str(out)).shape == (16, 24, 3)
    assert app.args.subdiv_mode == "bvh4.compressed.leaf"
    ply = tmp_path / "s.ply"
    ply.write_text("ply\nformat ascii 1.0\nelement vertex 3\n"
                   "property float x\nproperty float y\nproperty float z\n"
                   "element face 1\nproperty list uchar int vertex_indices\n"
                   "end_header\n0 0 0\n1 0 0\n0 1 0\n3 0 1 2\n")
    assert app.run(["-i", str(ply), "--size", "8", "8", "-o", str(out),
                    "-rtcore", "device=cpu"]) == 0
    assert built[1]["cscene"].tris.num_prims == 1
    pc = built[0]["cscene"].compressed_kernel
    assert pc.num_tiles == 6 * (1 << (3 - 2)) ** 2 and pc.comp_level == 2
    with pytest.raises(SystemExit):
        viewer.make_app().run(["-rtcore", "device=cpu"])
