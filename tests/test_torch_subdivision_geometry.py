"""The port's `subdivision_geometry` tutorial against the reference
binaries' render, and per-edge tessellation levels
(`tessellate_mesh_to_triangles_levels`, `SubdivMesh(edge_levels=)`):
byte-equal to the JAX package's host code, and the port's forms of
tests/test_edge_levels.py. Everything runs on the CPU."""
import os

import numpy as np
import torch

import embree_tpu_torch as ett
from embree_tpu.subdiv import tessellate as jtess
from embree_tpu_torch.render.camera import Camera
from embree_tpu_torch.render.image import read_pfm
from embree_tpu_torch.render.tutorial_app import TutorialApplication
from embree_tpu_torch.render.tutorials import subdivision_geometry as sg
from embree_tpu_torch.subdiv import tessellate as ttess

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _quant(img):
    """The reference's float -> RGBA8 -> float pipeline."""
    return np.floor(255.0 * np.clip(np.asarray(img), 0.0, 1.0)) / 255.0


def two_quads():
    #  v3--v2--v5
    #  |f0 | f1|
    #  v0--v1--v4    shared edge (v1, v2)
    verts = np.array([[0, 0, 0], [1, 0, 0.3], [1, 1, 0.3],
                      [0, 1, 0], [2, 0, 0], [2, 1, 0]], np.float32)
    return verts, np.array([4, 4], np.int32), np.array(
        [0, 1, 2, 3, 1, 4, 5, 2], np.int32)


def commit_levels(levels, sub_level=4, mesh=None):
    verts, counts, idx = two_quads() if mesh is None else mesh
    s = ett.Scene(ett.Device("ignore_config_files=1", device="cpu"))
    s.attach(ett.SubdivMesh(verts, counts, idx,
                            edge_levels=np.asarray(levels, np.float32)))
    s.set_levels(sub_level, 2)
    return s, s.commit()


def test_subdivision_geometry_matches_the_reference_render():
    """tests/test_ref_golden.py::test_ref_subdivision_geometry for the
    port: the eagerly tessellated cube at level 6 with smooth normals
    dPdu x dPdv from the analytic patches, 128x128, against
    ref_subdivision_128.pfm; at most 0.2 % of the pixels more than 1.5/255
    off (1 pixel of 16,384 on the CPU)."""
    state = sg.build_scene(subdiv_level=6, rtcore="device=cpu")
    img, n = sg.render_frame(state, Camera(from_=(1.5, 1.5, -1.5),
                                           to=(0, 0, 0)), (128, 128))
    ref = read_pfm(os.path.join(GOLDEN, "ref_subdivision_128.pfm"))
    assert n == 2 * 128 * 128 and img.shape == ref.shape == (128, 128, 3)
    diff = np.abs(_quant(img.numpy()) - ref).max(-1)
    frac = float((diff > 1.5 / 255).mean())
    assert frac <= 0.002, f"{frac:.4%} of the pixels differ"
    assert state["scene"]._patch_tables, "no analytic patch was evaluated"
    # the CLI: --subdLvl reaches the commit
    app = sg.make_app()
    app.args = app.parse(["--subdLvl", "3", "--compLvl", "2", "-rtcore",
                          "device=cpu"])
    st = app.build_scene(app)
    assert st["scene"].subdivision_level == 3
    assert st["cscene"].tris.num_prims == 2 + 6 * 2 * 8 * 8


def test_tessellate_levels_is_byte_equal():
    """The same triangles, prim ids and patch uv as the JAX package's for
    two quads at mixed rates, a cube at per-corner rates and a pentagon
    cap (n-gon faces at their largest corner rate), with and without
    `with_uv`."""
    rng = np.random.default_rng(0xE0)
    ang = np.linspace(0, 2 * np.pi, 5, endpoint=False)
    ring = np.stack([np.cos(ang), np.sin(ang), np.zeros(5)], 1)
    cap_v = np.concatenate([ring, 2.2 * ring + [0, 0, 0.4]]).astype(
        np.float32)
    cap_f = [0, 1, 2, 3, 4] + sum(([i, 5 + i, 5 + (i + 1) % 5, (i + 1) % 5]
                                   for i in range(5)), [])
    from embree_tpu_torch.verify.fixtures import subdiv_cube
    cases = [(two_quads(), [8, 2, 8, 8, 2, 2, 2, 2], 4),
             (subdiv_cube(), rng.choice([1, 2, 3, 5, 8], 24), 3),
             ((cap_v, np.array([5] + [4] * 5), np.array(cap_f)),
              rng.choice([1, 2, 4], 25), 3)]
    for (verts, counts, idx), lv, ml in cases:
        mesh = ett.SubdivMesh(verts, counts, idx)
        for with_uv in (False, True):
            a = jtess.tessellate_mesh_to_triangles_levels(
                mesh, np.asarray(lv, np.float32), max_level=ml,
                with_uv=with_uv)
            b = ttess.tessellate_mesh_to_triangles_levels(
                mesh, np.asarray(lv, np.float32), max_level=ml,
                with_uv=with_uv)
            assert len(a) == len(b) == 4 + with_uv
            for x, y in zip(a, b):
                assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def test_edge_levels_commit_and_stitch(rng):
    """tests/test_edge_levels.py for the port: the rates drive the
    triangle counts, the T-junction edge's vertex sets coincide, rays at
    the rate boundary never leak (4,000 rays through the packet kernel's
    plain version), and a scene with `edge_levels` commits with patch uv
    on its hits."""
    _, lo = commit_levels([2] * 8)
    _, hi = commit_levels([8, 8, 8, 8, 2, 2, 2, 2])
    _, uni = commit_levels([4] * 8)
    assert hi.tris.num_prims > lo.tris.num_prims
    assert uni.tris.num_prims == 2 * 2 * 4 * 4
    assert uni.tri_patch_uv is not None
    # the shared edge x == 1 at rate 2 from both faces
    verts, counts, idx = two_quads()
    mesh = ett.SubdivMesh(verts, counts, idx)
    v0, v1, v2, prim = ttess.tessellate_mesh_to_triangles_levels(
        mesh, np.array([8, 2, 8, 8, 2, 2, 2, 2], np.float32), max_level=4)
    tri = np.stack([v0, v1, v2], axis=1)

    def edge_pts(face):
        pts = tri[prim == face].reshape(-1, 3)
        return {tuple(np.round(p, 5))
                for p in pts[np.abs(pts[:, 0] - 1.0) < 1e-5]}
    assert edge_pts(0) and edge_pts(0) == edge_pts(1)
    # watertight across the rate change
    _, cs = commit_levels([8, 8, 8, 8, 2, 2, 2, 2], sub_level=3)
    n = 4000
    target = np.stack([rng.uniform(0.9, 1.1, n), rng.uniform(0.02, 0.98, n),
                       np.full(n, 0.15)], 1).astype(np.float32)
    org = target + np.array([0, 0, 5], np.float32)
    d = target - org
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    h = ett.scene_intersect(cs, ett.make_rays(org, d, device="cpu"))
    assert float((~h.valid).float().mean()) <= 2e-5
    assert ((h.u >= 0) & (h.u <= 1) & (h.v >= 0) & (h.v <= 1)).all()
    assert torch.isin(h.prim_id, torch.tensor([0, 1], dtype=h.prim_id.dtype)
                      ).all()
    # a TutorialApplication parses the levels the commit reads
    args = TutorialApplication("t", None, None).parse(["--subdLvl", "9",
                                                       "--compLvl", "7"])
    assert (args.subdLvl, args.compLvl) == (9, 4)
