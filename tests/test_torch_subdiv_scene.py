"""Subdivision meshes through the port's scene (embree_tpu_torch/scene/
scene.py): the port's forms of tests/test_cbvh.py (grid mode equals the
eager tessellation, the other modes are conservative, patch uv, the
conservative occlusion, displacement, smooth normals), mixed and
subdiv-only scenes, ray masks, the filter restart, the
`displacement_geometry` tutorial against the JAX package's image, and the
command-line flags that select the compressed modes. Everything runs on
the CPU, so the wrappers take the kernels' plain versions. Tolerances are
stated where they are used; those of the forms of tests/test_cbvh.py are
that file's."""
import numpy as np
import pytest
import torch

import embree_tpu_torch as ett
from embree_tpu_torch.render.camera import Camera
from embree_tpu_torch.render.tutorial_app import TutorialApplication
from embree_tpu_torch.render.tutorials import displacement_geometry as dg
from embree_tpu_torch.scene.subdiv_accel import (fused_normal_table,
                                                 interpolate_subdiv,
                                                 sample_normal_fused)
from embree_tpu_torch.traverse import cbvh_kernel as ck
from embree_tpu_torch.traverse import packet_kernel as pk
from embree_tpu_torch.verify.fixtures import subdiv_cube

PLANE_V = np.array([[-10, -2, -10], [-10, -2, 10], [10, -2, -10],
                    [10, -2, 10]], np.float32)
PLANE_I = np.array([[0, 1, 2], [1, 3, 2]], np.int32)


def displ(p, ng, u, v):
    return (p + 0.15 * ng * np.sin(5 * p[..., :1])).astype(np.float32)


def make_scene(mode=None, displacement=None, levels=(3, 2), plane=False,
               flavor="com", mask=None):
    cfg = "ignore_config_files=1"
    if mode:
        cfg += f",subdiv_accel=bvh4.compressed.{mode},compressed_node={flavor}"
    s = ett.Scene(ett.Device(cfg, device="cpu"))
    if plane:
        s.attach(ett.TriangleMesh(PLANE_V, PLANE_I))
    verts, counts, indices = subdiv_cube()
    mesh = ett.SubdivMesh(verts, counts, indices, displacement=displacement)
    if mask is not None:
        mesh.mask = mask
    s.attach(mesh)
    s.set_levels(*levels)
    s.commit()
    return s


def rand_rays(seed, n):
    rng = np.random.default_rng(seed)
    org = rng.normal(size=(n, 3)).astype(np.float32)
    org = org / np.linalg.norm(org, axis=1, keepdims=True) * 4.0
    d = -org / 4.0 + rng.normal(size=(n, 3)).astype(np.float32) * 0.05
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return ett.make_rays(org, d, device="cpu")


@pytest.fixture(scope="module")
def scenes():
    """The undisplaced cube at levels (3, 2): eager and every mode."""
    out = {m: make_scene(m) for m in ("grid", "leaf", "box", "full")}
    out["eager"] = make_scene()
    return out


def test_grid_mode_matches_eager(scenes):
    rays = rand_rays(1, 600)
    he, hg = scenes["eager"].intersect(rays), scenes["grid"].intersect(rays)
    assert (he.valid == hg.valid).float().mean() > 0.999
    both = he.valid & hg.valid
    assert both.sum() > 400
    np.testing.assert_allclose(hg.t[both].numpy(), he.t[both].numpy(),
                               atol=2e-3)
    # the eager hit reports patch uv too (not triangle barycentrics); half
    # of its cells are split along the other diagonal, hence 2e-2
    np.testing.assert_allclose(hg.u[both].numpy(), he.u[both].numpy(),
                               atol=2e-2)
    np.testing.assert_allclose(hg.v[both].numpy(), he.v[both].numpy(),
                               atol=2e-2)
    assert torch.equal(hg.prim_id[both], he.prim_id[both])


@pytest.mark.parametrize("mode", ["box", "leaf", "full"])
def test_conservative_modes(scenes, mode):
    """box/leaf/full hit everything the exact surface hits, slightly
    earlier (conservative quantized bounds never miss)."""
    rays = rand_rays(2, 500)
    he, hc = scenes["eager"].intersect(rays), scenes[mode].intersect(rays)
    assert (hc.valid | ~he.valid).float().mean() > 0.999, mode
    both = he.valid & hc.valid
    dt = (he.t - hc.t)[both]
    assert dt.min() > -2e-2, f"{mode} hit behind the exact surface"
    assert dt.abs().max() < 0.5, f"{mode} approximation error too large"


def test_uv_in_patch_range_and_ids(scenes):
    h = scenes["grid"].intersect(rand_rays(3, 300))
    v = h.valid
    assert h.u[v].min() >= -1e-4 and h.u[v].max() <= 1 + 1e-4
    assert h.v[v].min() >= -1e-4 and h.v[v].max() <= 1 + 1e-4
    assert set(h.prim_id[v].tolist()) <= set(range(6))
    assert (h.geom_id[v] == 0).all() and (h.geom_id[~v] == -1).all()
    assert (h.gprim == -1).all() and (h.inst_id == -1).all()


def test_occluded_conservative(scenes):
    rays = rand_rays(4, 300)
    h = scenes["box"].intersect(rays)
    occ = scenes["box"].occluded(rays)
    assert (occ | ~h.valid).all()
    assert occ.dtype == torch.bool and occ.shape == (300,)


def test_displacement_modes():
    rays = rand_rays(5, 500)
    he = make_scene(displacement=displ).intersect(rays)
    hg = make_scene("grid", displacement=displ).intersect(rays)
    assert (he.valid == hg.valid).float().mean() > 0.995
    both = he.valid & hg.valid
    np.testing.assert_allclose(hg.t[both].numpy(), he.t[both].numpy(),
                               atol=5e-3)
    hl = make_scene("leaf", displacement=displ).intersect(rays)
    assert (hl.valid | ~he.valid).float().mean() > 0.995
    # the displacement moved the surface
    h0 = make_scene("grid").intersect(rays)
    assert (h0.t - hg.t)[both & h0.valid].abs().max() > 0.05


def test_interpolate_smooth_normals(scenes):
    sc = scenes["grid"]
    rays = rand_rays(6, 200)
    h = sc.intersect(rays)
    v = h.valid
    ev = sc.subdiv_eval[0]
    P, N = interpolate_subdiv(ev, h.prim_id.clamp_min(0), h.u, h.v)
    hitp = rays.org + h.t[:, None] * rays.dir
    err = torch.linalg.norm((P - hitp)[v], dim=1)
    assert err.median() < 5e-2
    np.testing.assert_allclose(torch.linalg.norm(N[v], dim=1).numpy(), 1.0,
                               atol=1e-3)
    assert ((N[v] * P[v]).sum(1) > 0).float().mean() > 0.99
    fused = sample_normal_fused(fused_normal_table(ev), ev,
                                h.prim_id.clamp_min(0), h.u, h.v)
    np.testing.assert_allclose(fused[v].numpy(), N[v].numpy(), atol=1e-5)
    assert set(sc.subdiv_plan) == {0}


def test_memory_footprint():
    """Paper headline: 'com' node = 4 bytes, pizza leaf = 2 bytes a cell.
    A committed leaf-mode scene holds one compact record a tile (the 44
    header floats, 21 node words padded to 24, 32 leaf words) and of the
    accel itself only its ids and uv tables."""
    sc = make_scene("leaf", levels=(4, 3))
    cs = sc.committed
    tiles, pc = cs.compressed.tiles, cs.compressed_kernel
    cells = (1 << tiles.comp_level) ** 2
    words, node_ofs, leaf_ofs = ck.tile_layout(tiles.comp_level, tiles.mode)
    assert leaf_ofs - node_ofs == 24 >= (4 ** tiles.comp_level - 1) // 3
    assert (leaf_ofs - node_ofs) * 4 + cells * 2 == 24 * 4 + 64 * 2
    assert words == 44 + 24 + 32 and pc.tiles.shape == (24, words)
    assert tiles.num_tiles == 6 * 4 and tiles.nodes is None
    assert sc.device.bytes_used > 24 * words * 4


def test_subdiv_only_scene_and_empty_triangles(scenes, capsys):
    cs = scenes["leaf"].committed
    assert cs.tris.num_prims == 0 and cs.packet is None
    assert cs.compressed is not None and cs.compressed_kernel is not None
    assert scenes["full"].committed.compressed_kernel is None
    rays = rand_rays(7, 64)
    shaped = ett.Rays(*(a.reshape((8, 8) + a.shape[1:]) for a in rays))
    h = scenes["leaf"].intersect(shaped)
    assert h.t.shape == (8, 8) and h.ng.shape == (8, 8, 3)
    assert h.valid.sum() > 40
    assert scenes["leaf"].occluded(shaped).shape == (8, 8)
    lo, hi = scenes["leaf"].bounds
    assert (lo < -0.5).all() and (hi > 0.5).all()
    scenes["leaf"].print_statistics()
    assert "24 compressed tiles (leaf, level 2)" in capsys.readouterr().out


def test_mixed_scene_folds_both_accels():
    mixed = make_scene("leaf", plane=True)
    only = make_scene("leaf")
    rays = rand_rays(8, 400)
    before = (pk.launches, dict(ck.launches))
    hm, ho = mixed.intersect(rays), only.intersect(rays)
    assert (pk.launches, ck.launches) == before  # CPU: plain versions
    on_plane = hm.valid & (hm.geom_id == 0)
    on_cube = hm.valid & (hm.geom_id == 1)
    assert on_plane.sum() > 20 and on_cube.sum() > 200
    # the cube's geometry id moved from 0 to 1; where the cube wins the
    # mixed scene it gives the subdiv-only scene's hit
    assert torch.equal(on_cube | (on_plane & ho.valid), ho.valid)
    same_tile = on_cube & (hm.prim_id == ho.prim_id)
    np.testing.assert_allclose(hm.t[same_tile].numpy(),
                               ho.t[same_tile].numpy(), atol=2e-2)
    assert (hm.t[on_plane] < ho.t[on_plane]).all()
    assert (hm.ng[on_cube] == torch.tensor([1.0, 0, 0])).all()
    assert (hm.ng[on_plane].abs().sum(1) > 0).all()
    occ = mixed.occluded(rays)
    assert (occ | ~hm.valid).all()
    assert torch.equal(occ, mixed.occluded(rays, mask=-1))


def test_ray_masks_act_on_triangles_only():
    """As in the JAX package, a ray mask filters triangle geometry; the
    compressed accel is traversed whatever the mask."""
    mixed = make_scene("leaf", plane=True, mask=2)
    rays = rand_rays(9, 300)
    h_all = mixed.intersect(rays)
    h_none = mixed.intersect(rays, mask=0)
    assert not (h_none.valid & (h_none.geom_id == 0)).any()
    assert (h_none.geom_id == 1).sum() >= (h_all.geom_id == 1).sum() > 100
    per_ray = torch.where(torch.arange(300) % 2 == 0, -1, 0)
    h_half = mixed.intersect(rays, mask=per_ray)
    assert not (h_half.geom_id[1::2] == 0).any()
    assert torch.equal(h_half.geom_id[::2], h_all.geom_id[::2])


def test_filter_restart_over_a_compressed_scene():
    """The restart wavefront re-traverses both accels every round. The
    filter here rejects triangle hits only."""
    mixed = make_scene("leaf", plane=True)
    only = make_scene("leaf")
    rays = rand_rays(10, 200)
    base = mixed.intersect(rays)
    calls = []

    def drop_plane(org, d, t, u, v, ng, geom, prim):
        calls.append(t.shape[0])
        return geom != 0

    mixed.set_intersection_filter(drop_plane)
    h = mixed.intersect(rays)
    mixed.set_intersection_filter(None)
    assert len(calls) >= 2 and set(calls) == {200}
    assert (base.geom_id == 0).sum() > 10 and not (h.geom_id == 0).any()
    ho = only.intersect(rays)
    assert (h.valid == ho.valid).float().mean() > 0.99
    both = h.valid & ho.valid & (base.geom_id == 1)
    assert both.sum() > 100
    assert torch.equal(h.t[both], ho.t[both])
    assert (h.geom_id[h.valid] == 1).all()

    # a filter that accepts everything changes nothing
    mixed.set_intersection_filter(lambda *a: torch.ones(200, dtype=torch.bool))
    h_all = mixed.intersect(rays)
    mixed.set_intersection_filter(None)
    for a, b in zip(h_all, base):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["box", "leaf", "full"])
def test_filter_rejecting_a_slab_hit_raises(scenes, mode):
    """A rejected box or leaf hit would be found again a float further
    inside the same slab, round after round: the scene raises in the
    first round instead of crawling."""
    sc = scenes[mode]
    rays = rand_rays(12, 64)
    assert sc.intersect(rays).valid.sum() > 20
    sc.set_intersection_filter(lambda *a: a[6] != 0)
    try:
        with pytest.raises(ett.RaytracerError, match="not ported yet.*filter"):
            sc.intersect(rays)
        # a filter that rejects nothing goes through
        sc.set_intersection_filter(lambda *a: a[6] >= 0)
        assert sc.intersect(rays).valid.sum() > 20
    finally:
        sc.set_intersection_filter(None)


def test_filter_rejecting_grid_hits_restarts(scenes):
    """Grid mode tests triangles: a rejected hit is passed like any
    triangle's. Rejecting the near half of the hits leaves later ones."""
    sc = scenes["grid"]
    rays = rand_rays(12, 64)
    base = sc.intersect(rays)
    cut = float(base.t[base.valid].median())
    sc.set_intersection_filter(lambda *a: a[2] > cut)
    try:
        h = sc.intersect(rays)
    finally:
        sc.set_intersection_filter(None)
    assert base.valid.sum() > 20 and h.valid.sum() > 10
    assert (h.t[h.valid] > cut).all()
    far = base.valid & (base.t > cut)
    assert torch.equal(h.t[far], base.t[far])


def test_not_ported_arguments_raise():
    verts, counts, indices = subdiv_cube()
    # per-edge tessellation levels are ported: a uniform level buffer
    # commits as the uniform tessellation at that rate
    s = ett.Scene(ett.Device("ignore_config_files=1", device="cpu"))
    s.attach(ett.SubdivMesh(verts, counts, indices,
                            edge_levels=np.full(24, 4.0, np.float32)))
    assert s.commit().tris.num_prims == len(counts) * 2 * 4 * 4
    # a ray time is ported; on a scene without motion blur it changes
    # nothing, and occlusion over motion-blur geometry is what still raises
    sc = make_scene("leaf")
    rays = rand_rays(1, 4)
    assert torch.equal(sc.intersect(rays, time=0.5).t, sc.intersect(rays).t)
    mb = ett.Scene(ett.Device("ignore_config_files=1", device="cpu"))
    mb.attach(ett.SubdivMeshMB(verts, verts * np.float32(1.5), counts,
                               indices))
    mb.set_levels(2, 2)
    mb.commit()
    with pytest.raises(ett.RaytracerError, match="not ported yet"):
        mb.occluded(rays)


def test_eager_scene_reports_patch_uv_next_to_plain_triangles():
    sc = make_scene(None, plane=True)
    cs = sc.committed
    assert cs.compressed is None and cs.tri_patch_uv is not None
    assert cs.tri_patch_uv.shape == (cs.tris.num_prims, 3, 2)
    assert cs.tris.num_prims == 2 + 2 * 6 * 64
    h = sc.intersect(rand_rays(11, 300))
    cube = h.valid & (h.geom_id == 1)
    assert set(h.prim_id[cube].tolist()) <= set(range(6))
    assert h.u[cube].max() > 0.9 and h.v[cube].max() > 0.9
    plane = h.valid & (h.geom_id == 0)
    assert plane.any() and (h.u[plane] + h.v[plane] <= 1 + 1e-5).all()


@pytest.mark.parametrize("flags,mode", [
    (["--compress.leaf"], "bvh4.compressed.leaf"),
    (["--compress.grid"], "bvh4.compressed.grid"),
    (["--compress.box"], "bvh4.compressed.box"),
    (["--compress.ref"], "bvh4.compressed.full"),
    (["--compress.full"], "bvh4.compressed.full"),
    ([], None)])
def test_cli_flags_select_the_mode(flags, mode):
    app = TutorialApplication("t", None, None)
    args = app.parse(flags + ["--subdLvl", "1", "--compLvl", "9"])
    assert args.subdiv_mode == mode
    assert (args.subdLvl, args.compLvl) == (2, 2)


def test_displacement_geometry_cli(tmp_path, capsys):
    out = tmp_path / "d.ppm"
    app = dg.make_app()
    # levels are the tutorial's own (6, 4): 96 tiles of 256 cells
    rc = app.run(["--compress.box", "--size", "32", "24", "-o", str(out),
                  "--benchmark", "1", "1", "-rtcore", "device=cpu"])
    assert rc == 0
    text = capsys.readouterr().out
    assert "BENCHMARK_RENDER_AVG" in text and "BENCHMARK_RENDER_MRAYPS_AVG" in text
    data = out.read_bytes()
    assert data.startswith(b"P6\n32 24\n255\n") and len(data) == 13 + 32 * 24 * 3


def test_displacement_geometry_matches_reference_image():
    """64x48 frame, leaf mode at levels (3, 2), against the JAX package's
    render of the same scene. The two visit tiles in different orders and
    round differently, which moves a hit across a leaf slab on a few
    silhouette and shadow-edge pixels: at most 1 % of the pixels may
    differ by more than 2/255 in any channel."""
    import embree_tpu.render.tutorials.displacement_geometry as rdg
    from embree_tpu.render.camera import Camera as RefCamera
    w, h = 64, 48
    mode = "bvh4.compressed.leaf"
    rstate = rdg.build_scene(mode, 3, 2)
    rcam = RefCamera(from_=(2.5, 2.5, 2.5), to=(0, 0, 0))
    ref = np.asarray(rdg.render(rstate["cscene"], *rcam.ispc_camera(w, h),
                                width=w, height=h))
    state = dg.build_scene(mode, 3, 2, rtcore="device=cpu")
    img, nrays = dg.render_frame(state, Camera(from_=(2.5, 2.5, 2.5),
                                               to=(0, 0, 0)), (w, h))
    img = img.numpy()
    assert img.shape == ref.shape == (h, w, 3) and nrays == 2 * w * h
    assert np.isfinite(img).all()
    bad = (np.abs(img - ref).max(-1) > 2.0 / 255).mean()
    assert bad <= 0.01, f"{bad:.2%} of the pixels differ"
    assert (img.max(-1) > 0).mean() > 0.3
    # the cube (geom 1) and the plane (geom 0) both show
    assert (np.abs(img - 0.5 * np.array([0.9, 0.6, 0.5])).max(-1) < 0.6).any()
