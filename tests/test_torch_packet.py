"""The packet kernel's module (embree_tpu_torch/traverse/packet_kernel.py)
against embree_tpu/traverse/pallas_packet.py: the packer byte for byte,
and the port's plain version of the kernel against the JAX package's
Pallas kernel in interpret mode and against its XLA path, on the same
numpy inputs.

Tolerances: valid masks equal; t 5e-5 relative on every hit (XLA:CPU
contracts products into FMAs, the port rounds every product; on thin
triangles the two differ by up to 1.5e-5); prim equal except where the
two winners tie on t (the JAX kernel orders a node's children by the
nearest ray of a whole packet, the port by the ray's own distance, so
equal-t ties may resolve differently) — those rays are counted; u, v
1e-5 absolute; no dropped push."""
import numpy as np
import pytest
import torch

import embree_tpu as et
import embree_tpu_torch as ett
from embree_tpu.build import sah as ref_sah
from embree_tpu.traverse.pallas_packet import (intersect_pallas,
                                              occluded_pallas)
from embree_tpu.traverse.pallas_packet import pack_scene as ref_pack_scene
from embree_tpu_torch.build.sah import BuildSettings, build_sah
from embree_tpu_torch.core import stats as port_stats
from embree_tpu_torch.scene.prims import prim_bounds_np
from embree_tpu_torch.traverse import packet_kernel as pk
from embree_tpu_torch.verify.fixtures import random_triangles, triangle_sphere


def soup(verts, idx):
    v = np.asarray(verts, np.float32)[np.asarray(idx)]
    return tuple(np.ascontiguousarray(v[:, k]) for k in range(3))


def packed(verts, idx, width=4, prim_mask=None):
    v0, v1, v2 = soup(verts, idx)
    lo, hi = prim_bounds_np(v0, v1, v2)
    bvh = build_sah(lo, hi, BuildSettings(branching_factor=width))
    return pk.pack_scene(bvh, (v0, v1, v2), "cpu", prim_mask=prim_mask)


def ref_committed(verts, idx, cfg="ignore_config_files=1"):
    scene = et.Scene(et.Device(cfg))
    scene.attach(et.TriangleMesh(verts, idx))
    return scene.commit()


def rays_np(rng, n, extent, normalize=True, aim=None):
    """Random origins and directions; with `aim` (verts, idx) every
    second ray points near a random triangle's centroid, so that small
    scenes get hit."""
    org = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    if aim is not None:
        cen = np.asarray(aim[0], np.float32)[np.asarray(aim[1])].mean(1)
        tgt = cen[rng.integers(0, len(cen), n)]
        tgt = tgt + rng.uniform(-0.1, 0.1, (n, 3)).astype(np.float32)
        d[::2] = (tgt - org)[::2]
    if normalize:
        d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org, d


def assert_matches(ref, port):
    """ref: JAX Hits; port: torch Hits. Returns the number of ties."""
    rv = np.asarray(ref.valid)
    np.testing.assert_array_equal(port.valid.numpy(), rv)
    rt, pt = np.asarray(ref.t), port.t.numpy()
    np.testing.assert_allclose(pt[rv], rt[rv], rtol=5e-5)
    np.testing.assert_array_equal(pt[~rv], rt[~rv])
    same = np.asarray(ref.gprim) == port.gprim.numpy()
    ties = int((~same).sum())
    # a different prim is a tie: the same t to within the t tolerance
    np.testing.assert_allclose(pt[~same], rt[~same], rtol=5e-5)
    m = rv & same
    np.testing.assert_array_equal(port.prim_id.numpy()[m],
                                  np.asarray(ref.prim_id)[m])
    np.testing.assert_allclose(port.u.numpy()[m], np.asarray(ref.u)[m],
                               atol=1e-5)
    np.testing.assert_allclose(port.v.numpy()[m], np.asarray(ref.v)[m],
                               atol=1e-5)
    return ties


@pytest.mark.parametrize("width", [4, 8])
def test_pack_scene_byte_equal(rng, width):
    verts, idx = random_triangles(rng, 257, extent=5.0, size=1.0)
    v0, v1, v2 = soup(verts, idx)
    lo, hi = prim_bounds_np(v0, v1, v2)
    bvh = build_sah(lo, hi, BuildSettings(branching_factor=width))
    ref_bvh = ref_sah.build_sah(
        lo, hi, ref_sah.BuildSettings(branching_factor=width))
    ref = ref_pack_scene(ref_bvh, None, host_tris=(v0, v1, v2))
    ps = pk.pack_scene(bvh, (v0, v1, v2), "cpu")
    assert (ps.num_nodes, ps.num_prims, ps.width) == (
        ref.num_nodes, ref.num_prims, ref.width) == (
        bvh.child.shape[0], 257, width)
    for a, b in ((ps.nodes, ref.nodes), (ps.tdata, ref.tdata)):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy().view(np.int32),
                                      np.asarray(b).view(np.int32))
    assert ps.bvh_to_orig.dtype == torch.int32
    np.testing.assert_array_equal(ps.bvh_to_orig.numpy(),
                                  np.asarray(ref.bvh_to_orig))
    # 257 prims: 26 leaf rows + the pad row, 8 pad floats a row
    assert ps.tdata.shape == (27, 128)
    assert not ps.tdata[:, 120:].any() and not ps.tdata[-1].any()
    assert 2 <= ps.depth <= 64
    assert ps.depth == pk.tree_depth(bvh.child, bvh.count)


@pytest.mark.parametrize("ntri,nray", [(5, 64), (60, 100)])
def test_plain_matches_pallas_interpret_and_xla(rng, ntri, nray):
    verts, idx = random_triangles(rng, ntri, extent=5.0, size=1.0)
    cs = ref_committed(verts, idx)
    org, d = rays_np(rng, nray, 8.0, aim=(verts, idx))
    ref_rays = et.make_rays(org, d)
    xla = et.scene_intersect(cs, ref_rays, isa="xla")
    pallas = intersect_pallas(cs.pallas, cs.tris, ref_rays, interpret=True)

    sc = ett.Scene(ett.Device("ignore_config_files=1", device="cpu"))
    sc.attach(ett.TriangleMesh(verts, idx))
    pcs = sc.commit()
    rays = ett.make_rays(org, d, device="cpu")
    port = pk.intersect_packet_kernel(pcs.packet, pcs.tris, rays)
    assert np.asarray(xla.valid).sum() >= 3
    assert assert_matches(xla, port) == 0
    assert assert_matches(pallas, port) == 0
    st = pk.traversal_stats(pcs.packet, rays)
    assert st.shape == (1, 3) and st[0, 0] >= nray and st[0, 2] == 0


@pytest.mark.parametrize("nray", [7, 1025])
def test_plain_ray_counts_off_any_tile(rng, nray):
    verts, idx = random_triangles(rng, 10)
    cs = ref_committed(verts, idx)
    org, d = rays_np(rng, nray, 5.0, normalize=False, aim=(verts, idx))
    xla = et.scene_intersect(cs, et.make_rays(org, d), isa="xla")
    ps = packed(verts, idx)
    t, prim = pk.intersect_packet_kernel_raw(
        ps, ett.make_rays(org, d, device="cpu"))
    assert t.shape == prim.shape == (nray,)
    np.testing.assert_array_equal((prim >= 0).numpy(), np.asarray(xla.valid))
    np.testing.assert_array_equal(prim.numpy(), np.asarray(xla.gprim))


def test_plain_occluded_matches(rng):
    verts, idx = random_triangles(rng, 30, extent=5.0, size=1.0)
    cs = ref_committed(verts, idx)
    org, d = rays_np(rng, 64, 8.0, normalize=False, aim=(verts, idx))
    ref_rays = et.make_rays(org, d)
    xla = et.scene_occluded(cs, ref_rays, isa="xla")
    pallas = occluded_pallas(cs.pallas, ref_rays, interpret=True)
    ps = packed(verts, idx)
    rays = ett.make_rays(org, d, device="cpu")
    occ = pk.occluded_packet_kernel(ps, rays)
    assert occ.dtype == torch.bool and occ.sum() >= 3
    np.testing.assert_array_equal(occ.numpy(), np.asarray(xla))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(pallas))
    # any-hit writes no prim and marks hits with t = -inf
    t, prim, _ = pk.packet_trace(ps, rays, occluded=True)
    assert (prim == -1).all()
    assert torch.equal(t == -np.inf, occ)
    assert torch.equal(t[~occ], rays.tfar[~occ])


@pytest.mark.parametrize("width", [4, 8])
def test_plain_cull_and_origins_inside(rng, width):
    """triangle_sphere(24) with origins inside and outside, with and
    without backface culling, BVH4 and BVH8."""
    verts, idx = triangle_sphere((0, 0, 0), 2.0, 24)
    accel = "bvh8.triangle4" if width == 8 else "default"
    org, d = rays_np(rng, 400, 3.0)
    ties = 0
    for cull in (0, 1):
        cfg = (f"ignore_config_files=1,backface_culling={cull},"
               f"tri_accel={accel}")
        cs = ref_committed(verts, idx, cfg)
        assert cs.pallas.width == width
        xla = et.scene_intersect(cs, et.make_rays(org, d), isa="xla")
        sc = ett.Scene(ett.Device(cfg, device="cpu"))
        sc.attach(ett.TriangleMesh(verts, idx))
        pcs = sc.commit()
        assert pcs.packet.width == width and pcs.backface_cull == bool(cull)
        port = pk.intersect_packet_kernel(
            pcs.packet, pcs.tris, ett.make_rays(org, d, device="cpu"),
            cull=bool(cull))
        assert np.asarray(xla.valid).sum() >= 60
        ties += assert_matches(xla, port)
    assert ties == 0


def test_batch_shape_and_retired_rays(rng):
    """Rays keep their batch shape; a ray with tfar = -inf costs exactly
    one node visit and comes back as a miss."""
    verts, idx = triangle_sphere((0, 0, 0), 2.0, 12)
    ps = packed(verts, idx)
    v0, v1, v2 = (torch.from_numpy(a) for a in soup(verts, idx))
    n = len(idx)
    tris = ett.scene.prims.TrianglePrims(
        v0, v1, v2, torch.zeros(n, dtype=torch.int32),
        torch.arange(n, dtype=torch.int32), torch.zeros(n, dtype=torch.int32))
    org, d = rays_np(rng, 60, 1.0)
    rays = ett.make_rays(org.reshape(4, 15, 3), d.reshape(4, 15, 3),
                         device="cpu")
    h = pk.intersect_packet_kernel(ps, tris, rays)
    assert h.t.shape == (4, 15) and h.ng.shape == (4, 15, 3)
    assert h.valid.all()                        # origins inside the sphere
    assert pk.occluded_packet_kernel(ps, rays).shape == (4, 15)
    flat = ett.make_rays(org, d, 0.0, -np.inf, device="cpu")
    t, prim, st = pk.packet_trace(ps, flat, stats=True)
    assert (prim == -1).all() and (t == -np.inf).all()
    assert st["node_visits"] == 60 and st["tri_tests"] == 0
    assert st["leaf_visits"] == 0 and st["nodes_touched"] == 1


def test_masks_in_the_kernel(rng):
    """(prim_mask[p] & ray_mask) != 0 decides whether a hit stands."""
    verts, idx = random_triangles(rng, 300, extent=3.0, size=1.0)
    prim_mask = (1 << (np.arange(300) % 3)).astype(np.int32)
    ps = packed(verts, idx, prim_mask=prim_mask)
    np.testing.assert_array_equal(ps.prim_mask.numpy(),
                                  prim_mask[ps.bvh_to_orig.numpy()])
    org, d = rays_np(rng, 500, 4.0)
    rays = ett.make_rays(org, d, device="cpu")
    for bits in (1, 2, 4, 5, 7, 0):
        rm = torch.full((500,), bits, dtype=torch.int32)
        keep = np.nonzero(prim_mask & bits)[0]
        t, prim = pk.intersect_packet_kernel_raw(ps, rays, ray_mask=rm)
        occ = pk.occluded_packet_kernel(ps, rays, ray_mask=rm)
        assert torch.equal(occ, prim >= 0)
        if bits == 0:
            assert not occ.any()
            continue
        assert np.isin(prim.numpy()[prim.numpy() >= 0], keep).all()
        sub = packed(verts, idx[keep])
        t2, prim2 = pk.intersect_packet_kernel_raw(sub, rays)
        assert (prim2 >= 0).sum() >= 10
        assert torch.equal(t, t2)
        hit = (prim2 >= 0).numpy()
        np.testing.assert_array_equal(prim.numpy()[hit],
                                      keep[prim2.numpy()[hit]])
    with pytest.raises(ValueError, match="prim_mask"):
        pk.packet_trace(packed(verts, idx), rays,
                        ray_mask=torch.ones(500, dtype=torch.int32))
    with pytest.raises(ValueError, match="ray_mask"):
        pk.packet_trace(ps, rays, ray_mask=torch.ones(500))


def test_stack_depth_and_dropped_pushes(rng):
    verts, idx = triangle_sphere((0, 0, 0), 2.0, 16)
    ps = packed(verts, idx)
    org, d = rays_np(rng, 300, 3.0)
    rays = ett.make_rays(org, d, device="cpu")
    t, prim, st = pk.packet_plain(ps, rays, stats=True)
    assert st["dropped_pushes"] == 0 and (prim >= 0).sum() >= 50
    # a stack too small for the walk drops pushes, and says so
    _t, _p, st2 = pk.packet_plain(ps, rays, stats=True, stack_depth=2)
    assert st2["dropped_pushes"] > 0
    # a tree deeper than the kernel's compiled stack is refused
    with pytest.raises(ValueError, match="levels"):
        pk.packet_trace(ps._replace(depth=pk.MAX_DEPTH + 1), rays)
    with pytest.raises(ValueError, match="width"):
        pk.packet_trace(ps._replace(width=2), rays)
    with pytest.raises(ValueError, match="dtype"):
        pk.packet_trace(ps, rays._replace(org=rays.org.double()))
    with pytest.raises(ValueError, match="contiguous"):
        pk.packet_trace(ps, rays._replace(tfar=rays.tfar[:1].expand(300)))
    with pytest.raises(ValueError, match="shape"):
        pk.packet_trace(ps, rays._replace(dir=rays.dir[:5]))


def test_result_does_not_depend_on_ray_grouping(rng):
    verts, idx = random_triangles(rng, 400, extent=3.0, size=1.0)
    ps = packed(verts, idx, width=8)
    org, d = rays_np(rng, 300, 4.0)
    rays = ett.make_rays(org, d, device="cpu")
    t, prim, _ = pk.packet_trace(ps, rays)
    perm = torch.from_numpy(rng.permutation(300))
    t2, prim2, _ = pk.packet_trace(ps, ett.Rays(
        *(x[perm].contiguous() for x in rays)))
    assert torch.equal(t[perm], t2) and torch.equal(prim[perm], prim2)
    t3, prim3, _ = pk.packet_trace(ps, ett.Rays(
        *(x[:7].contiguous() for x in rays)))
    assert torch.equal(t[:7], t3) and torch.equal(prim[:7], prim3)


def test_cpu_tensors_take_plain_version_without_a_launch(rng, monkeypatch):
    verts, idx = random_triangles(rng, 20)
    ps = packed(verts, idx)
    org, d = rays_np(rng, 16, 5.0, aim=(verts, idx))
    rays = ett.make_rays(org, d, device="cpu")

    def no_kernel(*a, **k):
        raise AssertionError("the kernel path was taken for a CPU tensor")

    monkeypatch.setattr(pk, "_load_kernel", no_kernel)
    monkeypatch.setattr(pk, "_launch", no_kernel)
    before = pk.launches
    pk.intersect_packet_kernel_raw(ps, rays)
    pk.occluded_packet_kernel(ps, rays)
    pk.traversal_stats(ps, rays)
    assert pk.launches == before


def test_stat_counters_accumulate_when_enabled(rng):
    verts, idx = random_triangles(rng, 50, extent=3.0, size=1.0)
    ps = packed(verts, idx)
    org, d = rays_np(rng, 40, 4.0, aim=(verts, idx))
    rays = ett.make_rays(org, d, device="cpu")
    stat = port_stats.instance()
    stat.clear()
    pk.intersect_packet_kernel_raw(ps, rays)
    assert stat.normal.travs == 0               # disabled: nothing counted
    stat.enable(True)
    try:
        pk.intersect_packet_kernel_raw(ps, rays)
        pk.occluded_packet_kernel(ps, rays)
    finally:
        stat.enable(False)
    want = pk.traversal_stats(ps, rays)
    assert stat.normal.travs == 40 and stat.shadow.travs == 40
    assert stat.normal.trav_nodes == want[0, 0]
    assert stat.normal.trav_prims == want[0, 1]
    assert 0 < stat.shadow.trav_nodes <= stat.normal.trav_nodes
    stat.clear()
