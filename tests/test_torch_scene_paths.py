"""The paths of embree_tpu_torch/scene/scene.py that end in the packet
kernel: which kernel a request reaches, ray masks and intersection
filters against the JAX package on its own test cases, a scene carried
across with `committed_scene_from_reference`, and the ray-stream sort.

The port runs the plain versions of its kernels here (CPU tensors); the
JAX package runs its XLA path (`isa="xla"`). Tolerances: ids equal, t
1e-5 relative (the cases are axis-aligned or large triangles, no ties)."""
import numpy as np
import pytest
import torch

import embree_tpu as et
import embree_tpu_torch as ett
from embree_tpu.traverse import stream as ref_stream
from embree_tpu_torch.convert import committed_scene_from_reference
from embree_tpu_torch.scene import scene as port_scene
from embree_tpu_torch.traverse import packet_kernel as pk
from embree_tpu_torch.traverse import rowtrace2 as rt2
from embree_tpu_torch.traverse import stream as port_stream
from embree_tpu_torch.verify.fixtures import random_triangles, triangle_sphere

CFG = "ignore_config_files=1"


def both_devices(cfg=CFG):
    return et.Device(cfg), ett.Device(cfg, device="cpu")


def rays_np(rng, n, extent):
    org = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org, d


@pytest.fixture
def calls(monkeypatch):
    """Counts the calls that reach each kernel's plain version (on the
    card the same call sites launch the kernels)."""
    n = {"rowtrace2": 0, "packet": 0}
    rt_plain, pk_plain = rt2.rowtrace2_plain, pk.packet_plain

    def count_rt(*a, **k):
        n["rowtrace2"] += 1
        return rt_plain(*a, **k)

    def count_pk(*a, **k):
        n["packet"] += 1
        return pk_plain(*a, **k)

    monkeypatch.setattr(rt2, "rowtrace2_plain", count_rt)
    monkeypatch.setattr(pk, "packet_plain", count_pk)
    return n


def port_scene_of(verts, idx, cfg=CFG):
    sc = ett.Scene(ett.Device(cfg, device="cpu"))
    sc.attach(ett.TriangleMesh(verts, idx))
    sc.commit()
    return sc


def test_commit_builds_what_tri_accel_names(rng, monkeypatch):
    verts, idx = triangle_sphere((0, 0, 0), 2.0, 12)
    cs = port_scene_of(verts, idx).committed
    assert cs.packet is not None and cs.packet.width == 4
    assert cs.bvh.width == 4 and cs.bvh.num_nodes == cs.packet.num_nodes
    assert cs.rowtrace is None                 # under ROWTRACE_MIN_PRIMS
    cs = port_scene_of(verts, idx, CFG + ",tri_accel=bvh8.triangle4").committed
    assert cs.packet.width == 8 and cs.bvh.width == 8 and cs.rowtrace is None
    cs = port_scene_of(
        verts, idx, CFG + ",tri_accel=bvh4.triangle4.rowtrace").committed
    assert cs.rowtrace is not None and cs.packet.width == 4
    monkeypatch.setattr(port_scene, "ROWTRACE_MIN_PRIMS", 100)
    assert port_scene_of(verts, idx).committed.rowtrace is not None
    cs = port_scene_of(
        verts, idx, CFG + ",tri_accel=bvh4.triangle4.packet").committed
    assert cs.rowtrace is None and cs.packet is not None


def test_dispatch_between_the_two_kernels(rng, monkeypatch, calls):
    """rowtrace2 serves a batch only when the scene has a treelet scene,
    the batch is large, not coherent and unmasked; the packet kernel
    serves everything else. Both give the same answers."""
    verts, idx = triangle_sphere((0, 0, 0), 2.0, 16)
    sc = port_scene_of(verts, idx, CFG + ",tri_accel=bvh4.triangle4.rowtrace")
    monkeypatch.setattr(port_scene, "ROWTRACE_MIN_RAYS", 256)
    org, d = rays_np(rng, 300, 3.0)
    rays = ett.make_rays(org, d, device="cpu")
    few = ett.Rays(*(x[:200] for x in rays))
    ones = np.full(300, -1, np.int32)

    def took(fn):
        before = dict(calls)
        out = fn()
        return out, (calls["rowtrace2"] - before["rowtrace2"],
                     calls["packet"] - before["packet"])

    big, n = took(lambda: sc.intersect(rays))
    assert n == (1, 0)
    _, n = took(lambda: sc.occluded(rays))
    assert n == (1, 0)
    small, n = took(lambda: sc.intersect(few))
    assert n == (0, 1)
    _, n = took(lambda: sc.occluded(few))
    assert n == (0, 1)
    coh, n = took(lambda: sc.intersect(rays, coherent=True))
    assert n == (0, 1)
    occ_coh, n = took(lambda: ett.scene_occluded(sc.committed, rays,
                                                 coherent=True))
    assert n == (0, 1)
    masked, n = took(lambda: sc.intersect(rays, mask=ones))
    assert n == (0, 1)
    _, n = took(lambda: sc.occluded(rays, mask=ones))
    assert n == (0, 1)
    sc.set_intersection_filter(lambda *a: True)
    filt, n = took(lambda: sc.intersect(rays))
    assert n == (1, 0)                         # one round, every hit kept
    sc.set_intersection_filter(None)
    # a scene without a treelet scene never reaches rowtrace2
    plain_sc = port_scene_of(verts, idx)
    pkt, n = took(lambda: plain_sc.intersect(rays))
    assert n == (0, 1)
    assert big.valid.sum() >= 60
    for other in (coh, masked, filt, pkt):
        assert torch.equal(other.valid, big.valid)
        assert torch.equal(other.gprim, big.gprim)
        torch.testing.assert_close(other.t, big.t, rtol=1e-6, atol=0)
    assert torch.equal(small.gprim, big.gprim[:200])
    assert torch.equal(occ_coh, big.valid)


def test_stream_sorted_batch_gives_the_same_answers(rng):
    """Sort, trace in stream order, unsort: the answers of the unsorted
    batch, bit for bit (the kernel's result depends on the ray alone)."""
    verts, idx = random_triangles(rng, 300, extent=3.0, size=1.0)
    cs = port_scene_of(verts, idx).committed
    org, d = rays_np(rng, 500, 4.0)
    rays = ett.make_rays(org, d, device="cpu")
    masks = torch.from_numpy(rng.integers(0, 3, 500).astype(np.int32))
    srays, perm = port_stream.sort_rays_stream(rays, cs.world_lower,
                                               cs.world_upper)
    assert not torch.equal(perm, torch.arange(500))
    for rm in (None, masks):
        t, prim = pk.intersect_packet_kernel_raw(cs.packet, rays, ray_mask=rm)
        occ = pk.occluded_packet_kernel(cs.packet, rays, ray_mask=rm)
        srm = None if rm is None else rm[perm].contiguous()
        t_s, prim_s = port_stream.unsort_by_perm(
            perm, *pk.intersect_packet_kernel_raw(cs.packet, srays,
                                                  ray_mask=srm))
        occ_s = port_stream.unsort_by_perm(
            perm, pk.occluded_packet_kernel(cs.packet, srays, ray_mask=srm))
        assert (prim >= 0).sum() >= 40
        assert torch.equal(t, t_s) and torch.equal(prim, prim_s)
        assert torch.equal(occ, occ_s)


def _quad_mesh(pkg, z):
    # unit quad at depth z facing +z (two CCW triangles)
    v = np.array([[-1, -1, z], [1, -1, z], [1, 1, z], [-1, 1, z]], np.float32)
    i = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    return pkg.TriangleMesh(v, i)


def test_ray_masks_per_geometry():
    """Four stacked quads with masks 1, 2, 4, 8; a ray with mask m hits
    the nearest quad whose (geom.mask & m) != 0 — in both packages."""
    results = []
    for pkg, dev in zip((et, ett), both_devices()):
        scene = pkg.Scene(dev)
        gids = []
        for k in range(4):
            g = _quad_mesh(pkg, float(k))
            g.mask = 1 << k
            gids.append(scene.attach(g))
        scene.commit()
        org = np.tile(np.array([0.0, 0.0, -1.0], np.float32), (6, 1))
        d = np.tile(np.array([0.0, 0.0, 1.0], np.float32), (6, 1))
        kw = {"device": "cpu"} if pkg is ett else {}
        rays = pkg.make_rays(org, d, **kw)
        masks = np.array([1, 2, 4, 8, 0, 0xF], np.int32)
        hits = scene.intersect(rays, mask=masks)
        occ = scene.occluded(rays, mask=masks)
        results.append((np.asarray(hits.geom_id), np.asarray(hits.t),
                        np.asarray(hits.prim_id), np.asarray(occ), gids))
    (rg, rt, rp, rocc, gids), (pg, pt, pp, pocc, _) = results
    assert list(pg[:4]) == gids and pg[4] == -1 and pg[5] == gids[0]
    np.testing.assert_array_equal(pg, rg)
    np.testing.assert_array_equal(pp, rp)
    np.testing.assert_allclose(pt[:4], [1.0, 2.0, 3.0, 4.0], rtol=1e-5)
    np.testing.assert_allclose(pt, rt, rtol=1e-5)
    assert list(pocc) == list(rocc) == [True, True, True, True, False, True]


def test_ray_masks_default_scalar_and_batch_shape(rng):
    dev = ett.Device(CFG, device="cpu")
    scene = ett.Scene(dev)
    scene.attach(_quad_mesh(ett, 0.0))          # default mask -1
    scene.commit()
    rays = ett.make_rays(np.array([[0, 0, -1.0]], np.float32),
                         np.array([[0, 0, 1.0]], np.float32), device="cpu")
    h1 = scene.intersect(rays, mask=np.array([123], np.int32))
    h2 = scene.intersect(rays)
    assert h1.geom_id.item() == h2.geom_id.item() == 0
    assert scene.intersect(rays, mask=5).valid.item()      # a scalar mask
    assert not scene.intersect(rays, mask=0).valid.item()
    assert not scene.occluded(rays, mask=torch.zeros(1)).item()
    # masks keep the rays' batch shape
    org = np.zeros((2, 3, 3), np.float32)
    org[..., 2] = -1.0
    d = np.zeros((2, 3, 3), np.float32)
    d[..., 2] = 1.0
    grid = ett.make_rays(org, d, device="cpu")
    m = np.array([[1, 0, 1], [0, 1, 0]], np.int32)
    h = scene.intersect(grid, mask=m)
    assert h.valid.shape == (2, 3)
    np.testing.assert_array_equal(h.valid.numpy(), m.astype(bool))
    np.testing.assert_array_equal(scene.occluded(grid, mask=m).numpy(),
                                  m.astype(bool))


def test_ray_masks_match_reference_on_a_soup(rng):
    """Three geometries with masks 1, 2, 4 and random ray masks."""
    parts = [random_triangles(rng, 120, extent=3.0, size=1.2)
             for _ in range(3)]
    org, d = rays_np(rng, 400, 4.0)
    masks = rng.integers(0, 8, 400).astype(np.int32)
    out = []
    for pkg, dev in zip((et, ett), both_devices()):
        scene = pkg.Scene(dev)
        for k, (v, i) in enumerate(parts):
            g = pkg.TriangleMesh(v, i)
            g.mask = 1 << k
            scene.attach(g)
        scene.commit()
        kw = {"device": "cpu"} if pkg is ett else {}
        rays = pkg.make_rays(org, d, **kw)
        h = scene.intersect(rays, mask=masks)
        out.append((np.asarray(h.valid), np.asarray(h.geom_id),
                    np.asarray(h.prim_id), np.asarray(h.t),
                    np.asarray(scene.occluded(rays, mask=masks))))
    ref, port = out
    assert ref[0].sum() >= 40
    for a, b in zip(ref[:3], port[:3]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(port[3][ref[0]], ref[3][ref[0]], rtol=1e-5)
    np.testing.assert_array_equal(port[4], ref[4])
    assert ((1 << port[1][port[0]]) & masks[port[0]]).all()


def test_filter_rejects_and_traversal_continues():
    # two parallel triangles; the filter rejects the nearer one
    v = np.array([[-1, -1, 2], [1, -1, 2], [0, 1, 2],
                  [-1, -1, 0], [1, -1, 0], [0, 1, 0]], np.float32)
    idx = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    org = np.array([[0, 0, 5]], np.float32)
    d = np.array([[0, 0, -1]], np.float32)
    seen = []
    for pkg, dev in zip((et, ett), both_devices()):
        s = pkg.Scene(dev)
        s.attach(pkg.TriangleMesh(v, idx))
        s.commit()
        kw = {"device": "cpu"} if pkg is ett else {}
        rays = pkg.make_rays(org, d, **kw)
        row = []
        h = s.intersect(rays)
        row.append((int(h.prim_id[0]), float(h.t[0])))
        # reject prim 0 -> traversal must deliver prim 1 behind it
        s.set_intersection_filter(
            lambda org_, d_, t, u, v_, ng, geom, prim: prim != 0)
        h = s.intersect(rays)
        row.append((int(h.prim_id[0]), float(h.t[0])))
        # reject everything -> miss
        s.set_intersection_filter(
            lambda org_, d_, t, u, v_, ng, geom, prim: t != t)
        row.append(bool(s.intersect(rays).valid[0]))
        # clearing restores the unfiltered answer
        s.set_intersection_filter(None)
        row.append(int(s.intersect(rays).prim_id[0]))
        seen.append(row)
    ref, port = seen
    assert port[0][0] == 0 and abs(port[0][1] - 3.0) < 1e-5
    assert port[1][0] == 1 and abs(port[1][1] - 5.0) < 1e-5
    assert port[2] is False and port[3] == 0
    assert [r[0] if isinstance(r, tuple) else r for r in ref] == \
        [p[0] if isinstance(p, tuple) else p for p in port]


def test_filter_by_uv_transparency():
    """Classic transparency-texture filter: reject hits with u > 0.5."""
    v = np.array([[-1, -1, 0], [3, -1, 0], [-1, 3, 0]], np.float32)
    idx = np.array([[0, 1, 2]], np.int32)
    org = np.array([[0, 0, 5], [1.8, -0.5, 5]], np.float32)
    d = np.array([[0, 0, -1]] * 2, np.float32)
    valid = []
    for pkg, dev in zip((et, ett), both_devices()):
        s = pkg.Scene(dev)
        s.attach(pkg.TriangleMesh(v, idx))
        s.commit()
        s.set_intersection_filter(
            lambda org_, d_, t, u, v_, ng, geom, prim: u <= 0.5)
        kw = {"device": "cpu"} if pkg is ett else {}
        valid.append(np.asarray(s.intersect(pkg.make_rays(org, d, **kw)).valid))
    assert list(valid[1]) == [True, False]      # u ~ 0.25 and u ~ 0.7
    np.testing.assert_array_equal(valid[0], valid[1])


def test_filter_restart_on_a_soup_matches_a_reduced_scene(rng):
    """Keeping only even prims by a filter answers as a scene of the even
    prims does; the filter sees tensors of the scene's device, and rounds
    retire decided rays."""
    verts, idx = random_triangles(rng, 200, extent=2.0, size=1.5)
    sc = port_scene_of(verts, idx)
    org, d = rays_np(rng, 300, 3.0)
    rays = ett.make_rays(org, d, 0.0, 50.0, device="cpu")
    seen = []

    def keep_even(org_, d_, t, u, v_, ng, geom, prim):
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        assert org_.shape == (300, 3) and ng.shape == (300, 3)
        seen.append(int((t > -np.inf).sum()))
        return prim % 2 == 0

    sc.set_intersection_filter(keep_even)
    got = sc.intersect(rays)
    even = port_scene_of(verts, idx[::2])
    want = even.intersect(rays)
    assert want.valid.sum() >= 60
    assert torch.equal(got.valid, want.valid)
    assert torch.equal(got.prim_id, torch.where(
        want.valid, want.prim_id * 2, torch.full_like(want.prim_id, -1)))
    torch.testing.assert_close(got.t, want.t, rtol=1e-6, atol=0)
    assert (got.t[~got.valid] == 50.0).all()
    assert len(seen) >= 2 and seen[-1] < seen[0]   # later rounds are smaller
    # a filter with a mask: both conditions hold
    m = rng.integers(0, 2, 300).astype(np.int32)
    both = sc.intersect(rays, mask=m)
    assert torch.equal(both.valid, want.valid & torch.from_numpy(m != 0))
    # a python bool is a valid answer
    sc.set_intersection_filter(lambda *a: False)
    assert not sc.intersect(rays).valid.any()


def reference_arrays(cs) -> dict:
    """The JAX package's committed state as numpy arrays."""
    a = {f"tris.{k}": np.asarray(getattr(cs.tris, k))
         for k in ("v0", "v1", "v2", "geom_id", "prim_id", "uv_flip")}
    a.update({f"bvh.{k}": np.asarray(getattr(cs.bvh, k))
              for k in ("lower", "upper", "child", "count", "prim_order")})
    ps = cs.pallas
    a.update({"packet.nodes": np.asarray(ps.nodes),
              "packet.tdata": np.asarray(ps.tdata),
              "packet.bvh_to_orig": np.asarray(ps.bvh_to_orig),
              "packet.num_nodes": ps.num_nodes,
              "packet.num_prims": ps.num_prims, "packet.width": ps.width,
              "prim_mask": np.asarray(cs.prim_mask),
              "world_lower": np.asarray(cs.world_lower),
              "world_upper": np.asarray(cs.world_upper),
              "backface_cull": cs.backface_cull})
    return a


@pytest.mark.parametrize("accel", ["default", "bvh8.triangle4"])
def test_reference_commit_runs_through_the_port(rng, accel):
    """A scene committed by the JAX package, carried across as numpy
    arrays, answers through the port's packet kernel as the JAX package's
    XLA path does, and exactly as the port's own commit does."""
    cfg = f"{CFG},tri_accel={accel}"
    rdev, pdev = both_devices(cfg)
    parts = [random_triangles(rng, 150, extent=3.0, size=1.0),
             triangle_sphere((0.5, 0, 0), 1.5, 10)]
    scenes = []
    for pkg, dev in ((et, rdev), (ett, pdev)):
        sc = pkg.Scene(dev)
        for k, (v, i) in enumerate(parts):
            g = pkg.TriangleMesh(v, i)
            g.mask = 1 + k
            sc.attach(g)
        sc.commit()
        scenes.append(sc)
    ref_sc, port_sc = scenes
    cs = committed_scene_from_reference(reference_arrays(ref_sc.committed),
                                        "cpu")
    own = port_sc.committed
    assert cs.rowtrace is None and own.rowtrace is None
    assert cs.packet.width == (8 if accel.startswith("bvh8") else 4)
    for a, b in zip(cs.bvh, own.bvh):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for name in ("nodes", "tdata", "bvh_to_orig", "prim_mask"):
        a, b = getattr(cs.packet, name), getattr(own.packet, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert cs.packet[3:7] == own.packet[3:7]    # counts, width, depth
    org, d = rays_np(rng, 400, 3.0)
    rays = ett.make_rays(org, d, device="cpu")
    masks = rng.integers(0, 4, 400).astype(np.int32)
    ref = et.scene_intersect(ref_sc.committed, et.make_rays(org, d),
                             isa="xla", ray_mask=masks)
    got = ett.scene_intersect(cs, rays, ray_mask=masks)
    rv = np.asarray(ref.valid)
    assert rv.sum() >= 40
    np.testing.assert_array_equal(got.valid.numpy(), rv)
    np.testing.assert_array_equal(got.gprim.numpy(), np.asarray(ref.gprim))
    np.testing.assert_allclose(got.t.numpy()[rv], np.asarray(ref.t)[rv],
                               rtol=5e-5)
    for a, b in zip(got, port_sc.intersect(rays, mask=masks)):
        assert torch.equal(a, b)
    assert torch.equal(ett.scene_occluded(cs, rays), port_sc.occluded(rays))
    bad = reference_arrays(ref_sc.committed)
    bad["packet.width"] = 16
    with pytest.raises(ValueError):
        committed_scene_from_reference(bad, "cpu")


def test_stream_sort_keys_and_permutation_equal_reference(rng):
    import jax.numpy as jnp
    n = 3000
    org = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[::7, 1] = 0.0                               # zeros have no sign bit
    lo = np.array([-2, -2.5, -1], np.float32)
    hi = np.array([2, 2, 3], np.float32)
    ref_rays = et.make_rays(org, d)
    rays = ett.make_rays(org, d, device="cpu")
    tlo, thi = torch.from_numpy(lo), torch.from_numpy(hi)
    k_ref = np.asarray(ref_stream.stream_sort_keys(
        ref_rays, jnp.asarray(lo), jnp.asarray(hi)))
    k = port_stream.stream_sort_keys(rays, tlo, thi)
    assert k.dtype == torch.int64
    np.testing.assert_array_equal(k.numpy(), k_ref.astype(np.int64))
    assert len(np.unique(k_ref)) < n              # ties: stability matters
    s_ref, p_ref, i_ref = ref_stream.sort_rays_perm(
        ref_rays, jnp.asarray(lo), jnp.asarray(hi))
    s, p, i = port_stream.sort_rays_perm(rays, tlo, thi)
    np.testing.assert_array_equal(p.numpy(), np.asarray(p_ref))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    for a, b in zip(s, s_ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    s2, p2 = port_stream.sort_rays_stream(rays, tlo, thi)
    assert torch.equal(p2, p) and torch.equal(s2.org, s.org)
    # unsort restores the original order, one tensor or several
    x = torch.arange(n, dtype=torch.float32)
    flag = x % 3 == 0
    ref_un = ref_stream.unsort_by_perm(p_ref, jnp.asarray(x.numpy())[p_ref])
    np.testing.assert_array_equal(np.asarray(ref_un), x.numpy())
    assert torch.equal(port_stream.unsort_by_perm(p, x[p]), x)
    a, b = port_stream.unsort_by_perm(p, x[p], flag[p])
    assert torch.equal(a, x) and torch.equal(b, flag)
    assert torch.equal(x[p][i], x)                # inv is a gather index
