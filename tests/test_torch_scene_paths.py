"""The paths of embree_tpu_torch/scene/scene.py that end in the packet
kernel: which kernel a request reaches, ray masks and intersection
filters against the JAX package on its own test cases, a scene carried
across with `committed_scene_from_reference`, and the ray-stream sort.

The port runs the plain versions of its kernels here (CPU tensors); the
JAX package runs its XLA path (`isa="xla"`). Tolerances: ids equal, t
1e-5 relative (the cases are axis-aligned or large triangles, no ties).
The masks, the filters and the stream sort are in
test_torch_scene_paths_masks.py, test_torch_scene_paths_filters.py and
test_torch_scene_paths_stream.py, which use the helpers below."""
import numpy as np
import pytest
import torch

import embree_tpu as et
import embree_tpu_torch as ett
from embree_tpu_torch.convert import committed_scene_from_reference
from embree_tpu_torch.scene import scene as port_scene
from embree_tpu_torch.traverse import packet_kernel as pk
from embree_tpu_torch.traverse import rowtrace2 as rt2
from embree_tpu_torch.verify.fixtures import random_triangles, triangle_sphere
from test_torch_build import reference_native  # noqa: F401,E402

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
        # bits: the compact node records hold pushed refs as int bits,
        # some of them NaN patterns
        assert a.dtype == b.dtype and torch.equal(
            a.view(torch.int32), b.view(torch.int32)), name
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
