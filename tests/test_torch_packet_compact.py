"""The compact device form kernel B2 reads
(embree_tpu_torch/traverse/packet_kernel.py::compact_scene) against the
row layout it is cut from, which the JAX package's packer lays out
(tests/test_torch_packet.py):

  * every word of a compact node record and triangle record maps back to
    its word in `pack_scene`'s rows; a node's child fields hold the ref
    the walk pushes (`push_refs`), which gives back the row's child and
    count (`pulled_refs`); BVH4 and BVH8, masks, leaves that spanned two
    leaf rows, the empty scene;
  * the plain walk over the compact form equals the walk over the rows
    on every ray, bit for bit: t, prim and every counter, for closest
    hit, any hit, culling and masks, and on a tree deeper than the 16
    levels of the kernel's small stack;
  * the CUDA wrapper takes only the compact form;
  * a committed scene holds only the compact form, answers as the rows
    do, and its device bytes fall.

Cases are looped inside each test: under `--dist loadfile` a file of more
than five tests is handed out ahead of the slowest file of the suite and
delays its start."""
import math

import numpy as np
import pytest
import torch

import embree_tpu_torch as ett
from embree_tpu_torch.build.sah import BuildSettings, build_sah
from embree_tpu_torch.scene.prims import prim_bounds_np
from embree_tpu_torch.traverse import packet_kernel as pk
from embree_tpu_torch.verify.fixtures import random_triangles, triangle_sphere


def rows_of(verts, idx, width, prim_mask=None):
    v = np.asarray(verts, np.float32)[np.asarray(idx)]
    v0, v1, v2 = (np.ascontiguousarray(v[:, k]) for k in range(3))
    lo, hi = prim_bounds_np(v0, v1, v2)
    bvh = build_sah(lo, hi, BuildSettings(branching_factor=width))
    return pk.pack_scene(bvh, (v0, v1, v2), "cpu", prim_mask=prim_mask)


def deep_strip(n=300):
    """Triangles of geometrically growing size along x: a tree of more
    than 16 levels."""
    x = (1.07 ** np.arange(n)).astype(np.float32)
    v = np.zeros((3 * n, 3), np.float32)
    v[0::3, 0] = x
    v[1::3, 0] = x * 1.01
    v[2::3, 0] = x
    v[2::3, 1] = 0.01 * x
    return v, np.arange(3 * n).reshape(n, 3)


def scenes():
    rng = np.random.default_rng(0xC0)
    verts, idx = random_triangles(rng, 1500, extent=5.0, size=1.2)
    mask = (1 + np.arange(len(idx)) % 2).astype(np.int32)
    out = []
    for w in (4, 8):
        out.append((f"random BVH{w}", rows_of(verts, idx, w, mask), 8.0))
        out.append((f"sphere BVH{w}",
                    rows_of(*triangle_sphere((0, 0, 0), 2.0, 16), w), 3.0))
    out.append(("deep BVH4", rows_of(*deep_strip(), 4), 0.0))
    return out


def check_words(ps, cs):
    W, T = ps.width, ps.num_prims
    rows = ps.nodes.numpy()[:, :8 * W]
    recs = cs.nodes.numpy()
    assert recs.shape == rows.shape
    ref = np.ascontiguousarray(recs[:, 6 * W:7 * W]).view(np.int32)
    rest = np.r_[0:6 * W, 7 * W:8 * W]
    np.testing.assert_array_equal(recs[:, rest].view(np.uint32),
                                  rows[:, rest].view(np.uint32))
    child, count = rows[:, 6 * W:7 * W], rows[:, 7 * W:]
    np.testing.assert_array_equal(ref, pk.push_refs(child, count))
    cc, cn = pk.pulled_refs(torch.from_numpy(ref))
    used = count >= 0
    np.testing.assert_array_equal(cn.numpy(), np.where(used, count, -1))
    np.testing.assert_array_equal(cc.numpy()[used], child[used])
    assert ((ref == pk.EMPTY) == ~used).all()
    tri = ps.tdata.numpy()[:, :pk.NT_PER_ROW * pk.TRI_FLOATS]
    tri = tri.reshape(-1, pk.TRI_FLOATS)[:max(T, 1)]
    np.testing.assert_array_equal(cs.tdata.numpy().view(np.uint32),
                                  tri.view(np.uint32))
    assert torch.equal(cs.bvh_to_orig, ps.bvh_to_orig)
    assert (cs.prim_mask is None) == (ps.prim_mask is None)
    if ps.prim_mask is not None:
        assert torch.equal(cs.prim_mask, ps.prim_mask)
    assert (cs.num_nodes, cs.num_prims, cs.width, cs.depth) == (
        ps.num_nodes, ps.num_prims, ps.width, ps.depth)


def test_compact_words_map_back_to_the_rows():
    straddle = empty_slot = False
    for _name, ps, _e in scenes():
        cs = pk.compact_scene(ps)
        check_words(ps, cs)
        W = ps.width
        f = ps.nodes.numpy()[:, 6 * W:8 * W].astype(np.int64)
        start, count = f[:, :W], f[:, W:]
        straddle |= bool(((count > 0) & (start % pk.NT_PER_ROW + count
                                         > pk.NT_PER_ROW)).any())
        empty_slot |= bool((count < 0).any())
        assert cs.device_bytes < (0.5 if W == 4 else 0.7) * ps.device_bytes
    assert straddle and empty_slot
    with pytest.raises(ValueError, match="15"):
        pk.push_refs(np.zeros((1, 4)), np.full((1, 4), 16))
    empty = pk.pack_scene(build_sah(
        np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32),
        BuildSettings(branching_factor=4)), (np.zeros((0, 3), np.float32),)
        * 3, "cpu")
    ce = pk.compact_scene(empty)
    check_words(empty, ce)
    assert ce.nodes.shape == (1, 32) and ce.tdata.shape == (1, 12)
    rays = ett.make_rays(np.zeros((4, 3), np.float32),
                         np.tile(np.float32([[0, 0, 1]]), (4, 1)),
                         device="cpu")
    t, prim, st = pk.packet_trace(ce, rays, stats=True)
    assert (prim == -1).all() and st["node_visits"] == 4


def rays_for(rng, n, extent, deep=False):
    if deep:
        # down onto the strip; every second ray aimed into a triangle
        x = 1.07 ** rng.uniform(0, 300, n)
        x[::2] = 1.07 ** rng.integers(0, 300, n)[::2] * 1.004
        org = np.stack([x, 0.002 * x, np.ones(n)], 1).astype(np.float32)
        d = np.zeros((n, 3), np.float32)
        d[:, 2] = -1.0
        d[:, :2] = rng.normal(size=(n, 2)) * 1e-4
    else:
        org = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
        d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r = ett.make_rays(org, d.astype(np.float32), device="cpu")
    tf = r.tfar.clone()
    tf[::7] = -math.inf
    tf[3::11] = 2.0
    return r._replace(tfar=tf)


def test_plain_walk_over_compact_form_equals_walk_over_rows():
    rng = np.random.default_rng(0xC1)
    deep_seen = False
    for name, ps, extent in scenes():
        cs = pk.compact_scene(ps)
        deep = name.startswith("deep")
        deep_seen |= deep and ps.depth > 16
        rays = rays_for(rng, 600, extent, deep)
        rm = torch.from_numpy(rng.integers(0, 4, 600).astype(np.int32))
        modes = [(False, False, None), (True, False, None),
                 (False, True, None)]
        if ps.prim_mask is not None:
            modes += [(False, False, rm), (True, False, rm)]
        for occluded, cull, mask in modes:
            a = pk.packet_plain(cs, rays, occluded, cull, ray_mask=mask,
                                stats=True)
            b = pk.packet_plain(ps, rays, occluded, cull, ray_mask=mask,
                                stats=True)
            assert torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))
            assert torch.equal(a[1], b[1]) and a[2] == b[2], name
            assert a[2]["dropped_pushes"] == 0
            if not occluded:
                assert int((a[1] >= 0).sum()) > (5 if deep else 20), name
        # the wrapper takes the compact form on the CPU
        assert torch.equal(pk.packet_trace(cs, rays)[1],
                           pk.packet_plain(ps, rays)[1])
    assert deep_seen


def test_cuda_wrapper_takes_only_the_compact_form():
    """On a device other than the CPU the wrapper asks for the compact
    form (a 'meta' tensor stands in for a CUDA one here)."""
    ps = rows_of(*triangle_sphere((0, 0, 0), 2.0, 8), 4)
    cs = pk.compact_scene(ps)
    rays = ett.Rays(*(torch.zeros(s, device="meta")
                      for s in ((4, 3), (4, 3), (4,), (4,))))

    def on_meta(p):
        return p._replace(**{k: v.to("meta") for k, v in p._asdict().items()
                             if isinstance(v, torch.Tensor)})
    with pytest.raises(ValueError, match="compact"):
        pk._checked_inputs(on_meta(ps), rays, None)
    pk._checked_inputs(on_meta(cs), rays, None)
    with pytest.raises(ValueError, match="tdata"):
        pk._checked_inputs(on_meta(cs._replace(tdata=ps.tdata)), rays,
                           None)


def test_committed_scene_holds_only_the_compact_form():
    """A committed scene keeps the compact form alone; it answers as the
    rows do, and its device bytes fall below the rows'."""
    rng = np.random.default_rng(0xC3)
    verts, idx = triangle_sphere((0, 0, 0), 2.0, 20)
    for accel in ("bvh4.triangle4", "bvh8.triangle4"):
        sc = ett.Scene(ett.Device(f"ignore_config_files=1,tri_accel={accel}",
                                  device="cpu"))
        g = ett.TriangleMesh(verts, idx)
        g.mask = 3
        sc.attach(g)
        cs = sc.commit()
        ps = rows_of(verts, idx, 8 if accel.startswith("bvh8") else 4,
                     np.full(len(idx), 3, np.int32))
        assert isinstance(cs.packet, pk.CompactScene)
        check_words(ps, cs.packet)
        W, T = ps.width, ps.num_prims
        assert cs.packet.device_bytes == 4 * (
            ps.num_nodes * 8 * W + max(T, 1) * 12 + 2 * T)
        assert cs.packet.device_bytes < (
            0.5 if W == 4 else 0.75) * ps.device_bytes
        rays = rays_for(rng, 500, 3.0)
        h = sc.intersect(rays)
        t, prim = pk.packet_plain(ps, rays)
        assert torch.equal(h.t.view(torch.int32), t.view(torch.int32))
        assert torch.equal(h.valid, prim >= 0) and int(h.valid.sum()) > 50
        t_o, _ = pk.packet_plain(ps, rays, occluded=True)
        assert torch.equal(sc.occluded(rays), t_o == -math.inf)
