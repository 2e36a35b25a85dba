"""Host-side build of the PyTorch port against the JAX package: the
numpy modules the port copied give the same arrays bit for bit on the
same inputs."""
import numpy as np
import pytest

from embree_tpu.build import sah as ref_sah
from embree_tpu.build import treelets as ref_treelets
from embree_tpu.build.native import build_sah_native as ref_build_native
from embree_tpu.verify import fixtures as ref_fixtures

from embree_tpu_torch.build import sah as port_sah
from embree_tpu_torch.build import treelets as port_treelets
from embree_tpu_torch.build.bvh import empty_bvh_np, sah_cost
from embree_tpu_torch.build.native import (build_sah_native,
                                           native_available)
from embree_tpu_torch.scene.prims import prim_bounds_np
from embree_tpu_torch.verify import fixtures as port_fixtures


def _soup(seed, n):
    verts, idx = port_fixtures.random_triangles(
        np.random.default_rng(seed), n, extent=5.0, size=1.2)
    v = verts[idx]
    return v[:, 0], v[:, 1], v[:, 2]


def test_fixtures_bit_equal():
    for n in (1, 8, 64):
        a = ref_fixtures.triangle_sphere((0.5, -1, 2), 2.0, n)
        b = port_fixtures.triangle_sphere((0.5, -1, 2), 2.0, n)
        assert all(np.array_equal(x, y) and x.dtype == y.dtype
                   for x, y in zip(a, b))
    a = ref_fixtures.random_triangles(np.random.default_rng(7), 500)
    b = port_fixtures.random_triangles(np.random.default_rng(7), 500)
    assert all(np.array_equal(x, y) and x.dtype == y.dtype
               for x, y in zip(a, b))


def test_pack_bf16_bounds_bit_equal(rng):
    lo = np.concatenate([
        rng.normal(size=4000).astype(np.float32) * 100,
        np.array([0.0, -0.0, 1e-30, -1e-30, np.inf], np.float32)])
    hi = lo + np.abs(rng.normal(size=lo.shape).astype(np.float32))
    hi[-1] = -np.inf
    a = ref_treelets.pack_bf16_bounds(lo, hi).view(np.uint32)
    b = port_treelets.pack_bf16_bounds(lo, hi).view(np.uint32)
    np.testing.assert_array_equal(a, b)


def test_choose_fan_and_constants_equal():
    for n in (1, 300, 5000, 99_999, 998_284, 8_000_000, 50_000_000):
        assert ref_treelets.choose_fan(n) == port_treelets.choose_fan(n)
    for name in ("N_INNER", "N_PAIRS", "P_CAP", "L3_BASE", "NODE_ROWS",
                 "LEAF_FIELDS", "BLOCK_ROWS"):
        assert getattr(ref_treelets, name) == getattr(port_treelets, name)


def test_morton_bit_equal(rng):
    c = rng.uniform(-3, 3, (5000, 3)).astype(np.float32)
    a = ref_treelets._morton_np(c, c.min(0), c.max(0))
    b = port_treelets._morton_np(c, c.min(0), c.max(0))
    np.testing.assert_array_equal(a, b)


def test_native_builder_deterministic_and_equal_to_reference():
    """The C++ builder runs its subtrees on threads; the arrays it returns
    must not depend on their timing, or byte equality between the two
    packages would be luck."""
    assert native_available()
    v0, v1, v2 = _soup(11, 20_000)
    lo, hi = prim_bounds_np(v0, v1, v2)
    first = build_sah_native(lo, hi, branching=4, max_leaf=16)
    for _ in range(3):
        again = build_sah_native(lo, hi, branching=4, max_leaf=16)
        for x, y in zip(first, again):
            np.testing.assert_array_equal(x, y)
    ref = ref_build_native(lo, hi, branching=4, max_leaf=16)
    for x, y in zip(first, ref):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("backend", ["native", "python"])
def test_build_sah_equal(backend):
    v0, v1, v2 = _soup(5, 1500)
    lo, hi = prim_bounds_np(v0, v1, v2)
    a = ref_sah.build_sah(lo, hi, ref_sah.BuildSettings(), backend=backend)
    b = port_sah.build_sah(lo, hi, port_sah.BuildSettings(), backend=backend)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert sah_cost(b) > 0.0
    # every prim lands in exactly one leaf
    leaf = b.count > 0
    covered = np.zeros(len(b.prim_order), np.int64)
    for s, c in zip(b.child[leaf], b.count[leaf]):
        covered[s:s + c] += 1
    assert (covered == 1).all()
    assert sorted(b.prim_order.tolist()) == list(range(1500))
    e = port_sah.build_sah(lo[:0], hi[:0])
    assert e.count.tolist() == empty_bvh_np().count.tolist()


def _assert_scene_bytes_equal(a, b):
    assert (a.fan, a.num_mids, a.num_treelets, a.num_prims) == \
        (b.fan, b.num_mids, b.num_treelets, b.num_prims)
    np.testing.assert_array_equal(a.blocks.view(np.uint32),
                                  b.blocks.view(np.uint32))
    np.testing.assert_array_equal(a.mid_boxes.view(np.uint32),
                                  b.mid_boxes.view(np.uint32))
    np.testing.assert_array_equal(a.tre_boxes.view(np.uint32),
                                  b.tre_boxes.view(np.uint32))


@pytest.mark.parametrize("case", ["sphere64", "soup3000", "single_treelet"])
def test_build_treelet_scene_byte_equal(case):
    if case == "sphere64":
        verts, idx = port_fixtures.triangle_sphere((0, 0, 0), 2.0, 64)
        v = verts[idx]
        v0, v1, v2, fan = v[:, 0], v[:, 1], v[:, 2], 4
    elif case == "soup3000":
        v0, v1, v2 = _soup(3, 3000)
        fan = 8
    else:
        v0, v1, v2 = _soup(4, 40)
        fan = 4
    ids = np.arange(v0.shape[0])
    a = ref_treelets.build_treelet_scene(v0, v1, v2, ids, fan=fan)
    b = port_treelets.build_treelet_scene(v0, v1, v2, ids, fan=fan)
    _assert_scene_bytes_equal(a, b)
    # every real prim id appears exactly once in the leaf pid planes
    rows = [port_treelets.NODE_ROWS + ck * port_treelets.LEAF_FIELDS + f
            for ck in (0, 1) for f in (18, 19)]
    pids = np.concatenate([b.blocks[:, r, :].ravel()
                           for r in rows]).view(np.int32)
    assert sorted(pids[pids >= 0].tolist()) == list(range(v0.shape[0]))


def test_cut_ranges_python_fallback_equal(monkeypatch):
    """Without the native library both packages cut the numpy BVH2."""
    monkeypatch.setattr(ref_treelets, "_cut_ranges_native",
                        lambda lo, hi: None)
    monkeypatch.setattr(port_treelets, "_cut_ranges_native",
                        lambda lo, hi: None)
    v0, v1, v2 = _soup(9, 1800)
    ids = np.arange(1800)
    a = ref_treelets.build_treelet_scene(v0, v1, v2, ids, fan=4)
    b = port_treelets.build_treelet_scene(v0, v1, v2, ids, fan=4)
    _assert_scene_bytes_equal(a, b)
    assert b.num_treelets >= 4


def test_to_device_keeps_bits():
    v0, v1, v2 = _soup(4, 700)
    b = port_treelets.build_treelet_scene(v0, v1, v2, np.arange(700), fan=4)
    ts = b.to_device("cpu")
    assert ts.blocks.shape == (b.num_treelets, port_treelets.BLOCK_ROWS, 128)
    np.testing.assert_array_equal(ts.blocks.numpy().view(np.uint32),
                                  b.blocks.view(np.uint32))
    assert ts.mid_boxes.shape == (b.num_mids, 6)
    assert ts.device_bytes == (b.blocks.nbytes + b.mid_boxes.nbytes
                               + b.tre_boxes.nbytes)
