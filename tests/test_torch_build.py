"""Host-side build of the PyTorch port against the JAX package: the
numpy modules the port copied give the same arrays bit for bit on the
same inputs.

`reference_native` is the module fixture the other port test files
import: it makes sure the JAX package's native SAH builder is loaded in
this process. That package compiles `native/libet_sah.so` in place at
first use; a test process that loads the file while another one still
writes it marks the library failed and from then on builds every BVH
with its numpy builder, silently, so a comparison of BVH-dependent
arrays between the two packages would compare different trees."""
import os
import subprocess

import numpy as np
import pytest

from embree_tpu.build import native as ref_native
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


def ensure_reference_native(mp: pytest.MonkeyPatch, tmp_dir) -> None:
    """Load the JAX package's native SAH library; where its own loader
    failed, build the library privately into `tmp_dir` (a temporary file
    renamed into place) and point the loader there through `mp`."""
    if ref_native._load() is not None:
        return
    so = os.path.join(str(tmp_dir), "libet_sah.so")
    tmp = f"{so}.{os.getpid()}.tmp"
    subprocess.run(["g++", "-O3", "-march=native", "-std=c++17", "-shared",
                    "-fPIC", "-pthread", ref_native._SRC, "-o", tmp],
                   check=True, capture_output=True)
    os.replace(tmp, so)
    mp.setattr(ref_native, "_SO", so)
    mp.setattr(ref_native, "_failed", False)
    mp.setattr(ref_native, "_lib", None)
    assert ref_native._load() is not None


@pytest.fixture(autouse=True, scope="module")
def reference_native(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        ensure_reference_native(mp, tmp_path_factory.mktemp("ref_native"))
        yield


def test_reference_native_recovers_from_a_failed_load(monkeypatch,
                                                      tmp_path):
    """The loader in the state a half-written library leaves: the fixture
    builds a private library and both builders agree again."""
    monkeypatch.setattr(ref_native, "_failed", True)
    monkeypatch.setattr(ref_native, "_lib", None)
    assert ref_native.build_sah_native(np.zeros((1, 3), np.float32),
                                       np.ones((1, 3), np.float32)) is None
    monkeypatch.setattr(ref_native, "_failed", False)
    monkeypatch.setattr(ref_native, "_SO", str(tmp_path / "absent.so"))
    monkeypatch.setattr(ref_native, "_SRC", str(tmp_path / "absent.cpp"))
    assert ref_native._load() is None      # the loader fails again
    monkeypatch.setattr(ref_native, "_SRC", os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "native", "sah_builder.cpp"))
    ensure_reference_native(monkeypatch, tmp_path)
    assert ref_native._SO == str(tmp_path / "libet_sah.so")
    v0, v1, v2 = _soup(12, 500)
    lo, hi = prim_bounds_np(v0, v1, v2)
    for x, y in zip(build_sah_native(lo, hi, branching=4, max_leaf=16),
                    ref_build_native(lo, hi, branching=4, max_leaf=16)):
        np.testing.assert_array_equal(x, y)


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
    """The device holds the compact form; its words are the blocks' words
    (tests/test_torch_rowtrace_compact.py holds every word to its source)."""
    v0, v1, v2 = _soup(4, 700)
    b = port_treelets.build_treelet_scene(v0, v1, v2, np.arange(700), fan=4)
    ts = b.to_device("cpu")
    N = b.num_treelets
    assert ts.nodes.shape == (N, port_treelets.N_INNER,
                              port_treelets.NODE_ROWS)
    assert ts.pairs.shape == (N, port_treelets.N_PAIRS,
                              port_treelets.LEAF_FIELDS)
    np.testing.assert_array_equal(
        ts.nodes.numpy().view(np.uint32),
        b.blocks[:, :port_treelets.NODE_ROWS,
                 :port_treelets.N_INNER].transpose(0, 2, 1).view(np.uint32))
    assert ts.mid_boxes.shape == (b.num_mids, port_treelets.BOX_WORDS)
    np.testing.assert_array_equal(ts.mid_boxes.numpy()[:, :6].view(np.uint32),
                                  b.mid_boxes.view(np.uint32))
    assert ts.device_bytes == 4 * N * (
        port_treelets.N_INNER * port_treelets.NODE_ROWS
        + port_treelets.N_PAIRS * port_treelets.LEAF_FIELDS
        + port_treelets.BOX_WORDS) + 4 * b.num_mids * port_treelets.BOX_WORDS
    assert ts.device_bytes < b.blocks.nbytes + b.mid_boxes.nbytes \
        + b.tre_boxes.nbytes
