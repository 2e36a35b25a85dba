"""The compact treelet form the port's treelet kernel reads
(embree_tpu_torch/build/treelets.py::compact_treelets) against the blocks
of the JAX package's own build (embree_tpu/build/treelets.py): every
node, pair, fan and mid word equals, bit for bit, the block word it came
from, on small scenes and on one with a fan above 32 (two words of the
kernel's fan mask), and the pads are zero. Then the plain version over
the compact form (`rowtrace2_plain`) with its counters: the same answer
and the same counts whatever the ray order and batch split, and counts
that agree with what a ray can do. Parity of the answers with the JAX
package's kernel is tests/test_torch_rowtrace*.py's."""
import numpy as np
import pytest
import torch

from embree_tpu.build import treelets as ref_treelets

import embree_tpu_torch as ett
from embree_tpu_torch.build import treelets as port_treelets
from embree_tpu_torch.traverse import rowtrace2 as rt2
from embree_tpu_torch.verify.fixtures import random_triangles, triangle_sphere
from test_torch_build import reference_native  # noqa: F401,E402

NODE_ROWS = port_treelets.NODE_ROWS
LEAF_FIELDS = port_treelets.LEAF_FIELDS


def soup(seed, n, extent, size):
    verts, idx = random_triangles(np.random.default_rng(seed), n,
                                  extent=extent, size=size)
    return np.asarray(verts, np.float32)[np.asarray(idx)]


def sphere(res):
    verts, idx = triangle_sphere((0, 0, 0), 2.0, res)
    return np.asarray(verts, np.float32)[np.asarray(idx)]


SCENES = [("soup 1500, fan 4", lambda: soup(3, 1500, 4.0, 1.0), 4),
          ("sphere 40, fan 1", lambda: sphere(40), 1),
          ("soup 20000, fan 40", lambda: soup(5, 20000, 8.0, 0.5), 40)]


@pytest.fixture(scope="module")
def scenes(reference_native):  # noqa: F811
    """The JAX package's host builds and the port's compact forms of them:
    (reference build, compact words, triangles) a scene."""
    out = []
    for _name, make, fan in SCENES:
        v = make()
        ref = ref_treelets.build_treelet_scene(v[:, 0], v[:, 1], v[:, 2],
                                               np.arange(len(v)), fan=fan)
        arrs = port_treelets.compact_treelets(
            np.asarray(ref.blocks), np.asarray(ref.mid_boxes),
            np.asarray(ref.tre_boxes), ref.fan)
        out.append((ref, {k: a.view(np.uint32) for k, a in arrs.items()}, v))
    return out


def test_node_words_are_block_words(scenes):
    for built in scenes:
        _node_words_are_block_words(built)


def _node_words_are_block_words(built):
    ref, c, _v = built
    blocks = np.asarray(ref.blocks).view(np.uint32)
    N = ref.num_treelets
    assert c["nodes"].shape == (N, port_treelets.N_INNER, NODE_ROWS)
    t, slot, w = np.meshgrid(np.arange(N), np.arange(port_treelets.N_INNER),
                             np.arange(NODE_ROWS), indexing="ij")
    # word a*4+c of slot i is row a*4+c, lane i of the block
    np.testing.assert_array_equal(c["nodes"], blocks[t, w, slot])


def test_pair_words_are_block_words(scenes):
    for built in scenes:
        _pair_words_are_block_words(built)


def _pair_words_are_block_words(built):
    ref, c, v = built
    blocks = np.asarray(ref.blocks).view(np.uint32)
    N = ref.num_treelets
    assert c["pairs"].shape == (N, port_treelets.N_PAIRS, LEAF_FIELDS)
    t, p, f = np.meshgrid(np.arange(N), np.arange(port_treelets.N_PAIRS),
                          np.arange(LEAF_FIELDS), indexing="ij")
    # pairs 0..127 in rows 12..31, pairs 128..255 in rows 32..51
    rows = NODE_ROWS + (p >> 7) * LEAF_FIELDS + f
    np.testing.assert_array_equal(c["pairs"], blocks[t, rows, p & 127])
    # every prim id once among the pairs' id words
    pids = c["pairs"][:, :, 18:20].view(np.int32).ravel()
    assert sorted(pids[pids >= 0].tolist()) == list(range(len(v)))


def test_box_words_are_block_words_and_pads_zero(scenes):
    for built in scenes:
        _box_words_are_block_words_and_pads_zero(built)


def _box_words_are_block_words_and_pads_zero(built):
    ref, c, _v = built
    M, fan = ref.num_mids, ref.fan
    tre = np.asarray(ref.tre_boxes).view(np.uint32)
    mid = np.asarray(ref.mid_boxes).view(np.uint32).reshape(M, 6)
    assert c["fan_boxes"].shape == (M * fan, port_treelets.BOX_WORDS)
    assert c["mid_boxes"].shape == (M, port_treelets.BOX_WORDS)
    for m in range(M):
        for b in range(fan):
            np.testing.assert_array_equal(c["fan_boxes"][m * fan + b, :6],
                                          tre[m, :, b])
    np.testing.assert_array_equal(c["mid_boxes"][:, :6], mid)
    assert not c["fan_boxes"][:, 6:].any() and not c["mid_boxes"][:, 6:].any()
    if fan > 32:
        # a real treelet behind the first word of the kernel's fan mask
        lo = c["fan_boxes"][:, :3].view(np.float32)
        assert np.isfinite(lo.reshape(M, fan, 3)[:, 32:]).any()


def test_compact_scene_is_smaller_than_the_blocks(scenes):
    for built in scenes:
        _compact_scene_is_smaller_than_the_blocks(built)


def _compact_scene_is_smaller_than_the_blocks(built):
    ref, c, _v = built
    compact = sum(a.nbytes for a in c.values())
    blocks = sum(np.asarray(a).nbytes
                 for a in (ref.blocks, ref.mid_boxes, ref.tre_boxes))
    assert compact < blocks
    ts = port_treelets.TreeletSceneNP(
        np.asarray(ref.blocks), np.asarray(ref.mid_boxes).reshape(-1, 6),
        np.asarray(ref.tre_boxes), ref.fan, ref.num_mids, ref.num_treelets,
        ref.num_prims).to_device("cpu")
    assert ts.device_bytes == compact
    for k, a in c.items():
        np.testing.assert_array_equal(getattr(ts, k).numpy().view(np.uint32),
                                      a)


def test_plain_counters_do_not_depend_on_order_or_split(scenes, monkeypatch):
    for built in scenes:
        _plain_counters(built, monkeypatch)


def _plain_counters(built, monkeypatch):
    ref, _c, _v = built
    ts = port_treelets.TreeletSceneNP(
        np.asarray(ref.blocks), np.asarray(ref.mid_boxes).reshape(-1, 6),
        np.asarray(ref.tre_boxes), ref.fan, ref.num_mids, ref.num_treelets,
        ref.num_prims).to_device("cpu")
    rng = np.random.default_rng(11)
    n = 300
    org = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = ett.make_rays(org, d, device="cpu")
    perm = torch.from_numpy(rng.permutation(n))
    shuffled = ett.Rays(*(a[perm].contiguous() for a in rays))
    for occluded in (False, True):
        t, p, st = rt2.rowtrace2_plain(ts, rays, occluded, stats=True)
        t0, p0 = rt2.rowtrace2_plain(ts, rays, occluded)
        assert torch.equal(t, t0) and torch.equal(p, p0)
        ts_, ps_, st_s = rt2.rowtrace2_plain(ts, shuffled, occluded,
                                             stats=True)
        assert torch.equal(t[perm], ts_) and torch.equal(p[perm], ps_)
        assert st_s == st
        with monkeypatch.context() as mp:
            mp.setattr(rt2, "PLAIN_CHUNK", 64)
            assert rt2.rowtrace2_plain(ts, rays, occluded,
                                       stats=True)[2] == st
        assert st["rays"] == n
        # a walked treelet visits its root; a touched one was walked
        assert st["node_visits"] >= st["treelets_walked"] > 0
        assert 0 < st["treelets_touched"] <= min(st["treelets_walked"],
                                                 ts.num_treelets)
        assert st["mids_entered"] <= n * ts.num_mids
        hits = (t == -np.inf) if occluded else (p >= 0)
        assert 0 < int(hits.sum()) < n
        assert st["pair_tests"] >= int(hits.sum())
