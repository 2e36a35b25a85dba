"""The compact form of the compressed accel that the port's kernels B4
and B5 read (embree_tpu_torch/traverse/cbvh_kernel.py::pack_compact, what
a committed scene holds) against the JAX package's row layout, which
`pack_compressed` reproduces byte for byte (tests/test_torch_cbvh_build.py):

  * every word of a compact top-level row and tile record maps back to
    its word in the rows, the pads are zero, and a record is at most
    1.1 times the bytes a tile uses (a 'leaf' tile at level 1 excepted:
    its three 16-byte aligned sections take 208 bytes for 188), for
    'box', 'leaf' and 'grid' at levels 1-4;
  * the plain walk over the compact form equals the walk over the rows
    on every ray, bit for bit: t, u, v and tile, the counters, closest
    hit and occlusion;
  * a committed scene keeps of a packed accel only its ids and uv
    tables, and `scene.intersect` / `scene.occluded` answer as they do
    when the scene keeps the whole accel."""
import numpy as np
import pytest
import torch

import embree_tpu_torch as ett
from embree_tpu_torch.scene import scene as scene_module
from embree_tpu_torch.traverse import cbvh_kernel as ck
from embree_tpu_torch.verify.fixtures import subdiv_cube


def displ(p, ng, u, v):
    return (p + 0.15 * ng * np.sin(5 * p[..., :1])).astype(np.float32)


def commit(mode, level, keep_accel=False, monkeypatch=None, plane=False):
    """The displaced cube at levels (level, level) in `mode`; with
    `keep_accel` the committed scene keeps the whole accel."""
    s = ett.Scene(ett.Device(
        f"ignore_config_files=1,subdiv_accel=bvh4.compressed.{mode}",
        device="cpu"))
    if plane:
        s.attach(ett.TriangleMesh(
            np.array([[-9, -2, -9], [-9, -2, 9], [9, -2, -9], [9, -2, 9]],
                     np.float32), np.array([[0, 1, 2], [1, 3, 2]])))
    s.attach(ett.SubdivMesh(*subdiv_cube(), displacement=displ))
    s.set_levels(level, level)
    if keep_accel:
        with monkeypatch.context() as mp:
            mp.setattr(scene_module, "ids_only", lambda accel: accel)
            s.commit()
    else:
        s.commit()
    return s


def shell_rays(seed, n):
    rng = np.random.default_rng(seed)
    org = rng.normal(size=(n, 3)).astype(np.float32)
    org = org / np.linalg.norm(org, axis=1, keepdims=True) * 4.0
    d = -org / 4.0 + rng.normal(size=(n, 3)).astype(np.float32) * 0.08
    org[::8] *= 0.05                 # a few from inside the cube
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return ett.make_rays(org, d.astype(np.float32), device="cpu")


CASES = [(m, lv) for m in ck.MODES for lv in (1, 2, 3, 4)]


@pytest.fixture(scope="module")
def packed():
    """(rows, committed compact form) of the cube in every mode and level;
    the scenes keep the whole accel, from which the rows are packed."""
    mp = pytest.MonkeyPatch()
    out = {}
    for mode, level in CASES:
        s = commit(mode, level, keep_accel=True, monkeypatch=mp)
        out[mode, level] = (ck.pack_compressed(s.committed.compressed),
                            s.committed.compressed_kernel)
    mp.undo()
    return out


def test_record_words_map_back_to_the_rows(packed):
    for mode, level in CASES:
        _record_words_map_back(packed, mode, level)


def _record_words_map_back(packed, mode, level):
    pc, cc = packed[mode, level]
    assert cc.comp_level == level and cc.mode == mode
    assert cc.top_depth == pc.top_depth
    assert torch.equal(cc.tile_of_leaf, pc.tile_of_leaf)
    rows = {k: getattr(pc, k).numpy().view(np.uint32)
            for k in ("topnodes", "theader", "tnodes", "tleaf")}
    top = cc.topnodes.numpy().view(np.uint32)
    np.testing.assert_array_equal(top, rows["topnodes"][:, :ck.TOP_WORDS])
    rec = cc.tiles.numpy().view(np.uint32)
    T = pc.num_tiles
    words, node_ofs, leaf_ofs = ck.tile_layout(level, mode)
    assert rec.shape == (T, words) and words % 4 == 0
    assert node_ofs % 4 == 0 and leaf_ofs % 4 == 0
    g = 1 << level
    elems = (4 ** level - 1) // 3
    used = np.zeros(words, bool)
    for k in range(ck.HEADER_WORDS):
        np.testing.assert_array_equal(rec[:, k], rows["theader"][:, k])
        used[k] = True
    for k in range(elems):
        np.testing.assert_array_equal(rec[:, node_ofs + k],
                                      rows["tnodes"][:, k])
        used[node_ofs + k] = True
    payload = {"box": 0, "leaf": g * g // 2, "grid": 3 * (g + 1) ** 2}[mode]
    if mode == "leaf":
        src = rows["tleaf"]
    else:
        src = pc.tgrid.numpy().view(np.uint32).reshape(T, -1)
    for k in range(payload):
        np.testing.assert_array_equal(rec[:, leaf_ofs + k], src[:, k])
        used[leaf_ofs + k] = True
    assert not rec[:, ~used].any()
    used_bytes = 4 * (ck.HEADER_WORDS + elems) + (
        {"box": 0, "leaf": 2 * g * g, "grid": 12 * (g + 1) ** 2}[mode])
    ratio = 4 * words / used_bytes
    assert ratio <= (208 / 188 if (mode, level) == ("leaf", 1) else 1.1)


def test_walk_over_compact_form_equals_walk_over_rows(packed):
    for mode, level in CASES:
        _walks_agree(packed, mode, level)


def _walks_agree(packed, mode, level):
    pc, cc = packed[mode, level]
    rays = shell_rays(level, 96)
    tf = rays.tfar.clone()
    tf[3::11] = 2.5                  # some rays start from a finite t
    rays = rays._replace(tfar=tf)
    a = ck.cbvh_plain(cc, rays, stats=True)
    b = ck.cbvh_plain(pc, rays, stats=True)
    for x, y in zip(a[:4], b[:4]):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))
    assert a[4] == b[4] and a[4]["dropped_pushes"] == 0
    assert a[4]["tiles_entered"] > 0 and int((a[3] >= 0).sum()) > 20
    oa = ck.cbvh_occluded_plain(cc, rays, stats=True)
    ob = ck.cbvh_occluded_plain(pc, rays, stats=True)
    assert torch.equal(oa[0], ob[0]) and oa[1] == ob[1]
    # the wrappers take the compact form on the CPU as well
    assert torch.equal(ck.cbvh_trace(cc, rays)[3], a[3])


def test_the_cuda_kernels_refuse_the_rows(packed):
    """Only the plain versions walk the rows: on a device other than the
    CPU the wrappers ask for the compact form (a 'meta' tensor stands in
    for a CUDA one here)."""
    pc, cc = packed["leaf", 3]
    rays = ett.Rays(*(torch.zeros(s, device="meta")
                      for s in ((4, 3), (4, 3), (4,), (4,))))

    def on_meta(p):
        return p._replace(**{k: v.to("meta") for k, v in p._asdict().items()
                             if isinstance(v, torch.Tensor)})
    with pytest.raises(ValueError, match="compact"):
        ck._checked_inputs(on_meta(pc), rays)
    ck._checked_inputs(on_meta(cc), rays)


@pytest.mark.parametrize("mode", ["leaf", "grid"])
def test_committed_scene_answers_the_same_after_the_drop(mode, monkeypatch):
    kept = commit(mode, 4, keep_accel=True, monkeypatch=monkeypatch,
                  plane=True)
    slim = commit(mode, 4, plane=True)
    ck_, cs_ = kept.committed, slim.committed
    assert ck_.compressed.top is not None and cs_.compressed.top is None
    t = cs_.compressed.tiles
    assert t.space is None and t.nodes is None and t.leaf_z is None
    assert t.grid is None and t.num_tiles == ck_.compressed.tiles.num_tiles
    for k in ("geom_id", "prim_id", "uv0", "uvd"):
        assert torch.equal(getattr(t, k), getattr(ck_.compressed.tiles, k))
    assert scene_module._scene_bytes(cs_) < scene_module._scene_bytes(ck_)
    rays = shell_rays(7, 200)
    a, b = slim.intersect(rays), kept.intersect(rays)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert 0 < int(a.valid.sum()) < 200
    assert torch.equal(slim.occluded(rays), kept.occluded(rays))
