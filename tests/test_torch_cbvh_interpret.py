"""The port's plain versions of the two compressed kernels
(embree_tpu_torch/traverse/cbvh_kernel.py) against the JAX package's
Pallas kernels (embree_tpu/traverse/pallas_cbvh.py: `_make_kernel` for
closest hit, `_occl_kernel` for occlusion) run in interpret mode
(`isa="pallas"` on the CPU), on the same numpy rays. Each of the four
interpret-mode traces costs about half a minute, so each runs once, in a
module fixture, and every assertion reads that result; the port traces
the reference's own tiles, carried over by `convert.py`, as well as the
tiles it builds itself. This file traces `box` mode and occlusion;
test_torch_cbvh_interpret_leaf.py and test_torch_cbvh_interpret_grid.py
collect the same four closest-hit tests with a `traced` fixture of
their own mode (no port test file holds more than five tests).

Tolerances as in tests/test_torch_cbvh.py: valid and geom_id equal, t
1e-5 absolute, u and v 1e-4 absolute except in `box` mode, prim_id and uv
allowed to differ on at most 2 % of the hits (equal-t ties between tiles
or overlapping leaf slabs, which the two visit orders resolve
differently); occlusion equal."""
import numpy as np
import pytest
import torch

import embree_tpu as et
import embree_tpu_torch as ett
from embree_tpu_torch.build.cbvh import CompressedTiles
from embree_tpu_torch.convert import compressed_accel_from_reference
from embree_tpu_torch.traverse import cbvh
from embree_tpu_torch.traverse import cbvh_kernel as ck
from embree_tpu_torch.verify.fixtures import subdiv_cube
from test_torch_build import reference_native  # noqa: F401,E402

LEVELS = (2, 2)
N_RAYS = 48
T_ATOL = 1e-5
UV_ATOL = 1e-4


def rays_np():
    rng = np.random.default_rng(0x5EED)
    org = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    org = org / np.linalg.norm(org, axis=1, keepdims=True) * 4.0
    d = -org / 4.0 + rng.normal(size=(N_RAYS, 3)).astype(np.float32) * 0.05
    d[5::12] *= -1.0      # a few rays point away from the cube
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return org, d.astype(np.float32)


def ref_scene(mode):
    verts, counts, indices = subdiv_cube()
    s = et.Scene(et.Device(
        f"ignore_config_files=1,subdiv_accel=bvh4.compressed.{mode}"))
    s.attach(et.SubdivMesh(verts, counts, indices))
    s.set_levels(*LEVELS)
    s.commit()
    return s


def converted_accel(ref_accel):
    arrays = {f"top.{k}": np.asarray(getattr(ref_accel.top, k))
              for k in ("lower", "upper", "child", "count", "prim_order")}
    arrays.update({f"tiles.{k}": np.asarray(getattr(ref_accel.tiles, k))
                   for k in CompressedTiles.ARRAYS})
    arrays.update({"tiles.comp_level": ref_accel.tiles.comp_level,
                   "tiles.mode": ref_accel.tiles.mode,
                   "tiles.flavor": ref_accel.tiles.flavor})
    return compressed_accel_from_reference(arrays, "cpu")


def trace(mode):
    """One interpret-mode trace of the reference's closest-hit kernel and
    the port's answers on the same rays."""
    org, d = rays_np()
    rcs = ref_scene(mode).committed
    assert rcs.compressed_pallas is not None
    ref = et.scene_intersect(rcs, et.make_rays(org, d), isa="pallas")
    ref = {k: np.asarray(getattr(ref, k))
           for k in ("t", "u", "v", "prim_id", "geom_id")}
    accel = converted_accel(rcs.compressed)
    pc = ck.pack_compressed(accel)
    rays = ett.make_rays(org, d, device="cpu")
    st = ck.intersect_compressed_kernel(pc, rays)
    got = cbvh.compressed_hits(accel, rays, st)
    return mode, ref, got, st, pc, rays


@pytest.fixture(scope="module", params=["box"])
def traced(request):
    return trace(request.param)


def test_valid_geom_and_t_match_the_pallas_kernel(traced):
    _mode, ref, got, _st, _pc, _rays = traced
    rv = ref["geom_id"] >= 0
    np.testing.assert_array_equal(rv, got.valid.numpy())
    assert N_RAYS // 2 < rv.sum() < N_RAYS
    np.testing.assert_array_equal(ref["geom_id"], got.geom_id.numpy())
    np.testing.assert_allclose(got.t.numpy()[rv], ref["t"][rv], atol=T_ATOL,
                               rtol=0)
    assert np.isinf(got.t.numpy()[~rv]).all()


def test_prim_and_uv_match_the_pallas_kernel(traced):
    mode, ref, got, _st, _pc, _rays = traced
    rv = ref["geom_id"] >= 0
    differ = ref["prim_id"] != got.prim_id.numpy()
    if mode != "box":
        differ |= np.abs(got.u.numpy() - ref["u"]) > UV_ATOL
        differ |= np.abs(got.v.numpy() - ref["v"]) > UV_ATOL
    # one ray of the 40-odd hits may sit on an equal-t tie
    assert differ[rv].sum() <= 1, \
        f"prim_id or uv differ on {differ[rv].sum()} hits"
    for uv in (got.u.numpy(), got.v.numpy()):
        assert (uv >= -1e-4).all() and (uv <= 1 + 1e-4).all()
        assert (uv[~rv] == 0).all()


def test_port_built_tiles_trace_the_same(traced):
    """A scene committed by the port itself answers as the converted
    reference accel does, bit for bit (the builds are byte-equal)."""
    mode, _ref, got, st, _pc, rays = traced
    verts, counts, indices = subdiv_cube()
    s = ett.Scene(ett.Device(
        f"ignore_config_files=1,subdiv_accel=bvh4.compressed.{mode}",
        device="cpu"))
    s.attach(ett.SubdivMesh(verts, counts, indices))
    s.set_levels(*LEVELS)
    s.commit()
    own = s.intersect(rays)
    for a, b in zip(own, got):
        assert torch.equal(a, b)
    assert torch.equal(own.valid, st.tile >= 0)


def test_counting_walk_leaves_the_answer_unchanged(traced):
    _mode, _ref, _got, st, pc, rays = traced
    t, _u, _v, tile, stats = ck.cbvh_trace(pc, rays, stats=True)
    assert torch.equal(t, st.t) and torch.equal(tile, st.tile)
    assert stats["dropped_pushes"] == 0
    assert stats["tiles_entered"] >= int((tile >= 0).sum())
    assert stats["tiles_touched"] <= pc.num_tiles == 6
    assert stats["nodes_touched"] <= pc.num_nodes


def test_occluded_matches_the_pallas_kernel():
    org, d = rays_np()
    rcs = ref_scene("leaf").committed
    ref = np.asarray(et.scene_occluded(rcs, et.make_rays(org, d),
                                       isa="pallas"))
    pc = ck.pack_compressed(converted_accel(rcs.compressed))
    rays = ett.make_rays(org, d, device="cpu")
    got, stats = ck.cbvh_occluded_trace(pc, rays, stats=True)
    np.testing.assert_array_equal(ref, got.numpy())
    assert ref.any() and not ref.all()
    assert stats["dropped_pushes"] == 0 and stats["top_nodes"] >= N_RAYS
    assert torch.equal(got, ck.occluded_compressed_kernel(pc, rays))
