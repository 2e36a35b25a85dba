"""The port's host build of the compressed accel (embree_tpu_torch/build/
cbvh.py, scene/subdiv_accel.py, traverse/cbvh_kernel.py::pack_compressed,
convert.py) against the JAX package's on the same numpy inputs: every
array byte-equal (both are the same numpy arithmetic)."""
import numpy as np
import pytest
import torch

import embree_tpu_torch as ett
from embree_tpu.build import cbvh as ref_cbvh
from embree_tpu.render import noise as ref_noise
from embree_tpu.scene import subdiv_accel as ref_sa
from embree_tpu.scene.geometry import SubdivMesh as RefSubdivMesh
from embree_tpu.traverse import pallas_cbvh as ref_pc
from embree_tpu_torch.build import cbvh
from embree_tpu_torch.convert import compressed_accel_from_reference
from embree_tpu_torch.render import noise
from embree_tpu_torch.scene import subdiv_accel as sa
from embree_tpu_torch.traverse import cbvh_kernel as ck
from embree_tpu_torch.verify.fixtures import subdiv_cube
from test_torch_build import reference_native  # noqa: F401,E402

MODES = ("box", "leaf", "grid", "full")
FLAVORS = ("com", "non", "mid")


def same_bytes(a, b, what):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, \
        f"{what}: {a.dtype}{a.shape} vs {b.dtype}{b.shape}"
    assert a.tobytes() == b.tobytes(), what


def same_tiles(ref, got):
    for k in cbvh.CompressedTiles.ARRAYS:
        same_bytes(getattr(ref, k), getattr(got, k), f"tiles.{k}")
    assert (ref.comp_level, ref.mode, ref.flavor) == \
        (got.comp_level, got.mode, got.flavor)


def random_tiles(rng, T, comp_level):
    g = 1 << comp_level
    i, j = np.meshgrid(np.arange(g + 1), np.arange(g + 1), indexing="ij")
    base = np.stack([i / g, j / g, np.zeros_like(i, float)], -1)
    tv = base[None] + rng.uniform(-0.02, 0.02, (T, g + 1, g + 1, 3))
    tv[..., 2] += 0.1 * np.sin(3 * tv[..., 0]) * np.cos(2 * tv[..., 1])
    rot = np.linalg.qr(rng.normal(size=(T, 3, 3)))[0]
    tv = np.einsum("tij,txyj->txyi", rot, tv) + rng.uniform(-2, 2, (T, 1, 1, 3))
    und = tv - rng.uniform(0, 0.01, tv.shape)
    return tv.astype(np.float32), und.astype(np.float32)


@pytest.mark.parametrize("flavor", FLAVORS)
@pytest.mark.parametrize("mode", MODES)
def test_build_compressed_tiles_byte_equal(mode, flavor):
    rng = np.random.default_rng(11)
    T, cl = 5, 2
    tv, und = random_tiles(rng, T, cl)
    uv0 = rng.uniform(0, 0.5, (T, 2)).astype(np.float32)
    uvd = np.full((T, 2), 0.5, np.float32)
    gid = np.arange(T, dtype=np.int64) % 2
    pid = np.arange(T, dtype=np.int64)
    ref = ref_cbvh.build_compressed_tiles(tv, und, uv0, uvd, gid, pid, cl,
                                          mode, flavor=flavor)
    got = cbvh.build_compressed_tiles(tv, und, uv0, uvd, gid, pid, cl, mode,
                                      flavor=flavor, device="cpu")
    same_tiles(ref.tiles, got.tiles)
    same_bytes(ref.world_lower, got.world_lower, "world_lower")
    same_bytes(ref.world_upper, got.world_upper, "world_upper")
    assert got.tiles.num_tiles == T


def test_flavor_node_bytes():
    """com 4 bytes a node, non 8, mid 2 (compressed_node.h:241-396)."""
    rng = np.random.default_rng(1)
    g = 4
    tv = rng.uniform(0, 1, (3, g + 1, g + 1, 3)).astype(np.float32)
    tv[..., 2] *= 0.1
    uv0 = np.zeros((3, 2), np.float32)
    uvd = np.ones((3, 2), np.float32)
    gid = np.zeros(3, np.int64)
    pid = np.arange(3, dtype=np.int64)
    for flavor, width in (("com", 4), ("non", 8), ("mid", 2)):
        r = cbvh.build_compressed_tiles(tv, None, uv0, uvd, gid, pid, 2,
                                        "box", flavor=flavor)
        assert r.tiles.nodes.shape[-1] == width
        assert r.tiles.flavor == flavor
        vals = r.tiles.nodes.numpy()
        assert (vals >= 0).all() and (vals <= 255).all()
    with pytest.raises(ValueError):
        cbvh.build_compressed_tiles(tv, None, uv0, uvd, gid, pid, 2, "pizza")
    with pytest.raises(ValueError):
        cbvh.build_compressed_tiles(tv, None, uv0, uvd, gid, pid, 3, "box")


def test_tables_and_morton_helpers():
    for name in ("TABLE_BORDER", "TABLE_MID", "TABLE_Z"):
        same_bytes(getattr(ref_cbvh, name), getattr(cbvh, name), name)
    codes = np.arange(256, dtype=np.uint32)
    x, y = cbvh.morton2_decode(codes)
    np.testing.assert_array_equal(cbvh.morton2_encode(x, y), codes)
    assert cbvh.lookup_idx(cbvh.TABLE_BORDER, np.float32(0.004)) == 0
    assert cbvh.lookup_idx(cbvh.TABLE_BORDER, np.float32(0.005)) == 1
    assert cbvh.lookup_idx(cbvh.TABLE_BORDER, np.float32(0.7)) == 7
    assert cbvh.lookup_idx(cbvh.TABLE_MID, np.float32(0.505)) == 4
    src = np.array([[[0, 0], [2, 0], [0, 1], [2.5, 1.5]]], np.float32)
    dst = np.array([[[-1, -1], [1, -1], [-1, 1], [1, 1]]], np.float32)
    for a, b in zip(ref_cbvh.homography_from_4pts(src, dst),
                    cbvh.homography_from_4pts(src, dst)):
        same_bytes(a, b, "homography")


def displ(p, ng, u, v):
    return (p + 0.15 * ng * np.sin(5 * p[..., :1])).astype(np.float32)


def both_accels(mode, flavor="com", levels=(3, 2), displacement=None):
    verts, counts, indices = subdiv_cube()
    ref = ref_sa.build_compressed_accel(
        [(3, RefSubdivMesh(verts, counts, indices,
                           displacement=displacement))],
        levels[0], levels[1], mode, flavor=flavor)
    got = sa.build_compressed_accel(
        [(3, ett.SubdivMesh(verts, counts, indices,
                            displacement=displacement))],
        levels[0], levels[1], mode, flavor=flavor, device="cpu")
    return ref, got


@pytest.mark.parametrize("mode,flavor,levels,displacement", [
    ("leaf", "com", (3, 2), None), ("box", "non", (2, 2), None),
    ("grid", "com", (3, 3), displ), ("full", "mid", (3, 2), displ)])
def test_build_compressed_accel_byte_equal(mode, flavor, levels,
                                           displacement):
    ref, got = both_accels(mode, flavor, levels, displacement)
    same_tiles(ref[0].tiles, got[0].tiles)
    for k in ("lower", "upper", "child", "count", "prim_order"):
        same_bytes(getattr(ref[0].top, k), getattr(got[0].top, k), f"top.{k}")
    ev_r, ev_g = ref[1][3], got[1][3]
    for k in ("verts", "normals", "grids", "patch_of_face",
              "patches_per_face"):
        same_bytes(getattr(ev_r, k), getattr(ev_g, k), f"eval.{k}")
    assert ev_r.grid_res == ev_g.grid_res
    assert set(got[2]) == {3}
    same_bytes(ref[3], got[3], "world_lo")
    same_bytes(ref[4], got[4], "world_hi")


@pytest.mark.parametrize("mode,levels", [
    ("box", (2, 2)), ("leaf", (3, 3)), ("grid", (3, 2)), ("leaf", (4, 4))])
def test_pack_compressed_byte_equal(mode, levels):
    ref, got = both_accels(mode, levels=levels)
    rp = ref_pc.pack_compressed(ref[0])
    gp = ck.pack_compressed(got[0])
    for k in ("topnodes", "theader", "tnodes", "tleaf", "tile_of_leaf"):
        same_bytes(getattr(rp, k), getattr(gp, k), k)
    if mode == "grid":
        same_bytes(rp.tgrid, gp.tgrid, "tgrid")
    else:  # the reference allocates zeros here; the port uploads nothing
        assert not np.asarray(rp.tgrid).any()
        assert tuple(gp.tgrid.shape) == (0, 8, 128)
    assert (gp.comp_level, gp.mode) == (rp.comp_level, rp.mode)
    assert gp.top_depth >= 1 and gp.num_tiles == got[0].tiles.num_tiles


def test_pack_compressed_refuses_full():
    _ref, got = both_accels("full")
    assert ck.pack_compressed(got[0]) is None


def test_compressed_accel_from_reference_round_trip():
    ref, got = both_accels("leaf", levels=(3, 2), displacement=displ)
    arrays = {f"top.{k}": np.asarray(getattr(ref[0].top, k))
              for k in ("lower", "upper", "child", "count", "prim_order")}
    arrays.update({f"tiles.{k}": np.asarray(getattr(ref[0].tiles, k))
                   for k in cbvh.CompressedTiles.ARRAYS})
    arrays.update({"tiles.comp_level": ref[0].tiles.comp_level,
                   "tiles.mode": ref[0].tiles.mode,
                   "tiles.flavor": ref[0].tiles.flavor})
    conv = compressed_accel_from_reference(arrays, "cpu")
    same_tiles(got[0].tiles, conv.tiles)
    for k in ("lower", "upper", "child", "count", "prim_order"):
        same_bytes(getattr(got[0].top, k).numpy(), getattr(conv.top, k),
                   f"top.{k}")
    back = ck.accel_arrays(conv)
    for k, v in back.items():
        same_bytes(arrays[k], v, k)
    arrays["top.prim_order"] = arrays["top.prim_order"][:-1]
    with pytest.raises(ValueError):
        compressed_accel_from_reference(arrays, "cpu")


def test_degenerate_cage_face_gives_oversized_tiles_in_both_packages():
    """A cage face with an edge of length 0 (the pole faces of
    quad_sphere) gets a degenerate frame, and its tiles world boxes as
    large as the whole sphere: a fault of the build that the port
    reproduces byte for byte (ROADMAP.md C). Rays far from such a tile
    still reach its box, so the conservative occlusion says yes to them."""
    from embree_tpu_torch.verify.fixtures import quad_sphere
    verts, quads = quad_sphere((0, 0, 0), 2.0, 16)
    counts = np.full(len(quads), 4, np.int32)
    ref = ref_sa.build_compressed_accel(
        [(0, RefSubdivMesh(verts, counts, quads.reshape(-1)))], 3, 2, "leaf")
    got = sa.build_compressed_accel(
        [(0, ett.SubdivMesh(verts, counts, quads.reshape(-1)))], 3, 2, "leaf",
        device="cpu")
    same_tiles(ref[0].tiles, got[0].tiles)
    for k in ("lower", "upper", "child", "count", "prim_order"):
        same_bytes(getattr(ref[0].top, k), getattr(got[0].top, k), f"top.{k}")
    top = got[0].top
    diag = (top.upper - top.lower)[top.count > 0].norm(dim=1)
    assert diag.max() > 1.9 and diag.median() < 0.8
    # without the two rows of pole faces no tile is oversized
    open_quads = quads[16:-16]
    open_accel = sa.build_compressed_accel(
        [(0, ett.SubdivMesh(verts, counts[32:], open_quads.reshape(-1)))],
        3, 2, "leaf", device="cpu")[0]
    otop = open_accel.top
    odiag = (otop.upper - otop.lower)[otop.count > 0].norm(dim=1)
    assert odiag.max() < 1.2


def test_noise_matches_reference():
    rng = np.random.default_rng(2)
    p = rng.uniform(-3, 3, (500, 3)).astype(np.float32)
    same_bytes(ref_noise.noise3(p), noise.noise3(p), "noise3")
    same_bytes(ref_noise.fbm_displacement(p), noise.fbm_displacement(p),
               "fbm_displacement")
    tp, tg = noise.noise_tables()
    assert tp.shape == (513,) and tg.shape == (128, 3)
