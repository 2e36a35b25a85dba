"""The port's compressed traversal (embree_tpu_torch/traverse/cbvh.py and
cbvh_kernel.py: the plain versions of the two kernels and the torch-op
traversal of mode `full` and flavors `non` / `mid`) against the JAX
package's XLA path (`isa="xla"`, embree_tpu/traverse/cbvh.py) on the same
numpy rays and byte-equal tiles. The JAX package's Pallas kernels in
interpret mode are held in tests/test_torch_cbvh_interpret.py.

Tolerances: valid masks and geom_id equal; t 1e-5 absolute (XLA:CPU
contracts products into FMAs, the port rounds every product); u, v 1e-4
absolute except in `box` mode, where uv derives from the entry point of
whichever box was visited first (the JAX package's own test skips it);
prim_id (the base face) and uv may differ only where two tiles or two
overlapping leaf slabs tie on t, because the JAX package orders visits by
the nearest ray of a packet and the port by the ray's own distance: such
rays are counted and bounded at 2 % (one ray of 64)."""
import numpy as np
import pytest
import torch

import embree_tpu as et
import embree_tpu_torch as ett
from embree_tpu_torch.traverse import cbvh
from embree_tpu_torch.scene import scene as scene_module
from embree_tpu_torch.traverse import cbvh_kernel as ck
from embree_tpu_torch.verify.fixtures import subdiv_cube
from test_torch_build import reference_native  # noqa: F401,E402

LEVELS = (2, 2)
N_RAYS = 64
T_ATOL = 1e-5
UV_ATOL = 1e-4


def rays_np(seed=0x5EED, n=N_RAYS):
    """Rays from a shell aimed at the cube, a few from inside it."""
    rng = np.random.default_rng(seed)
    org = rng.normal(size=(n, 3)).astype(np.float32)
    org = org / np.linalg.norm(org, axis=1, keepdims=True) * 4.0
    d = -org / 4.0 + rng.normal(size=(n, 3)).astype(np.float32) * 0.05
    org[::8] *= 0.05
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return org, d.astype(np.float32)


def cfg(mode, flavor="com"):
    return ("ignore_config_files=1,"
            f"subdiv_accel=bvh4.compressed.{mode},compressed_node={flavor}")


def ref_scene(mode, flavor="com", levels=LEVELS):
    verts, counts, indices = subdiv_cube()
    s = et.Scene(et.Device(cfg(mode, flavor)))
    s.attach(et.SubdivMesh(verts, counts, indices))
    s.set_levels(*levels)
    s.commit()
    return s


def port_scene(mode, flavor="com", levels=LEVELS, displacement=None):
    verts, counts, indices = subdiv_cube()
    s = ett.Scene(ett.Device(cfg(mode, flavor), device="cpu"))
    s.attach(ett.SubdivMesh(verts, counts, indices,
                            displacement=displacement))
    s.set_levels(*levels)
    s.commit()
    return s


def assert_hits_agree(ref, got, mode):
    """`ref` are the JAX package's Hits, `got` the port's."""
    rv, gv = np.asarray(ref.valid), got.valid.numpy()
    np.testing.assert_array_equal(rv, gv)
    assert rv.sum() > N_RAYS // 2
    np.testing.assert_array_equal(np.asarray(ref.geom_id), got.geom_id.numpy())
    np.testing.assert_allclose(got.t.numpy()[rv], np.asarray(ref.t)[rv],
                               atol=T_ATOL, rtol=0)
    assert np.isinf(got.t.numpy()[~rv]).all()
    differ = np.asarray(ref.prim_id) != got.prim_id.numpy()
    if mode not in ("box", "full"):
        differ |= np.abs(got.u.numpy() - np.asarray(ref.u)) > UV_ATOL
        differ |= np.abs(got.v.numpy() - np.asarray(ref.v)) > UV_ATOL
    assert differ[rv].mean() <= 0.02, \
        f"prim_id or uv differ on {differ[rv].mean():.1%} of the hits"
    assert (got.u.numpy()[rv] >= -1e-4).all() and (got.u.numpy() <= 1 + 1e-4).all()
    assert (got.v.numpy()[rv] >= -1e-4).all() and (got.v.numpy() <= 1 + 1e-4).all()
    ng = got.ng.numpy()
    np.testing.assert_array_equal(ng[rv], np.broadcast_to([1.0, 0, 0],
                                                          ng[rv].shape))
    np.testing.assert_array_equal(ng[~rv], 0.0)
    assert (got.gprim.numpy() == -1).all()


@pytest.mark.parametrize("mode,flavor", [
    ("box", "com"), ("leaf", "com"), ("grid", "com"),      # the kernels' modes
    ("full", "com"), ("box", "non"), ("leaf", "mid")])     # torch ops only
def test_closest_hit_matches_xla_path(mode, flavor):
    org, d = rays_np()
    ref = et.scene_intersect(ref_scene(mode, flavor).committed,
                             et.make_rays(org, d), isa="xla")
    sc = port_scene(mode, flavor)
    kernel_served = flavor == "com" and mode != "full"
    assert (sc.committed.compressed_kernel is not None) == kernel_served
    before = dict(ck.launches)
    got = sc.intersect(ett.make_rays(org, d, device="cpu"))
    assert ck.launches == before      # CPU tensors: the plain version
    assert_hits_agree(ref, got, mode)


@pytest.mark.parametrize("mode,flavor", [("leaf", "com"), ("box", "non")])
def test_occluded_matches_xla_path(mode, flavor):
    org, d = rays_np(seed=7)
    d[1::8] *= -1.0       # some rays point away from the cube
    ref = np.asarray(et.scene_occluded(ref_scene(mode, flavor).committed,
                                       et.make_rays(org, d), isa="xla"))
    sc = port_scene(mode, flavor)
    rays = ett.make_rays(org, d, device="cpu")
    got = sc.occluded(rays)
    np.testing.assert_array_equal(ref, got.numpy())
    assert ref.any() and not ref.all()
    # conservative: every closest hit is occluded
    assert (got | ~sc.intersect(rays).valid).all()


def displ(p, ng, u, v):
    return (p + 0.15 * ng * np.sin(5 * p[..., :1])).astype(np.float32)


@pytest.fixture(scope="module")
def leaf43():
    """A displaced cube at levels (4, 3) in every kernel mode, port only."""
    return {m: port_scene(m, levels=(4, 3), displacement=displ)
            for m in ck.MODES}


@pytest.fixture(scope="module")
def leaf43_accels():
    """The unpacked accels of `leaf43`'s scenes, which a committed scene
    drops once it has packed them (`scene.ids_only` patched to the
    identity keeps them)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(scene_module, "ids_only", lambda accel: accel)
        return {m: port_scene(m, levels=(4, 3),
                              displacement=displ).committed.compressed
                for m in ck.MODES}


@pytest.mark.parametrize("mode", ck.MODES)
def test_answer_independent_of_ray_order_and_batch_split(leaf43, mode,
                                                         monkeypatch):
    pc = leaf43[mode].committed.compressed_kernel
    org, d = rays_np(seed=3, n=96)
    rays = ett.make_rays(org, d, device="cpu")
    whole = ck.cbvh_plain(pc, rays, stats=True)
    perm = torch.from_numpy(np.random.default_rng(1).permutation(96))
    shuffled = ck.cbvh_plain(pc, ett.Rays(*(a[perm].contiguous()
                                            for a in rays)))
    for a, b in zip(whole[:4], shuffled):
        assert torch.equal(a[perm], b)
    monkeypatch.setattr(cbvh, "PLAIN_CHUNK", 20)
    split = ck.cbvh_plain(pc, rays, stats=True)
    for a, b in zip(whole[:4], split[:4]):
        assert torch.equal(a, b)
    assert whole[4] == split[4]
    st = whole[4]
    assert st["dropped_pushes"] == 0 and st["rays"] == 96
    assert st["tiles_entered"] > 0 and st["leaf_tests"] > 0
    assert 0 < st["tiles_touched"] <= pc.num_tiles
    occ = ck.cbvh_occluded_plain(pc, rays)
    assert torch.equal(occ[perm], ck.cbvh_occluded_plain(
        pc, ett.Rays(*(a[perm].contiguous() for a in rays))))
    assert (occ | (whole[3] < 0)).all()


def test_packed_and_unpacked_sources_agree_bit_for_bit(leaf43,
                                                       leaf43_accels):
    """The plain version of the kernel (the compact form a scene commits)
    and the torch-op traversal (unpacked tiles) decode the same 'com'
    nodes."""
    org, d = rays_np(seed=5, n=96)
    rays = ett.make_rays(org, d, device="cpu")
    for mode in ck.MODES:
        cs = leaf43[mode].committed
        full = leaf43_accels[mode]
        assert full.top is not None
        a = ck.intersect_compressed_kernel(cs.compressed_kernel, rays)
        b = cbvh.intersect_compressed(full, rays)
        for x, y in zip(a, b):
            assert torch.equal(x, y), mode
        assert torch.equal(
            ck.occluded_compressed_kernel(cs.compressed_kernel, rays),
            cbvh.occluded_compressed(full, rays))


def test_t_in_and_retired_rays(leaf43):
    pc = leaf43["leaf"].committed.compressed_kernel
    org, d = rays_np(seed=9)
    rays = ett.make_rays(org, d, device="cpu")
    t, _u, _v, tile, _ = ck.cbvh_trace(pc, rays)
    hit = tile >= 0
    assert hit.sum() > 30
    # a ray that starts from a t in front of its hit finds nothing
    t_in = torch.where(hit, t * 0.5, t)
    t2, _u, _v, tile2, st = ck.cbvh_trace(pc, rays, t_in, stats=True)
    assert (tile2 < 0).all() and torch.equal(t2, t_in)
    # just behind the hit: the same tile; t moves a little, because the
    # projected ray is fitted between the frustum entry and min(exit, t)
    t3, _u, _v, tile3, _ = ck.cbvh_trace(pc, rays, t * 1.001 + 1e-3)
    same = tile3 == tile
    assert same.float().mean() > 0.9 and (tile3 >= 0)[hit].all()
    np.testing.assert_allclose(t3[hit & same].numpy(),
                               t[hit & same].numpy(), atol=5e-2)
    # a retired ray (tfar = -inf) costs one top-level node visit
    dead = rays._replace(tfar=torch.full_like(rays.tfar, -np.inf))
    _t, _u, _v, tile4, st = ck.cbvh_trace(pc, dead, stats=True)
    assert (tile4 < 0).all() and st["top_nodes"] == N_RAYS
    assert st["tiles_entered"] == 0
    assert not ck.occluded_compressed_kernel(pc, dead).any()


def test_wrappers_reject_what_the_kernels_do_not_take(leaf43):
    pc = leaf43["box"].committed.compressed_kernel
    org, d = rays_np()
    rays = ett.make_rays(org, d, device="cpu")
    with pytest.raises(ValueError, match="dtype"):
        ck.cbvh_trace(pc, rays._replace(org=rays.org.double()))
    with pytest.raises(ValueError, match="shape"):
        ck.cbvh_trace(pc, rays._replace(dir=rays.dir[:5]))
    with pytest.raises(ValueError, match="contiguous"):
        ck.cbvh_occluded_trace(pc, rays._replace(
            tfar=rays.tfar[:1].expand(N_RAYS)))
    with pytest.raises(ValueError, match="mode"):
        ck.cbvh_trace(pc._replace(mode="full"), rays)
    with pytest.raises(ValueError, match="level"):
        ck.cbvh_trace(pc._replace(comp_level=5), rays)
    with pytest.raises(ValueError, match="levels"):
        ck.cbvh_trace(pc._replace(top_depth=65), rays)
    with pytest.raises(ValueError, match="tgrid"):
        ck.cbvh_trace(pc._replace(mode="grid"), rays)
