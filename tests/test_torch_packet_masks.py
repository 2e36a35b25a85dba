"""The packet kernel's plain version against the JAX package: backface
culling and origins inside, ray and primitive masks, the stack depth
with no dropped push, and an answer that does not depend on how the
rays are grouped (the tolerances of tests/test_torch_packet.py, whose
helpers these use)."""
import numpy as np
import pytest
import torch

import embree_tpu as et
import embree_tpu_torch as ett
from embree_tpu_torch.traverse import packet_kernel as pk
from embree_tpu_torch.verify.fixtures import random_triangles, triangle_sphere

from test_torch_build import reference_native  # noqa: F401

from test_torch_packet import (  # noqa: F401
    assert_matches, packed, rays_np, ref_committed)


@pytest.mark.parametrize("width", [4, 8])
def test_plain_cull_and_origins_inside(rng, width):
    """triangle_sphere(24) with origins inside and outside, with and
    without backface culling, BVH4 and BVH8."""
    verts, idx = triangle_sphere((0, 0, 0), 2.0, 24)
    accel = "bvh8.triangle4" if width == 8 else "default"
    org, d = rays_np(rng, 400, 3.0)
    ties = 0
    for cull in (0, 1):
        cfg = (f"ignore_config_files=1,backface_culling={cull},"
               f"tri_accel={accel}")
        cs = ref_committed(verts, idx, cfg)
        assert cs.pallas.width == width
        xla = et.scene_intersect(cs, et.make_rays(org, d), isa="xla")
        sc = ett.Scene(ett.Device(cfg, device="cpu"))
        sc.attach(ett.TriangleMesh(verts, idx))
        pcs = sc.commit()
        assert pcs.packet.width == width and pcs.backface_cull == bool(cull)
        port = pk.intersect_packet_kernel(
            pcs.packet, pcs.tris, ett.make_rays(org, d, device="cpu"),
            cull=bool(cull))
        assert np.asarray(xla.valid).sum() >= 60
        ties += assert_matches(xla, port)
    assert ties == 0


def test_masks_in_the_kernel(rng):
    """(prim_mask[p] & ray_mask) != 0 decides whether a hit stands."""
    verts, idx = random_triangles(rng, 300, extent=3.0, size=1.0)
    prim_mask = (1 << (np.arange(300) % 3)).astype(np.int32)
    ps = packed(verts, idx, prim_mask=prim_mask)
    np.testing.assert_array_equal(ps.prim_mask.numpy(),
                                  prim_mask[ps.bvh_to_orig.numpy()])
    org, d = rays_np(rng, 500, 4.0)
    rays = ett.make_rays(org, d, device="cpu")
    for bits in (1, 2, 4, 5, 7, 0):
        rm = torch.full((500,), bits, dtype=torch.int32)
        keep = np.nonzero(prim_mask & bits)[0]
        t, prim = pk.intersect_packet_kernel_raw(ps, rays, ray_mask=rm)
        occ = pk.occluded_packet_kernel(ps, rays, ray_mask=rm)
        assert torch.equal(occ, prim >= 0)
        if bits == 0:
            assert not occ.any()
            continue
        assert np.isin(prim.numpy()[prim.numpy() >= 0], keep).all()
        sub = packed(verts, idx[keep])
        t2, prim2 = pk.intersect_packet_kernel_raw(sub, rays)
        assert (prim2 >= 0).sum() >= 10
        assert torch.equal(t, t2)
        hit = (prim2 >= 0).numpy()
        np.testing.assert_array_equal(prim.numpy()[hit],
                                      keep[prim2.numpy()[hit]])
    with pytest.raises(ValueError, match="prim_mask"):
        pk.packet_trace(packed(verts, idx), rays,
                        ray_mask=torch.ones(500, dtype=torch.int32))
    with pytest.raises(ValueError, match="ray_mask"):
        pk.packet_trace(ps, rays, ray_mask=torch.ones(500))


def test_stack_depth_and_dropped_pushes(rng):
    verts, idx = triangle_sphere((0, 0, 0), 2.0, 16)
    ps = packed(verts, idx)
    org, d = rays_np(rng, 300, 3.0)
    rays = ett.make_rays(org, d, device="cpu")
    t, prim, st = pk.packet_plain(ps, rays, stats=True)
    assert st["dropped_pushes"] == 0 and (prim >= 0).sum() >= 50
    # a stack too small for the walk drops pushes, and says so
    _t, _p, st2 = pk.packet_plain(ps, rays, stats=True, stack_depth=2)
    assert st2["dropped_pushes"] > 0
    # a tree deeper than the kernel's compiled stack is refused
    with pytest.raises(ValueError, match="levels"):
        pk.packet_trace(ps._replace(depth=pk.MAX_DEPTH + 1), rays)
    with pytest.raises(ValueError, match="width"):
        pk.packet_trace(ps._replace(width=2), rays)
    with pytest.raises(ValueError, match="dtype"):
        pk.packet_trace(ps, rays._replace(org=rays.org.double()))
    with pytest.raises(ValueError, match="contiguous"):
        pk.packet_trace(ps, rays._replace(tfar=rays.tfar[:1].expand(300)))
    with pytest.raises(ValueError, match="shape"):
        pk.packet_trace(ps, rays._replace(dir=rays.dir[:5]))


def test_result_does_not_depend_on_ray_grouping(rng):
    verts, idx = random_triangles(rng, 400, extent=3.0, size=1.0)
    ps = packed(verts, idx, width=8)
    org, d = rays_np(rng, 300, 4.0)
    rays = ett.make_rays(org, d, device="cpu")
    t, prim, _ = pk.packet_trace(ps, rays)
    perm = torch.from_numpy(rng.permutation(300))
    t2, prim2, _ = pk.packet_trace(ps, ett.Rays(
        *(x[perm].contiguous() for x in rays)))
    assert torch.equal(t[perm], t2) and torch.equal(prim[perm], prim2)
    t3, prim3, _ = pk.packet_trace(ps, ett.Rays(
        *(x[:7].contiguous() for x in rays)))
    assert torch.equal(t[:7], t3) and torch.equal(prim[:7], prim3)
