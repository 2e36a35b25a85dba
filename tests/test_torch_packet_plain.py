"""The packet kernel's plain version (embree_tpu_torch/traverse/packet_kernel.py)
against the JAX package's Pallas kernel in interpret mode and its XLA
path, at ray counts off any tile, and a request's batch shape and
retired rays (the tolerances of tests/test_torch_packet.py, whose helpers
these use)."""
import numpy as np
import pytest
import torch

import embree_tpu as et
import embree_tpu_torch as ett
from embree_tpu.traverse.pallas_packet import intersect_pallas
from embree_tpu_torch.traverse import packet_kernel as pk
from embree_tpu_torch.verify.fixtures import random_triangles, triangle_sphere

from test_torch_build import reference_native  # noqa: F401

from test_torch_packet import (  # noqa: F401
    assert_matches, packed, rays_np, ref_committed, soup)


@pytest.mark.parametrize("ntri,nray", [(5, 64), (60, 100)])
def test_plain_matches_pallas_interpret_and_xla(rng, ntri, nray):
    verts, idx = random_triangles(rng, ntri, extent=5.0, size=1.0)
    cs = ref_committed(verts, idx)
    org, d = rays_np(rng, nray, 8.0, aim=(verts, idx))
    ref_rays = et.make_rays(org, d)
    xla = et.scene_intersect(cs, ref_rays, isa="xla")
    pallas = intersect_pallas(cs.pallas, cs.tris, ref_rays, interpret=True)

    sc = ett.Scene(ett.Device("ignore_config_files=1", device="cpu"))
    sc.attach(ett.TriangleMesh(verts, idx))
    pcs = sc.commit()
    rays = ett.make_rays(org, d, device="cpu")
    port = pk.intersect_packet_kernel(pcs.packet, pcs.tris, rays)
    assert np.asarray(xla.valid).sum() >= 3
    assert assert_matches(xla, port) == 0
    assert assert_matches(pallas, port) == 0
    st = pk.traversal_stats(pcs.packet, rays)
    assert st.shape == (1, 3) and st[0, 0] >= nray and st[0, 2] == 0


@pytest.mark.parametrize("nray", [7, 1025])
def test_plain_ray_counts_off_any_tile(rng, nray):
    verts, idx = random_triangles(rng, 10)
    cs = ref_committed(verts, idx)
    org, d = rays_np(rng, nray, 5.0, normalize=False, aim=(verts, idx))
    xla = et.scene_intersect(cs, et.make_rays(org, d), isa="xla")
    ps = packed(verts, idx)
    t, prim = pk.intersect_packet_kernel_raw(
        ps, ett.make_rays(org, d, device="cpu"))
    assert t.shape == prim.shape == (nray,)
    np.testing.assert_array_equal((prim >= 0).numpy(), np.asarray(xla.valid))
    np.testing.assert_array_equal(prim.numpy(), np.asarray(xla.gprim))


def test_batch_shape_and_retired_rays(rng):
    """Rays keep their batch shape; a ray with tfar = -inf costs exactly
    one node visit and comes back as a miss."""
    verts, idx = triangle_sphere((0, 0, 0), 2.0, 12)
    ps = packed(verts, idx)
    v0, v1, v2 = (torch.from_numpy(a) for a in soup(verts, idx))
    n = len(idx)
    tris = ett.scene.prims.TrianglePrims(
        v0, v1, v2, torch.zeros(n, dtype=torch.int32),
        torch.arange(n, dtype=torch.int32), torch.zeros(n, dtype=torch.int32))
    org, d = rays_np(rng, 60, 1.0)
    rays = ett.make_rays(org.reshape(4, 15, 3), d.reshape(4, 15, 3),
                         device="cpu")
    h = pk.intersect_packet_kernel(ps, tris, rays)
    assert h.t.shape == (4, 15) and h.ng.shape == (4, 15, 3)
    assert h.valid.all()                        # origins inside the sphere
    assert pk.occluded_packet_kernel(ps, rays).shape == (4, 15)
    flat = ett.make_rays(org, d, 0.0, -np.inf, device="cpu")
    t, prim, st = pk.packet_trace(ps, flat, stats=True)
    assert (prim == -1).all() and (t == -np.inf).all()
    assert st["node_visits"] == 60 and st["tri_tests"] == 0
    assert st["leaf_visits"] == 0 and st["nodes_touched"] == 1
