"""Ray masks through the port's scene against the JAX package on its own
test cases (the tolerances of tests/test_torch_scene_paths.py, whose
helpers these use)."""
import numpy as np
import torch

import embree_tpu as et
import embree_tpu_torch as ett
from embree_tpu_torch.verify.fixtures import random_triangles

from test_torch_build import reference_native  # noqa: F401

from test_torch_scene_paths import (  # noqa: F401
    CFG, both_devices, rays_np)


def _quad_mesh(pkg, z):
    # unit quad at depth z facing +z (two CCW triangles)
    v = np.array([[-1, -1, z], [1, -1, z], [1, 1, z], [-1, 1, z]], np.float32)
    i = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    return pkg.TriangleMesh(v, i)


def test_ray_masks_per_geometry():
    """Four stacked quads with masks 1, 2, 4, 8; a ray with mask m hits
    the nearest quad whose (geom.mask & m) != 0 — in both packages."""
    results = []
    for pkg, dev in zip((et, ett), both_devices()):
        scene = pkg.Scene(dev)
        gids = []
        for k in range(4):
            g = _quad_mesh(pkg, float(k))
            g.mask = 1 << k
            gids.append(scene.attach(g))
        scene.commit()
        org = np.tile(np.array([0.0, 0.0, -1.0], np.float32), (6, 1))
        d = np.tile(np.array([0.0, 0.0, 1.0], np.float32), (6, 1))
        kw = {"device": "cpu"} if pkg is ett else {}
        rays = pkg.make_rays(org, d, **kw)
        masks = np.array([1, 2, 4, 8, 0, 0xF], np.int32)
        hits = scene.intersect(rays, mask=masks)
        occ = scene.occluded(rays, mask=masks)
        results.append((np.asarray(hits.geom_id), np.asarray(hits.t),
                        np.asarray(hits.prim_id), np.asarray(occ), gids))
    (rg, rt, rp, rocc, gids), (pg, pt, pp, pocc, _) = results
    assert list(pg[:4]) == gids and pg[4] == -1 and pg[5] == gids[0]
    np.testing.assert_array_equal(pg, rg)
    np.testing.assert_array_equal(pp, rp)
    np.testing.assert_allclose(pt[:4], [1.0, 2.0, 3.0, 4.0], rtol=1e-5)
    np.testing.assert_allclose(pt, rt, rtol=1e-5)
    assert list(pocc) == list(rocc) == [True, True, True, True, False, True]


def test_ray_masks_default_scalar_and_batch_shape(rng):
    dev = ett.Device(CFG, device="cpu")
    scene = ett.Scene(dev)
    scene.attach(_quad_mesh(ett, 0.0))          # default mask -1
    scene.commit()
    rays = ett.make_rays(np.array([[0, 0, -1.0]], np.float32),
                         np.array([[0, 0, 1.0]], np.float32), device="cpu")
    h1 = scene.intersect(rays, mask=np.array([123], np.int32))
    h2 = scene.intersect(rays)
    assert h1.geom_id.item() == h2.geom_id.item() == 0
    assert scene.intersect(rays, mask=5).valid.item()      # a scalar mask
    assert not scene.intersect(rays, mask=0).valid.item()
    assert not scene.occluded(rays, mask=torch.zeros(1)).item()
    # masks keep the rays' batch shape
    org = np.zeros((2, 3, 3), np.float32)
    org[..., 2] = -1.0
    d = np.zeros((2, 3, 3), np.float32)
    d[..., 2] = 1.0
    grid = ett.make_rays(org, d, device="cpu")
    m = np.array([[1, 0, 1], [0, 1, 0]], np.int32)
    h = scene.intersect(grid, mask=m)
    assert h.valid.shape == (2, 3)
    np.testing.assert_array_equal(h.valid.numpy(), m.astype(bool))
    np.testing.assert_array_equal(scene.occluded(grid, mask=m).numpy(),
                                  m.astype(bool))


def test_ray_masks_match_reference_on_a_soup(rng):
    """Three geometries with masks 1, 2, 4 and random ray masks."""
    parts = [random_triangles(rng, 120, extent=3.0, size=1.2)
             for _ in range(3)]
    org, d = rays_np(rng, 400, 4.0)
    masks = rng.integers(0, 8, 400).astype(np.int32)
    out = []
    for pkg, dev in zip((et, ett), both_devices()):
        scene = pkg.Scene(dev)
        for k, (v, i) in enumerate(parts):
            g = pkg.TriangleMesh(v, i)
            g.mask = 1 << k
            scene.attach(g)
        scene.commit()
        kw = {"device": "cpu"} if pkg is ett else {}
        rays = pkg.make_rays(org, d, **kw)
        h = scene.intersect(rays, mask=masks)
        out.append((np.asarray(h.valid), np.asarray(h.geom_id),
                    np.asarray(h.prim_id), np.asarray(h.t),
                    np.asarray(scene.occluded(rays, mask=masks))))
    ref, port = out
    assert ref[0].sum() >= 40
    for a, b in zip(ref[:3], port[:3]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(port[3][ref[0]], ref[3][ref[0]], rtol=1e-5)
    np.testing.assert_array_equal(port[4], ref[4])
    assert ((1 << port[1][port[0]]) & masks[port[0]]).all()
