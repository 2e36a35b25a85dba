"""Variants and edge shapes of the PyTorch port's treelet traversal:
origins inside the mesh, any-hit, backface culling and converging rays
against the JAX package's kernel in interpret mode; the shapes that are
too slow in interpret mode are in test_torch_rowtrace_variants_large.py."""
import numpy as np
import torch

import embree_tpu_torch as ett
from embree_tpu_torch.traverse import rowtrace2 as rt2
from embree_tpu_torch.verify.fixtures import random_triangles, triangle_sphere

from test_torch_rowtrace import (assert_closest_parity, both, build,
                                 random_rays)


def test_sphere_inside_origins(rng):
    verts, idx = triangle_sphere((0, 0, 0), 2.0, 24)   # ~1.1k tris
    org, d = random_rays(rng, 800, 3.0)
    ref, port = both(build(verts, idx, 4), org, d)
    assert_closest_parity(ref, port, 150)


def test_occluded(rng):
    verts, idx = triangle_sphere((0, 0, 0), 2.0, 16)
    org, d = random_rays(rng, 400, 3.0)
    (t_r, p_r), (t_p, p_p) = both(build(verts, idx, 4), org, d,
                                  occluded=True)
    assert (t_r == -np.inf).sum() >= 50
    # hit rays carry -inf, the others keep their tfar; prim is never set
    np.testing.assert_array_equal(t_p, t_r)
    assert (p_p == -1).all() and (p_r == -1).all()


def test_backface_cull(rng):
    verts, idx = triangle_sphere((0, 0, 0), 2.0, 24)
    org, d = random_rays(rng, 600, 3.0)
    ts_np = build(verts, idx, 4)
    ref, port = both(ts_np, org, d, cull=True)
    assert_closest_parity(ref, port, 100)
    # culling changes the answer for rays that start inside the sphere
    _, p_all = rt2.intersect_rowtrace2(
        ts_np.to_device("cpu"), ett.make_rays(org, d, device="cpu"))
    assert (p_all.numpy() != port[1]).any()


def test_converging_rays_many_mids(rng):
    """Every ray crosses the boxes of nearly every treelet; fan 2 makes
    the mid count large. Closest and any-hit."""
    verts, idx = random_triangles(rng, 3000, extent=1.5, size=0.9)
    ts_np = build(verts, idx, 2)
    assert ts_np.num_mids >= 3
    d = rng.normal(size=(512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    org = -d * 6.0
    ref, port = both(ts_np, org, d)
    assert_closest_parity(ref, port, 500)
    t_occ, _ = rt2.intersect_rowtrace2(
        ts_np.to_device("cpu"), ett.make_rays(org, d, device="cpu"),
        occluded=True)
    np.testing.assert_array_equal(t_occ.numpy() == -np.inf, port[1] >= 0)


def test_ray_interval_and_axis_parallel_directions():
    """tnear/tfar clip hits; directions with zero components (rcp_safe's
    +-1e30) still find the triangle they point at."""
    verts = np.array([[-1, -1, 0], [1, -1, 0], [0, 1, 0],
                      [-1, -1, 2], [1, -1, 2], [0, 1, 2]], np.float32)
    idx = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    ts = build(verts, idx, 4).to_device("cpu")
    org = np.array([[0, 0, -1]] * 4 + [[0.1, -0.2, 5]], np.float32)
    d = np.array([[0, 0, 1]] * 4 + [[0, 0, -1]], np.float32)
    tnear = np.array([0, 1.5, 0, 3.5, 0], np.float32)
    tfar = np.array([np.inf, np.inf, 0.5, np.inf, np.inf], np.float32)
    rays = ett.make_rays(org, d, tnear, tfar, device="cpu")
    t, prim = rt2.intersect_rowtrace2(ts, rays)
    assert prim.tolist() == [0, 1, -1, -1, 1]
    np.testing.assert_allclose(t.numpy(), [1.0, 3.0, 0.5, np.inf, 3.0])
    t, prim = rt2.intersect_rowtrace2(ts, rays, occluded=True)
    assert (t == -np.inf).tolist() == [True, True, False, False, True]
    empty = ett.make_rays(np.zeros((0, 3)), np.zeros((0, 3)), device="cpu")
    t, prim = rt2.intersect_rowtrace2(ts, empty)
    assert t.shape == (0,) and prim.dtype == torch.int32
