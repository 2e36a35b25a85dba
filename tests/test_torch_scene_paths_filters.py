"""Intersection filters through the port's scene against the JAX package
on its own test cases: a rejecting filter, a uv-transparency filter and
the restart on a soup (the tolerances of tests/test_torch_scene_paths.py,
whose helpers these use)."""
import numpy as np
import torch

import embree_tpu as et
import embree_tpu_torch as ett
from embree_tpu_torch.verify.fixtures import random_triangles

from test_torch_build import reference_native  # noqa: F401

from test_torch_scene_paths import (  # noqa: F401
    both_devices, port_scene_of, rays_np)


def test_filter_rejects_and_traversal_continues():
    # two parallel triangles; the filter rejects the nearer one
    v = np.array([[-1, -1, 2], [1, -1, 2], [0, 1, 2],
                  [-1, -1, 0], [1, -1, 0], [0, 1, 0]], np.float32)
    idx = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    org = np.array([[0, 0, 5]], np.float32)
    d = np.array([[0, 0, -1]], np.float32)
    seen = []
    for pkg, dev in zip((et, ett), both_devices()):
        s = pkg.Scene(dev)
        s.attach(pkg.TriangleMesh(v, idx))
        s.commit()
        kw = {"device": "cpu"} if pkg is ett else {}
        rays = pkg.make_rays(org, d, **kw)
        row = []
        h = s.intersect(rays)
        row.append((int(h.prim_id[0]), float(h.t[0])))
        # reject prim 0 -> traversal must deliver prim 1 behind it
        s.set_intersection_filter(
            lambda org_, d_, t, u, v_, ng, geom, prim: prim != 0)
        h = s.intersect(rays)
        row.append((int(h.prim_id[0]), float(h.t[0])))
        # reject everything -> miss
        s.set_intersection_filter(
            lambda org_, d_, t, u, v_, ng, geom, prim: t != t)
        row.append(bool(s.intersect(rays).valid[0]))
        # clearing restores the unfiltered answer
        s.set_intersection_filter(None)
        row.append(int(s.intersect(rays).prim_id[0]))
        seen.append(row)
    ref, port = seen
    assert port[0][0] == 0 and abs(port[0][1] - 3.0) < 1e-5
    assert port[1][0] == 1 and abs(port[1][1] - 5.0) < 1e-5
    assert port[2] is False and port[3] == 0
    assert [r[0] if isinstance(r, tuple) else r for r in ref] == \
        [p[0] if isinstance(p, tuple) else p for p in port]


def test_filter_by_uv_transparency():
    """Classic transparency-texture filter: reject hits with u > 0.5."""
    v = np.array([[-1, -1, 0], [3, -1, 0], [-1, 3, 0]], np.float32)
    idx = np.array([[0, 1, 2]], np.int32)
    org = np.array([[0, 0, 5], [1.8, -0.5, 5]], np.float32)
    d = np.array([[0, 0, -1]] * 2, np.float32)
    valid = []
    for pkg, dev in zip((et, ett), both_devices()):
        s = pkg.Scene(dev)
        s.attach(pkg.TriangleMesh(v, idx))
        s.commit()
        s.set_intersection_filter(
            lambda org_, d_, t, u, v_, ng, geom, prim: u <= 0.5)
        kw = {"device": "cpu"} if pkg is ett else {}
        valid.append(np.asarray(s.intersect(pkg.make_rays(org, d, **kw)).valid))
    assert list(valid[1]) == [True, False]      # u ~ 0.25 and u ~ 0.7
    np.testing.assert_array_equal(valid[0], valid[1])


def test_filter_restart_on_a_soup_matches_a_reduced_scene(rng):
    """Keeping only even prims by a filter answers as a scene of the even
    prims does; the filter sees tensors of the scene's device, and rounds
    retire decided rays."""
    verts, idx = random_triangles(rng, 200, extent=2.0, size=1.5)
    sc = port_scene_of(verts, idx)
    org, d = rays_np(rng, 300, 3.0)
    rays = ett.make_rays(org, d, 0.0, 50.0, device="cpu")
    seen = []

    def keep_even(org_, d_, t, u, v_, ng, geom, prim):
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        assert org_.shape == (300, 3) and ng.shape == (300, 3)
        seen.append(int((t > -np.inf).sum()))
        return prim % 2 == 0

    sc.set_intersection_filter(keep_even)
    got = sc.intersect(rays)
    even = port_scene_of(verts, idx[::2])
    want = even.intersect(rays)
    assert want.valid.sum() >= 60
    assert torch.equal(got.valid, want.valid)
    assert torch.equal(got.prim_id, torch.where(
        want.valid, want.prim_id * 2, torch.full_like(want.prim_id, -1)))
    torch.testing.assert_close(got.t, want.t, rtol=1e-6, atol=0)
    assert (got.t[~got.valid] == 50.0).all()
    assert len(seen) >= 2 and seen[-1] < seen[0]   # later rounds are smaller
    # a filter with a mask: both conditions hold
    m = rng.integers(0, 2, 300).astype(np.int32)
    both = sc.intersect(rays, mask=m)
    assert torch.equal(both.valid, want.valid & torch.from_numpy(m != 0))
    # a python bool is a valid answer
    sc.set_intersection_filter(lambda *a: False)
    assert not sc.intersect(rays).valid.any()
