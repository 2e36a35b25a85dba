"""Shapes of the PyTorch port's treelet traversal that are too slow in
interpret mode (more than 256 mids, fan 48) against a brute-force test
of every triangle; the rest of tests/test_torch_rowtrace_variants.py's
cases, split off so that no port test file holds more than five tests."""
import numpy as np
import pytest

import embree_tpu_torch as ett
from embree_tpu_torch.traverse import rowtrace2 as rt2
from embree_tpu_torch.verify.fixtures import triangle_sphere

from test_torch_rowtrace import build, random_rays


def brute_force(verts, idx, org, d, cull=False):
    """float32 Moeller test of every ray against every triangle, in the
    kernel's order of operations: (valid, t, prim) of the closest hit."""
    v = np.asarray(verts, np.float32)[np.asarray(idx)]
    v0, e1, e2 = v[:, 0], v[:, 0] - v[:, 1], v[:, 2] - v[:, 0]
    ng = np.cross(e2, e1).astype(np.float32)
    best_t = np.full(len(org), np.inf, np.float32)
    best_p = np.full(len(org), -1, np.int64)
    for i, (o, dd) in enumerate(zip(org, d)):
        c = v0 - o
        r = np.cross(c, dd).astype(np.float32)
        den = ng[:, 0] * dd[0] + ng[:, 1] * dd[1] + ng[:, 2] * dd[2]
        sgn = np.where(den >= 0, np.float32(1), np.float32(-1))
        u = (r[:, 0] * e2[:, 0] + r[:, 1] * e2[:, 1] + r[:, 2] * e2[:, 2]) * sgn
        w = (r[:, 0] * e1[:, 0] + r[:, 1] * e1[:, 1] + r[:, 2] * e1[:, 2]) * sgn
        ts = (ng[:, 0] * c[:, 0] + ng[:, 1] * c[:, 1] + ng[:, 2] * c[:, 2]) * sgn
        ad = np.abs(den)
        ok = ((den < 0) if cull else (den != 0)) & (u >= 0) & (w >= 0) \
            & (u + w <= ad) & (ts > 0)
        if ok.any():
            t = np.where(ok, ts / np.maximum(ad, np.float32(1e-37)), np.inf)
            best_p[i] = int(np.argmin(t))
            best_t[i] = t[best_p[i]]
    return best_p >= 0, best_t, best_p


@pytest.mark.parametrize("res,fan,nray", [
    (200, 1, 192),     # ~80k tris, more than 256 mids
    (100, 48, 256),    # ~20k tris, a fan mask of two words
])
def test_large_shapes_against_brute_force(rng, res, fan, nray):
    verts, idx = triangle_sphere((0, 0, 0), 2.0, res)
    ts_np = build(verts, idx, fan)
    if fan == 1:
        assert ts_np.num_mids > 256, ts_np.num_mids
    org, d = random_rays(rng, nray, 3.0)
    ts = ts_np.to_device("cpu")
    rays = ett.make_rays(org, d, device="cpu")
    t, prim = rt2.intersect_rowtrace2(ts, rays)
    valid, bt, bp = brute_force(verts, idx, org, d)
    assert valid.sum() >= 40
    np.testing.assert_array_equal(prim.numpy() >= 0, valid)
    np.testing.assert_allclose(t.numpy()[valid], bt[valid], rtol=1e-5)
    # ids may differ only between triangles at the same distance
    differ = prim.numpy()[valid] != bp[valid]
    np.testing.assert_allclose(t.numpy()[valid][differ], bt[valid][differ],
                               rtol=1e-6)
    assert differ.mean() <= 0.02
    t_occ, p_occ = rt2.intersect_rowtrace2(ts, rays, occluded=True)
    np.testing.assert_array_equal(t_occ.numpy() == -np.inf, valid)
    assert (p_occ == -1).all()
