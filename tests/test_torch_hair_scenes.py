"""Curves in whole scenes through the port's Scene on the CPU against the
JAX package: a B-spline curve hit through either accel, the curve demo,
motion-blur curves and a mixed scene of triangles and hair (the
tolerances of tests/test_torch_hair.py, whose helpers these use)."""
import numpy as np
import pytest
import torch

import embree_tpu_torch as ett
from embree_tpu_torch.render.camera import Camera
from embree_tpu_torch.verify.fixtures import hair_ball, triangle_sphere

from test_torch_hair import (  # noqa: F401
    CFG, _agree, _both, _query, _rays_np, one_torch_thread)


@pytest.mark.parametrize("accel", ["obb", "segment"])
def test_bspline_curve_hit(accel):
    cp = np.asarray([[0, -3, 0, 0.3], [0, -1, 0, 0.3],
                     [0, 1, 0, 0.3], [0, 3, 0, 0.3]], np.float32)
    idx = np.zeros(1, np.int32)
    ref, port = _both(lambda pkg: [pkg.BSplineCurves(
        cp, idx, tessellation_rate=4)], f",hair_accel={accel}")
    q = _query(ref, port, np.asarray([[0, 0, -5]], np.float32),
               np.asarray([[0, 0, 1]], np.float32), occluded=True)
    assert bool(q["port"].valid[0])
    assert abs(float(q["port"].t[0]) - 4.7) < 0.05
    _agree(q)
    assert q["port_occ"].tolist() == [True]


def test_curve_demo_renders():
    from embree_tpu_torch.render.tutorials.curve_geometry import (
        build_scene, render_frame)
    st = build_scene(ett.Device(CFG, device="cpu"))
    img, n = render_frame(st, Camera(from_=(2, 2.5, -6), to=(0, 0, 0)),
                          (96, 64))
    img = img.numpy()
    assert img.shape == (64, 96, 3) and n == 96 * 64
    assert img.max() > 0.3 and np.isfinite(img).all()


def test_curve_mb():
    """A straight thick curve translating over time: hits move with the
    ray's time; the JAX package agrees on the ray that hits at each
    time, queried alone; occlusion over MB curves raises."""
    def curve_at(zoff):
        return np.array([[0, -1, zoff, 0.2], [0, -0.4, zoff, 0.2],
                         [0, 0.4, zoff, 0.2], [0, 1, zoff, 0.2]], np.float32)

    ref, port = _both(lambda pkg: [pkg.BezierCurvesMB(
        indices=np.array([0], np.int32),
        timesteps=[curve_at(0.0), curve_at(2.0)], tessellation_rate=8)])
    assert port.committed.mb_curves is not None
    org = np.array([[3, 0, 0], [3, 0, 2], [3, 0, 1]], np.float32)
    d = np.array([[-1, 0, 0]] * 3, np.float32)
    got = {}
    for tm in (0.0, 1.0, 0.5):
        q = _query(ref, port, org, d, time=tm)
        got[tm] = q["port"]
        # the ray that hits at this time, alone: the JAX package's leaf
        # sums the cone's axis over the batch (ROADMAP.md C)
        i = {0.0: 0, 1.0: 1, 0.5: 2}[tm]
        qi = _query(ref, port, org[i:i + 1], d[i:i + 1], time=tm)
        _agree(qi)
        assert torch.equal(qi["port"].t, got[tm].t[i:i + 1])
    h0, h1, hm = got[0.0], got[1.0], got[0.5]
    assert bool(h0.valid[0]) and not bool(h0.valid[1])
    assert bool(h1.valid[1]) and not bool(h1.valid[0])
    assert bool(hm.valid[2])
    assert abs(float(h0.t[0]) - 2.8) < 1e-2
    assert abs(float(hm.t[2]) - 2.8) < 1e-2
    # per-ray times in one request
    hr = port.intersect(ett.make_rays(org, d, device="cpu"),
                        time=torch.tensor([0.0, 1.0, 0.5]))
    assert hr.valid.tolist() == [True, True, True]
    with pytest.raises(ett.RaytracerError,
                       match="not ported yet: occluded over motion-blur"):
        port.occluded(ett.make_rays(org, d, device="cpu"))


def test_triangles_plus_hair(rng):
    """A sphere of triangles (kernel B2's plain version) and diagonal
    hair (B3's) in one scene, against the JAX package's XLA fold: the
    same accel type wins per ray; occlusion equals the hit mask."""
    verts, idx = triangle_sphere((0, 0, 0), 1.6, 16)
    hv, hi = hair_ball(rng, 40, diagonal=True)
    hv[:, 3] = 0.03
    ref, port = _both(lambda pkg: [pkg.TriangleMesh(verts, idx),
                                   pkg.BezierCurves(hv, hi,
                                                    tessellation_rate=4)])
    assert port.committed.hairs and port.committed.tris.num_prims
    org, d = _rays_np(rng, 1024, aim=hv[hi + 1, :3])
    q = _query(ref, port, org, d, occluded=True)
    ok = _agree(q)
    assert (q["port"].geom_id.numpy()[ok] == 1).sum() > 30
    assert (q["port"].geom_id.numpy()[ok] == 0).sum() > 30
    # with tfar = inf any hit is a closest hit found, triangles and hair
    np.testing.assert_array_equal(q["port_occ"], q["port"].valid.numpy())
    # a hair hit carries no triangle slot
    hair = q["port"].geom_id == 1
    assert (q["port"].gprim[hair] == -1).all()
