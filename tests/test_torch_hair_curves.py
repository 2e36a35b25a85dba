"""Curve geometry types through the port's Scene on the CPU against the
JAX package: flat ribbons, round line segments and their caps, Bezier
hair and the B-spline segments' convex hull (the tolerances of
tests/test_torch_hair.py, whose helpers these use)."""
import numpy as np

import embree_tpu_torch as ett

from test_torch_hair import (  # noqa: F401
    CFG, _agree, _both, _hair, _query, one_torch_thread)


def test_ribbon_flat_curves():
    """FLAT curves use the ribbon leaf: a thick straight curve hit
    head-on reports t at the curve's axis depth (the ribbon faces the
    ray) and misses beyond the radius; as the JAX package."""
    verts = np.array([[0, 0, 0, 0.1], [0, 0.33, 0, 0.1],
                      [0, 0.66, 0, 0.1], [0, 1, 0, 0.1]], np.float32)
    idx = np.array([0], np.int32)
    ref, port = _both(_hair(verts, idx, rate=4, flat=True),
                      ",hair_accel=obb")
    org = np.array([[0.05, 0.5, 2.0], [0.3, 0.5, 2.0]], np.float32)
    d = np.array([[0, 0, -1.0], [0, 0, -1.0]], np.float32)
    q = _query(ref, port, org, d)
    h = q["port"]
    assert h.valid.tolist() == [True, False]
    assert abs(float(h.t[0]) - 2.0) < 1e-3
    _agree(q)
    assert q["port_occ"].tolist() == [True, False]


def test_line_segments_round():
    verts = np.array([[0, 0, 0, 0.2], [2, 0, 0, 0.2]], np.float32)
    idx = np.array([0], np.int32)
    ref, port = _both(lambda pkg: [pkg.LineSegments(verts, idx)])
    org = np.array([[1, 0, 5], [1, 0.19, 5], [1, 0.5, 5], [-1, 0, 5]],
                   np.float32)
    d = np.array([[0, 0, -1]] * 4, np.float32)
    q = _query(ref, port, org, d, occluded=True)
    h = q["port"]
    assert h.valid.tolist() == [True, True, False, False]
    assert abs(float(h.t[0]) - 4.8) < 1e-3
    assert int(h.geom_id[0]) == 0
    assert abs(float(h.u[0]) - 0.5) < 0.02
    _agree(q)
    np.testing.assert_array_equal(q["port_occ"], h.valid.numpy())


def test_line_segment_caps():
    verts = np.array([[0, 0, 0, 0.3], [1, 0, 0, 0.3]], np.float32)
    idx = np.array([0], np.int32)
    ref, port = _both(lambda pkg: [pkg.LineSegments(verts, idx)])
    q = _query(ref, port, np.array([[-2, 0, 0]], np.float32),
               np.array([[1, 0, 0]], np.float32))
    assert bool(q["port"].valid[0])
    assert abs(float(q["port"].t[0]) - 1.7) < 1e-3
    _agree(q)


def test_bezier_hair():
    """A gently curved, tapering strand (one OBB cluster): rays down its
    path hit it, u recovers the curve parameter, t = 5 - radius."""
    cp = np.array([[0, 0, 0, 0.10], [1, 0.5, 0, 0.08],
                   [2, -0.5, 0, 0.06], [3, 0, 0, 0.04]], np.float32)
    idx = np.array([0], np.int32)
    port = ett.Scene(ett.Device(CFG, device="cpu"))
    port.attach(ett.BezierCurves(cp, idx, tessellation_rate=16))
    port.commit()
    n = 32
    ts = np.linspace(0.05, 0.95, n).astype(np.float32)
    b = ((1 - ts[:, None]) ** 3 * cp[0] + 3 * (1 - ts[:, None]) ** 2
         * ts[:, None] * cp[1] + 3 * (1 - ts[:, None]) * ts[:, None] ** 2
         * cp[2] + ts[:, None] ** 3 * cp[3])
    org = np.stack([b[:, 0], b[:, 1], np.full(n, 5.0)], 1).astype(np.float32)
    d = np.tile(np.array([0, 0, -1.0], np.float32), (n, 1))
    h = port.intersect(ett.make_rays(org, d, device="cpu"))
    v = h.valid.numpy()
    assert v.mean() > 0.95
    assert (h.geom_id.numpy()[v] == 0).all()
    assert (h.prim_id.numpy()[v] == 0).all()
    assert np.median(np.abs(h.u.numpy()[v] - ts[v])) < 0.08
    r = (1 - ts) ** 3 * 0.10 + 3 * (1 - ts) ** 2 * ts * 0.08 \
        + 3 * (1 - ts) * ts ** 2 * 0.06 + ts ** 3 * 0.04
    np.testing.assert_allclose(h.t.numpy()[v], (5 - r)[v], atol=0.03)
    _agree(_query(*_both(_hair(cp, idx, rate=4)), org, d))


def test_bspline_segments_convex_hull():
    from embree_tpu_torch.render.tutorials.curve_geometry import (
        HAIR_INDICES, HAIR_VERTICES)
    g = ett.BSplineCurves(HAIR_VERTICES, HAIR_INDICES, tessellation_rate=8)
    p0, p1, prim, u0, du = g.to_segments()
    lo = HAIR_VERTICES[:, :3].min(0) - 1e-5
    hi = HAIR_VERTICES[:, :3].max(0) + 1e-5
    for p in (p0, p1):
        assert (p[:, :3] >= lo).all() and (p[:, :3] <= hi).all()
    assert prim.shape[0] == 6 * 8
    np.testing.assert_allclose(p0[0], p1[-1], atol=1e-5)
