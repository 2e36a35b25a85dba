"""Curves in the port against the JAX package, below the scene: the
geometry types' host tessellation and the hair clustering byte for
byte."""
import numpy as np
import pytest

from embree_tpu.build import hair as ref_hair
from embree_tpu.scene import curves as ref_curves
from embree_tpu_torch.build import hair as port_hair
from embree_tpu_torch.scene import curves as port_curves
from embree_tpu_torch.verify.fixtures import hair_ball

from test_torch_build import reference_native  # noqa: F401

from test_torch_curves import (  # noqa: F401
    _cps, _same, one_torch_thread)


@pytest.mark.parametrize("kind", ["LineSegments", "BezierCurves",
                                  "BSplineCurves"])
def test_tessellation_byte_equal(kind):
    rng = np.random.default_rng(11)
    verts = rng.normal(size=(40, 4)).astype(np.float32)
    verts[:, 3] = np.abs(verts[:, 3]) * 0.1
    idx = np.arange(0, 36, 4, dtype=np.int32)
    kw = {} if kind == "LineSegments" else {"tessellation_rate": 5}
    r = getattr(ref_curves, kind)(verts, idx, **kw)
    p = getattr(port_curves, kind)(verts, idx, **kw)
    for a, b in zip(r.to_segments(), p.to_segments()):
        _same(a, b)
    if kind != "LineSegments":
        for a, b in zip(r.to_bezier(), p.to_bezier()):
            _same(a, b)
    p0, p1 = r.to_segments()[:2]
    for a, b in zip(ref_curves.segment_bounds(p0, p1),
                    port_curves.segment_bounds(p0, p1)):
        _same(a, b)


@pytest.mark.parametrize("builder", ["auto", "default"])
def test_hair_clusters_byte_equal(builder):
    for diagonal in (False, True):
        verts, idx = hair_ball(np.random.default_rng(5), 150,
                               diagonal=diagonal)
        cp3, rad = _cps(verts, idx)
        ref = ref_hair.build_hair_clusters(cp3, rad, builder=builder)
        port = port_hair.build_hair_clusters(cp3, rad, builder=builder)
        assert len(ref) == len(port) == (1 if diagonal else 13)
        for a, b in zip(ref, port):
            _same(a.rot, b.rot)
            _same(a.members, b.members)
            for k in ("lower", "upper", "child", "count", "prim_order"):
                _same(getattr(a.bvh, k), getattr(b.bvh, k))
        clusters = port_hair.cluster_curves(cp3)
        assert [m.tolist() for _r, m in clusters] == [
            c.members.tolist() for c in port]
