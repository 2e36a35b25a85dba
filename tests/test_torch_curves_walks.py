"""The port's torch-op curve walks against the JAX package's XLA walks on
the same inputs: the segment soup through traverse/user.py and the hair
cluster walk of traverse/hair.py (the tolerances of
tests/test_torch_curves.py, whose helpers these use)."""
import numpy as np
import pytest
import torch

from embree_tpu.build import hair as ref_hair
from embree_tpu.core.rayhit import Rays as RefRays
from embree_tpu.scene import curves as ref_curves
from embree_tpu.traverse import hair as ref_thair
from embree_tpu.traverse import user as ref_user
from embree_tpu_torch.build import hair as port_hair
from embree_tpu_torch.core.rayhit import Rays
from embree_tpu_torch.scene import curves as port_curves
from embree_tpu_torch.traverse import hair as port_thair
from embree_tpu_torch.traverse import user as port_user
from embree_tpu_torch.verify.fixtures import hair_ball

from test_torch_build import reference_native  # noqa: F401

from test_torch_curves import (  # noqa: F401
    _close, _cps, _rays_np, one_torch_thread)


# u = u0 + du * (alpha + beta * t) / aa carries t's error times the ray's
# slope along the segment (observed 1.7e-4)
U_ATOL = 1e-3


def test_intersect_user_segment_soup_matches_reference():
    """The segment soup of a hair ball (swept cones with caps) walked by
    both packages' intersect_user: same hits, t, prims and pops."""
    rng = np.random.default_rng(31)
    verts, idx = hair_ball(rng, 30)
    g = port_curves.BezierCurves(verts, idx, tessellation_rate=4)
    p0, p1, prim, u0, du = g.to_segments()
    lo, hi = port_curves.segment_bounds(p0, p1)
    from embree_tpu.build.sah import BuildSettings, build_sah
    bvh_np = build_sah(lo, hi, BuildSettings())
    org, d = _rays_np(rng, 256)
    # half the rays aimed at segment midpoints
    k = rng.integers(0, len(p0), 256)
    tgt = 0.5 * (p0[k, :3] + p1[k, :3])
    d[::2] = (tgt - org)[::2]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tn = np.zeros(256, np.float32)
    tf = np.full(256, np.inf, np.float32)
    tf[::5] = 2.0
    fn_r, _ = ref_curves.make_segment_intersector(p0, p1, prim, u0, du)
    ref = ref_user.intersect_user(
        ref_user.UserAccel(bvh_np.to_device(), 0, len(p0)), fn_r,
        RefRays(org, d, tn, tf), tf, with_stats=True)
    fn_p, _ = port_curves.make_segment_intersector(p0, p1, prim, u0, du,
                                                   "cpu")
    from embree_tpu_torch.build.bvh import BVHArraysNP
    port_bvh = BVHArraysNP(*(np.asarray(a) for a in bvh_np)).to_device("cpu")
    t = torch.from_numpy
    got = port_user.intersect_user(
        port_user.UserAccel(port_bvh, 0, len(p0)), fn_p,
        Rays(t(org), t(d), t(tn), t(tf)), t(tf), with_stats=True)
    m = _close(np.asarray(ref[0]), got[0].numpy(), np.asarray(ref[5]),
               got[5].numpy())
    assert m.sum() > 40
    np.testing.assert_array_equal(np.asarray(ref[4])[m], got[4].numpy()[m])
    np.testing.assert_allclose(got[1].numpy()[m], np.asarray(ref[1])[m],
                               atol=U_ATOL)
    assert int(ref[6]) == got[6]


def _cluster_walks(flat, rng, n_rays=192):
    # a diagonal hair ball and a stray: two clusters (the JAX package's
    # walk compiles a while loop a cluster, ~2 s each)
    verts, idx = hair_ball(rng, 30, diagonal=True)
    sv, si = hair_ball(rng, 1)
    verts = np.concatenate([verts, sv])
    idx = np.concatenate([idx, si + 120]).astype(np.int32)
    cp3, rad = _cps(verts, idx)
    clusters_r = ref_hair.build_hair_clusters(cp3, rad)
    clusters_p = port_hair.build_hair_clusters(cp3, rad)
    assert len(clusters_r) > 1
    org, d = _rays_np(rng, n_rays)
    tgt = cp3[rng.integers(0, len(cp3), n_rays), 1]
    d[::2] = (tgt - org)[::2]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tn = np.zeros(n_rays, np.float32)
    tf = np.full(n_rays, np.inf, np.float32)
    mk_r = (ref_thair.make_ribbon_intersector if flat
            else ref_thair.make_round_curve_intersector)
    mk_p = (port_thair.make_ribbon_intersector if flat
            else port_thair.make_round_curve_intersector)
    fns_r = [mk_r(cp3[c.members] @ c.rot, rad[c.members], c.members, K=4)
             for c in clusters_r]
    fns_p = [mk_p(cp3[c.members] @ c.rot, rad[c.members], c.members, K=4,
                  device="cpu")
             for c in clusters_p]
    poc = np.arange(len(idx), dtype=np.int32)
    ref = ref_thair.intersect_hair_clusters(
        clusters_r, fns_r, RefRays(org, d, tn, tf), tf, 0, poc,
        with_stats=True)
    t = torch.from_numpy
    got = port_thair.intersect_hair_clusters(
        clusters_p, fns_p, Rays(t(org), t(d), t(tn), t(tf)), t(tf), 0, poc,
        with_stats=True)
    return ref, got


@pytest.mark.parametrize("flat", [False, True], ids=["round", "ribbon"])
def test_cluster_walk_matches_reference(flat):
    """traverse/hair.py's cluster fold (curve BVHs, K = 4 sub-segment
    leaves) against the JAX package's XLA cluster walk on the same
    clusters: same hits, t, prims and pops."""
    ref, got = _cluster_walks(flat, np.random.default_rng(41 + flat))
    m = _close(np.asarray(ref[0]), got[0].numpy(), np.asarray(ref[5]),
               got[5].numpy())
    assert m.sum() > 30
    np.testing.assert_array_equal(np.asarray(ref[4])[m], got[4].numpy()[m])
    np.testing.assert_allclose(got[1].numpy()[m], np.asarray(ref[1])[m],
                               atol=U_ATOL)
    ng_r, ng_p = np.asarray(ref[3])[m], got[3].numpy()[m]
    cos = (ng_r * ng_p).sum(1) / (np.linalg.norm(ng_r, axis=1)
                                  * np.linalg.norm(ng_p, axis=1))
    assert cos.min() > 0.999
    assert int(ref[6]) == got[6]
