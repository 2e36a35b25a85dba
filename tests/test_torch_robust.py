"""NaN and Inf rays through every kernel's plain version: the port's form
of tests/test_intersect.py::test_nan_inf_rays (verify.cpp:2832/:2905).

Each batch of 64 rays carries bad lanes — a NaN origin (lane 0), a NaN
direction (1), an Inf direction (2), a zero direction (3), a NaN in one
origin component (4) and one direction component (5) — and, for motion
blur, times of NaN, +Inf, -Inf and -0.5 on clean rays. The JAX package
on the same inputs decides what is right: its bad lanes miss, and its
clean lanes equal a clean batch. The port's plain versions of B1
(rowtrace2), B2 (packet), B4 / B5 (compressed), B6 (motion blur) and B3
(hair) must answer the same: bad lanes miss (a NaN time misses, +-Inf
clamp to 1 and 0, -0.5 to 0), clean lanes equal the port's own clean
batch bit for bit, and valid masks equal the JAX package's on every
lane, with t within 5e-5 relative where both hit (XLA:CPU contracts
FMAs; the port rounds every product).

One exception, the JAX package's and reproduced: B5 (conservative
occlusion over compressed tiles) reports the Inf-direction lane occluded.
Its slab distances are all 0 then, so it enters every tile box and a
conservative mode answers yes on entry; both packages agree, and the test
holds that they do (ROADMAP.md C.2)."""
import math

import numpy as np
import pytest
import torch

import embree_tpu as et
import embree_tpu_torch as ett
from embree_tpu.verify.fixtures import random_triangles as ref_random_tris
from embree_tpu_torch.traverse.rowtrace2 import intersect_rowtrace2
from embree_tpu_torch.verify.fixtures import subdiv_cube, triangle_sphere
from test_torch_build import reference_native  # noqa: F401,E402

CFG = "ignore_config_files=1"
N = 64
BAD = 6                  # lanes 0..5 carry NaN / Inf / zero
T_RTOL = 5e-5
HAIR_RTOL = 1e-3         # tests/test_torch_hair_kernel.py's bound


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lanes(org, d):
    """Bad lanes 0..5 of (org, d), and the clean batch they replace."""
    dirty_o, dirty_d = org.copy(), d.copy()
    dirty_o[0] = np.nan
    dirty_d[1] = np.nan
    dirty_d[2] = np.inf
    dirty_d[3] = 0.0
    dirty_o[4, 1] = np.nan
    dirty_d[5, 2] = np.nan
    return dirty_o, dirty_d


def _rays(org, d):
    return (et.make_rays(org, d), ett.make_rays(org, d, device="cpu"))


def _bits(a):
    return a.view(torch.int32) if a.dtype == torch.float32 else a


def _check(ref_valid, ref_t, port, clean, occ=None, clean_occ=None,
           ref_occ=None, rtol=T_RTOL):
    """Bad lanes miss in both packages; valid equal on every lane, t close
    where both hit; the port's clean lanes equal its clean batch."""
    rv, rt = np.asarray(ref_valid), np.asarray(ref_t)
    pv, pt = port.valid.numpy(), port.t.numpy()
    assert not rv[:BAD].any() and not pv[:BAD].any()
    np.testing.assert_array_equal(pv, rv)
    np.testing.assert_allclose(pt[rv], rt[rv], rtol=rtol)
    assert rv[BAD:].sum() >= 8
    for name in ("t", "u", "v", "ng", "prim_id", "geom_id"):
        a, b = getattr(port, name)[BAD:], getattr(clean, name)[BAD:]
        assert torch.equal(_bits(a), _bits(b)), name
    if occ is not None:
        assert not occ[:BAD].any()
        assert torch.equal(occ[BAD:], clean_occ[BAD:])
        assert torch.equal(occ, port.valid)
        if ref_occ is not None:
            np.testing.assert_array_equal(occ.numpy(), np.asarray(ref_occ))


def _triangle_batch(rng):
    verts, idx = ref_random_tris(rng, 50)
    org = rng.uniform(-5, 5, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    # aim half the rays at a triangle so that enough clean lanes hit
    cen = verts[idx[rng.integers(0, len(idx), N)]].mean(1)
    d[::2] = (cen - org)[::2]
    return verts, idx, org, d


def test_triangles_packet_and_rowtrace(rng):
    """B2 (the scene's path for a small batch) and B1 (called directly on
    the scene's treelets) against the JAX package's scene."""
    verts, idx, org, d = _triangle_batch(rng)
    ref = et.Scene(et.Device(CFG))
    ref.attach(et.TriangleMesh(verts, idx))
    ref.commit()
    port = ett.Scene(ett.Device(CFG + ",tri_accel=bvh4.triangle4.rowtrace",
                                device="cpu"))
    port.attach(ett.TriangleMesh(verts, idx))
    cs = port.commit()
    assert cs.rowtrace is not None
    dirty = _lanes(org, d)
    rr, pr = _rays(*dirty)
    _rc, pc = _rays(org, d)
    ref_h = ref.intersect(rr)
    h, clean = port.intersect(pr), port.intersect(pc)
    _check(ref_h.valid, ref_h.t, h, clean, port.occluded(pr),
           port.occluded(pc), ref.occluded(rr))
    for occluded in (False, True):
        t, prim = intersect_rowtrace2(cs.rowtrace, pr, occluded=occluded)
        tc, primc = intersect_rowtrace2(cs.rowtrace, pc, occluded=occluded)
        hit = (t == -math.inf) if occluded else prim >= 0
        assert torch.equal(hit, h.valid)
        assert torch.equal(_bits(t[BAD:]), _bits(tc[BAD:]))
        if not occluded:
            assert torch.equal(_bits(t[h.valid]), _bits(h.t[h.valid]))


def test_compressed_leaf_mode(rng):
    """B4 and B5 on the subdivision cube in the paper's leaf mode."""
    cv, cc, ci = subdiv_cube()
    mode = "bvh4.compressed.leaf"
    ref = et.Scene(et.Device(CFG + f",subdiv_accel={mode}"))
    port = ett.Scene(ett.Device(CFG + f",subdiv_accel={mode}", device="cpu"))
    ref.attach(et.SubdivMesh(cv, cc, ci))
    port.attach(ett.SubdivMesh(cv, cc, ci))
    for s in (ref, port):
        s.set_levels(3, 2)
        s.commit()
    org = (rng.normal(size=(N, 3)) * 3).astype(np.float32)
    d = (-org + rng.normal(size=(N, 3)) * 0.3).astype(np.float32)
    dirty = _lanes(org, d)
    rr, pr = _rays(*dirty)
    _rc, pc = _rays(org, d)
    ref_h, ref_o = ref.intersect(rr), np.asarray(ref.occluded(rr))
    h, clean = port.intersect(pr), port.intersect(pc)
    _check(ref_h.valid, ref_h.t, h, clean)
    occ, occ_c = port.occluded(pr), port.occluded(pc)
    # the Inf-direction lane enters every tile: occluded in both packages
    assert ref_o[2] and occ[2]
    keep = np.ones(N, bool)
    keep[2] = False
    assert not occ[:BAD][keep[:BAD]].any()
    np.testing.assert_array_equal(occ.numpy(), ref_o)
    assert torch.equal(occ[BAD:], occ_c[BAD:])
    assert torch.equal(occ[keep], (h.valid | occ)[keep])


def test_motion_blur_rays_and_times(rng):
    """B6 on a sphere moving linearly over two timesteps: the bad ray
    lanes at random times, then clean rays at times NaN, +Inf, -Inf and
    -0.5."""
    v, idx = triangle_sphere((0, 0, 0), 2.0, 8)
    ts = [v, v + np.float32([0.8, 0.3, 0])]
    ref = et.Scene(et.Device(CFG))
    ref.attach(et.TriangleMeshMB(indices=idx, timesteps=ts))
    ref.commit()
    port = ett.Scene(ett.Device(CFG, device="cpu"))
    port.attach(ett.TriangleMeshMB(indices=idx, timesteps=ts))
    port.commit()
    org = rng.uniform(-4, 4, (N, 3)).astype(np.float32)
    d = (-org + rng.normal(size=(N, 3)) * 0.4).astype(np.float32)
    tm = rng.uniform(0, 1, N).astype(np.float32)
    odd = {6: np.nan, 7: np.inf, 8: -np.inf, 9: -0.5}
    dirty_t = tm.copy()
    for k, x in odd.items():
        dirty_t[k] = x
    dirty = _lanes(org, d)
    rr, pr = _rays(*dirty)
    _rc, pc = _rays(org, d)
    ref_h = ref.intersect(rr, time=dirty_t)
    h = port.intersect(pr, time=torch.from_numpy(dirty_t))
    clean = port.intersect(pc, time=torch.from_numpy(tm))
    rv = np.asarray(ref_h.valid)
    assert not rv[:BAD].any() and not rv[6] and not h.valid[:BAD].any()
    assert not h.valid[6]
    np.testing.assert_array_equal(h.valid.numpy(), rv)
    np.testing.assert_allclose(h.t.numpy()[rv], np.asarray(ref_h.t)[rv],
                               rtol=T_RTOL)
    lanes = torch.arange(N) >= 10
    for name in ("t", "u", "v", "ng", "prim_id"):
        a, b = getattr(h, name)[lanes], getattr(clean, name)[lanes]
        assert torch.equal(_bits(a), _bits(b)), name
    # +Inf is time 1, -Inf and -0.5 are time 0
    for k, at in ((7, 1.0), (8, 0.0), (9, 0.0)):
        one = port.intersect(ett.make_rays(org[k:k + 1], d[k:k + 1],
                                           device="cpu"), time=at)
        assert bool(one.valid[0]) == bool(h.valid[k])
        assert torch.equal(_bits(one.t[:1]), _bits(h.t[k:k + 1]))
    assert h.valid[7:10].any()


@pytest.mark.parametrize("flat", [False, True], ids=["cone", "ribbon"])
def test_hair(rng, flat):
    """B3 over every cluster of the hair tutorial's fur at 120 strands (2
    clusters, one launch of the set). t against the JAX package within
    HAIR_RTOL: the cone quadratic B*B - 4*A*C cancels most digits on
    thin strands, and XLA:CPU contracts it into FMAs."""
    from embree_tpu_torch.render.tutorials import hair_geometry as hg
    verts, idx = hg.make_fur(120)
    ref = et.Scene(et.Device(CFG))
    ref.attach(et.BezierCurves(verts, idx, tessellation_rate=3, flat=flat))
    ref.commit()
    port = ett.Scene(ett.Device(CFG, device="cpu"))
    port.attach(ett.BezierCurves(verts, idx, tessellation_rate=3,
                                 flat=flat))
    cs = port.commit()
    assert len(cs.hairs) == 2 and len(cs.hair_set.packed.runs()) == 1
    cp = verts[idx[rng.integers(0, len(idx), N)]
               + rng.integers(0, 4, N)][:, :3]
    org = (cp + rng.normal(size=(N, 3)) * 0.5).astype(np.float32)
    d = (cp - org).astype(np.float32)
    dirty = _lanes(org, d)
    rr, pr = _rays(*dirty)
    _rc, pc = _rays(org, d)
    ref_h = ref.intersect(rr)
    h, clean = port.intersect(pr), port.intersect(pc)
    _check(ref_h.valid, ref_h.t, h, clean, port.occluded(pr),
           port.occluded(pc), rtol=HAIR_RTOL)
