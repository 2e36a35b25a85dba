"""Curves in the port against the JAX package, below the scene: the
geometry types' host tessellation, the hair clustering and the
motion-blur curve build byte for byte, the converter of the MB curve
accel, and the torch-op walks (traverse/user.py, traverse/hair.py's
cluster walk, traverse/mb.py's MB curve walk) against the JAX package's
XLA walks on the same inputs.

Tolerances: host arrays equal byte for byte. Walks: hit masks equal; t
within 1e-4 relative, the JAX package's own bound between its two hair
paths (tests/test_hair.py:161), on all but at most 2 % of the hits
(GRAZING), which stay within 2e-3: XLA:CPU contracts products into FMAs,
the port rounds every product, and the cone quadratic B*B - 4*A*C
cancels most digits on thin cones seen at a grazing angle (observed: one
ray of 68 at 1.5e-4); prim equal where t agrees; node pops equal; u
within 1e-3. The tessellation and the clustering are in
test_torch_curves_host.py, the segment soup and the cluster walk in
test_torch_curves_walks.py; both use the helpers below."""
import numpy as np
import pytest
import torch

import embree_tpu as et
import embree_tpu_torch as ett
from embree_tpu.core.rayhit import Rays as RefRays
from embree_tpu.traverse import mb as ref_mb
from embree_tpu_torch.build import hair as port_hair
from embree_tpu_torch.convert import mb_curves_from_reference
from embree_tpu_torch.core.rayhit import Rays
from embree_tpu_torch.traverse import hair as port_thair
from embree_tpu_torch.traverse import mb as port_mb
from embree_tpu_torch.traverse import user as port_user
from embree_tpu_torch.verify.fixtures import hair_ball
from test_hair import _hair_ball
from test_torch_build import reference_native  # noqa: F401,E402

CFG = "ignore_config_files=1"
T_RTOL = 1e-4
MB_FIELDS = ("lower_ts", "upper_ts", "p0_ts", "p1_ts", "geom_id", "prim_id",
             "u0", "du")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rays_np(rng, n, extent=3.0):
    org = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org, d


def _cps(verts, idx):
    cps = np.stack([verts[idx + k] for k in range(4)], 1)
    return cps[:, :, :3].copy(), cps[:, :, 3].copy()


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def test_hair_ball_fixture_is_the_tests_hair_ball():
    for diagonal in (False, True):
        a = _hair_ball(np.random.default_rng(3), 40, diagonal=diagonal)
        b = hair_ball(np.random.default_rng(3), 40, diagonal=diagonal)
        _same(a[0], b[0])
        _same(a[1], b[1])


def _mb_curve_geoms(module):
    rng = np.random.default_rng(21)
    verts, idx = hair_ball(rng, 12)
    shift = np.float32([0.3, -0.2, 0.1, 0.0])
    return [module.BezierCurvesMB(verts, verts + shift, indices=idx,
                                  tessellation_rate=4),
            module.BezierCurvesMB(indices=idx[:5], tessellation_rate=3,
                                  timesteps=[verts, verts + shift,
                                             verts - 2 * shift])]


@pytest.fixture(scope="module")
def mb_curves_pair():
    ref = et.Scene(et.Device(CFG))
    port = ett.Scene(ett.Device(CFG, device="cpu"))
    for g in _mb_curve_geoms(et):
        ref.attach(g)
    for g in _mb_curve_geoms(ett):
        port.attach(g)
    return ref.commit().mb_curves, port.commit().mb_curves


def _mb_ref_arrays(acc):
    out = {f"bvh.{k}": np.asarray(getattr(acc.bvh, k))
           for k in ("lower", "upper", "child", "count", "prim_order")}
    out.update({k: np.asarray(getattr(acc, k)) for k in MB_FIELDS})
    return out


def test_mb_curve_build_byte_equal(mb_curves_pair):
    ref, port = mb_curves_pair
    assert port.num_timesteps == 3
    for k in ("lower", "upper", "child", "count", "prim_order"):
        _same(getattr(ref.bvh, k), getattr(port.bvh, k).numpy())
    for k in MB_FIELDS:
        _same(getattr(ref, k), getattr(port, k).numpy())


def test_mb_curves_converter_round_trip(mb_curves_pair):
    ref, port = mb_curves_pair
    conv = mb_curves_from_reference(_mb_ref_arrays(ref), "cpu")
    for a, b in zip(list(conv.bvh) + list(conv[1:]),
                    list(port.bvh) + list(port[1:])):
        assert torch.equal(a, b)


GRAZING = 0.02


def _close(t_ref, t_port, valid_ref, valid_port):
    """Hit masks equal, t as the module docstring says; returns the mask
    of the hits whose t agrees within T_RTOL."""
    np.testing.assert_array_equal(valid_ref, valid_port)
    with np.errstate(invalid="ignore"):       # inf - inf on misses
        rel = np.where(valid_ref, np.abs(t_port - t_ref)
                       / np.where(valid_ref, np.abs(t_ref), 1.0), 0.0)
    m = valid_ref & (rel <= T_RTOL)
    assert (valid_ref & ~m).sum() <= GRAZING * valid_ref.sum()
    assert not (rel[valid_ref] > 2e-3).any()
    return m


def test_obb_beats_aabb_on_diagonal_hair():
    """The port's form of tests/test_hair.py's: the strand-aligned
    clusters pop at most half the nodes of an axis-aligned build over the
    same diagonal curves."""
    rng = np.random.default_rng(0x5EED)
    verts, idx = hair_ball(rng, 200, diagonal=True)
    cp3, rad = _cps(verts, idx)
    org, d = _rays_np(rng, 1024)
    t = torch.from_numpy
    rays = Rays(t(org), t(d), torch.zeros(1024),
                torch.full((1024,), float("inf")))

    def pops_of(clusters):
        total = 0
        for cl in clusters:
            fn = port_thair.make_round_curve_intersector(
                cp3[cl.members] @ cl.rot, rad[cl.members], cl.members, 8,
                device="cpu")
            rr = Rays(port_thair.rows_times(rays.org, cl.rot),
                      port_thair.rows_times(rays.dir, cl.rot), rays.tnear,
                      rays.tfar)
            total += port_user.intersect_user(
                port_user.UserAccel(cl.bvh.to_device("cpu"), 0,
                                    int(cl.members.shape[0])),
                fn, rr, rays.tfar, with_stats=True)[-1]
        return total

    from embree_tpu_torch.build.sah import BuildSettings, build_sah
    rmax = rad.max(axis=1, keepdims=True)
    aabb = [port_hair.HairCluster(
        rot=np.eye(3, dtype=np.float32),
        bvh=build_sah(cp3.min(axis=1) - rmax, cp3.max(axis=1) + rmax,
                      BuildSettings()),
        members=np.arange(cp3.shape[0], dtype=np.int32))]
    p_obb = pops_of(port_hair.build_hair_clusters(cp3, rad))
    p_aabb = pops_of(aabb)
    assert p_obb * 2 <= p_aabb, (p_obb, p_aabb)


def test_mb_curve_walk_matches_reference_ray_by_ray(mb_curves_pair):
    """The MB curve walk at per-ray times against the JAX package's walk
    run one ray at a time (its leaf sums the cone's squared axis length
    over the whole batch, so only a batch of one ray is right there):
    same hits, t and prims. The same rays as one batch through the JAX
    package miss or move hits (ROADMAP.md C)."""
    ref_acc, port_acc = mb_curves_pair
    rng = np.random.default_rng(51)
    n = 24
    p0 = port_acc.p0_ts.numpy()                       # (S, C, 4)
    org, _ = _rays_np(rng, n)
    tm = rng.uniform(0, 1, n).astype(np.float32)
    tm[:3] = (0.0, 0.5, 1.0)
    # aim at a segment start where it is at the ray's time
    x = tm * (port_acc.num_timesteps - 1)
    a = np.minimum(x.astype(int), port_acc.num_timesteps - 2)
    w = (x - a)[:, None]
    k = rng.integers(0, p0.shape[1], n)
    tgt = p0[a, k, :3] * (1 - w) + p0[a + 1, k, :3] * w
    d = (tgt - org).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tn = np.zeros(n, np.float32)
    tf = np.full(n, np.inf, np.float32)
    t = torch.from_numpy
    got = port_mb.intersect_mb_curves(port_acc, Rays(t(org), t(d), t(tn),
                                                     t(tf)), t(tm))
    one = [ref_mb.intersect_mb_curves(
        ref_acc, RefRays(org[i:i + 1], d[i:i + 1], tn[i:i + 1], tf[i:i + 1]),
        tm[i:i + 1]) for i in range(n)]
    t_r = np.concatenate([np.asarray(o[0]) for o in one])
    v_r = np.concatenate([np.asarray(o[6]) for o in one])
    p_r = np.concatenate([np.asarray(o[4]) for o in one])
    g_r = np.concatenate([np.asarray(o[5]) for o in one])
    m = _close(t_r, got[0].numpy(), v_r, got[6].numpy())
    assert m.sum() >= n // 2
    np.testing.assert_array_equal(p_r[m], got[4].numpy()[m])
    np.testing.assert_array_equal(g_r[m], got[5].numpy()[m])
    batch = ref_mb.intersect_mb_curves(ref_acc, RefRays(org, d, tn, tf), tm)
    moved = ((np.asarray(batch[6]) != v_r)
             | (v_r & ~np.isclose(np.asarray(batch[0]), t_r, rtol=1e-3)))
    assert moved.any()
