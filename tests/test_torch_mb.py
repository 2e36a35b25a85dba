"""Motion blur in the PyTorch port against the JAX package, at the scene
level: the port's forms of tests/test_motion_blur.py (all but the curve
test: motion-blur curves are not ported), `_build_mb`'s arrays and
`refit` bit for bit, whole scenes through `scene_intersect` at per-ray
times (quads, subdivision meshes, static triangles beside), the filter
restart with per-ray times, the raises, and the motion_blur_geometry
tutorial's image for the same per-pixel times.

Tolerances: the build, the refit and the knot soups bit-equal; valid
masks equal; t 5e-5 relative (XLA:CPU contracts products into FMAs, the
port rounds every product); prim equal except on equal-t ties, which are
counted and are 0 on these shapes; u, v 5e-5 absolute (XLA:CPU also
contracts the vertex lerp, and U / |den| carries its ulp into u and v),
except on the crossing clusters (edges of 0.05 seen from 5 to 13 away)
and the subdivision cube (near-grazing hits), where float32 keeps only
three to four digits of u and v in either package and the two differ by
up to 1.2e-3 and 5.4e-4: 5e-3 and 1e-3 there; the tutorial's pixels
1e-5 absolute."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import embree_tpu as et
import embree_tpu_torch as ett
from embree_tpu.build import refit as ref_refit
from embree_tpu.build.bvh import BVH as RefBVH
from embree_tpu.render.tutorials import motion_blur_geometry as ref_tut
from embree_tpu_torch.build import refit as port_refit
from embree_tpu_torch.build.bvh import sah_cost
from embree_tpu_torch.build.sah import BuildSettings, build_sah
from embree_tpu_torch.render.tutorials import motion_blur_geometry as port_tut
from embree_tpu_torch.scene.prims import prim_bounds_np
from embree_tpu_torch.verify.fixtures import (crossing_clusters, subdiv_cube,
                                              triangle_sphere)
from test_torch_build import reference_native  # noqa: F401,E402

CFG = "ignore_config_files=1"
TRI = np.array([[-1, -1, 0], [1, -1, 0], [0, 1, 0]], np.float32)
TRI_IDX = np.array([[0, 1, 2]], np.int32)



@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Six test processes share the cores: one intra-op thread a process
    keeps torch's parallel regions from spinning against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def commit_both(geoms, levels=None):
    """The same geometries committed in each package. `geoms` holds
    (class name, args, kwargs); numpy arrays are shared."""
    out = []
    for pkg, dev in ((et, et.Device(CFG)), (ett, ett.Device(CFG,
                                                            device="cpu"))):
        sc = pkg.Scene(dev)
        for name, args, kw in geoms:
            sc.attach(getattr(pkg, name)(*args, **kw))
        if levels is not None:
            sc.set_levels(*levels)
        sc.commit()
        out.append(sc)
    return out


def intersect_both(ref, port, org, d, time):
    h_r = et.scene_intersect(ref.committed, et.make_rays(org, d), isa="xla",
                             time=time)
    h_p = ett.scene_intersect(port.committed,
                              ett.make_rays(org, d, device="cpu"),
                              time=torch.as_tensor(time))
    return h_r, h_p


def assert_matches(ref, port, uv_atol=5e-5):
    """ref: JAX Hits; port: torch Hits. Returns the number of ties."""
    rv = np.asarray(ref.valid)
    np.testing.assert_array_equal(port.valid.numpy(), rv)
    rt, pt = np.asarray(ref.t), port.t.numpy()
    np.testing.assert_allclose(pt[rv], rt[rv], rtol=5e-5)
    np.testing.assert_array_equal(pt[~rv], rt[~rv])
    same = np.asarray(ref.gprim) == port.gprim.numpy()
    np.testing.assert_allclose(pt[~same], rt[~same], rtol=5e-5)
    m = rv & same
    for f in ("prim_id", "geom_id"):
        np.testing.assert_array_equal(getattr(port, f).numpy()[m],
                                      np.asarray(getattr(ref, f))[m])
    for f in ("u", "v"):
        np.testing.assert_allclose(getattr(port, f).numpy()[m],
                                   np.asarray(getattr(ref, f))[m],
                                   atol=uv_atol)
    return int((~same).sum())


def sphere_knots(res, offsets):
    v, idx = triangle_sphere((0, 0, 0), 2.0, res)
    return [v + np.float32(o) for o in offsets], idx


KINKED = ((0, 0, 0), (0.8, 0.3, 0.0), (1.6, -0.4, 0.0))
ZIGZAG = ((0, 0, 0), (0.5, 0, 0), (0.5, 0.7, 0), (-0.2, 0.7, 0.3))


def _shape(name):
    """(geometries, levels, ray extent) of the scenes the build and
    intersect parity tests run on."""
    if name == "linear":
        return [("TriangleMeshMB", (TRI, TRI + np.float32([4, 0, 0]),
                                    TRI_IDX), {})], None, 4.0
    if name == "zigzag":
        ts, idx = sphere_knots(8, ZIGZAG)
        return [("TriangleMeshMB", (), dict(indices=idx, timesteps=ts))], \
            None, 3.0
    if name == "cross":
        ts, idx = crossing_clusters(np.random.default_rng(0xB10))
        return [("TriangleMeshMB", (), dict(indices=idx, timesteps=ts))], \
            None, 8.0
    if name == "quad":
        q = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]],
                     np.float32)
        return [("QuadMeshMB", (q, q + np.float32([0, 0, 2]),
                                np.array([[0, 1, 2, 3]], np.int32)), {})], \
            None, 1.5
    if name == "subdiv":
        v, counts, faces = subdiv_cube()
        return [("SubdivMeshMB", (v, v * np.float32(1.3)
                                  + np.float32([0.3, 0, 0]), counts, faces),
                 {}),
                ("TriangleMesh", (TRI * np.float32(4) + np.float32(
                    [0, 0, -3]), TRI_IDX), {})], (3, 3), 3.0
    raise KeyError(name)


SHAPES = ("linear", "zigzag", "cross", "quad", "subdiv")


@pytest.fixture(scope="module")
def scenes():
    cache = {}

    def get(name):
        if name not in cache:
            geoms, levels, extent = _shape(name)
            cache[name] = commit_both(geoms, levels) + [extent]
        return cache[name]
    return get


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("name", SHAPES)
def test_build_mb_bit_equal(scenes, name):
    """`_build_mb`'s arrays: the knot soups, the per-knot refit bounds,
    the topology and the time gates, with temporal splits (`cross`) and
    without."""
    ref, port, _ = scenes(name)
    r, p = ref.committed.mb, port.committed.mb
    assert p.has_time_splits == r.has_time_splits == (name == "cross")
    for f in ("lower_ts", "upper_ts", "v0_ts", "v1_ts", "v2_ts", "geom_id",
              "prim_id", "uv_flip", "time_lo", "time_hi"):
        a, b = getattr(r, f), getattr(p, f)
        if a is None:
            assert b is None
            continue
        assert tuple(b.shape) == tuple(np.shape(a)), f
        np.testing.assert_array_equal(_bits(b.numpy()), _bits(a), err_msg=f)
    for f in ("lower", "upper", "child", "count", "prim_order"):
        np.testing.assert_array_equal(_bits(getattr(p.bvh, f).numpy()),
                                      _bits(getattr(r.bvh, f)), err_msg=f)
    wl, wu = port.bounds
    knots = np.stack([p.v0_ts.numpy(), p.v1_ts.numpy(), p.v2_ts.numpy()])
    assert (wl <= knots.min((0, 1, 2))).all()
    assert (wu >= knots.max((0, 1, 2))).all()


@pytest.mark.parametrize("name", SHAPES)
def test_scene_intersect_matches_reference(scenes, rng, name):
    ref, port, extent = scenes(name)
    n = 512
    times = rng.uniform(0, 1, n).astype(np.float32)
    times[::7] = 0.0
    times[::11] = 1.0
    org = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    org[:, 2] = 5.0
    d = rng.normal(size=(n, 3)).astype(np.float32) * 0.3
    d[:, 2] = -1.0
    # every second ray aims at a random moving triangle where it is at
    # the ray's time
    mb = port.committed.mb
    S = mb.num_timesteps
    x = times * np.float32(S - 1)
    seg = np.clip(x.astype(np.int32), 0, S - 2)
    w = (x - seg)[:, None]
    k = rng.integers(0, mb.v0_ts.shape[1], n)
    cen = sum(vt.numpy()[seg, k] * (1 - w) + vt.numpy()[seg + 1, k] * w
              for vt in (mb.v0_ts, mb.v1_ts, mb.v2_ts)) / 3
    d[::2] = (cen - org)[::2]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    h_r, h_p = intersect_both(ref, port, org, d, times)
    assert np.asarray(h_r.valid).sum() >= 3
    uv_atol = {"cross": 5e-3, "subdiv": 1e-3}.get(name, 5e-5)
    assert assert_matches(h_r, h_p, uv_atol) == 0


def test_refit_bit_equal(rng):
    v0, v1, v2 = (rng.uniform(-3, 3, (600, 3)).astype(np.float32)
                  for _ in range(3))
    lo, hi = prim_bounds_np(v0, v1, v2)
    bvh_np = build_sah(lo, hi, BuildSettings())
    moved = [a + rng.normal(size=a.shape).astype(np.float32) * 0.3
             for a in (v0, v1, v2)]
    mlo, mhi = prim_bounds_np(*moved)
    port_bvh = bvh_np.to_device("cpu")
    ref_bvh = RefBVH(*(jnp.asarray(a) for a in bvh_np))
    p = port_refit.refit(port_bvh, port_refit.plan_refit(port_bvh),
                         torch.from_numpy(mlo), torch.from_numpy(mhi))
    r = ref_refit.refit(ref_bvh, ref_refit.plan_refit(ref_bvh),
                        jnp.asarray(mlo), jnp.asarray(mhi))
    for f in ("lower", "upper"):
        np.testing.assert_array_equal(_bits(getattr(p, f).numpy()),
                                      _bits(getattr(r, f)))
    assert not np.array_equal(p.lower.numpy(), bvh_np.lower)
    # every valid slot bounds its subtree's moved prims
    root = p.lower[0][p.count[0] >= 0].amin(0), p.upper[0][
        p.count[0] >= 0].amax(0)
    assert (root[0].numpy() <= mlo.min(0)).all()
    assert (root[1].numpy() >= mhi.max(0)).all()


# ---- the port's forms of tests/test_motion_blur.py --------------------

def test_mb_triangle_interpolates(scenes):
    ref, port, _ = scenes("linear")
    org = np.array([[0, 0, 5], [2, 0, 5], [4, 0, 5]], np.float32)
    d = np.array([[0, 0, -1]] * 3, np.float32)
    for tq, want in ((0.0, [True, False, False]), (0.5, [False, True, False]),
                     (1.0, [False, False, True])):
        h_r, h_p = intersect_both(ref, port, org, d, tq)
        assert h_p.valid.tolist() == want
        assert assert_matches(h_r, h_p) == 0
        if tq == 0.5:
            assert abs(float(h_p.t[1]) - 5.0) < 1e-4


def test_mb_per_ray_time(scenes):
    ref, port, _ = scenes("linear")
    org = np.array([[0, 0, 5], [4, 0, 5]], np.float32)
    d = np.array([[0, 0, -1]] * 2, np.float32)
    h_r, h_p = intersect_both(ref, port, org, d,
                              np.array([0.0, 1.0], np.float32))
    assert h_p.valid.tolist() == [True, True]
    assert assert_matches(h_r, h_p) == 0
    # times in the rays' batch shape
    h2 = port.intersect(ett.make_rays(org[None], d[None], device="cpu"),
                        time=torch.tensor([[0.0, 1.0]]))
    assert h2.valid.shape == (1, 2) and h2.valid.all()


def test_mb_combined_with_static():
    geoms = [("TriangleMesh", (TRI, TRI_IDX), {}),
             ("TriangleMeshMB", (TRI + np.float32([0, 0, 2]),
                                 TRI + np.float32([0, 0, 3]), TRI_IDX), {})]
    ref, port = commit_both(geoms)
    org = np.array([[0, 0, 5]], np.float32)
    d = np.array([[0, 0, -1]], np.float32)
    for tq, want in ((0.0, 3.0), (1.0, 2.0)):
        h_r, h_p = intersect_both(ref, port, org, d, tq)
        assert abs(float(h_p.t[0]) - want) < 1e-4
        assert int(h_p.geom_id[0]) == 1
        assert assert_matches(h_r, h_p) == 0


def test_multisegment_four_timesteps(rng):
    """N=4 timesteps of zig-zag motion: hits at segment-interior times
    equal those of a static scene at the exactly interpolated cage."""
    ts, idx = sphere_knots(12, ZIGZAG)
    dev = ett.Device(CFG, device="cpu")
    s = ett.Scene(dev)
    s.attach(ett.TriangleMeshMB(indices=idx, timesteps=ts))
    s.commit()
    n = 4000
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = ett.make_rays(np.zeros((n, 3), np.float32), d, device="cpu")
    for tq in (0.0, 0.18, 1.0 / 3.0, 0.5, 0.83, 1.0):
        h = s.intersect(rays, time=torch.full((n,), tq))
        x = np.float32(tq) * np.float32(3)
        a = int(min(np.floor(x), 2))
        w = np.float32(x - a)
        static = ett.Scene(dev)
        static.attach(ett.TriangleMesh((1 - w) * ts[a] + w * ts[a + 1], idx))
        static.commit()
        href = static.intersect(rays)
        assert torch.equal(h.valid, href.valid)
        m = href.valid
        np.testing.assert_allclose(h.t[m].numpy(), href.t[m].numpy(),
                                   rtol=2e-5, atol=2e-6)


def test_temporal_splits_mb4d(scenes, rng):
    """Crossing clusters: the build emits time-gated subtrees whose
    per-knot SAH cost beats a union topology's by more than 1.3x, and
    hits equal a brute force over the lerped triangles."""
    ts, idx = crossing_clusters(np.random.default_rng(0xB10))
    S = len(ts)
    _ref, port, _ = scenes("cross")
    mb = port.committed.mb
    assert mb.has_time_splits and (mb.time_lo[0] > 0).any()
    los, his = zip(*(prim_bounds_np(v[idx[:, 0]], v[idx[:, 1]], v[idx[:, 2]])
                     for v in ts))
    union_np = build_sah(np.minimum.reduce(los), np.maximum.reduce(his),
                         BuildSettings())
    union = union_np.to_device("cpu")
    sched = port_refit.plan_refit(union)
    worst_union = 0.0
    for s in range(S):
        b = port_refit.refit(union, sched, torch.from_numpy(los[s]),
                             torch.from_numpy(his[s]))
        worst_union = max(worst_union, sah_cost(union_np._replace(
            lower=b.lower.numpy(), upper=b.upper.numpy())))
    ch0, cn0 = mb.bvh.child[0].numpy(), mb.bvh.count[0].numpy()
    bases = [int(ch0[r]) for r in range(ch0.shape[0]) if cn0[r] == 0]
    ends = bases[1:] + [mb.bvh.child.shape[0]]
    worst_split = 0.0
    for s in range(S):
        tk = s / (S - 1)
        for r, (b0, b1) in enumerate(zip(bases, ends)):
            if mb.time_lo[0, r] <= tk <= mb.time_hi[0, r]:
                worst_split = max(worst_split, sah_cost(union_np._replace(
                    lower=mb.lower_ts[s, b0:b1].numpy(),
                    upper=mb.upper_ts[s, b0:b1].numpy(),
                    child=mb.bvh.child[b0:b1].numpy(),
                    count=mb.bvh.count[b0:b1].numpy())))
                break
    assert worst_union > 1.3 * worst_split, (worst_union, worst_split)

    nray = 300
    org = rng.uniform(-8, 8, (nray, 3)).astype(np.float32)
    d = rng.normal(size=(nray, 3)).astype(np.float32)
    tmv = rng.uniform(0, 1, nray).astype(np.float32)
    x = np.clip(tmv, 0, 1) * (S - 1)
    seg = np.clip(x.astype(np.int32), 0, S - 2)
    w = (x - seg)[:, None, None]
    va = np.stack(ts).astype(np.float64)
    vi = va[seg] * (1 - w) + va[seg + 1] * w
    # every second ray aims at a random triangle where it is at its time
    k = rng.integers(0, len(idx), nray)
    cen = vi[np.arange(nray)[:, None], idx[k]].mean(1)
    d[::2] = (cen - org)[::2]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    h = port.intersect(ett.make_rays(org, d, device="cpu"),
                       time=torch.from_numpy(tmv))
    v0, v1, v2 = (vi[:, idx[:, k]] for k in range(3))      # (R, n, 3)
    e1, e2 = v1 - v0, v2 - v0
    p = np.cross(d[:, None].astype(np.float64), e2)
    det = np.einsum("rnk,rnk->rn", e1, p)
    ok = np.abs(det) > 1e-12
    inv = 1.0 / np.where(ok, det, 1.0)
    tv = org[:, None].astype(np.float64) - v0
    u = np.einsum("rnk,rnk->rn", tv, p) * inv
    q = np.cross(tv, e1)
    vv = np.einsum("rk,rnk->rn", d.astype(np.float64), q) * inv
    t = np.einsum("rnk,rnk->rn", e2, q) * inv
    hit = ok & (u >= -1e-6) & (vv >= -1e-6) & (u + vv <= 1 + 1e-6) & (t > 0)
    t_best = np.where(hit, t, np.inf).min(1)
    valid = np.isfinite(t_best)
    np.testing.assert_array_equal(h.valid.numpy(), valid)
    assert valid.sum() >= 5
    np.testing.assert_allclose(h.t.numpy()[valid], t_best[valid], rtol=1e-4)


def test_quad_mb(scenes):
    ref, port, _ = scenes("quad")
    org = np.array([[0.5, 0.5, 5], [-0.5, -0.5, 5]], np.float32)
    d = np.array([[0, 0, -1]] * 2, np.float32)
    h0_r, h0 = intersect_both(ref, port, org, d, 0.0)
    h1_r, h1 = intersect_both(ref, port, org, d, 1.0)
    assert h0.valid.all()
    np.testing.assert_allclose(h0.t.numpy(), [5.0, 5.0], rtol=1e-5)
    np.testing.assert_allclose(h1.t.numpy(), [3.0, 3.0], rtol=1e-5)
    assert 0.6 < float(h0.u[0]) < 0.9 and 0.6 < float(h0.v[0]) < 0.9
    assert 0.1 < float(h0.u[1]) < 0.4 and 0.1 < float(h0.v[1]) < 0.4
    assert assert_matches(h0_r, h0) == assert_matches(h1_r, h1) == 0


# ---- filters, raises, the tutorial ------------------------------------

def test_filter_restart_keeps_each_rays_time(scenes, rng):
    """A filter that rejects every hit on the moving mesh's first half of
    prims: each restart round re-traces with the ray's own time, so the
    result equals the unfiltered hits of a scene without those prims."""
    ts, idx = sphere_knots(10, KINKED)
    keep = np.arange(len(idx)) >= len(idx) // 2
    n = 400
    org = rng.uniform(-2, 3, (n, 3)).astype(np.float32)
    org[:, 2] = 5.0
    d = np.tile(np.float32([0, 0, -1]), (n, 1))
    times = torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32))
    rays = ett.make_rays(org, d, device="cpu")
    dev = ett.Device(CFG, device="cpu")
    full = ett.Scene(dev)
    full.attach(ett.TriangleMeshMB(indices=idx, timesteps=ts))
    full.commit()
    half = ett.Scene(dev)
    half.attach(ett.TriangleMeshMB(indices=idx[keep], timesteps=ts))
    half.commit()
    full.set_intersection_filter(
        lambda o, dd, t, u, v, ng, geom, prim: prim >= len(idx) // 2)
    got = full.intersect(rays, time=times)
    want = half.intersect(rays, time=times)
    assert got.valid.sum() > 20
    assert torch.equal(got.valid, want.valid)
    assert torch.equal(got.t, want.t)
    assert torch.equal(got.prim_id[got.valid],
                       want.prim_id[want.valid] + len(idx) // 2)
    # a ray's time, not the batch's, decides: the same rays at time 0
    at0 = full.intersect(rays, time=0.0)
    assert not torch.equal(at0.valid, got.valid)


def test_occluded_over_motion_blur_raises_and_curves_stay_unported(scenes):
    _ref, port, _ = scenes("linear")
    rays = ett.make_rays(np.array([[0, 0, 5]], np.float32),
                         np.array([[0, 0, -1]], np.float32), device="cpu")
    with pytest.raises(ett.RaytracerError,
                       match="not ported yet: occluded over motion-blur "
                             "geometry") as e:
        port.occluded(rays)
    assert e.value.code == ett.Error.INVALID_OPERATION

    class BezierCurvesMB(ett.Geometry):
        num_prims = 1

    sc = ett.Scene(ett.Device(CFG, device="cpu"))
    sc.attach(BezierCurvesMB())
    with pytest.raises(ett.RaytracerError,
                       match="not ported yet: geometry type BezierCurvesMB"):
        sc.commit()


def test_tutorial_matches_reference_for_the_same_times():
    W, H = 96, 64
    key = jax.random.PRNGKey(3)
    rs = ref_tut.build_scene()
    cam = ref_tut.make_app().camera
    ref = np.asarray(ref_tut.render(rs["cscene"], key,
                                    *cam.ispc_camera(W, H), width=W,
                                    height=H))
    times = torch.from_numpy(
        np.array(jax.random.uniform(key, (H, W))).reshape(-1))
    st = port_tut.build_scene(ett.Device(CFG, device="cpu"))
    pcam = port_tut.make_app().camera.ispc_camera(W, H, device="cpu")
    img = port_tut.render(st["cscene"], st["colors"], times, *pcam,
                          width=W, height=H).numpy()
    assert (img.max(-1) > 0).mean() > 0.3
    np.testing.assert_allclose(img, ref, atol=1e-5)
    # the accumulation buffer: frames averaged, times from the frame count
    state = port_tut.build_scene(ett.Device(CFG, device="cpu"))
    app = port_tut.make_app()
    f0, _ = port_tut.render_frame(state, app.camera, (16, 12))
    f0 = f0.clone()
    f1, nrays = port_tut.render_frame(state, app.camera, (16, 12))
    assert state["frame"] == 2 and nrays == 16 * 12
    one = port_tut.render(state["cscene"], state["colors"],
                          port_tut.frame_times(1, 16, 12, "cpu"),
                          *app.camera.ispc_camera(16, 12, device="cpu"),
                          width=16, height=12)
    torch.testing.assert_close(f1, (f0 + one) / 2, rtol=0, atol=1e-6)


def test_tutorial_cli(tmp_path, capsys):
    out = tmp_path / "mb.ppm"
    rc = port_tut.make_app().run(["--size", "32", "24", "-o", str(out),
                                  "--benchmark", "0", "2",
                                  "-rtcore", "device=cpu"])
    assert rc == 0 and out.read_bytes().startswith(b"P6")
    assert "BENCHMARK_RENDER_AVG" in capsys.readouterr().out
