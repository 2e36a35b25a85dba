"""Hair and curves through the port's Scene on the CPU (kernel B3's plain
version for the OBB clusters, the torch-op walks for segment soups and
motion-blur curves): the port's forms of tests/test_hair.py,
tests/test_curves.py, tests/test_lazy_curve_demos.py and
tests/test_motion_blur.py::test_curve_mb, a mixed scene of triangles and
hair (the shape of tests/test_mixed_fastpath.py:34-71), filters over hair
hits, and the hair_geometry and curve_geometry tutorials; each held to
the JAX package's tolerances (or tighter) and also against the JAX
package's `scene_intersect(isa="xla")` on the same input.

Against the JAX package: hit masks equal and t within 1e-4 relative on
every ray, and any hit (`scene_occluded`) equal where it is queried;
except on the OBB path of the diagonal hair ball, where the JAX
package's XLA walk runs its cone test compiled (XLA:CPU contracts
products into FMAs) and the port's kernel B3 rounds every operation. The
cone quadratic B*B - 4*A*C cancels most digits on thin strands at a
grazing angle and a cone leaf tests one root only, so there a grazing
hit can pass one test and fail the other (observed, seed 0xD1A, rate 4:
of 600 rays, 275 round hits, no flip, 3 hits beyond 1e-4 — one at 25 %,
the XLA walk taking curve 41's third sub-segment that the unfused test
rejects —; ribbons within 3.7e-7). Those rays count against the JAX
package's own bound between its two hair paths, 1 % of the rays
(tests/test_hair.py:159-166), and a second witness decides them: the JAX
package's own leaf tests (`_cone_leaf_test`, `_ribbon_leaf_test`) run op
by op without jit over every sub-segment of its packed clusters, with
the rays rotated in the port's order; the port equals that witness bit
for bit on every ray. Queries against the JAX package use tessellation
rates of 4 to 8: its XLA hair walk compiles anew on every call (2 s at
rate 4, 11 s at 16). Tutorial images: the share of pixels more than
1.5/255 apart is bounded (curve_geometry: observed 0; hair_geometry:
observed 1.2 % at 64x48, all on strands, bounded by 2 %)."""

import numpy as np
import pytest
import torch

import embree_tpu as et
import embree_tpu_torch as ett
from embree_tpu_torch.render.camera import Camera
from embree_tpu_torch.verify.fixtures import hair_ball, triangle_sphere

CFG = "ignore_config_files=1"
GRAZING = 0.01
T_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(geoms, cfg=""):
    """Commit the same geometries in both packages: (ref scene, port
    scene); `geoms(pkg)` makes the geometry list of a package."""
    ref = et.Scene(et.Device(CFG + cfg))
    port = ett.Scene(ett.Device(CFG + cfg, device="cpu"))
    for g in geoms(et):
        ref.attach(g)
    for g in geoms(ett):
        port.attach(g)
    ref.commit()
    port.commit()
    return ref, port


def _rays_np(rng, n, extent=3.0, aim=None):
    org = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    if aim is not None:
        d[::2] = (aim[rng.integers(0, len(aim), n)] - org)[::2]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org, d


def _query(ref, port, org, d, occluded=False, **kw):
    """Both packages' answers; `occluded` adds both `scene_occluded`s, which
    `_agree` holds equal (without it only the port's is taken, for tests
    that hold it to the port's own hit mask)."""
    a = et.scene_intersect(ref.committed, et.make_rays(org, d), isa="xla",
                           **kw)
    b = port.intersect(ett.make_rays(org, d, device="cpu"), **kw)
    out = dict(ref=a, port=b, port_occ=port.occluded(
        ett.make_rays(org, d, device="cpu")).numpy()
        if "time" not in kw else None)
    if occluded:
        out["ref_occ"] = np.asarray(et.scene_occluded(
            ref.committed, et.make_rays(org, d), isa="xla"))
    return out


def _witness(ref, org, d):
    """The closest hair hit of each ray by the JAX package's own leaf
    tests run op by op (no jit, so no contraction into FMAs) over every
    sub-segment of every packed cluster, no BVH; the rays rotated into
    each cluster's frame in the port's order (core/math.py::rows_times):
    (valid, t). For a scene of hair alone."""
    import jax
    import jax.numpy as jnp
    from embree_tpu.build.hair import build_hair_clusters
    from embree_tpu.traverse.pallas_hair import (_cone_leaf_test,
                                                 _ribbon_leaf_test)
    (g,) = ref.geometries.values()
    rots = [cl.rot for cl in build_hair_clusters(*g.to_bezier())]
    n = len(org)
    t = np.full(n, np.inf, np.float32)
    with jax.disable_jit():
        for rot, hp in zip(rots, ref.committed.hair_pallas):
            R = jnp.asarray(rot)

            def rotate(x):
                x = jnp.asarray(x)
                return x[:, 0, None] * R[0] + x[:, 1, None] * R[1] \
                    + x[:, 2, None] * R[2]
            o, dv = rotate(org), rotate(d)
            ctx = dict(o=tuple(o[:, c, None] for c in range(3)),
                       d=tuple(dv[:, c, None] for c in range(3)),
                       tnear=jnp.zeros((n, 1), jnp.float32))
            fld = tuple(jnp.asarray(hp.seg)[None, :, c] for c in range(8))
            leaf = _ribbon_leaf_test if hp.flat else _cone_leaf_test
            th, _ = leaf(ctx, fld, 0, jnp.full((n, hp.seg.shape[0]), jnp.inf,
                                               jnp.float32), -1, False, False)
            t = np.minimum(t, np.asarray(th).min(1))
    return np.isfinite(t), t


def _agree(q, witness=None):
    """Hit masks and t against the JAX package as the module docstring
    says, and both packages' any hit where `q` holds them; returns the
    agreeing hits' mask. Without a `witness` every ray agrees; with one,
    the port equals it on every ray and the rays off the JAX package's
    XLA walk are at most GRAZING of the rays."""
    va, vb = np.asarray(q["ref"].valid), q["port"].valid.numpy()
    ta, tb = np.asarray(q["ref"].t), q["port"].t.numpy()
    both = va & vb
    with np.errstate(invalid="ignore"):
        rel = np.where(both, np.abs(ta - tb) / np.where(both, ta, 1.0), 0.0)
    off = (va != vb) | (rel > T_RTOL)
    if witness is None:
        assert not off.any(), (int((va != vb).sum()), rel.max())
    else:
        np.testing.assert_array_equal(witness[0], vb)
        np.testing.assert_array_equal(witness[1][vb], tb[vb])
        assert off.sum() <= GRAZING * va.size, np.nonzero(off)[0]
    if "ref_occ" in q:
        np.testing.assert_array_equal(q["port_occ"], q["ref_occ"])
    ok = both & ~off
    same = np.asarray(q["ref"].prim_id)[ok] == q["port"].prim_id.numpy()[ok]
    assert same.all()
    assert (np.asarray(q["ref"].geom_id)[ok]
            == q["port"].geom_id.numpy()[ok]).all()
    return ok


def _hair(verts, idx, rate=8, flat=False):
    return lambda pkg: [pkg.BezierCurves(verts, idx, tessellation_rate=rate,
                                         flat=flat)]


# --- tests/test_hair.py ------------------------------------------------------

def test_obb_round_matches_segment_soup(rng):
    """The OBB clusters' swept cones (kernel B3) against the segment soup
    (cones with caps, traverse/user.py) in the port, with the JAX
    package's tolerances; the soup also against the JAX package's."""
    verts, idx = hair_ball(rng, 120)
    org, d = _rays_np(rng, 800)
    obb = ett.Scene(ett.Device(CFG + ",hair_accel=obb", device="cpu"))
    obb.attach(ett.BezierCurves(verts, idx, tessellation_rate=8))
    cs_obb = obb.commit()
    ref_seg, seg = _both(_hair(verts, idx), ",hair_accel=segment")
    assert len(cs_obb.hairs) == 13 and not cs_obb.users
    assert seg.committed.users and not seg.committed.hairs
    rays = ett.make_rays(org, d, device="cpu")
    a = obb.intersect(rays)
    b = seg.intersect(rays)
    va, vb = a.valid.numpy(), b.valid.numpy()
    assert (va != vb).mean() < 0.01
    m = va & vb
    np.testing.assert_allclose(a.t.numpy()[m], b.t.numpy()[m], rtol=1e-3,
                               atol=1e-4)
    assert (a.prim_id.numpy()[m] == b.prim_id.numpy()[m]).mean() > 0.98
    _agree(_query(ref_seg, seg, org, d))


@pytest.fixture(scope="module")
def diagonal_pair():
    """A diagonal hair ball (one cluster) committed by both packages,
    round and flat, and rays half aimed at its curves."""
    rng = np.random.default_rng(0xD1A)
    verts, idx = hair_ball(rng, 120, diagonal=True)
    org, d = _rays_np(rng, 600, aim=verts[idx + 1, :3])
    return {flat: (_both(_hair(verts, idx, rate=4, flat=flat)), org, d)
            for flat in (False, True)}


@pytest.mark.parametrize("flat", [False, True], ids=["round", "ribbon"])
def test_obb_matches_reference_and_occluded_equals_valid(diagonal_pair,
                                                         flat):
    (ref, port), org, d = diagonal_pair[flat]
    assert len(port.committed.hairs) == 1
    assert port.committed.hairs[0].packed.flat is flat
    q = _query(ref, port, org, d, occluded=True)
    ok = _agree(q, witness=_witness(ref, org, d))
    assert ok.sum() > 150
    # curves only: any hit is the same set as a closest hit (here through
    # B3's any-hit variant; the JAX package runs its closest-hit walk, so
    # its occlusion is its hit mask), and `_agree` held it to the JAX
    # package's `scene_occluded`
    np.testing.assert_array_equal(q["port_occ"], q["port"].valid.numpy())
    np.testing.assert_allclose(q["port"].u.numpy()[ok],
                               np.asarray(q["ref"].u)[ok], atol=2e-3)
    ng_a, ng_b = np.asarray(q["ref"].ng)[ok], q["port"].ng.numpy()[ok]
    cos = (ng_a * ng_b).sum(1) / (np.linalg.norm(ng_a, axis=1)
                                  * np.linalg.norm(ng_b, axis=1))
    assert np.median(cos) > 0.9999


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


# --- tests/test_curves.py ----------------------------------------------------

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


# --- tests/test_lazy_curve_demos.py -----------------------------------------

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


# --- tests/test_motion_blur.py::test_curve_mb -----------------------------

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


# --- a mixed scene (tests/test_mixed_fastpath.py:34-71) ---------------------

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


# --- filters over hair hits -----------------------------------------------

@pytest.mark.parametrize("flat", [True, False], ids=["ribbon", "round"])
def test_filter_restart_over_hair_hits(diagonal_pair, flat):
    """A filter that keeps the even curves answers as a scene of the even
    curves does (and that scene as the JAX package's): the restart goes on
    past rejected hair hits. Ribbons agree exactly. A cone leaf takes
    one root only (its entry, or its exit where the entry is not past
    tnear), so a ray restarted inside an even curve's open cone end may
    find that curve's exit, which the even scene does not report: counted,
    at most 1 % of the rays (observed: one of 600)."""
    (_ref, port), org, d = diagonal_pair[flat]
    verts = port.geometries[0].vertices
    idx = port.geometries[0].indices
    calls = []

    def keep_even(o, dv, t, u, v, ng, geom, prim):
        calls.append(1)
        return (prim % 2) == 0

    port.set_intersection_filter(keep_even)
    try:
        got = port.intersect(ett.make_rays(org, d, device="cpu"))
    finally:
        port.set_intersection_filter(None)
    assert len(calls) > 1                      # restarted at least once
    ref_even, port_even = _both(_hair(verts, idx[::2], rate=4, flat=flat))
    want = port_even.intersect(ett.make_rays(org, d, device="cpu"))
    same = (got.valid == want.valid) & ((got.t == want.t) | ~got.valid)
    if flat:
        assert same.all()
    else:
        assert (~same).sum() <= 0.01 * same.numel()
    assert torch.equal(got.prim_id[same & got.valid],
                       2 * want.prim_id[same & want.valid])
    assert (got.prim_id[got.valid] % 2 == 0).all()
    if flat:
        _agree(_query(ref_even, port_even, org, d))


# --- the tutorials ---------------------------------------------------------

def _tutorial_images(name, size=(64, 48)):
    from embree_tpu.render.camera import Camera as RefCamera
    import importlib
    ref_mod = importlib.import_module(
        f"embree_tpu.render.tutorials.{name}")
    port_mod = importlib.import_module(
        f"embree_tpu_torch.render.tutorials.{name}")
    app = port_mod.make_app()
    c = app.camera
    ref_img, _ = ref_mod.render_frame(
        ref_mod.build_scene(),
        RefCamera(from_=c.from_, to=c.to, up=c.up, fov=c.fov), size)
    port_img, _ = port_mod.render_frame(
        port_mod.build_scene(ett.Device(CFG, device="cpu")), c, size)
    return np.asarray(ref_img), port_img.numpy()


@pytest.mark.parametrize("name,budget", [("curve_geometry", 0.0),
                                         ("hair_geometry", 0.02)])
def test_tutorial_matches_reference(name, budget):
    ref, port = _tutorial_images(name)
    assert port.shape == ref.shape == (48, 64, 3)
    diff = np.abs(ref - port).max(-1)
    assert np.isfinite(port).all()
    assert (diff > 1.5 / 255).mean() <= budget, (diff > 1.5 / 255).mean()
    assert (port.max(-1) > 0).mean() > 0.3


@pytest.mark.parametrize("name", ["hair_geometry", "curve_geometry"])
def test_tutorial_cli(name, tmp_path, capsys):
    import importlib
    from embree_tpu_torch.render.image import read_ppm
    mod = importlib.import_module(
        f"embree_tpu_torch.render.tutorials.{name}")
    out = tmp_path / f"{name}.ppm"
    rc = mod.make_app().run(["--size", "32", "24", "-o", str(out),
                             "--benchmark", "0", "1",
                             "-rtcore", "device=cpu"])
    assert rc == 0
    text = capsys.readouterr().out
    for key in ("BENCHMARK_RENDER_AVG", "BENCHMARK_RENDER_MRAYPS_AVG"):
        assert key in text
    img = read_ppm(str(out))
    assert img.shape == (24, 32, 3) and img.max() > 0
