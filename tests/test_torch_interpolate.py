"""`Scene.interpolate` / `interpolate_normal` of the port (rtcInterpolate)
against the JAX package's, the port's forms of tests/test_interpolation.py,
and the `interpolation` tutorial against the JAX package's image.

The same seeded (prim, u, v) go through both packages on the CPU. Values
(positions, attributes) and normals are held at 1e-5 of the largest
entry of the field, the derivative set of triangles and quads at 1e-4.
The analytic derivatives of subdivision meshes through
`Scene.interpolate(..., derivatives=True)` are held against the JAX
package in tests/test_torch_patches.py, beside `eval_patch_table`, whose
JAX side compiles there once."""
import itertools

import numpy as np
import torch

import embree_tpu as et
import embree_tpu_torch as ett
from embree_tpu.render.camera import Camera as JCamera
from embree_tpu.render.tutorials import interpolation as jinterp
from embree_tpu_torch.render.camera import Camera
from embree_tpu_torch.render.tutorials import interpolation as interp
from embree_tpu_torch.render.tutorials.interpolation import (CUBE_COLORS,
                                                             CUBE_Q, CUBE_T,
                                                             CUBE_V)

DERIV_TOL = {"P": 1e-5, "dPdu": 1e-4, "dPdv": 1e-4, "ddPdudu": 1e-4,
             "ddPdvdv": 1e-4, "ddPdudv": 1e-4, "Ng": 1e-4}


def pentagon_cap():
    """A pentagon with a ring of quads around it (tests/test_patches.py's
    n-gon cage) and one colour a vertex."""
    ang = np.linspace(0, 2 * np.pi, 5, endpoint=False)
    ring = np.stack([np.cos(ang), np.sin(ang), np.zeros(5)], 1)
    verts = np.concatenate([ring, 2.2 * ring + np.array([0, 0, 0.4])])
    faces, counts = [[0, 1, 2, 3, 4]], [5]
    for i in range(5):
        j = (i + 1) % 5
        faces.append([i, 5 + i, 5 + j, j])
        counts.append(4)
    return (verts.astype(np.float32), np.asarray(counts, np.int32),
            np.concatenate(faces).astype(np.int32),
            np.linspace(0, 1, 30, dtype=np.float32).reshape(10, 3))


def close(name, got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, name
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{name}: {err:.3g} of the largest entry (tol {tol})"
    return err


def both(make, mode=None, levels=(3, 2)):
    """The same geometry attached and committed in both packages."""
    out = []
    for pkg, kw in ((et, {}), (ett, {"device": "cpu"})):
        cfg = "ignore_config_files=1"
        if mode:
            cfg += f",subdiv_accel=bvh4.compressed.{mode}"
        s = pkg.Scene(pkg.Device(cfg, **kw))
        s.set_levels(*levels)
        gid = s.attach(make(pkg))
        s.commit()
        out.append((s, gid))
    return out


def points(rng, n, faces, counts=None):
    prim = rng.integers(0, faces, n)
    u = rng.uniform(0, 1, n).astype(np.float32)
    v = rng.uniform(0, 1, n).astype(np.float32)
    if counts is not None:          # n-gon faces: u in [0, n)
        c = counts[prim]
        u = np.where(c == 4, u, u + rng.integers(0, np.maximum(c, 1)))
        u = u.astype(np.float32)
    return prim, u, v


def test_triangle_and_quad_meshes_match_the_jax_package(rng):
    """Positions, normals, `slot=0`, the derivative set and
    interpolate_normal for a triangle and a quad mesh (a cube with moved
    vertices); the port's
    forms of test_interpolation.py's analytic and corner checks. For
    quads ddPdudv is zero in both packages although the bilinear patch's
    is p0 - p1 + p2 - p3 (ROADMAP.md C.2)."""
    # a cube with its vertices moved, so that its quads are not planar
    bent = (CUBE_V + rng.normal(0, 0.2, CUBE_V.shape)).astype(np.float32)
    for kind, idx in (("TriangleMesh", CUBE_T), ("QuadMesh", CUBE_Q)):
        def make(pkg):
            g = getattr(pkg, kind)(bent, idx)
            g.vertex_attributes.append(CUBE_COLORS)
            return g
        (js, jg), (ts, tg) = both(make)
        prim, u, v = points(rng, 64, len(idx))
        if kind == "TriangleMesh":
            v = (v * (1 - u)).astype(np.float32)
        jP, jN = js.interpolate(jg, prim, u, v)
        tP, tN = ts.interpolate(tg, prim, u, v)
        close(f"{kind} P", tP, jP, 1e-5)
        close(f"{kind} N", tN, jN, 1e-5)
        close(f"{kind} slot 0", ts.interpolate(tg, prim, u, v, slot=0),
              js.interpolate(jg, prim, u, v, slot=0), 1e-5)
        close(f"{kind} interpolate_normal",
              ts.interpolate_normal(tg, torch.from_numpy(prim), u, v),
              js.interpolate_normal(jg, prim, u, v), 1e-5)
        jd = js.interpolate(jg, prim, u, v, derivatives=True)
        td = ts.interpolate(tg, torch.from_numpy(prim), torch.from_numpy(u),
                            torch.from_numpy(v), derivatives=True)
        assert set(td) == set(jd)
        for k in jd:
            close(f"{kind} {k}", td[k], jd[k], DERIV_TOL[k])
        if kind == "QuadMesh":
            assert not td["ddPdudv"].any()
            q = bent[CUBE_Q[prim]]
            true = q[:, 0] - q[:, 1] + q[:, 2] - q[:, 3]
            assert np.abs(true).max() > 0.1
    # test_interpolation.py: barycentric colours, the quad's corners
    (_, _), (ts, tg) = both(lambda pkg: _with_colors(pkg.TriangleMesh(
        CUBE_V, CUBE_T)))
    got = ts.interpolate(tg, np.array([0, 3]), np.array([0.25, 0.5]),
                         np.array([0.25, 0.25]), slot=0).numpy()
    for k, (p, a, b) in enumerate(((0, 0.25, 0.25), (3, 0.5, 0.25))):
        i0, i1, i2 = CUBE_T[p]
        want = ((1 - a - b) * CUBE_COLORS[i0] + a * CUBE_COLORS[i1]
                + b * CUBE_COLORS[i2])
        np.testing.assert_allclose(got[k], want, atol=1e-6)
    P, N = ts.interpolate(tg, np.array([0]), np.array([0.3]),
                          np.array([0.4]))
    assert abs(float(torch.linalg.norm(N[0])) - 1.0) < 1e-5
    (_, _), (ts, tg) = both(lambda pkg: _with_colors(pkg.QuadMesh(CUBE_V,
                                                                  CUBE_Q)))
    got = ts.interpolate(tg, np.zeros(4, np.int64), np.array([0, 1, 1, 0]),
                         np.array([0, 0, 1, 1]), slot=0)
    np.testing.assert_allclose(got.numpy(), CUBE_COLORS[CUBE_Q[0]],
                               atol=1e-6)


def _with_colors(g, colors=CUBE_COLORS):
    g.vertex_attributes.append(colors)
    return g


def test_subdivision_meshes_match_the_jax_package(rng):
    """A subdivision cube and the pentagon cap: (P, N) through the
    evaluation grids, `slot=0` refined through `evaluate_plan`, and
    interpolate_normal through the fused table; the eager scene builds
    its SubdivEval at the first call, the compressed ones keep theirs
    through the commit that drops the unpacked tiles. An n-gon face
    samples its sub-patch 0 with u clamped to [0, 1]: u + 3 answers as
    u = 1 (ROADMAP.md C.2)."""
    vc, cc, ic, _ = pentagon_cap()
    cages = (("cube", CUBE_V, np.full(6, 4, np.int32), CUBE_Q.reshape(-1),
              CUBE_COLORS),
             ("pentagon cap", vc, cc, ic, pentagon_cap()[3]))
    for mode, (name, verts, counts, idx, colors) in itertools.product(
            (None, "grid", "leaf"), cages):
        (js, jg), (ts, tg) = both(
            lambda pkg: _with_colors(pkg.SubdivMesh(verts, counts, idx),
                                     colors), mode)
        if mode is None:
            assert ts.subdiv_eval == {}
        prim, u, v = points(rng, 64, len(counts))
        u = np.minimum(u, 1).astype(np.float32)   # grid uv is [0, 1]
        jP, jN = js.interpolate(jg, prim, u, v)
        tP, tN = ts.interpolate(tg, prim, u, v)
        close(f"{name} {mode} P", tP, jP, 1e-5)
        close(f"{name} {mode} N", tN, jN, 1e-5)
        close(f"{name} {mode} slot 0", ts.interpolate(tg, prim, u, v, slot=0),
              js.interpolate(jg, prim, u, v, slot=0), 1e-5)
        close(f"{name} {mode} interpolate_normal",
              ts.interpolate_normal(tg, torch.from_numpy(prim), u, v),
              js.interpolate_normal(jg, prim, u, v), 1e-5)
        assert ("nrm_fused", tg) in ts._attr_cache
        if name == "pentagon cap":
            ngon = prim == 0
            assert ngon.any()
            moved = ts.interpolate(tg, prim[ngon], u[ngon] + 3, v[ngon])[0]
            edge = ts.interpolate(tg, prim[ngon], np.ones(ngon.sum()),
                                  v[ngon])[0]
            assert torch.equal(moved, edge)
        if name == "cube":
            # test_interpolation.py: the smoothed colour at a face's
            # centre lies inside the colours' hull, near the corners' mean
            c = ts.interpolate(tg, np.array([0]), np.array([0.5]),
                               np.array([0.5]), slot=0)[0].numpy()
            assert np.all(c >= CUBE_COLORS.min(0) - 1e-6)
            assert np.all(c <= CUBE_COLORS.max(0) + 1e-6)
            assert np.linalg.norm(c - CUBE_COLORS[CUBE_Q[0]].mean(0)) < 0.35
    # a new commit drops what the caches held
    ts.commit()
    assert ts._attr_cache == {} and ts._patch_tables == {}


def test_interpolation_tutorial_matches_the_jax_package():
    """The `interpolation` tutorial at 64x64 against the JAX package's
    frame: every pixel within 2/255 (both packages quantize the same
    colours; the budget is 0.5 % of the pixels for t ties at cube
    edges)."""
    cam = dict(from_=(0, 3, -6.5), to=(0, 0, 0))
    img, n = interp.render_frame(interp.build_scene(rtcore="device=cpu"),
                                 Camera(**cam), (64, 64))
    ref, _ = jinterp.render_frame(jinterp.build_scene(), JCamera(**cam),
                                  (64, 64))
    ref = np.asarray(ref)
    assert n == 64 * 64 and img.shape == ref.shape == (64, 64, 3)
    bad = float((np.abs(img.numpy() - ref).max(-1) > 2 / 255).mean())
    assert bad <= 0.005, f"{bad:.4%} of the pixels differ"
    assert img.max() > 0.2 and torch.isfinite(img).all()
    # all three cubes are in the frame
    assert (img[:, :20].amax() > 0.2 and img[:, 22:42].amax() > 0.2
            and img[:, 44:].amax() > 0.2)
