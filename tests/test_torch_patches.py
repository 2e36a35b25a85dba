"""The port's analytic patches (embree_tpu_torch/subdiv/patches.py)
against the JAX package's: `build_patch_table` gives the same arrays,
byte for byte, on the cages of tests/test_patches.py; `eval_patch_table`
agrees at seeded points (P at 1e-5 of the largest entry, every
derivative and Ng at 1e-4); and the port's forms of that file's gates, run on the port
alone: deep uniform refinement, the regular-corner limit stencil, the
exact EV cap against a deeper table, the limit point, and the
finite-difference gates with a step scaled to the distance from the EV."""
import dataclasses

import numpy as np
import pytest
import torch

from embree_tpu.subdiv import patches as jp
from embree_tpu.subdiv.core import evaluate_plan as j_evaluate_plan
from embree_tpu_torch.subdiv import patches as tp
from embree_tpu_torch.subdiv.core import (evaluate_plan, limit_project,
                                          plan_subdivision)
from embree_tpu_torch.subdiv.tessellate import build_patch_grids

TOL = {"P": 1e-5, "dPdu": 1e-4, "dPdv": 1e-4, "ddPdudu": 1e-4,
       "ddPdvdv": 1e-4, "ddPdudv": 1e-4, "Ng": 1e-4}
CUBE_V = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                   for z in (-1, 1)], np.float32)
CUBE_F = np.array([[0, 1, 3, 2], [4, 6, 7, 5], [0, 4, 5, 1],
                   [2, 3, 7, 6], [0, 2, 6, 4], [1, 5, 7, 3]]).reshape(-1)
RING = np.array([[0, 1], [1, 3], [3, 2], [2, 0]])


def grid_cage(n, z):
    xs, ys = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    verts = np.stack([xs.ravel(), ys.ravel(), z], 1).astype(np.float32)
    quads = [[i * n + j, i * n + j + n, i * n + j + n + 1, i * n + j + 1]
             for i in range(n - 1) for j in range(n - 1)]
    return verts, np.full(len(quads), 4), np.asarray(quads).reshape(-1)


def pentagon_cap():
    ang = np.linspace(0, 2 * np.pi, 5, endpoint=False)
    ring = np.stack([np.cos(ang), np.sin(ang), np.zeros(5)], 1)
    verts = np.concatenate([ring, 2.2 * ring + np.array([0, 0, 0.4])])
    faces, counts = [[0, 1, 2, 3, 4]], [5]
    for i in range(5):
        j = (i + 1) % 5
        faces.append([i, 5 + i, 5 + j, j])
        counts.append(4)
    return verts.astype(np.float32), np.asarray(counts), np.concatenate(faces)


def cages():
    """(name, verts, counts, indices, crease kwargs): tests/test_patches.py's
    regular grid, cube EVs, creased cube (also its creased-EV cage),
    semi-sharp crease and n-gon face cages."""
    xs, ys = np.meshgrid(np.arange(6), np.arange(6), indexing="ij")
    fc6 = np.full(6, 4)
    return [
        ("regular grid", *grid_cage(6, np.sin(xs.ravel() * 0.7)
                                    * np.cos(ys.ravel())), {}),
        ("cube EVs", CUBE_V, fc6, CUBE_F, {}),
        ("creased cube", CUBE_V, fc6, CUBE_F,
         dict(edge_creases=RING,
              edge_crease_weights=np.full(4, np.inf, np.float32))),
        ("semi-sharp crease", CUBE_V, fc6, CUBE_F,
         dict(edge_creases=np.array([[0, 1]]),
              edge_crease_weights=np.asarray([1.6], np.float32))),
        ("n-gon face", *pentagon_cap(), {}),
    ]


@pytest.fixture(scope="module")
def tables():
    """name -> (verts, counts, indices, JAX table, port table)."""
    out = {}
    for name, verts, counts, idx, kw in cages():
        nv = verts.shape[0]
        out[name] = (verts, np.asarray(counts), idx,
                     jp.build_patch_table(counts, idx, nv, **kw),
                     tp.build_patch_table(counts, idx, nv, **kw))
    return out


def same_array(what, a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what


def test_build_patch_table_is_byte_equal(tables):
    """Every field of the PatchTable and of each Ladder, and the iso
    plan's final quads and vertex count."""
    for name, (_v, _c, _i, jt, tt) in tables.items():
        for f in dataclasses.fields(jt):
            a, b = getattr(jt, f.name), getattr(tt, f.name)
            if f.name == "plan":
                same_array(f"{name} plan quads", a.final_quads, b.final_quads)
                assert a.num_final_vertices == b.num_final_vertices
            elif f.name == "ladders":
                assert len(a) == len(b), name
                for la, lb in zip(a, b):
                    for g in dataclasses.fields(la):
                        x, y = getattr(la, g.name), getattr(lb, g.name)
                        if isinstance(x, np.ndarray) or isinstance(
                                y, np.ndarray):
                            same_array(f"{name} ladder {g.name}", x, y)
                        else:
                            assert x == y, (name, g.name)
            elif a is None or isinstance(a, np.ndarray):
                if a is None:
                    assert b is None, (name, f.name)
                else:
                    same_array(f"{name} {f.name}", a, b)
            else:
                assert a == b, (name, f.name)
    assert len(tables["cube EVs"][3].ladders) > 0
    assert (tables["regular grid"][4].kind == 0).sum() > 0
    assert tables["semi-sharp crease"][4].iso_levels >= 4
    assert tables["creased cube"][4].lad_stam_ok.mean() > 0.9


@pytest.fixture(scope="module")
def evaluated(tables):
    """name -> (face, u, v, the JAX package's eval_patch_table outputs)
    at 400 seeded points a cage, n-gon faces with u in [0, n)."""
    rng = np.random.default_rng(0x9A7C)
    out = {}
    for name, (verts, counts, idx, jt, tt) in tables.items():
        n = 400
        face = rng.integers(0, len(counts), n)
        u = rng.uniform(0.02, 0.98, n).astype(np.float32)
        v = rng.uniform(0.02, 0.98, n).astype(np.float32)
        u = np.where(counts[face] == 4, u,
                     u + rng.integers(0, np.maximum(counts[face], 1))
                     ).astype(np.float32)
        jo = jp.eval_patch_table(jt, j_evaluate_plan(jt.plan, verts), face,
                                 u, v)
        out[name] = (face, u, v, {k: np.asarray(x) for k, x in jo.items()})
    return out


def held(name, got, want):
    """Each field of `got` within TOL of `want`; the errors."""
    errs = {}
    for k, tol in TOL.items():
        err = (float(np.abs(got[k].numpy() - want[k]).max())
               / max(float(np.abs(want[k]).max()), 1e-30))
        assert err <= tol, f"{name} {k}: {err:.3g} (tol {tol})"
        errs[k] = err
    return errs


def test_eval_matches_the_jax_package(tables, evaluated):
    """eval_patch_table at the seeded points against the JAX package's,
    and against deep uniform refinement (the port's form of _check_cage:
    P within 3e-3 of the cage's scale at the 99th percentile)."""
    worst = {k: 0.0 for k in TOL}
    for name, (verts, counts, idx, jt, tt) in tables.items():
        face, u, v, jo = evaluated[name]
        to = tp.eval_patch_table(tt, torch.from_numpy(
            evaluate_plan(tt.plan, verts)), torch.from_numpy(face), u, v)
        for k, e in held(name, to, jo).items():
            worst[k] = max(worst[k], e)
        # deep uniform refinement, sampled through the patch grids
        plan = plan_subdivision(counts, idx, verts.shape[0], 7,
                                **_creases(name))
        fine = limit_project(plan, evaluate_plan(plan, verts))
        grids = build_patch_grids(plan)
        ref = _sample_grid(grids, fine, face, u, v, counts)
        err = np.abs(to["P"].numpy() - ref).max(axis=1)
        scale = max(1.0, float(np.abs(verts).max()))
        assert np.quantile(err, 0.99) < 3e-3 * scale, name
    print("largest difference to the JAX package:", worst)


def test_scene_interpolate_derivatives(tables, evaluated):
    """Scene.interpolate(..., derivatives=True) on committed subdivision
    meshes (the creased cube, the pentagon cap): the port's
    eval_patch_table over the scene's cached table, so against the JAX
    package's eval_patch_table (which the JAX package's Scene calls) at
    the seeded points; and P against the grid-based interpolate
    (test_patches.py's scene form, 8e-3)."""
    import embree_tpu_torch as ett
    for name in ("creased cube", "n-gon face"):
        verts, counts, idx, _jt, _tt = tables[name]
        face, u, v, jo = evaluated[name]
        s = ett.Scene(ett.Device("ignore_config_files=1", device="cpu"))
        s.set_levels(5, 2)
        gid = s.attach(ett.SubdivMesh(verts, counts, idx, **_creases(name)))
        s.commit()
        got = s.interpolate(gid, face, u, v, derivatives=True)
        assert set(got) == set(jo)
        held(f"Scene {name}", got, jo)
        assert s._patch_tables[gid][0].tensors     # built once, kept
        if name == "creased cube":
            f6 = np.arange(6)
            uu = np.full(6, 0.37, np.float32)
            vv = np.full(6, 0.61, np.float32)
            P_grid, _ = s.interpolate(gid, f6, uu, vv)
            P = s.interpolate(gid, f6, uu, vv, derivatives=True)["P"]
            np.testing.assert_allclose(P.numpy(), P_grid.numpy(), atol=8e-3)
            assert float(got["dPdu"].abs().max()) > 0.1


def _creases(name):
    return next(kw for n, *_r, kw in cages() if n == name)


def _sample_grid(grids, fine, face, u, v, counts):
    """Bilinear sample of the deep grid at (face, u, v), u in [0, n) for
    n-gons (tests/test_patches.py::_sample_grid)."""
    is_quad = counts == 4
    start = np.zeros(len(counts), np.int64)
    start[1:] = np.cumsum(np.where(is_quad, 1, counts))[:-1]
    sub = np.where(is_quad[face], 0, np.floor(u).astype(np.int64))
    patch = start[face] + sub
    uu = np.where(is_quad[face], u, u - sub)
    g = np.where(is_quad[face], grids.grid_res, grids.grid_res // 2)
    fi = np.clip(uu * g, 0, g - 1e-4)
    fj = np.clip(v * g, 0, g - 1e-4)
    i0, j0 = fi.astype(np.int64), fj.astype(np.int64)
    du, dv = (fi - i0)[:, None], (fj - j0)[:, None]
    gg = grids.grids
    return (fine[gg[patch, i0, j0]] * (1 - du) * (1 - dv)
            + fine[gg[patch, i0 + 1, j0]] * du * (1 - dv)
            + fine[gg[patch, i0, j0 + 1]] * (1 - du) * dv
            + fine[gg[patch, i0 + 1, j0 + 1]] * du * dv)


def _eval(pt, verts, face, u, v):
    vi = torch.from_numpy(evaluate_plan(pt.plan, verts))
    out = tp.eval_patch_table(pt, vi, face, np.asarray(u, np.float32),
                              np.asarray(v, np.float32))
    return {k: x.numpy() for k, x in out.items()}


def test_exact_cap_and_limit_points(tables):
    """The port's forms of test_limit_corner_stencil,
    test_ev_exact_vs_deep_regular, test_ev_limit_point_exact and the
    deeper-table half of test_creased_ev_exact_cap."""
    rng = np.random.default_rng(5)
    # a regular interior corner equals the (1,4,1)^2/36 limit stencil
    n = 7
    z = rng.normal(size=n * n).astype(np.float32) * 0.3
    verts, fc, fi = grid_cage(n, z)
    pt = tp.build_patch_table(fc, fi, n * n)
    fidx = 2 * (n - 1) + 2
    P = _eval(pt, verts, [fidx], [0.0], [0.0])["P"][0]
    vid = fi.reshape(-1, 4)[fidx][0]
    i0, j0 = vid // n, vid % n
    st = np.array([[1, 4, 1], [4, 16, 4], [1, 4, 1]], np.float32) / 36.0
    ref = sum(st[a + 1, b + 1] * verts[(i0 + a) * n + (j0 + b)]
              for a in (-1, 0, 1) for b in (-1, 0, 1))
    np.testing.assert_allclose(P, ref, atol=1e-4)
    # the exact cap near the EVs against a deeper table's regular patches
    for name, pdist, ddist in (("cube EVs", 1e-5, 1e-3),
                               ("creased cube", 2e-5, 1e-3)):
        kw = _creases(name)
        pt2 = tables[name][4]
        pt6 = tp.build_patch_table(np.full(6, 4), CUBE_F, 8, iso_levels=6,
                                   **kw)
        assert pt2.lad_stam_ok is not None and pt2.lad_stam_ok.any()
        m = 500
        r = 10 ** rng.uniform(-1.5, -0.7, m)
        th = rng.uniform(0.1 if name == "cube EVs" else 0.0,
                         np.pi / 2 - 0.1 if name == "cube EVs" else np.pi / 3,
                         m)
        u, v = r * np.cos(th), r * np.sin(th)
        f = np.zeros(m, np.int64)
        o2 = _eval(pt2, CUBE_V, f, u, v)
        o6 = _eval(pt6, CUBE_V, f, u, v)
        assert np.linalg.norm(o2["P"] - o6["P"], axis=1).max() < pdist
        assert np.linalg.norm(o2["dPdu"] - o6["dPdu"], axis=1).max() < ddist
    # P at the EV itself is the Catmull-Clark limit point
    P = _eval(tables["cube EVs"][4], CUBE_V, [0], [1e-7], [1e-7])["P"][0]
    plan = plan_subdivision(np.full(6, 4), CUBE_F, 8, levels=7)
    fine = limit_project(plan, evaluate_plan(plan, CUBE_V))
    truth = fine[np.argmin(np.linalg.norm(fine - CUBE_V[0], axis=1))]
    assert np.linalg.norm(P - truth) < 1e-4, (P, truth)


def test_finite_difference_gates(tables):
    """The port's forms of test_ev_adjacent_fd_gate, the FD half of
    test_creased_ev_golden and of test_creased_ev_exact_cap: dPdu against
    central differences of P with the step h = r/20 scaled to the
    distance r from the EV, and ddPdudu against differences of dPdu."""
    for name, seed, lo, hi, th_lo, th_hi, tol, frac in (
            ("cube EVs", 7, -2.2, -1.0, 0.05, np.pi / 2 - 0.05, 1e-3, 0.99),
            ("creased cube", 11, -2.0, -1.0, 0.05, np.pi / 2 - 0.05, 1e-2,
             0.95),
            ("creased cube", 17, -1.5, -0.7, 0.0, np.pi / 3, 1e-2, 0.99)):
        pt = tables[name][4]
        rng = np.random.default_rng(seed)
        n = 800
        r = 10 ** rng.uniform(lo, hi, n)
        th = rng.uniform(th_lo, th_hi, n)
        u, v = r * np.cos(th), r * np.sin(th)
        f = np.zeros(n, np.int64)
        h = r / 20
        out = _eval(pt, CUBE_V, f, u, v)
        hi_ = _eval(pt, CUBE_V, f, u + h, v)
        lo_ = _eval(pt, CUBE_V, f, u - h, v)
        fd = (hi_["P"].astype(np.float64) - lo_["P"]) / (2 * h)[:, None]
        rel = np.linalg.norm(fd - out["dPdu"], axis=1) / np.maximum(
            np.linalg.norm(fd, axis=1), 1e-9)
        assert (rel < tol).mean() >= frac, (name, (rel < tol).mean())
        if name == "cube EVs":
            fd2 = ((hi_["dPdu"].astype(np.float64) - lo_["dPdu"])
                   / (2 * h)[:, None])
            rel2 = np.linalg.norm(fd2 - out["ddPdudu"], axis=1) / np.maximum(
                np.linalg.norm(fd2, axis=1), 1e-6)
            assert (rel2 < 1e-2).mean() >= 0.95
