"""The plain reference: its Catmull-Clark subdivision against analytic
limit points of small cages (a bicubic B-spline patch and its border
curve, pinned corners, the limit kept under refinement at extraordinary
vertices), and the references against the program's plain paths on the
CPU (a small sphere, B2's plain version; the demo's cage at level 4,
B4's), run through the harness with the limits."""
import numpy as np
import torch

from conftest import cage_overrides
from rtbench import harness
from rtbench.reference import catmull_clark as cc
from rtbench.scenes import obj_subdiv

SPHERE = {"params": {"n": 40}, "traffic": {"rays": 4096},
          "check": {"check_rays": 512}}


def _bspline(t):
    """The uniform cubic B-spline basis centred on 0."""
    t = np.abs(t)
    return np.where(t < 1, (4 - 6 * t**2 + 3 * t**3) / 6,
                    np.where(t < 2, (2 - t)**3 / 6, 0.0))


def _grid_cage(m, rng):
    """An (m + 1)^2 grid of vertices (i, j, z_ij) as m^2 quads."""
    i, j = np.meshgrid(np.arange(m + 1), np.arange(m + 1), indexing="ij")
    z = rng.normal(size=(m + 1, m + 1))
    verts = np.stack([i, j, z], -1).reshape(-1, 3)
    vid = (i * (m + 1) + j)
    quads = np.stack([vid[:-1, :-1], vid[1:, :-1], vid[1:, 1:],
                      vid[:-1, 1:]], -1).reshape(-1, 4)
    return verts, np.full(m * m, 4), quads.reshape(-1), z


def test_regular_grid_is_the_bicubic_bspline():
    m, level = 8, 2
    verts, fc, fi, z = _grid_cage(m, np.random.default_rng(5))
    lim, grids = cc.limit_grids(verts, fc, fi, level, "cpu")
    pts = lim[grids].reshape(-1, 3).numpy()
    # every limit point of the mesh lies on the grid's coordinates, the
    # (i, j) of a cage vertex scaled by 2^-level; x and y stay linear
    assert np.allclose(pts[:, :2] * 2**level, np.round(pts[:, :2] * 2**level))
    a = np.arange(m + 1)
    inner = ((pts[:, 0] >= 2) & (pts[:, 0] <= m - 2)
             & (pts[:, 1] >= 2) & (pts[:, 1] <= m - 2))
    assert inner.sum() > 100
    for x, y, zz in pts[inner]:
        want = _bspline(x - a) @ z @ _bspline(y - a)
        assert abs(zz - want) < 1e-12
    # the border j = 0 is the cubic B-spline curve of its border vertices
    edge = (pts[:, 1] == 0) & (pts[:, 0] >= 2) & (pts[:, 0] <= m - 2)
    assert edge.sum() > 10
    for x, _, zz in pts[edge]:
        assert abs(zz - _bspline(x - a) @ z[:, 0]) < 1e-12
    # corners (a border vertex of one face) are pinned
    for c in (0, m, m * (m + 1), (m + 1)**2 - 1):
        assert torch.equal(lim[c], torch.as_tensor(verts[c], dtype=lim.dtype))


def _cube():
    v = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                  for z in (-1, 1)], np.float64)
    q = [[0, 1, 3, 2], [4, 6, 7, 5], [0, 4, 5, 1], [2, 3, 7, 6],
         [0, 2, 6, 4], [1, 5, 7, 3]]
    return v, np.full(6, 4), np.asarray(q).reshape(-1)


def _limit_kept(verts, fc, fi, level):
    """The limit of every vertex at `level` equals its limit after one more
    refinement (a vertex keeps its id), to rounding."""
    p = torch.as_tensor(verts, dtype=torch.float64)
    g = cc.cage_grids(fc, fi, "cpu")
    for _ in range(level):
        p, g = cc.refine(p, g)
    lim = cc.limit(p, g)
    p2, g2 = cc.refine(p, g)
    lim2 = cc.limit(p2, g2)[:lim.shape[0]]
    scale = float(p.abs().max())
    assert float((lim - lim2).abs().max()) < 1e-12 * scale
    return lim


def test_limit_kept_under_refinement():
    v, fc, fi = _cube()
    lim = _limit_kept(v, fc, fi, 0)
    # the cube's corners (valence 3) by the limit mask, by symmetry on
    # the diagonal: (9 + 4 (1) + (-1)) / 24 = 1/2
    assert torch.allclose(lim[:8], torch.as_tensor(v) / 2, atol=1e-15)
    _limit_kept(v, fc, fi, 2)
    # the demo's cage: interior valences 3 to 8, border valences 2 to 5
    params = harness.load_json("rtbench/configs/bomberman.json")["params"]
    inp = obj_subdiv.inputs(params, harness.ROOT)
    _limit_kept(inp["vertices"].astype(np.float64), inp["face_counts"],
                inp["face_indices"], 1)


def test_refuses_what_it_does_not_cover():
    v, fc, fi = _cube()
    for bad in ((np.full(4, 3), fi[:12]),       # triangles
                (np.full(7, 4), np.concatenate([fi, fi[:4]]))):  # 3 faces an edge
        try:
            cc.limit_grids(v, *bad, 1, "cpu")
        except ValueError:
            continue
        raise AssertionError("accepted a cage it does not cover")


def test_sphere_within_limits():
    res = harness.run("sphere1m.incoherent", 2**33 + 1, 0.5, False,
                      device="cpu", overrides=SPHERE)
    assert res["correct"], res["checks"]


def test_cage_within_limits():
    res = harness.run("bomberman.incoherent8m", 2**35 + 3, 0.5, False,
                      device="cpu", overrides=cage_overrides())
    assert res["correct"], res["checks"]
