"""Procedural scene creators for tests and the on-card smoke run.

Copy (numpy only) of the creators of embree_tpu/verify/fixtures.py
that the ported modules use, and the hair ball of the JAX package's
hair tests (`hair_ball`).

Analog of tutorials/common/scenegraph/geometry_creation.cpp
(createTriangleSphere / createQuadSphere / createTrianglePlane /
createSubdivSphere) used throughout the reference verify suite
(tutorials/verify/verify.cpp).
"""
from __future__ import annotations

import numpy as np


def triangle_sphere(center, radius: float, n: int):
    """Lat-long sphere: 2*n*n triangles (geometry_creation.cpp:createTriangleSphere)."""
    center = np.asarray(center, np.float32)
    theta = np.linspace(0.0, np.pi, n + 1)
    phi = np.linspace(0.0, 2.0 * np.pi, n + 1)[:-1]
    tt, pp = np.meshgrid(theta, phi, indexing="ij")  # (n+1, n)
    x = np.sin(tt) * np.cos(pp)
    y = np.cos(tt)
    z = np.sin(tt) * np.sin(pp)
    verts = np.stack([x, y, z], -1).reshape(-1, 3) * radius + center
    idx = np.arange((n + 1) * n).reshape(n + 1, n)

    tris = []
    for i in range(n):
        for j in range(n):
            j2 = (j + 1) % n
            a, b, c, d = idx[i, j], idx[i, j2], idx[i + 1, j], idx[i + 1, j2]
            if i > 0:
                tris.append([a, c, b])
            if i < n - 1:
                tris.append([b, c, d])
    return verts.astype(np.float32), np.asarray(tris, np.int32)


def quad_sphere(center, radius: float, n: int):
    """Lat-long sphere of n*n quads (createQuadSphere)."""
    center = np.asarray(center, np.float32)
    theta = np.linspace(0.0, np.pi, n + 1)
    phi = np.linspace(0.0, 2.0 * np.pi, n + 1)[:-1]
    tt, pp = np.meshgrid(theta, phi, indexing="ij")
    x = np.sin(tt) * np.cos(pp)
    y = np.cos(tt)
    z = np.sin(tt) * np.sin(pp)
    verts = np.stack([x, y, z], -1).reshape(-1, 3) * radius + center
    idx = np.arange((n + 1) * n).reshape(n + 1, n)
    quads = []
    for i in range(n):
        for j in range(n):
            j2 = (j + 1) % n
            quads.append([idx[i, j], idx[i + 1, j], idx[i + 1, j2], idx[i, j2]])
    return verts.astype(np.float32), np.asarray(quads, np.int32)


def triangle_plane(p0, dx, dy, n: int):
    """Regular grid plane with 2*n*n triangles (createTrianglePlane)."""
    p0 = np.asarray(p0, np.float32)
    dx = np.asarray(dx, np.float32)
    dy = np.asarray(dy, np.float32)
    u = np.linspace(0, 1, n + 1)
    v = np.linspace(0, 1, n + 1)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    verts = p0 + uu[..., None] * dx + vv[..., None] * dy
    verts = verts.reshape(-1, 3).astype(np.float32)
    idx = np.arange((n + 1) * (n + 1)).reshape(n + 1, n + 1)
    tris = []
    for i in range(n):
        for j in range(n):
            a, b, c, d = (idx[i, j], idx[i, j + 1], idx[i + 1, j],
                          idx[i + 1, j + 1])
            tris.append([a, b, c])
            tris.append([b, d, c])
    return verts, np.asarray(tris, np.int32)


def random_triangles(rng: np.random.Generator, n: int, extent: float = 10.0,
                     size: float = 0.5):
    """Random triangle soup for stress/overlap tests (verify.cpp:1093)."""
    base = rng.uniform(-extent, extent, (n, 1, 3)).astype(np.float32)
    offs = rng.uniform(-size, size, (n, 3, 3)).astype(np.float32)
    tri = base + offs
    verts = tri.reshape(-1, 3)
    idx = np.arange(3 * n, dtype=np.int32).reshape(n, 3)
    return verts, idx


def subdiv_cube():
    """8-vertex cube as a 6-quad subdiv control mesh."""
    verts = np.array([
        [-1, -1, -1], [+1, -1, -1], [+1, -1, +1], [-1, -1, +1],
        [-1, +1, -1], [+1, +1, -1], [+1, +1, +1], [-1, +1, +1]], np.float32)
    faces = np.array([
        [0, 1, 2, 3], [4, 7, 6, 5], [0, 4, 5, 1],
        [1, 5, 6, 2], [2, 6, 7, 3], [3, 7, 4, 0]], np.int32)
    counts = np.full(6, 4, np.int32)
    return verts, counts, faces.reshape(-1)


def crossing_clusters(rng: np.random.Generator, n: int = 220, S: int = 5):
    """Two clusters of small random triangles that swap places over the
    shutter (one sweeps from x = -6 to +6, the other back), as S vertex
    timesteps and the (n, 3) indices: a scene on which one union
    topology is poor and the motion-blur build splits time."""
    tris = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    e1 = rng.normal(size=(n, 3)).astype(np.float32) * 0.05
    e2 = rng.normal(size=(n, 3)).astype(np.float32) * 0.05
    off0 = np.where(np.arange(n)[:, None] < n // 2, [-6.0, 0, 0],
                    [6.0, 0, 0]).astype(np.float32)
    verts_t = []
    for s in range(S):
        w = s / (S - 1)
        p0 = tris + ((1 - w) * off0 - w * off0)
        verts_t.append(np.concatenate([p0, p0 + e1, p0 + e2]))
    idx = np.stack([np.arange(n), np.arange(n) + n,
                    np.arange(n) + 2 * n], 1).astype(np.int32)
    return verts_t, idx


def hair_ball(rng: np.random.Generator, n_curves: int = 120,
              diagonal: bool = False):
    """Random hair (tests/test_hair.py's `_hair_ball`): n_curves cubic
    Bezier curves of radius 0.02, 1.2 long, rooted uniformly in [-1, 1]^3,
    bowed a little; all along (1, 1, 1) when `diagonal`. Returns
    ((4 n, 4) xyzr vertices, (n,) first-vertex indices)."""
    verts = []
    idx = []
    for c in range(n_curves):
        base = rng.uniform(-1, 1, 3).astype(np.float32)
        if diagonal:
            axis = np.array([1.0, 1.0, 1.0]) / np.sqrt(3.0)
        else:
            axis = rng.normal(size=3)
            axis /= np.linalg.norm(axis)
        bow = rng.normal(size=3).astype(np.float32) * 0.05
        r = 0.02
        for k in range(4):
            p = base + axis * (k / 3.0) * 1.2 + bow * np.sin(k * 1.1)
            verts.append([p[0], p[1], p[2], r])
        idx.append(4 * c)
    return (np.asarray(verts, np.float32),
            np.asarray(idx, np.int32))
