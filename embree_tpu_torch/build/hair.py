"""Hair acceleration: strand-aligned OBB clusters over Bezier curves.

Counterpart (host numpy, a copy) of embree_tpu/build/hair.py. The
reference builds hair BVHs with unaligned (OBB) nodes binned along strand
directions (bvh_builder_hair.cpp, bvh.h:971 UnalignedNode): axis-aligned
boxes around diagonal strands are mostly empty. The JAX package's
re-design, kept here: curves are clustered by strand direction over 13
canonical orientations (axes, face diagonals, body diagonals,
sign-collapsed); each cluster gets one rigid frame R that turns its
canonical direction to +z, and its curves are bounded and built over IN
THE ROTATED FRAME. A query rotates the rays once per cluster and walks
an axis-aligned BVH there: one 3x3 transform per (ray, cluster) instead
of one per (ray, node).

`cluster_curves` is the clustering alone (what the scene's commit
needs: it builds its own BVH over sub-segments, traverse/hair_kernel.py);
`build_hair_clusters` adds the per-cluster SAH BVH over curve bounds
that the torch-op cluster walk (traverse/hair.py) reads.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .bvh import BVHArraysNP
from .sah import BuildSettings, build_sah

# 13 canonical strand orientations (sign-collapsed)
_DIRS = np.array([
    [1, 0, 0], [0, 1, 0], [0, 0, 1],
    [1, 1, 0], [1, -1, 0], [1, 0, 1], [1, 0, -1],
    [0, 1, 1], [0, 1, -1],
    [1, 1, 1], [1, -1, 1], [1, 1, -1], [-1, 1, 1],
], np.float32)
_DIRS /= np.linalg.norm(_DIRS, axis=1, keepdims=True)


def _frame_for(z: np.ndarray) -> np.ndarray:
    """Orthonormal frame with third column = z (columns are axes; apply
    with x @ R to rotate into the frame)."""
    a = np.array([1.0, 0, 0], np.float32)
    if abs(z[0]) > 0.9:
        a = np.array([0, 1.0, 0], np.float32)
    x = np.cross(a, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=1).astype(np.float32)


class HairCluster(NamedTuple):
    """One strand-aligned cluster: rotation, host SAH BVH over the
    member curves' bounds in the rotated frame, member curve ids."""

    rot: np.ndarray        # (3, 3) world -> cluster frame (x @ rot)
    bvh: BVHArraysNP       # host BVH over rotated curve bounds
    members: np.ndarray    # (M,) i32 indices into the curve arrays


def cluster_curves(cps: np.ndarray):
    """cps: (S, 4, 3) cubic Bezier control points. Returns [(rot,
    members)] for the non-empty clusters in orientation order. Strand
    direction = p3 - p0 (the chord embree's unaligned binning uses per
    strand); a degenerate strand goes to cluster 0."""
    d = cps[:, 3] - cps[:, 0]
    n = np.linalg.norm(d, axis=1, keepdims=True)
    d = d / np.maximum(n, 1e-20)
    sim = np.abs(d @ _DIRS.T)                      # (S, 13)
    cluster = np.argmax(sim, axis=1)
    cluster[np.squeeze(n, -1) < 1e-12] = 0
    out = []
    for k in range(_DIRS.shape[0]):
        members = np.nonzero(cluster == k)[0]
        if members.size:
            out.append((_frame_for(_DIRS[k]), members.astype(np.int32)))
    return out


def build_hair_clusters(cps: np.ndarray, radii: np.ndarray,
                        builder: str = "auto") -> list:
    """cps: (S, 4, 3) cubic Bezier control points; radii: (S, 4).
    Returns [HairCluster] (empty clusters skipped)."""
    out = []
    for R, members in cluster_curves(cps):
        cr = cps[members] @ R                      # (M, 4, 3) rotated cps
        rmax = radii[members].max(axis=1, keepdims=True)  # (M, 1)
        lo = cr.min(axis=1) - rmax                 # cp hull bounds curve
        hi = cr.max(axis=1) + rmax
        bvh = build_sah(lo.astype(np.float32), hi.astype(np.float32),
                        BuildSettings(), backend=builder)
        out.append(HairCluster(rot=R, bvh=bvh, members=members))
    return out


def bezier_from_bspline(cps4: np.ndarray) -> np.ndarray:
    """Uniform cubic B-spline span -> Bezier control points
    (bspline_curve.h basis conversion)."""
    m = np.array([[1, 4, 1, 0],
                  [0, 4, 2, 0],
                  [0, 2, 4, 0],
                  [0, 1, 4, 1]], np.float32) / 6.0
    return np.einsum("ij,sjk->sik", m, cps4)
