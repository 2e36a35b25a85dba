"""BVH tree rotations (kernels/bvh/bvh_rotate.{h,cpp} analog).

Counterpart of embree_tpu/build/rotate.py, a host numpy copy whose
output is byte-equal to the JAX package's. The reference improves
low-quality (morton) trees by local rotations: for every inner node,
pick a child slot `c1` and a grandchild slot `cc` under a *different*
inner child `c2`, and swap them if that shrinks `c2`'s box
(BVHNRotate<4>::rotate, bvh_rotate.cpp:30-118 — best-gain swap per
node, applied bottom-up). Here the pass runs on the host SoA arrays
(BVHArraysNP) as a post-build optimization for BuildQuality.LOW trees.
"""
from __future__ import annotations

import numpy as np

from .bvh import BVHArraysNP


def _half_area(lo, hi):
    # empty slots carry (+inf, -inf) bounds; the subtract warns harmlessly
    with np.errstate(invalid="ignore", over="ignore"):
        d = np.maximum(hi - lo, 0.0)
    return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] \
        + d[..., 2] * d[..., 0]


def rotate_bvh(bvh: BVHArraysNP, rounds: int = 1) -> BVHArraysNP:
    """Bottom-up best-swap rotations; returns a new BVHArraysNP.

    One round visits every inner node once in reverse-BFS order (children
    before parents, valid because builders emit parents before children).
    """
    lower = bvh.lower.copy()
    upper = bvh.upper.copy()
    child = bvh.child.copy()
    count = bvh.count.copy()
    M, W = child.shape
    if M == 0:
        return bvh

    for _ in range(rounds):
        for n in range(M - 1, -1, -1):
            area = _half_area(lower[n], upper[n])  # (W,)
            best_gain = 0.0
            best = None
            for c2 in range(W):
                if count[n, c2] != 0:
                    continue  # only inner children can host a swap
                m = child[n, c2]
                for c1 in range(W):
                    if c1 == c2 or count[n, c1] < 0:
                        continue
                    for cc in range(W):
                        if count[m, cc] < 0:
                            continue
                        # c2's new box: union of m's slots with cc
                        # replaced by c1's box
                        lo = np.minimum.reduce([
                            lower[n, c1] if k == cc else lower[m, k]
                            for k in range(W) if count[m, k] >= 0
                            or k == cc])
                        hi = np.maximum.reduce([
                            upper[n, c1] if k == cc else upper[m, k]
                            for k in range(W) if count[m, k] >= 0
                            or k == cc])
                        gain = float(area[c2] - _half_area(lo, hi))
                        if gain > best_gain:
                            best_gain = gain
                            best = (c1, c2, cc, lo, hi)
            if best is None:
                continue
            c1, c2, cc, lo, hi = best
            m = child[n, c2]
            # swap slot (n, c1) <-> (m, cc)
            for arr in (lower, upper):
                tmp = arr[n, c1].copy()
                arr[n, c1] = arr[m, cc]
                arr[m, cc] = tmp
            for arr in (child, count):
                tmp = arr[n, c1].copy()
                arr[n, c1] = arr[m, cc]
                arr[m, cc] = tmp
            # refit c2's slot box in n
            lower[n, c2] = lo
            upper[n, c2] = hi

    return BVHArraysNP(lower, upper, child, count, bvh.prim_order)
