"""Wide-BVH host arrays (numpy).

Counterpart of embree_tpu/build/bvh.py, host side only. Nodes store all
child bounds SoA with two parallel i32 arrays in place of tagged NodeRef
pointers (reference bvh.h:118-141):

  child[m, c]  inner: index of child node        leaf: start into prim_order
  count[m, c]  0: inner   >0: leaf prim count    -1: invalid child slot

The leaf's prims are the contiguous range prim_order[start:start+count],
the analog of embree's reordered PrimRef ranges. Root is node 0.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

WIDTH = 4  # BVH4 default, like the reference's BVH4Factory production path


class BVHArraysNP(NamedTuple):
    """Host-side (numpy) builder output."""

    lower: np.ndarray
    upper: np.ndarray
    child: np.ndarray
    count: np.ndarray
    prim_order: np.ndarray


def empty_bvh_np(width: int = WIDTH) -> BVHArraysNP:
    return BVHArraysNP(
        lower=np.full((1, width, 3), np.inf, np.float32),
        upper=np.full((1, width, 3), -np.inf, np.float32),
        child=np.zeros((1, width), np.int32),
        count=np.full((1, width), -1, np.int32),
        prim_order=np.zeros((0,), np.int32),
    )


def sah_cost(bvh: BVHArraysNP) -> float:
    """SAH statistic printer analog (kernels/bvh/bvh_statistics.cpp)."""
    lower, upper = np.asarray(bvh.lower), np.asarray(bvh.upper)
    valid = np.asarray(bvh.count) >= 0
    d = np.maximum(upper - lower, 0.0)
    area = d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0]
    inner_area = float(np.sum(area * (np.asarray(bvh.count) == 0)))
    leaf_area = float(
        np.sum(area * np.maximum(np.asarray(bvh.count), 0) * (np.asarray(bvh.count) > 0))
    )
    root_d = np.maximum(upper[0].max(0) - lower[0][valid[0]].min(0), 1e-30)
    root_area = root_d[0] * root_d[1] + root_d[1] * root_d[2] + root_d[2] * root_d[0]
    return (inner_area + leaf_area) / max(root_area, 1e-30)
