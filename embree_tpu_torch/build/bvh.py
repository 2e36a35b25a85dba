"""Wide-BVH data structure: host arrays (numpy) and device tensors.

Counterpart of embree_tpu/build/bvh.py. Nodes store all
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
import torch

WIDTH = 4  # BVH4 default, like the reference's BVH4Factory production path


class BVH(NamedTuple):
    """Device-side wide BVH."""

    lower: torch.Tensor       # (M, W, 3) f32 child bounds
    upper: torch.Tensor       # (M, W, 3) f32
    child: torch.Tensor       # (M, W) i32
    count: torch.Tensor       # (M, W) i32
    prim_order: torch.Tensor  # (P,) i32 permutation into scene prim arrays

    @property
    def num_nodes(self):
        return self.lower.shape[0]

    @property
    def width(self):
        return self.lower.shape[1]


class BVHArraysNP(NamedTuple):
    """Host-side (numpy) builder output before device upload."""

    lower: np.ndarray
    upper: np.ndarray
    child: np.ndarray
    count: np.ndarray
    prim_order: np.ndarray

    def to_device(self, device) -> BVH:
        device = torch.device(device)

        def up(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

        return BVH(lower=up(self.lower, np.float32),
                   upper=up(self.upper, np.float32),
                   child=up(self.child, np.int32),
                   count=up(self.count, np.int32),
                   prim_order=up(self.prim_order, np.int32))


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
