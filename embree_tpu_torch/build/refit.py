"""Bottom-up BVH refit (RTC_BUILD_QUALITY_REFIT).

Counterpart of embree_tpu/build/refit.py, the analog of
kernels/bvh/bvh_refit.{h,cpp}: keep the tree structure of a previous
build and recompute the node bounds from moved primitives. The plan
(`plan_refit`, host numpy) lists the nodes level by level, deepest
first; `refit` replays it as torch ops on the BVH's device: the leaf
slots reduce their contiguous prim ranges at once, then every level
takes each inner slot's box as the union of its child node's valid slot
boxes. Min and max are exact, so the result is bit-equal to the JAX
package's whatever the order of reduction.

The motion-blur build (scene/scene.py::_build_mb) refits at every knot;
a scene committed at BuildQuality.REFIT is built anew, as in the JAX
package.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .bvh import BVH


class RefitSchedule(NamedTuple):
    """Structure-dependent, geometry-independent refit plan."""

    level_nodes: tuple          # (K,) long tensors, deepest level first
    max_leaf: int


def plan_refit(bvh: BVH) -> RefitSchedule:
    """Per-depth node order (host, once per structure)."""
    child = bvh.child.cpu().numpy()
    count = bvh.count.cpu().numpy()
    depth = np.full(child.shape[0], -1, np.int64)
    depth[0] = 0
    stack = [0]
    maxd = 0
    while stack:
        n = stack.pop()
        for c in range(child.shape[1]):
            if count[n, c] == 0:
                depth[child[n, c]] = depth[n] + 1
                maxd = max(maxd, depth[n] + 1)
                stack.append(int(child[n, c]))
    dev = bvh.child.device
    levels = tuple(torch.from_numpy(np.nonzero(depth == d)[0]).to(dev)
                   for d in range(maxd, -1, -1))
    max_leaf = int(count.max(initial=1))
    return RefitSchedule(level_nodes=levels, max_leaf=max(max_leaf, 1))


def refit(bvh: BVH, schedule: RefitSchedule, prim_lower: torch.Tensor,
          prim_upper: torch.Tensor) -> BVH:
    """All node bounds recomputed for moved prims (P, 3) on the BVH's
    device; the structure is shared with `bvh`."""
    max_leaf = schedule.max_leaf
    P = bvh.prim_order.shape[0]
    order = bvh.prim_order.long()
    plo = prim_lower[order]
    phi = prim_upper[order]
    k = torch.arange(max_leaf, device=order.device)

    # every leaf slot reduces its contiguous prim range at once
    is_leaf = bvh.count > 0
    idx = (bvh.child.long()[..., None] + k).clamp(0, max(P - 1, 0))
    valid = (k < bvh.count[..., None])[..., None]
    if P:
        llo = torch.where(valid, plo[idx], math.inf).amin(dim=-2)
        lhi = torch.where(valid, phi[idx], -math.inf).amax(dim=-2)
        lower = torch.where(is_leaf[..., None], llo, bvh.lower)
        upper = torch.where(is_leaf[..., None], lhi, bvh.upper)
    else:
        lower, upper = bvh.lower.clone(), bvh.upper.clone()

    # bottom-up: an inner slot's box is the union of its child node's
    # valid slot boxes
    M = bvh.child.shape[0]
    for nodes in schedule.level_nodes:
        # leaf and invalid slots index anything; their result is dropped
        ch = bvh.child[nodes].long().clamp(0, M - 1)    # (K, W)
        inner = (bvh.count[nodes] == 0)[..., None]
        ok = (bvh.count[ch] >= 0)[..., None]            # (K, W, W, 1)
        clo = torch.where(ok, lower[ch], math.inf).amin(dim=2)
        chi = torch.where(ok, upper[ch], -math.inf).amax(dim=2)
        lower[nodes] = torch.where(inner, clo, lower[nodes])
        upper[nodes] = torch.where(inner, chi, upper[nodes])
    return BVH(lower=lower, upper=upper, child=bvh.child, count=bvh.count,
               prim_order=bvh.prim_order)
