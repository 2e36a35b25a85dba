"""Device-side Morton BVH builder (build quality LOW / dynamic scenes).

Counterpart of embree_tpu/build/morton.py, the analog of the reference's
morton builder (kernels/builders/bvh_builder_morton.h: 30-bit codes :77,
radix sort, bottom-up merge): the whole build is torch ops on the
primitives' device — code computation, one stable sort, and an implicit
complete 4-ary tree over the sorted order whose bounds come from
reshape/min/max reductions. Min and max are exact and the sort is
stable (as `jnp.argsort` is), so the tree equals the JAX package's node
for node, boxes bit for bit. Codes are int64 tensors: the values are
those of the JAX package's uint32 codes.

Tree quality is below SAH (no object splits), matching the reference's
LOW-quality tradeoff; traversal consumes the same BVH.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .bvh import BVH


def morton3d(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Interleave 10-bit coords (integer tensors) -> 30-bit morton code."""
    def part(v):
        v = v.to(torch.int64) & 0x3FF
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v
    return part(x) | (part(y) << 1) | (part(z) << 2)


def _pad_rows(a: torch.Tensor, n: int, fill: float) -> torch.Tensor:
    """`a` (K, 3) with rows of `fill` appended up to `n` rows."""
    return torch.cat([a, a.new_full((n - a.shape[0], 3), fill)])


def build_morton(prim_lower: torch.Tensor, prim_upper: torch.Tensor,
                 max_leaf: int = 4) -> BVH:
    """BVH build on the primitives' device: morton sort + implicit 4-ary
    tree. Returns a BVH (node 0 = root) of the same layout as the SAH
    build's; the node count depends only on the prim count."""
    dev = prim_lower.device
    P = prim_lower.shape[0]
    centroid = 0.5 * (prim_lower + prim_upper)
    lo = centroid.amin(0)
    hi = centroid.amax(0)
    # tensor / tensor: a true division (a Python scalar over a tensor is
    # taken as a reciprocal times the scalar)
    scale = torch.tensor(1023.0, device=dev) / (hi - lo).clamp_min(1e-20)
    q = ((centroid - lo) * scale).clamp(0.0, 1023.0).to(torch.int64)
    codes = morton3d(q[:, 0], q[:, 1], q[:, 2])
    order = torch.sort(codes, stable=True).indices.to(torch.int32)

    # --- leaves: chunks of max_leaf prims in morton order -----------------
    n_leaves = -(-P // max_leaf)
    # padded prims get empty boxes (inf, -inf) so reductions ignore them
    plo = _pad_rows(prim_lower[order.long()], n_leaves * max_leaf, math.inf)
    phi = _pad_rows(prim_upper[order.long()], n_leaves * max_leaf, -math.inf)
    leaf_lo = plo.reshape(n_leaves, max_leaf, 3).amin(1)
    leaf_hi = phi.reshape(n_leaves, max_leaf, 3).amax(1)
    leaf_start = torch.arange(n_leaves, dtype=torch.int32,
                              device=dev) * max_leaf
    leaf_count = (P - leaf_start).clamp(0, max_leaf).to(torch.int32)

    # --- implicit 4-ary levels (bottom-up bounds) -------------------------
    levels = []  # (lo, hi, K) of each level, leaves first
    cur_lo, cur_hi = leaf_lo, leaf_hi
    while cur_lo.shape[0] > 1:
        K = cur_lo.shape[0]
        Kp = -(-K // 4) * 4
        levels.append((cur_lo, cur_hi, K))
        cur_lo = _pad_rows(cur_lo, Kp, math.inf).reshape(-1, 4, 3).amin(1)
        cur_hi = _pad_rows(cur_hi, Kp, -math.inf).reshape(-1, 4, 3).amax(1)
    levels.append((cur_lo, cur_hi, cur_lo.shape[0]))
    levels.reverse()  # levels[0] = root level (K=1)

    # single-leaf scene: one root node with one leaf child
    if len(levels) == 1:
        lower = torch.full((1, 4, 3), math.inf, device=dev)
        upper = torch.full((1, 4, 3), -math.inf, device=dev)
        lower[0, 0] = leaf_lo[0]
        upper[0, 0] = leaf_hi[0]
        child = torch.zeros((1, 4), dtype=torch.int32, device=dev)
        count = torch.full((1, 4), -1, dtype=torch.int32, device=dev)
        count[0, 0] = leaf_count[0]
        return BVH(lower, upper, child, count, order)

    # node layout: BFS concat of all levels EXCEPT the leaf level; each
    # node's 4 children are the next level's entries 4i..4i+3
    inner_levels = levels[:-1]
    level_offsets = np.concatenate(
        [[0], np.cumsum([lv[2] for lv in inner_levels])]).astype(int)
    M = int(level_offsets[-1])

    lower = torch.full((M, 4, 3), math.inf, device=dev)
    upper = torch.full((M, 4, 3), -math.inf, device=dev)
    child = torch.zeros((M, 4), dtype=torch.int32, device=dev)
    count = torch.full((M, 4), -1, dtype=torch.int32, device=dev)

    for li, (_, _, K) in enumerate(inner_levels):
        off = int(level_offsets[li])
        nlo, nhi, nK = levels[li + 1]
        Kp = -(-nK // 4) * 4
        lower[off:off + K] = _pad_rows(nlo, Kp, math.inf).reshape(
            -1, 4, 3)[:K]
        upper[off:off + K] = _pad_rows(nhi, Kp, -math.inf).reshape(
            -1, 4, 3)[:K]
        child_ids = torch.arange(K * 4, dtype=torch.int32,
                                 device=dev).reshape(K, 4)
        valid = child_ids < nK
        if li + 1 < len(inner_levels):
            noff = int(level_offsets[li + 1])
            child[off:off + K] = torch.where(valid, child_ids + noff, 0)
            count[off:off + K] = torch.where(valid, 0, -1)
        else:
            # children are leaves
            ids = child_ids.clamp(0, n_leaves - 1).long()
            child[off:off + K] = torch.where(valid, leaf_start[ids], 0)
            count[off:off + K] = torch.where(valid, leaf_count[ids], -1)

    return BVH(lower=lower, upper=upper, child=child, count=count,
               prim_order=order)
