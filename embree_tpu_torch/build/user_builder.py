"""User-space BVH build API (the rtcBuildBVH analog), on the host.

Counterpart of embree_tpu/build/user_builder.py, copied: host numpy
whose trees, handed to the user's callbacks, equal the JAX package's
node for node at every quality. Re-expression of reference
kernels/common/rtcore_builder.cpp:97-425 (`rtcBuildBVH`,
`RTCBuildArguments`, quality dispatch morton/sah/spatial): the caller
supplies primitive bounds plus node/leaf construction callbacks and gets
back their own tree built with the scene builders' quality tiers:

  LOW    -> morton-ordered median build   (rtcore_builder.cpp:97  bvh_morton)
  MEDIUM -> binned-SAH                    (rtcore_builder.cpp:163 bvh_sah)
  HIGH   -> binned-SAH + bounded pre-split spatial duplication, driven by
            the user's split_primitive callback (rtcore_builder.cpp:230
            bvh_spatial, splitter at :255-263)

The tree is emitted bottom-up through callbacks mirroring the reference's
(createNode/setNodeChildren/setNodeBounds/createLeaf, rtcore_builder.h),
so embree user-builder code maps 1:1. There is no thread-local allocator
argument: python objects are returned directly.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

import torch

from .morton import morton3d
from .sah import BuildSettings, build_bvh2


class BuildQualityEnum:
    LOW = 0
    MEDIUM = 1
    HIGH = 2


@dataclasses.dataclass
class BuildArguments:
    """Mirror of RTCBuildArguments (include/embree3/rtcore_builder.h:45-80).

    Callback shapes:
      create_node(num_children) -> node
      set_node_children(node, [child, ...]) -> None
      set_node_bounds(node, [(lower, upper), ...]) -> None
      create_leaf(prims) -> leaf   # prims: structured list of
                                   # (lower, upper, geom_id, prim_id)
      split_primitive(prim, dim, pos) -> ((llo, lhi), (rlo, rhi))
      progress(fraction) -> bool   # False cancels the build
    """

    build_quality: int = BuildQualityEnum.MEDIUM
    max_branching_factor: int = 2
    max_depth: int = 64
    sah_block_size: int = 1
    min_leaf_size: int = 1
    max_leaf_size: int = 4
    traversal_cost: float = 1.0
    intersection_cost: float = 1.0
    max_spatial_split_replications: float = 1.2
    create_node: Optional[Callable] = None
    set_node_children: Optional[Callable] = None
    set_node_bounds: Optional[Callable] = None
    create_leaf: Optional[Callable] = None
    split_primitive: Optional[Callable] = None
    progress: Optional[Callable] = None


@dataclasses.dataclass
class BuildPrimitive:
    """One RTCBuildPrimitive (rtcore_builder.h:29-42)."""

    lower: np.ndarray
    upper: np.ndarray
    geom_id: int
    prim_id: int


class BuildCancelled(RuntimeError):
    """Progress callback returned False (RTC_ERROR_CANCELLED analog)."""


def _morton_order(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Host 30-bit morton sort of primitive centroids
    (bvh_builder_morton.h:77 code computation)."""
    c = 0.5 * (lo + hi)
    cmin, cmax = c.min(0), c.max(0)
    ext = np.maximum(cmax - cmin, 1e-30)
    q = np.clip(((c - cmin) / ext) * 1023.0, 0, 1023).astype(np.uint32)
    code = morton3d(*(torch.from_numpy(q[:, k].astype(np.int64))
                      for k in range(3))).numpy()
    return np.argsort(code, kind="stable")


def _morton_bvh2(lo: np.ndarray, hi: np.ndarray, max_leaf: int):
    """Median build over the morton order -> same (child2, nlo2, nhi2,
    order, root_ref, leaf_mult) contract as build_bvh2."""
    P = lo.shape[0]
    order = _morton_order(lo, hi).astype(np.int64)
    leaf_mult = max_leaf + 1
    child2, nlo2, nhi2 = [], [], []

    def rec(s, e):
        cnt = e - s
        if cnt <= max_leaf:
            return -(s * leaf_mult + cnt + 1)
        mid = (s + e) // 2
        my = len(child2)
        child2.append([0, 0])
        nlo2.append([[0.0] * 3] * 2)
        nhi2.append([[0.0] * 3] * 2)
        for side, (a, b) in enumerate(((s, mid), (mid, e))):
            ref = rec(a, b)
            sel = order[a:b]
            child2[my][side] = ref
            nlo2[my][side] = lo[sel].min(0)
            nhi2[my][side] = hi[sel].max(0)
        return my

    root = rec(0, P) if P else None
    return (np.asarray(child2, np.int64).reshape(-1, 2),
            np.asarray(nlo2, np.float32).reshape(-1, 2, 3),
            np.asarray(nhi2, np.float32).reshape(-1, 2, 3),
            order, root, leaf_mult)


def _presplit(lo, hi, gid, pid, args: BuildArguments):
    """Bounded largest-area pre-splits through the user's split callback
    (the HIGH-quality path; cap = max_spatial_split_replications like
    state.h:113 / native/sah_builder.cpp presplit)."""
    budget = int((args.max_spatial_split_replications - 1.0) * lo.shape[0])
    if budget <= 0 or args.split_primitive is None:
        return lo, hi, gid, pid
    # one prioritized pass: split the `budget` largest-extent prims once
    # each at their widest-dimension midpoint (bounded presplit heuristic)
    ext = np.maximum(hi - lo, 0.0)
    priority = ext.max(1)
    pick = np.argsort(-priority, kind="stable")[:budget]
    new_lo, new_hi, new_g, new_p = [], [], [], []
    for i in pick:
        dim = int(np.argmax(ext[i]))
        pos = 0.5 * float(lo[i, dim] + hi[i, dim])
        prim = BuildPrimitive(lo[i].copy(), hi[i].copy(),
                              int(gid[i]), int(pid[i]))
        (llo, lhi), (rlo, rhi) = args.split_primitive(prim, dim, pos)
        lo[i], hi[i] = np.asarray(llo, np.float32), np.asarray(lhi, np.float32)
        new_lo.append(np.asarray(rlo, np.float32))
        new_hi.append(np.asarray(rhi, np.float32))
        new_g.append(int(gid[i]))
        new_p.append(int(pid[i]))
    return (np.concatenate([lo, np.stack(new_lo)]),
            np.concatenate([hi, np.stack(new_hi)]),
            np.concatenate([gid, np.asarray(new_g, np.int64)]),
            np.concatenate([pid, np.asarray(new_p, np.int64)]))


def build_user_bvh(args: BuildArguments, lower: np.ndarray, upper: np.ndarray,
                   geom_ids: np.ndarray | None = None,
                   prim_ids: np.ndarray | None = None):
    """rtcBuildBVH: build and emit the user tree; returns the root object."""
    if args.create_node is None or args.create_leaf is None:
        raise ValueError("create_node and create_leaf callbacks are required")
    lower = np.asarray(lower, np.float32).reshape(-1, 3)
    upper = np.asarray(upper, np.float32).reshape(-1, 3)
    P = lower.shape[0]
    geom_ids = (np.zeros(P, np.int64) if geom_ids is None
                else np.asarray(geom_ids, np.int64))
    prim_ids = (np.arange(P, dtype=np.int64) if prim_ids is None
                else np.asarray(prim_ids, np.int64))
    if P == 0:
        return args.create_leaf([])

    if args.progress is not None and not args.progress(0.0):
        raise BuildCancelled()

    if args.build_quality == BuildQualityEnum.HIGH:
        lower, upper, geom_ids, prim_ids = _presplit(
            lower, upper, geom_ids, prim_ids, args)

    if args.build_quality == BuildQualityEnum.LOW:
        child2, nlo2, nhi2, order, root_ref, leaf_mult = _morton_bvh2(
            lower, upper, args.max_leaf_size)
    else:
        settings = BuildSettings(
            branching_factor=args.max_branching_factor,
            max_leaf_size=args.max_leaf_size,
            min_leaf_size=args.min_leaf_size,
            travcost=args.traversal_cost,
            intcost=args.intersection_cost,
            max_depth=args.max_depth)
        child2, nlo2, nhi2, order, root_ref, leaf_mult = build_bvh2(
            lower, upper, settings)

    if args.progress is not None and not args.progress(0.5):
        raise BuildCancelled()

    def leaf_prims(ref):
        v = -ref - 1
        start, cnt = v // leaf_mult, v % leaf_mult
        sel = order[start:start + cnt]
        return [BuildPrimitive(lower[i], upper[i], int(geom_ids[i]),
                               int(prim_ids[i])) for i in sel]

    def leaf_bounds(ref):
        v = -ref - 1
        start, cnt = v // leaf_mult, v % leaf_mult
        sel = order[start:start + cnt]
        return lower[sel].min(0), upper[sel].max(0)

    area2 = None
    if args.max_branching_factor > 2:
        d = np.maximum(nhi2 - nlo2, 0.0)
        area2 = (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                 + d[..., 2] * d[..., 0])

    def emit(ref):
        if ref < 0:
            return args.create_leaf(leaf_prims(ref)), leaf_bounds(ref)
        # gather up to max_branching_factor children, expanding the
        # largest-area inner entry (bvh_builder_sah.h:240-266 rule)
        entries = [(int(child2[ref, s]), nlo2[ref, s], nhi2[ref, s])
                   for s in range(2)]
        if area2 is not None:
            def ent_area(e):
                d = np.maximum(e[2] - e[1], 0.0)
                return d[0] * d[1] + d[1] * d[2] + d[2] * d[0]
            while len(entries) < args.max_branching_factor:
                inner = [i for i, e in enumerate(entries) if e[0] >= 0]
                if not inner:
                    break
                i = max(inner, key=lambda k: ent_area(entries[k]))
                r = entries.pop(i)[0]
                entries.extend(
                    (int(child2[r, s]), nlo2[r, s], nhi2[r, s])
                    for s in range(2))
        node = args.create_node(len(entries))
        built = [emit(e[0]) for e in entries]
        if args.set_node_children is not None:
            args.set_node_children(node, [b[0] for b in built])
        if args.set_node_bounds is not None:
            args.set_node_bounds(node, [(e[1], e[2]) for e in entries])
        return node, (nlo2[ref].min(0) if ref >= 0 else None,
                      nhi2[ref].max(0) if ref >= 0 else None)

    root, _ = emit(root_ref)
    if args.progress is not None and not args.progress(1.0):
        raise BuildCancelled()
    return root
