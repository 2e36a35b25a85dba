"""Two-level BVH with the open-merge heuristic (host numpy).

Counterpart of embree_tpu/build/twolevel.py, copied: the same entries,
byte for byte, for the same host BVH arrays. Reference:
bvh_builder_twolevel.cpp + heuristic_openmerge_array.h — instead of
building the top level over opaque per-instance root boxes (whose
world-space AABBs of rotated instances overlap), the builder OPENS the
largest instance subtrees, replacing a root entry by its (transformed)
child boxes until an entry budget is hit.

Use here: `Scene.commit` opens each instance's child BVH on its own
(one instance, budget 8 entries), and the instance fold of
`scene_intersect` slab-tests every ray against the instance's opened
entry boxes and sends the rays that miss all of them into the child
with tfar = -inf (a retired ray costs the child's kernel one node
visit).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class TwoLevelEntries(NamedTuple):
    lower: np.ndarray     # (E, 3) world-space entry bounds
    upper: np.ndarray     # (E, 3)
    inst: np.ndarray      # (E,) instance index of each entry


def _xfm_box(l2w: np.ndarray, lo: np.ndarray, hi: np.ndarray):
    """Transform AABBs (N, 3) by an affine (3, 4): world AABB of the 8
    transformed corners."""
    lin = l2w[:, :3]
    t = l2w[:, 3]
    out_lo = np.full_like(lo, np.inf)
    out_hi = np.full_like(hi, -np.inf)
    for m in range(8):
        c = np.where([(m >> k) & 1 for k in range(3)], hi, lo)
        w = c @ lin.T + t
        out_lo = np.minimum(out_lo, w)
        out_hi = np.maximum(out_hi, w)
    return out_lo, out_hi


def _area(lo, hi):
    d = np.maximum(hi - lo, 0.0)
    return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] \
        + d[..., 2] * d[..., 0]


def open_merge_entries(instances, budget_factor: float = 8.0,
                       max_entries: int = 4096) -> TwoLevelEntries:
    """Opened top-level entry set (heuristic_openmerge_array.h analog).

    `instances`: [(l2w (3,4) np, child BVH host arrays: lower, upper,
    child, count)] — per instance, start from the root box and greedily
    open the largest-area openable entry (an inner node of that
    instance's BVH) until the budget (budget_factor * #instances,
    capped) is spent. Opening priority = world-space surface area, the
    reference's open_sequential criterion."""
    import heapq

    # entry = (-area, seq, inst_idx, node_ref, is_leafref)
    heap = []
    seq = 0
    infos = []
    for ii, (l2w, lower, upper, child, count) in enumerate(instances):
        valid0 = count[0] >= 0
        lo_r = lower[0][valid0].min(0)
        hi_r = upper[0][valid0].max(0)
        wlo, whi = _xfm_box(l2w, lo_r[None], hi_r[None])
        heapq.heappush(heap, (-float(_area(wlo[0], whi[0])), seq, ii,
                              -1, wlo[0], whi[0]))
        seq += 1
        infos.append((l2w, lower, upper, child, count))

    budget = min(max_entries, max(len(instances),
                                  int(budget_factor * len(instances))))
    out = []
    while heap:
        neg_a, _s, ii, node, wlo, whi = heapq.heappop(heap)
        l2w, lower, upper, child, count = infos[ii]
        n_open = len(heap) + len(out) + 1
        if n_open >= budget:
            out.append((ii, wlo, whi))
            continue
        # open: node == -1 means the instance root box -> push node 0's
        # children; node >= 0 pushes that inner node's children
        nid = 0 if node == -1 else node
        opened = False
        for c in range(child.shape[1]):
            if count[nid, c] < 0:
                continue
            clo, chi = _xfm_box(l2w, lower[nid, c][None],
                                upper[nid, c][None])
            if count[nid, c] == 0:
                heapq.heappush(
                    heap, (-float(_area(clo[0], chi[0])), seq, ii,
                           int(child[nid, c]), clo[0], chi[0]))
            else:
                out.append((ii, clo[0], chi[0]))
            seq += 1
            opened = True
        if not opened:
            out.append((ii, wlo, whi))
    # drain any unopened heap entries
    for neg_a, _s, ii, node, wlo, whi in heap:
        out.append((ii, wlo, whi))

    inst = np.asarray([o[0] for o in out], np.int32)
    lo = np.asarray([o[1] for o in out], np.float32)
    hi = np.asarray([o[2] for o in out], np.float32)
    return TwoLevelEntries(lower=lo, upper=hi, inst=inst)
