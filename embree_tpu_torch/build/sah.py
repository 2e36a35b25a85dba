"""Frontier-based binned-SAH BVH builder (bulk-synchronous, vectorized).

Re-expression of the reference's recursive task-parallel builder
(kernels/builders/bvh_builder_sah.h GeneralBVHBuilder::recurse :202-301 and
heuristic_binning.h BinInfoT :233-316) as level-at-a-time data-parallel
passes: instead of a work-stealing task tree, every build record on the
current frontier is binned / swept / partitioned with one batch of
vectorized scatter-reduce ops — the formulation an accelerator wants, and
the same decisions embree makes:

  * 32-bin centroid binning per axis       (heuristic_binning.h:72,233)
  * SAH sweep with prefix/suffix areas     (heuristic_binning.h:353 best())
  * leaf-vs-split test                     (bvh_builder_sah.h:216-222)
  * fallback median split when centroids degenerate or depth caps out
                                           (bvh_builder_sah.h:139-198)

Builds a binary BVH first, then collapses to a WIDTH-ary BVH by repeatedly
expanding the largest-area inner child (bvh_builder_sah.h:240-266's N-ary
child-filling rule). Host numpy (commit-time preprocessing). Copy of
embree_tpu/build/sah.py.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .bvh import BVHArraysNP, empty_bvh_np

NBINS = 32


@dataclasses.dataclass
class BuildSettings:
    """Subset of embree's builder Settings (bvh_builder_sah.h:35-70)."""

    branching_factor: int = 4
    max_leaf_size: int = 4
    min_leaf_size: int = 1
    travcost: float = 1.0
    intcost: float = 1.0
    max_depth: int = 64
    # > 1 enables pre-split reference duplication (the bounded form of
    # spatial splits; embree max_spatial_split_replications default 1.2).
    # Native backend only; the python fallback ignores it.
    spatial_factor: float = 1.0


def _half_area(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    d = np.maximum(hi - lo, 0.0)
    return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0]


def build_bvh2(prim_lower: np.ndarray, prim_upper: np.ndarray,
               settings: BuildSettings):
    """Binary SAH build over PrimRef bounds.

    Returns (child2, nlo2, nhi2, order, root_ref, leaf_mult): child2 is
    (N2, 2) i64 child refs — inner >= 0 is a node index, leaf < 0 encodes
    -(start * leaf_mult + count + 1) into the reordered prim array.
    """
    P = prim_lower.shape[0]
    order = np.arange(P, dtype=np.int64)
    centroid = 0.5 * (prim_lower + prim_upper)
    leaf_mult = settings.max_leaf_size + 1

    cap = max(2 * P // max(settings.max_leaf_size, 1) + 16, 64)
    child2 = np.zeros((cap, 2), np.int64)
    nlo2 = np.full((cap, 2, 3), np.inf, np.float32)
    nhi2 = np.full((cap, 2, 3), -np.inf, np.float32)
    num_nodes = 0

    def encode_leaf(start, cnt):
        return -(int(start) * leaf_mult + int(cnt) + 1)

    # frontier record arrays: range [start, end) of `order`, parent flat slot
    # (= node_id*2 + side), -1 for the root record
    rec_s = np.array([0], np.int64)
    rec_e = np.array([P], np.int64)
    rec_parent = np.array([-1], np.int64)
    root_ref = None
    depth = 0

    while rec_s.size:
        S = rec_s.size
        cnt = rec_e - rec_s
        total = int(cnt.sum())
        seg_of = np.repeat(np.arange(S), cnt)
        seg_flat_start = np.concatenate([[0], np.cumsum(cnt)[:-1]])
        pos_in_seg = np.arange(total) - seg_flat_start[seg_of]
        global_pos = rec_s[seg_of] + pos_in_seg
        pidx = order[global_pos]

        plo = prim_lower[pidx]
        phi = prim_upper[pidx]
        c = centroid[pidx]

        # --- per-segment geometry & centroid bounds -------------------------
        glo = np.full((S, 3), np.inf, np.float32)
        ghi = np.full((S, 3), -np.inf, np.float32)
        np.minimum.at(glo, seg_of, plo)
        np.maximum.at(ghi, seg_of, phi)
        clo = np.full((S, 3), np.inf, np.float32)
        chi = np.full((S, 3), -np.inf, np.float32)
        np.minimum.at(clo, seg_of, c)
        np.maximum.at(chi, seg_of, c)

        # --- binning (heuristic_binning.h:72 BinMapping::bin) ---------------
        ext = chi - clo
        scale = np.where(ext > 0, (NBINS * (1.0 - 1e-6)) / np.maximum(ext, 1e-30), 0.0)
        bins = np.clip(((c - clo[seg_of]) * scale[seg_of]).astype(np.int64),
                       0, NBINS - 1)  # (total, 3)

        hist_n = np.zeros((S, 3, NBINS), np.int64)
        hist_lo = np.full((S, 3, NBINS, 3), np.inf, np.float32)
        hist_hi = np.full((S, 3, NBINS, 3), -np.inf, np.float32)
        for ax in range(3):
            np.add.at(hist_n, (seg_of, ax, bins[:, ax]), 1)
            np.minimum.at(hist_lo, (seg_of, ax, bins[:, ax]), plo)
            np.maximum.at(hist_hi, (seg_of, ax, bins[:, ax]), phi)

        # --- SAH sweep (heuristic_binning.h:353 best) -----------------------
        ln = np.cumsum(hist_n, axis=2)
        llo = np.minimum.accumulate(hist_lo, axis=2)
        lhi = np.maximum.accumulate(hist_hi, axis=2)
        rn = np.cumsum(hist_n[:, :, ::-1], axis=2)[:, :, ::-1]
        rlo = np.minimum.accumulate(hist_lo[:, :, ::-1], axis=2)[:, :, ::-1]
        rhi = np.maximum.accumulate(hist_hi[:, :, ::-1], axis=2)[:, :, ::-1]
        # split after bin b: left = bins[0..b], right = bins[b+1..]
        la = _half_area(llo[:, :, :-1], lhi[:, :, :-1])
        ra = _half_area(rlo[:, :, 1:], rhi[:, :, 1:])
        lc, rc = ln[:, :, :-1], rn[:, :, 1:]
        cost = np.where((lc == 0) | (rc == 0), np.inf, la * lc + ra * rc)
        flat = cost.reshape(S, -1)
        best = flat.argmin(axis=1)
        best_cost = flat[np.arange(S), best]
        best_axis = (best // (NBINS - 1)).astype(np.int64)
        best_bin = (best % (NBINS - 1)).astype(np.int64)

        # --- leaf / split decision (bvh_builder_sah.h:216-222) --------------
        area = _half_area(glo, ghi)
        leaf_sah = settings.intcost * cnt * area
        split_sah = settings.travcost * area + settings.intcost * best_cost
        no_split = ~np.isfinite(best_cost)
        make_leaf = (cnt <= settings.min_leaf_size) | (
            (cnt <= settings.max_leaf_size) & ((leaf_sah <= split_sah) | no_split))
        fallback = (~make_leaf) & (no_split | (depth >= settings.max_depth))

        # --- allocate nodes for splits, wire refs into parents --------------
        split_idx = np.nonzero(~make_leaf)[0]
        n_split = split_idx.size
        if num_nodes + n_split > child2.shape[0]:
            grow = max(child2.shape[0] * 2, num_nodes + n_split)
            child2 = np.concatenate([child2, np.zeros((grow - child2.shape[0], 2), np.int64)])
            nlo2 = np.concatenate([nlo2, np.full((grow - nlo2.shape[0], 2, 3), np.inf, np.float32)])
            nhi2 = np.concatenate([nhi2, np.full((grow - nhi2.shape[0], 2, 3), -np.inf, np.float32)])
        node_of_rec = np.full(S, -1, np.int64)
        node_of_rec[split_idx] = num_nodes + np.arange(n_split)
        num_nodes += n_split

        refs = np.where(make_leaf,
                        -(rec_s * leaf_mult + cnt + 1),
                        node_of_rec)
        has_parent = rec_parent >= 0
        pp = rec_parent[has_parent]
        child2.reshape(-1)[pp] = refs[has_parent]
        nlo2.reshape(-1, 3)[pp] = glo[has_parent]
        nhi2.reshape(-1, 3)[pp] = ghi[has_parent]
        if not has_parent.all():
            root_ref = int(refs[~has_parent][0])

        if n_split == 0:
            break

        # --- partition (stable, vectorized over the whole frontier) --------
        goes_left = bins[np.arange(total), best_axis[seg_of]] <= best_bin[seg_of]
        goes_left = np.where(fallback[seg_of],
                             pos_in_seg < (cnt[seg_of] // 2), goes_left)
        sel = (~make_leaf)[seg_of]
        pidx_sel = pidx[sel]
        # stable sort by (segment, right-flag) == embree's in-order partition
        key = seg_of[sel] * 2 + (~goes_left[sel])
        perm = np.argsort(key, kind="stable")
        # dest positions: flat order within each segment is ascending already
        order[global_pos[sel]] = pidx_sel[perm]

        lcounts = np.bincount(seg_of[sel & goes_left], minlength=S)
        mid = rec_s + lcounts
        rec_s = np.concatenate([rec_s[split_idx], mid[split_idx]])
        rec_e = np.concatenate([mid[split_idx], rec_e[split_idx]])
        rec_parent = np.concatenate(
            [node_of_rec[split_idx] * 2, node_of_rec[split_idx] * 2 + 1])
        depth += 1

    return (child2[:num_nodes], nlo2[:num_nodes], nhi2[:num_nodes], order,
            root_ref, leaf_mult)


def collapse_to_wide(child2, nlo2, nhi2, order, root_ref, leaf_mult,
                     width: int, prim_lower, prim_upper) -> BVHArraysNP:
    """BVH2 -> BVH<width> by expanding the largest-area inner child
    (the reference's multi-way child filling, bvh_builder_sah.h:240-266)."""
    if root_ref is None:
        return empty_bvh_np(width)

    def leaf_decode(ref):
        v = -ref - 1
        return v // leaf_mult, v % leaf_mult

    # leaf root -> single node with one leaf child
    if root_ref < 0:
        start, cnt = leaf_decode(root_ref)
        node_lo = np.full((width, 3), np.inf, np.float32)
        node_hi = np.full((width, 3), -np.inf, np.float32)
        ch = np.zeros(width, np.int32)
        cn = np.full(width, -1, np.int32)
        if cnt > 0:
            sel = order[start:start + cnt]
            node_lo[0] = prim_lower[sel].min(0)
            node_hi[0] = prim_upper[sel].max(0)
            ch[0], cn[0] = start, cnt
        return BVHArraysNP(node_lo[None], node_hi[None], ch[None], cn[None],
                           order.astype(np.int32))

    area2 = _half_area(nlo2, nhi2)  # (N2, 2)
    wide_ids = {int(root_ref): 0}
    todo = [int(root_ref)]
    next_id = 1
    rows = []
    while todo:
        ref = todo.pop()
        entries = [(int(child2[ref, s]), nlo2[ref, s], nhi2[ref, s],
                    float(area2[ref, s])) for s in range(2)]
        while len(entries) < width:
            best_i, best_a = -1, -1.0
            for i, e in enumerate(entries):
                if e[0] >= 0 and e[3] > best_a:
                    best_i, best_a = i, e[3]
            if best_i < 0:
                break
            r = entries.pop(best_i)[0]
            entries.extend(
                (int(child2[r, s]), nlo2[r, s], nhi2[r, s], float(area2[r, s]))
                for s in range(2))
        rows.append((ref, entries))
        for e in entries:
            if e[0] >= 0 and e[0] not in wide_ids:
                wide_ids[e[0]] = next_id
                next_id += 1
                todo.append(e[0])

    M = next_id
    lower = np.full((M, width, 3), np.inf, np.float32)
    upper = np.full((M, width, 3), -np.inf, np.float32)
    childw = np.zeros((M, width), np.int32)
    countw = np.full((M, width), -1, np.int32)
    for ref, entries in rows:
        m = wide_ids[ref]
        for i, (r, lo, hi, _a) in enumerate(entries):
            lower[m, i] = lo
            upper[m, i] = hi
            if r >= 0:
                childw[m, i] = wide_ids[r]
                countw[m, i] = 0
            else:
                start, cnt = leaf_decode(r)
                childw[m, i] = start
                countw[m, i] = cnt

    return BVHArraysNP(lower, upper, childw, countw, order.astype(np.int32))


def build_sah(prim_lower: np.ndarray, prim_upper: np.ndarray,
              settings: BuildSettings = BuildSettings(),
              backend: str = "default", tri_verts=None) -> BVHArraysNP:
    """Full pipeline: binary SAH build + collapse to wide BVH.

    backend: "default"/"native" prefer the C++ builder (~400x the numpy
    frontier builder); "python" forces the numpy path (tests/fallback)."""
    prim_lower = np.asarray(prim_lower, np.float32)
    prim_upper = np.asarray(prim_upper, np.float32)
    if prim_lower.shape[0] == 0:
        return empty_bvh_np(settings.branching_factor)
    if backend in ("default", "native"):
        from .native import build_sah_native
        out = build_sah_native(prim_lower, prim_upper,
                               branching=settings.branching_factor,
                               max_leaf=settings.max_leaf_size,
                               min_leaf=settings.min_leaf_size,
                               spatial_factor=settings.spatial_factor,
                               tri_verts=tri_verts)
        if out is not None:
            return out
        if backend == "native":
            raise RuntimeError("native builder unavailable")
    child2, nlo2, nhi2, order, root_ref, leaf_mult = build_bvh2(
        prim_lower, prim_upper, settings)
    return collapse_to_wide(child2, nlo2, nhi2, order, root_ref, leaf_mult,
                            settings.branching_factor, prim_lower, prim_upper)
