"""Catmull-Clark subdivision core (topology + uniform refinement).

Counterpart of embree_tpu/subdiv/core.py: the topology and the numpy
evaluation are host copies; the differentiable evaluation
(`apply_stencil_torch`, `apply_limit_stencil` and
`vertex_normals_torch`, the JAX package's `apply_stencil_jnp`,
`apply_limit_stencil` and `vertex_normals_jnp`) runs as torch ops, whose
gradients autograd carries through `index_add` and indexing.

Re-design of the reference's subdivision stack
(kernels/subdiv/*): instead of per-patch feature-adaptive evaluation
(catmullclark_ring.h / patch_eval_grid.h), we run **global uniform
subdivision** of the whole control cage, L levels deep — exactly the
semantics the fork forces anyway (bvh_builder_subdiv.cpp:772-775 sets
every edge level to 1 << subdivisionLevel) — expressed as bulk
gather/segment-sum passes over flat arrays. Stencils are precomputed per
level on the host and evaluated with numpy; displacement is a function
of the subdivided vertices, not a per-patch callback.

Rules (standard Catmull-Clark, matching half_edge.h semantics):
  * face point = face centroid
  * edge point: smooth (v0+v1+f0+f1)/4; boundary/sharp (v0+v1)/2;
    semi-sharp 0<s<1 lerps the two (crease weight decays by 1 per level)
  * vertex point: smooth (n-2)/n S + 1/n^2 (sum others) + 1/n^2 (sum face
    points); crease (two sharp edges) 3/4 S + 1/8 each sharp neighbor;
    corner (>=3 sharp edges, hard vertex crease, or boundary corner)
    pinned; semi-sharp lerps
Mesh-level displacement keeps shared vertices bitwise identical across
patches, so displaced surfaces are watertight by construction (the
reference needs explicit grid stitching, tessellation.h:77).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class LevelStencil:
    """One refinement level: topology + evaluation stencils.

    Output vertex layout: [face points (F) | edge points (E) | vertex
    points (V)]. Evaluation is three passes (faces first because edge and
    vertex rows reference face-point outputs).
    """

    F: int
    E: int
    V: int
    # face rows: CSR over input vertices
    f_seg: np.ndarray      # (sum counts,) output face id per entry
    f_idx: np.ndarray      # input vertex ids
    f_w: np.ndarray        # weights
    # edge rows: (E, 2) verts + (E, 2) faces with weights
    e_vidx: np.ndarray     # (E, 2)
    e_vw: np.ndarray       # (E, 2)
    e_fidx: np.ndarray     # (E, 2) face ids (clamped; weight 0 when absent)
    e_fw: np.ndarray       # (E, 2)
    # vertex rows: self + CSR over neighbor verts + CSR over faces
    v_self_w: np.ndarray   # (V,)
    vn_seg: np.ndarray     # neighbor entries: output vertex id per entry
    vn_idx: np.ndarray     # neighbor input vertex ids
    vn_w: np.ndarray
    vf_seg: np.ndarray     # face entries: output vertex id per entry
    vf_idx: np.ndarray     # face ids
    vf_w: np.ndarray
    # output quads (F_out, 4) into output vertex space, + provenance
    out_quads: np.ndarray
    quad_parent: np.ndarray  # input face id of each output quad
    quad_corner: np.ndarray  # corner index within the input face
    # state carried to the next level
    next_edge_sharp: np.ndarray  # (E,) sharpness for child edges (decayed)
    next_vertex_sharp: np.ndarray  # (F+E+V,)

    @property
    def num_out_vertices(self) -> int:
        return self.F + self.E + self.V


def _build_edges(face_counts, face_offsets, face_indices):
    """Unique undirected edges; per-edge adjacent faces; halfedge->edge."""
    F = face_counts.shape[0]
    reps = face_counts.astype(np.int64)
    fid = np.repeat(np.arange(F), reps)
    a = face_indices.astype(np.int64)
    pos = np.arange(a.shape[0]) - np.repeat(face_offsets[:-1], reps)
    nxt = np.where(pos + 1 < reps[fid], np.arange(a.shape[0]) + 1,
                   np.repeat(face_offsets[:-1], reps))
    b = face_indices[nxt].astype(np.int64)
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    key = lo * (1 << 31) + hi
    uniq, inv = np.unique(key, return_inverse=True)
    E = uniq.shape[0]
    edges = np.stack([uniq // (1 << 31), uniq % (1 << 31)], 1)
    edge_faces = np.full((E, 2), -1, np.int64)
    order = np.argsort(inv, kind="stable")
    count = np.bincount(inv, minlength=E)
    first = np.concatenate([[0], np.cumsum(count)[:-1]])
    edge_faces[:, 0] = fid[order[first]]
    has2 = count >= 2
    edge_faces[has2, 1] = fid[order[first[has2] + 1]]
    return edges, edge_faces, inv


def refine_topology(face_counts, face_indices,
                    num_vertices: int,
                    edge_sharp: Optional[np.ndarray] = None,
                    edge_sharp_edges: Optional[np.ndarray] = None,
                    vertex_sharp: Optional[np.ndarray] = None) -> LevelStencil:
    """One uniform refinement step. `edge_sharp_edges`/(edge_sharp) give
    crease weights for specific (v0<v1) pairs; boundary edges are
    implicitly infinitely sharp."""
    face_counts = np.asarray(face_counts, np.int64)
    face_indices = np.asarray(face_indices, np.int64)
    V = int(num_vertices)
    F = face_counts.shape[0]
    face_offsets = np.concatenate([[0], np.cumsum(face_counts)])
    edges, edge_faces, he_edge = _build_edges(face_counts, face_offsets,
                                              face_indices)
    E = edges.shape[0]
    boundary = edge_faces[:, 1] < 0

    sharp = np.zeros(E, np.float32)
    if edge_sharp is not None and edge_sharp_edges is not None \
            and len(edge_sharp):
        ce = np.asarray(edge_sharp_edges, np.int64).reshape(-1, 2)
        lo = np.minimum(ce[:, 0], ce[:, 1])
        hi = np.maximum(ce[:, 0], ce[:, 1])
        ckey = lo * (1 << 31) + hi
        ekey = edges[:, 0] * (1 << 31) + edges[:, 1]
        pos = np.searchsorted(ekey, ckey)
        ok = (pos < E)
        ok[ok] &= ekey[pos[ok]] == ckey[ok]
        sharp_vals = np.asarray(edge_sharp, np.float32).reshape(-1)
        np.maximum.at(sharp, pos[ok], sharp_vals[ok])
    sharp = np.where(boundary, np.float32(np.inf), sharp)
    vsharp = np.zeros(V, np.float32) if vertex_sharp is None \
        else np.asarray(vertex_sharp, np.float32)[:V]

    fp0, ep0, vp0 = 0, F, F + E

    # ---- face rows ---------------------------------------------------------
    reps = face_counts
    fid = np.repeat(np.arange(F), reps)
    f_seg = fid
    f_idx = face_indices
    f_w = (1.0 / face_counts[fid]).astype(np.float32)

    # ---- edge rows ---------------------------------------------------------
    s01 = np.clip(np.nan_to_num(sharp, posinf=1e9), 0.0, 1.0)
    wv = (0.25 * (1.0 - s01) + 0.5 * s01).astype(np.float32)
    wf = np.where(boundary, 0.0, 0.25 * (1.0 - s01)).astype(np.float32)
    e_vidx = edges
    e_vw = np.stack([wv, wv], 1)
    e_fidx = np.maximum(edge_faces, 0)
    e_fw = np.stack([wf, wf], 1)

    # ---- vertex rows -------------------------------------------------------
    vcount = np.bincount(edges.reshape(-1), minlength=V)
    fcount = np.bincount(face_indices, minlength=V)
    sharp_edge = (np.nan_to_num(sharp, posinf=1e9) >= 1.0)
    n_sharp = np.bincount(edges[sharp_edge].reshape(-1), minlength=V)
    bcount = np.bincount(edges[boundary].reshape(-1), minlength=V)

    # per-vertex sorted incident edges / faces
    ve_vert = edges.reshape(-1)
    ve_order = np.argsort(ve_vert, kind="stable")
    ve_edge = ve_order // 2
    ve_other = edges[ve_edge, 1 - (ve_order % 2)]
    ve_off = np.concatenate([[0], np.cumsum(vcount)])
    vf_order = np.argsort(face_indices, kind="stable")
    vf_face = fid[vf_order]

    # rule per vertex: 0 smooth, 1 crease, 2 corner
    rule = np.zeros(V, np.int64)
    rule[n_sharp >= 2] = 1
    rule[(n_sharp >= 3) | (vsharp >= 1.0)] = 2
    rule[(bcount >= 2) & (vcount <= 2)] = 2
    rule[vcount == 0] = 2

    n = np.maximum(vcount, 1).astype(np.float32)
    # semi-sharp vertex lerp factor: fractional vertex crease, plus the
    # fractional edge-crease transition (avg of the two largest fractional
    # sharpnesses), matching half_edge.h's blended rules in spirit
    frac = np.clip(vsharp, 0.0, 1.0)

    # neighbor entries: weight by rule
    vseg_n = ve_vert[ve_order]
    e_of_entry = ve_edge
    is_sharp_entry = sharp_edge[e_of_entry]
    rule_n = rule[vseg_n]
    w_smooth_n = (1.0 / (n * n))[vseg_n]
    # crease: the (first two) sharp-edge neighbors get 1/8 — with exactly 2
    # sharp edges every sharp entry gets 1/8; >2 is corner anyway
    w_crease_n = np.where(is_sharp_entry, 0.125, 0.0)
    vn_w = np.where(rule_n == 0, w_smooth_n,
                    np.where(rule_n == 1, w_crease_n, 0.0)).astype(np.float32)
    vn_w = vn_w * (1.0 - frac[vseg_n])
    vn_seg = vseg_n
    vn_idx = ve_other

    # face entries: smooth only
    vseg_f = face_indices[vf_order]
    rule_f = rule[vseg_f]
    w_f = np.where(rule_f == 0, (1.0 / (n * n))[vseg_f], 0.0).astype(np.float32)
    w_f = w_f * (1.0 - frac[vseg_f])
    vf_seg = vseg_f
    vf_idx = vf_face
    vf_w = w_f

    # self weights
    w_self = np.where(rule == 0, (n - 2.0) / n,
                      np.where(rule == 1, 0.75, 1.0)).astype(np.float32)
    v_self_w = w_self * (1.0 - frac) + frac

    # non-quad-valence guard: smooth rule assumed fcount == vcount
    # (interior manifold). Where it doesn't hold (boundary smooth
    # vertices with one sharp edge, "darts" on boundaries), fall back to
    # normalizing total weight to 1.
    tot = np.zeros(V, np.float64)
    np.add.at(tot, vn_seg, vn_w)
    np.add.at(tot, vf_seg, vf_w)
    tot += v_self_w
    bad = np.abs(tot - 1.0) > 1e-4
    if bad.any():
        scale = np.where(bad, 1.0 / np.maximum(tot, 1e-9), 1.0)
        v_self_w = (v_self_w * scale).astype(np.float32)
        vn_w = (vn_w * scale[vn_seg]).astype(np.float32)
        vf_w = (vf_w * scale[vf_seg]).astype(np.float32)

    # ---- output quads ------------------------------------------------------
    total_corners = int(face_counts.sum())
    corner_face = fid
    corner_pos = np.arange(total_corners) - np.repeat(face_offsets[:-1], reps)
    prev_pos = np.where(corner_pos > 0, np.arange(total_corners) - 1,
                        np.arange(total_corners) + face_counts[corner_face] - 1)
    he_prev = he_edge[prev_pos]
    out_quads = np.stack([
        vp0 + face_indices,
        ep0 + he_edge,
        fp0 + corner_face,
        ep0 + he_prev], 1)

    # ---- sharpness decay for the next level --------------------------------
    next_edge_sharp = np.where(boundary, np.float32(np.inf),
                               np.maximum(np.nan_to_num(sharp, posinf=1e9)
                                          - 1.0, 0.0))
    next_vsharp = np.zeros(F + E + V, np.float32)
    next_vsharp[vp0:] = np.maximum(vsharp - 1.0, 0.0)

    return LevelStencil(
        F=F, E=E, V=V,
        f_seg=f_seg, f_idx=f_idx, f_w=f_w,
        e_vidx=e_vidx, e_vw=e_vw.astype(np.float32),
        e_fidx=e_fidx, e_fw=e_fw.astype(np.float32),
        v_self_w=v_self_w.astype(np.float32),
        vn_seg=vn_seg, vn_idx=vn_idx, vn_w=vn_w,
        vf_seg=vf_seg, vf_idx=vf_idx, vf_w=vf_w,
        out_quads=out_quads, quad_parent=corner_face,
        quad_corner=corner_pos,
        next_edge_sharp=next_edge_sharp,
        next_vertex_sharp=next_vsharp,
    )


def apply_stencil_np(st: LevelStencil, verts: np.ndarray) -> np.ndarray:
    """Numpy evaluation of one refinement level."""
    C = verts.shape[1]
    fp = np.zeros((st.F, C), verts.dtype)
    np.add.at(fp, st.f_seg, verts[st.f_idx] * st.f_w[:, None])
    ep = (verts[st.e_vidx[:, 0]] * st.e_vw[:, 0:1]
          + verts[st.e_vidx[:, 1]] * st.e_vw[:, 1:2]
          + fp[st.e_fidx[:, 0]] * st.e_fw[:, 0:1]
          + fp[st.e_fidx[:, 1]] * st.e_fw[:, 1:2])
    vp = verts[:st.V] * st.v_self_w[:, None]
    np.add.at(vp, st.vn_seg, verts[st.vn_idx] * st.vn_w[:, None])
    np.add.at(vp, st.vf_seg, fp[st.vf_idx] * st.vf_w[:, None])
    return np.concatenate([fp, ep, vp])


def _like(a, verts: torch.Tensor) -> torch.Tensor:
    """A stencil array as a tensor on `verts`' device: weights in its
    dtype (the JAX package rounds them to float32 too), ids as they are."""
    t = torch.as_tensor(a, device=verts.device)
    return t.to(verts.dtype) if t.is_floating_point() else t


def _seg_sum(rows, vals, n: int) -> torch.Tensor:
    """segment_sum: `vals` summed into `n` rows (out of place)."""
    return vals.new_zeros((n, vals.shape[1])).index_add(0, rows, vals)


def apply_stencil_torch(st: LevelStencil, verts: torch.Tensor):
    """Torch evaluation (differentiable w.r.t. verts) of one level; the
    stencil's arrays may be numpy or tensors on verts' device
    (`plan_to`). Gathers are `index_select`, whose backward is one
    `index_add` (advanced indexing's sorts its indices first, an order of
    magnitude slower on the card)."""
    def t(a):
        return _like(a, verts)

    def take(a, idx):
        return a.index_select(0, idx)

    e_vidx, e_vw, e_fidx, e_fw = (t(st.e_vidx), t(st.e_vw), t(st.e_fidx),
                                  t(st.e_fw))
    fp = _seg_sum(t(st.f_seg), take(verts, t(st.f_idx)) * t(st.f_w)[:, None],
                  st.F)
    ep = (take(verts, e_vidx[:, 0]) * e_vw[:, 0:1]
          + take(verts, e_vidx[:, 1]) * e_vw[:, 1:2]
          + take(fp, e_fidx[:, 0]) * e_fw[:, 0:1]
          + take(fp, e_fidx[:, 1]) * e_fw[:, 1:2])
    vp = verts[:st.V] * t(st.v_self_w)[:, None]
    vp = vp + _seg_sum(t(st.vn_seg),
                       take(verts, t(st.vn_idx)) * t(st.vn_w)[:, None], st.V)
    vp = vp + _seg_sum(t(st.vf_seg),
                       take(fp, t(st.vf_idx)) * t(st.vf_w)[:, None], st.V)
    return torch.cat([fp, ep, vp])


_STENCIL_ARRAYS = ("f_seg", "f_idx", "f_w", "e_vidx", "e_vw", "e_fidx",
                   "e_fw", "v_self_w", "vn_seg", "vn_idx", "vn_w", "vf_seg",
                   "vf_idx", "vf_w")


@dataclasses.dataclass
class SubdivisionPlan:
    """All L refinement levels for a control cage (topology only —
    positions are evaluated later, possibly differentiably)."""

    levels: list
    base_face_counts: np.ndarray
    base_num_vertices: int
    # creases surviving to the final mesh (for limit projection)
    final_edge_creases: np.ndarray = None        # (K, 2) or None
    final_edge_crease_weights: np.ndarray = None
    final_vertex_sharp: np.ndarray = None        # (Vfinal,)

    @property
    def final_quads(self) -> np.ndarray:
        return self.levels[-1].out_quads

    @property
    def num_final_vertices(self) -> int:
        return self.levels[-1].num_out_vertices


def plan_subdivision(face_counts, face_indices, num_vertices, levels: int,
                     edge_creases=None, edge_crease_weights=None,
                     vertex_creases=None, vertex_crease_weights=None
                     ) -> SubdivisionPlan:
    assert levels >= 1
    face_counts = np.asarray(face_counts, np.int64)
    face_indices = np.asarray(face_indices, np.int64)
    vsharp = np.zeros(num_vertices, np.float32)
    if vertex_creases is not None and len(vertex_creases):
        vsharp[np.asarray(vertex_creases, np.int64)] = np.asarray(
            vertex_crease_weights, np.float32)
    es_edges = None
    es_w = None
    if edge_creases is not None and len(edge_creases):
        es_edges = np.asarray(edge_creases, np.int64).reshape(-1, 2)
        es_w = np.asarray(edge_crease_weights, np.float32).reshape(-1)

    out = []
    V = num_vertices
    for _lvl in range(levels):
        st = refine_topology(face_counts, face_indices, V,
                             edge_sharp=es_w, edge_sharp_edges=es_edges,
                             vertex_sharp=vsharp)
        out.append(st)
        # next level: all quads over the new vertex set
        Fq = st.out_quads.shape[0]
        face_counts = np.full(Fq, 4, np.int64)
        face_indices = st.out_quads.reshape(-1)
        V = st.num_out_vertices
        vsharp = st.next_vertex_sharp
        # child creases: edge e splits into (v0', e') and (v1', e')
        dec = st.next_edge_sharp
        keep = dec > 0
        if keep.any():
            ids = np.nonzero(keep)[0]
            ep0 = st.F
            vp0 = st.F + st.E
            c0 = np.stack([vp0 + st.e_vidx[ids, 0], ep0 + ids], 1)
            c1 = np.stack([vp0 + st.e_vidx[ids, 1], ep0 + ids], 1)
            es_edges = np.concatenate([c0, c1])
            es_w = np.concatenate([dec[ids], dec[ids]])
        else:
            es_edges = None
            es_w = None

    return SubdivisionPlan(levels=out, base_face_counts=face_counts,
                           base_num_vertices=num_vertices,
                           final_edge_creases=es_edges,
                           final_edge_crease_weights=es_w,
                           final_vertex_sharp=vsharp)


def evaluate_plan(plan: SubdivisionPlan, base_vertices):
    """Run all levels; returns the final vertex array: numpy for a numpy
    cage, a tensor (differentiable) for a tensor."""
    apply = (apply_stencil_torch if isinstance(base_vertices, torch.Tensor)
             else apply_stencil_np)
    v = base_vertices
    for st in plan.levels:
        v = apply(st, v)
    return v


def plan_to(plan: SubdivisionPlan, device) -> SubdivisionPlan:
    """The plan with its evaluation stencils as tensors on `device` (the
    weights float32), so that `evaluate_plan` uploads nothing a call."""
    def up(a):
        t = torch.as_tensor(a, device=device)
        return t.float() if t.is_floating_point() else t

    return dataclasses.replace(plan, levels=[
        dataclasses.replace(st, **{f: up(getattr(st, f))
                                   for f in _STENCIL_ARRAYS})
        for st in plan.levels])


def limit_stencil(plan: SubdivisionPlan):
    """Sparse (rows, cols, w) stencil with limit_verts = scatter-add of
    w * verts[cols] into rows — the same rules as limit_project but as a
    topology-only linear operator, which `apply_limit_stencil` applies to
    tensors differentiably (the differentiable commit path)."""
    quads = plan.final_quads
    V = plan.num_final_vertices
    n_faces = np.zeros(V, np.int64)
    for c in range(4):
        np.add.at(n_faces, quads[:, c], 1)
    n = np.maximum(n_faces, 1).astype(np.float64)

    rows, cols, ws = [], [], []
    inv = 1.0 / ((n + 5.0) * n)
    for c in range(4):
        a = quads[:, c]
        b = quads[:, (c + 1) % 4]
        d = quads[:, (c + 3) % 4]
        diag = quads[:, (c + 2) % 4]
        # E_sum entries are halved (counted once per adjacent quad)
        for col, wgt in ((b, 2.0), (d, 2.0), (diag, 1.0)):
            rows.append(a)
            cols.append(col)
            ws.append(wgt * inv[a])
    rows.append(np.arange(V))
    cols.append(np.arange(V))
    ws.append(n * n * inv)

    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    ws = np.concatenate(ws)

    # crease/corner rows override the interior stencil
    fc = np.full(quads.shape[0], 4, np.int64)
    fo = np.concatenate([[0], np.cumsum(fc)])
    edges, edge_faces, _he = _build_edges(fc, fo, quads.reshape(-1))
    boundary = edge_faces[:, 1] < 0
    sharp = boundary.copy()
    if plan.final_edge_creases is not None and len(plan.final_edge_creases):
        ce = np.asarray(plan.final_edge_creases, np.int64)
        cw = np.asarray(plan.final_edge_crease_weights, np.float32)
        lo = np.minimum(ce[:, 0], ce[:, 1])
        hi = np.maximum(ce[:, 0], ce[:, 1])
        ckey = lo * (1 << 31) + hi
        ekey = edges[:, 0] * (1 << 31) + edges[:, 1]
        pos = np.searchsorted(ekey, ckey)
        ok = pos < ekey.shape[0]
        ok[ok] &= ekey[pos[ok]] == ckey[ok]
        hard = ok & (cw >= 1.0)
        sharp[pos[hard]] = True
    n_sharp = np.bincount(edges[sharp].reshape(-1), minlength=V)
    crease_v = n_sharp == 2
    corner_v = n_sharp >= 3
    corner_v |= (n_faces == 1) & (n_sharp >= 2)
    crease_v &= ~corner_v
    if plan.final_vertex_sharp is not None:
        vs = np.asarray(plan.final_vertex_sharp, np.float32)[:V]
        corner_v |= vs >= 1.0
    special = crease_v | corner_v

    keep = ~special[rows]
    rows, cols, ws = rows[keep], cols[keep], ws[keep]
    se = edges[sharp]
    cr0, cc0, cw0 = [rows], [cols], [ws]
    for a, b in ((se[:, 0], se[:, 1]), (se[:, 1], se[:, 0])):
        m = crease_v[a]
        cr0.append(a[m])
        cc0.append(b[m])
        cw0.append(np.full(m.sum(), 1.0 / 6.0))
    ids = np.arange(V)
    cr0.append(ids[crease_v])
    cc0.append(ids[crease_v])
    cw0.append(np.full(int(crease_v.sum()), 4.0 / 6.0))
    cr0.append(ids[corner_v])
    cc0.append(ids[corner_v])
    cw0.append(np.ones(int(corner_v.sum())))
    return (np.concatenate(cr0), np.concatenate(cc0),
            np.concatenate(cw0).astype(np.float32))


def apply_limit_stencil(stencil, verts):
    """Apply a limit_stencil to numpy vertices, or to a tensor
    (differentiably; the stencil's arrays numpy or tensors)."""
    rows, cols, w = stencil
    if isinstance(verts, np.ndarray):
        out = np.zeros_like(verts)
        np.add.at(out, rows, w[:, None] * verts[cols])
        return out
    return torch.zeros_like(verts).index_add(
        0, _like(rows, verts), _like(w, verts)[:, None]
        * verts.index_select(0, _like(cols, verts)))


def vertex_normals_torch(verts: torch.Tensor, quads):
    """Differentiable area-weighted vertex normals (torch twin of
    tessellate.vertex_normals; the JAX package's vertex_normals_jnp)."""
    q = _like(quads, verts).long()
    p0, p1, p2, p3 = (verts.index_select(0, q[:, k]) for k in range(4))
    n = torch.linalg.cross(p2 - p0, p3 - p1)
    out = torch.zeros_like(verts)
    for k in range(4):
        out = out.index_add(0, q[:, k], n)
    ln = torch.linalg.norm(out, dim=1, keepdim=True)
    return out / ln.clamp_min(1e-20)


def limit_project(plan: SubdivisionPlan, verts: np.ndarray) -> np.ndarray:
    """Push the final subdivided vertices to their LIMIT positions
    (catmullclark_ring.h getLimitVertex :373-400):

      interior:  (n^2 v + 4 sum(E) + sum(F)) / (n (n+5))
      boundary/crease (2 sharp edges): (4 v + b1 + b2) / 6
      corner / hard vertex crease: pinned

    E = edge-adjacent vertices, F = quad-diagonal vertices of the final
    all-quad mesh — fully vectorized scatter sums."""
    quads = plan.final_quads
    V = verts.shape[0]
    E_sum = np.zeros_like(verts)
    F_sum = np.zeros_like(verts)
    n_faces = np.zeros(V, np.int64)

    for c in range(4):
        a = quads[:, c]
        b = quads[:, (c + 1) % 4]
        d = quads[:, (c + 3) % 4]
        diag = quads[:, (c + 2) % 4]
        np.add.at(E_sum, a, verts[b] + verts[d])
        np.add.at(F_sum, a, verts[diag])
        np.add.at(n_faces, a, 1)

    # each interior edge-neighbor was counted twice (once per quad side)
    E_sum *= 0.5
    n = np.maximum(n_faces, 1).astype(np.float32)[:, None]
    limit = (n * n * verts + 4.0 * E_sum + F_sum) / ((n + 5.0) * n)

    # boundary & crease handling: collect sharp edges (boundary edges +
    # surviving infinite creases)
    fc = np.full(quads.shape[0], 4, np.int64)
    fo = np.concatenate([[0], np.cumsum(fc)])
    edges, edge_faces, _he = _build_edges(fc, fo, quads.reshape(-1))
    boundary = edge_faces[:, 1] < 0
    sharp = boundary.copy()
    if plan.final_edge_creases is not None and len(plan.final_edge_creases):
        ce = np.asarray(plan.final_edge_creases, np.int64)
        cw = np.asarray(plan.final_edge_crease_weights, np.float32)
        lo = np.minimum(ce[:, 0], ce[:, 1])
        hi = np.maximum(ce[:, 0], ce[:, 1])
        ckey = lo * (1 << 31) + hi
        ekey = edges[:, 0] * (1 << 31) + edges[:, 1]
        pos = np.searchsorted(ekey, ckey)
        ok = pos < ekey.shape[0]
        ok[ok] &= ekey[pos[ok]] == ckey[ok]
        hard = ok & (cw >= 1.0)
        sharp[pos[hard]] = True

    n_sharp = np.bincount(edges[sharp].reshape(-1), minlength=V)
    crease_v = n_sharp == 2
    corner_v = n_sharp >= 3
    # boundary corners (one incident quad + two sharp edges) are pinned,
    # matching the refinement's corner rule
    corner_v |= (n_faces == 1) & (n_sharp >= 2)
    crease_v &= ~corner_v
    if plan.final_vertex_sharp is not None:
        vs = np.asarray(plan.final_vertex_sharp, np.float32)[:V]
        corner_v |= vs >= 1.0

    if crease_v.any():
        B_sum = np.zeros_like(verts)
        se = edges[sharp]
        np.add.at(B_sum, se[:, 0], verts[se[:, 1]])
        np.add.at(B_sum, se[:, 1], verts[se[:, 0]])
        limit_b = (4.0 * verts + B_sum) / 6.0
        limit = np.where(crease_v[:, None], limit_b, limit)

    limit = np.where(corner_v[:, None], verts, limit)
    return limit.astype(np.float32)
