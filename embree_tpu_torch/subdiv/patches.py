"""Analytic limit-surface patch evaluation with derivatives.

Counterpart of embree_tpu/subdiv/patches.py: the table build is a host
(numpy) copy that gives the same `PatchTable` arrays for the same cage;
the evaluation is torch ops in float32 on the iso vertices' device.

The analog of the reference's patch stack
(kernels/subdiv/bspline_patch.h:503, patch.h:51-78, patch_eval.h,
feature_adaptive_eval.h): rtcInterpolate-style evaluation of the
Catmull-Clark limit surface P(face, u, v) with first AND second
derivatives, exact on regular regions and feature-adaptive elsewhere.

Design (build once per topology, evaluate vectorized in torch ops):

  1. The cage is uniformly refined L_iso levels (subdiv/core.py plans);
     L_iso = 2 + ceil(max finite crease weight), so extraordinary
     vertices are isolated and all semi-sharp creases have decayed —
     only boundaries and infinite creases survive.
  2. Every iso-level quad is classified:
       REGULAR — all 4 corners valence-4 interior or regular-crease /
       boundary vertices: evaluated as a uniform bicubic B-SPLINE patch
       whose 16 control points come from the iso mesh; control points
       across a boundary/infinite crease are MIRRORED (2*edge - inner),
       which reproduces the crease limit curve exactly (the reference's
       border handling in bspline_patch.h).
       IRREGULAR — touches an extraordinary vertex (or a crease
       corner): evaluated by a precomputed FEATURE-ADAPTIVE LADDER
       (feature_adaptive_eval.h semantics): the quad's 2-ring submesh
       is refined rung by rung; each rung stores B-spline stencils for
       the three regular children, and the child at the irregular
       corner recurses. At the depth cap, interior EVs switch to EXACT
       self-similar evaluation: the cap ring's stationary subdivision
       matrix A is raised to the required depth by power-by-squaring
       (the eigen-free form of Stam's exact scheme; reference analog
       gregory_patch.h / patch.h irregular dispatch), so P and both
       derivative orders are exact arbitrarily close to the EV. Crease
       EVs keep the bilinear cap (error ~ 2^-M of the feature scale).
  3. Evaluation maps (face, u, v) through the level provenance that
     tessellate.track_patches records (patch/i/j/rot), gathers control
     points from the iso vertex array, and applies the B-spline bases —
     all torch ops, so it is differentiable w.r.t. cage vertices and
     batch-vectorized.

UV convention: quad faces use (u, v) in [0,1]^2. N-gon faces use
u in [0, n): integer part selects the corner sub-patch (the reference
splits n-gons the same way, patch_eval_grid.h:214-222, with a different
packed encoding).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from .core import (SubdivisionPlan, _build_edges, plan_subdivision,
                   refine_topology)
from .tessellate import track_patches

M_LADDER = 10        # ladder depth cap (error ~ 2^-M of feature scale)
N0_MAX = 96          # padded 2-RING submesh vertex count (valence <= 14)


# --------------------------------------------------------------------------
# B-spline bases
# --------------------------------------------------------------------------

def bspline_basis(t):
    """Uniform cubic B-spline basis (4,) at t in [0,1] + 1st/2nd
    derivative bases (bspline_patch.h's basis functions)."""
    s = 1.0 - t
    b0 = s * s * s / 6.0
    b1 = (3 * t * t * t - 6 * t * t + 4.0) / 6.0
    b2 = (-3 * t * t * t + 3 * t * t + 3 * t + 1.0) / 6.0
    b3 = t * t * t / 6.0
    d0 = -s * s / 2.0
    d1 = (3 * t * t - 4 * t) / 2.0
    d2 = (-3 * t * t + 2 * t + 1.0) / 2.0
    d3 = t * t / 2.0
    g0 = s
    g1 = 3 * t - 2.0
    g2 = -3 * t + 1.0
    g3 = t
    st = lambda *a: torch.stack(a, dim=-1)
    return st(b0, b1, b2, b3), st(d0, d1, d2, d3), st(g0, g1, g2, g3)


# --------------------------------------------------------------------------
# build: classification + control-point extraction on an all-quad mesh
# --------------------------------------------------------------------------

def _quad_adjacency(quads: np.ndarray, V: int):
    """Per-halfedge neighbor (face, pos) and per-vertex incident-face
    sums/counts on an all-quad mesh."""
    F = quads.shape[0]
    fc = np.full(F, 4, np.int64)
    fo = np.arange(F + 1) * 4
    edges, edge_faces, he_edge = _build_edges(fc, fo, quads.reshape(-1))
    he_face = np.repeat(np.arange(F), 4)
    he_pos = np.tile(np.arange(4), F)
    # pair up halfedges by edge id
    order = np.argsort(he_edge, kind="stable")
    cnt = np.bincount(he_edge, minlength=edges.shape[0])
    first = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    opp_face = np.full(4 * F, -1, np.int64)
    opp_pos = np.full(4 * F, -1, np.int64)
    two = cnt == 2
    a = order[first[two]]
    b = order[first[two] + 1]
    opp_face[a] = he_face[b]
    opp_pos[a] = he_pos[b]
    opp_face[b] = he_face[a]
    opp_pos[b] = he_pos[a]
    vf_sum = np.zeros(V, np.int64)
    vf_cnt = np.zeros(V, np.int64)
    for k in range(4):
        np.add.at(vf_sum, quads[:, k], np.arange(F))
        np.add.at(vf_cnt, quads[:, k], 1)
    return (edges, edge_faces, he_edge,
            opp_face.reshape(F, 4), opp_pos.reshape(F, 4), vf_sum, vf_cnt)


def _sharp_edge_mask(plan: SubdivisionPlan, edges: np.ndarray,
                     edge_faces: np.ndarray):
    """Boundary + surviving (>=1 or inf) creases on the final mesh."""
    E = edges.shape[0]
    sharp = edge_faces[:, 1] < 0
    semi = np.zeros(E, np.float32)
    if plan.final_edge_creases is not None and len(plan.final_edge_creases):
        ce = np.asarray(plan.final_edge_creases, np.int64)
        cw = np.asarray(plan.final_edge_crease_weights, np.float32)
        lo = np.minimum(ce[:, 0], ce[:, 1])
        hi = np.maximum(ce[:, 0], ce[:, 1])
        ckey = lo * (1 << 31) + hi
        ekey = edges[:, 0] * (1 << 31) + edges[:, 1]
        pos = np.searchsorted(ekey, ckey)
        ok = pos < E
        ok[ok] &= ekey[pos[ok]] == ckey[ok]
        np.maximum.at(semi, pos[ok], cw[ok])
    sharp = sharp | (semi >= 1.0)
    return sharp, semi


def _classify_corners(quads, V, edges, sharp, vf_cnt, vsharp):
    """Per-vertex: 0 regular-interior, 1 crease/boundary-regular,
    2 irregular."""
    vcount = np.bincount(edges.reshape(-1), minlength=V)
    n_sharp = np.bincount(edges[sharp].reshape(-1), minlength=V)
    vs = np.zeros(V, np.float32) if vsharp is None else \
        np.asarray(vsharp, np.float32)[:V]
    cls = np.full(V, 2, np.int64)
    reg_int = (vcount == 4) & (vf_cnt == 4) & (n_sharp == 0) & (vs <= 0)
    # regular crease: exactly 2 sharp edges; boundary form (3 edges /
    # 2 faces) or interior-crease form (4 edges / 4 faces)
    reg_crease = (n_sharp == 2) & (vs <= 0) & (
        ((vcount == 3) & (vf_cnt == 2)) | ((vcount == 4) & (vf_cnt == 4)))
    cls[reg_crease] = 1
    cls[reg_int] = 0
    return cls


@dataclasses.dataclass
class Ladder:
    """Feature-adaptive ladder of one irregular iso quad."""

    ring_ids: np.ndarray     # (N0_MAX,) iso vertex ids (pad -1)
    r_corner: int            # irregular corner of the iso quad
    # per rung: child c stencils (c walks the OTHER three quadrants);
    # stored dense: (M, 4, 16, N0_MAX); slot for the irregular quadrant
    # unused except at the cap rung
    child_w: np.ndarray
    child_ok: np.ndarray     # (M, 4) bool: child has a B-spline stencil
    child_bw: np.ndarray     # (M, 4, 4, N0_MAX) bilinear corner fallbacks
    cap_w: np.ndarray        # (4, N0_MAX) bilinear corners at the cap
    # exact cap (interior EVs): the cap submesh is SELF-SIMILAR, so the
    # limit surface inside the cap is evaluated exactly at any depth via
    # powers of the stationary ring->ring subdivision matrix A (the
    # eigen-free form of Stam's exact evaluation; reference analog:
    # gregory_patch.h's exact EV handling in patch.h's type dispatch).
    stam_valid: bool = False
    stam_K: int = 0                         # live ring size
    stam_Cw: Optional[np.ndarray] = None    # (N0_MAX, N0_MAX) cap ring wts
    stam_Apow: Optional[np.ndarray] = None  # (5, N0, N0) A^(2^i)
    stam_M: Optional[np.ndarray] = None     # (4, 16, N0) child cp stencils


@dataclasses.dataclass
class PatchTable:
    plan: SubdivisionPlan           # iso plan (topology only)
    iso_levels: int
    # query mapping (from tessellate.track_patches on the iso plan)
    patch_of_face: np.ndarray       # (F,) first patch id
    face_is_quad: np.ndarray        # (F,)
    qid_grid: np.ndarray            # (P, g+1.., ) iso quad id per cell
    patch_depth: np.ndarray         # (P,) cells = 2^depth per side
    quad_rot: np.ndarray            # (Q,) rot of iso quad vs patch space
    # regular patches
    kind: np.ndarray                # (Q,) 0=regular 1=ladder
    cp_idx: np.ndarray              # (Q, 16, 4) iso vertex ids
    cp_w: np.ndarray                # (Q, 16, 4) weights
    ladder_of_quad: np.ndarray      # (Q,) index into ladders or -1
    ladders: list                   # list[Ladder]
    # packed ladder arrays for vectorized eval
    lad_ring: Optional[np.ndarray] = None     # (L, N0_MAX)
    lad_r: Optional[np.ndarray] = None        # (L,)
    lad_child_w: Optional[np.ndarray] = None  # (L, M, 4, 16, N0_MAX)
    lad_child_ok: Optional[np.ndarray] = None
    lad_child_bw: Optional[np.ndarray] = None
    lad_cap_w: Optional[np.ndarray] = None    # (L, 4, N0_MAX)
    # packed exact-cap arrays (zeros where lad_stam_ok is False)
    lad_stam_ok: Optional[np.ndarray] = None    # (L,) bool
    lad_stam_Cw: Optional[np.ndarray] = None    # (L, N0, N0)
    lad_stam_Apow: Optional[np.ndarray] = None  # (L, 5, N0, N0)
    lad_stam_M: Optional[np.ndarray] = None     # (L, 4, 16, N0)
    # the arrays above as tensors, one PatchTensors a device, made by
    # eval_patch_table at its first call there
    tensors: dict = dataclasses.field(default_factory=dict, repr=False,
                                      compare=False)

    @property
    def num_iso_vertices(self):
        return self.plan.num_final_vertices


def _extract_regular_cps(quads, V, adj, sharp_edge_of_he, cls):
    """(Q,16,4) idx + weights for every quad (valid where regular).

    CP grid CP[i][j]: i along s (corner0->corner1), j along t
    (corner0->corner3); quad corners at CP[1][1],[2][1],[2][2],[1][2].
    """
    (edges, edge_faces, he_edge, opp_face, opp_pos, vf_sum, vf_cnt) = adj
    Q = quads.shape[0]
    idx = np.zeros((Q, 16, 4), np.int64)
    w = np.zeros((Q, 16, 4), np.float32)

    def put(slot, vid):
        idx[:, slot, 0] = vid
        w[:, slot, 0] = 1.0

    S = {(i, j): i * 4 + j for i in range(4) for j in range(4)}
    w0, w1, w2, w3 = quads[:, 0], quads[:, 1], quads[:, 2], quads[:, 3]
    put(S[1, 1], w0)
    put(S[2, 1], w1)
    put(S[2, 2], w2)
    put(S[1, 2], w3)

    def outer(k, corner_v):
        """Across quad edge k: the neighbor vertex adjacent to corner_v."""
        n = opp_face[:, k]
        nsafe = np.maximum(n, 0)
        nv = quads[nsafe]                       # (Q,4)
        pa = np.argmax(nv == corner_v[:, None], axis=1)
        cand1 = nv[np.arange(Q), (pa + 1) % 4]
        cand2 = nv[np.arange(Q), (pa + 3) % 4]
        # the adjacent vertex that is not this edge's other endpoint
        partner_a = quads[:, k]
        partner_b = quads[:, (k + 1) % 4]
        other = np.where((cand1 != partner_a) & (cand1 != partner_b),
                         cand1, cand2)
        return np.where(n >= 0, other, 0), n >= 0

    # edge rows: (slotA from cornerA, slotB from cornerB) per quad edge
    edge_slots = [
        (0, w0, w1, S[1, 0], S[2, 0]),   # e01 -> t<0 row
        (1, w1, w2, S[3, 1], S[3, 2]),   # e12 -> s>1 col
        (2, w2, w3, S[2, 3], S[1, 3]),   # e23 -> t>1 row
        (3, w3, w0, S[0, 2], S[0, 1]),   # e30 -> s<0 col
    ]
    have = {}
    for k, ca, cb, sa, sb in edge_slots:
        va, oka = outer(k, ca)
        vb, okb = outer(k, cb)
        for slot, vv, ok in ((sa, va, oka), (sb, vb, okb)):
            idx[:, slot, 0] = vv
            w[:, slot, 0] = np.where(ok, 1.0, 0.0)
            have[slot] = ok

    # diagonal corners via incident-face sums (valence-4 interior only)
    def diag(corner_v, ka, kb, slot):
        qa = opp_face[:, ka]
        qb = opp_face[:, kb]
        ok = (qa >= 0) & (qb >= 0) & (vf_cnt[corner_v] == 4)
        qd = vf_sum[corner_v] - np.arange(Q) - np.maximum(qa, 0) \
            - np.maximum(qb, 0)
        ok &= (qd >= 0) & (qd < Q)
        qds = np.clip(qd, 0, Q - 1)
        nv = quads[qds]
        pa = np.argmax(nv == corner_v[:, None], axis=1)
        dv = nv[np.arange(Q), (pa + 2) % 4]
        idx[:, slot, 0] = np.where(ok, dv, 0)
        w[:, slot, 0] = np.where(ok, 1.0, 0.0)
        have[slot] = ok

    diag(w0, 0, 3, S[0, 0])
    diag(w1, 1, 0, S[3, 0])
    diag(w2, 2, 1, S[3, 3])
    diag(w3, 3, 2, S[0, 3])

    # mirror pass: sharp quad edges replace the across rows/cols
    he_sharp = sharp_edge_of_he.reshape(Q, 4)

    def combo(slot):
        return idx[:, slot, :], w[:, slot, :]

    def mirror(slot_out, slot_a, slot_b, cond):
        """CP[out] = 2*CP[a] - CP[b] where cond. Sources must carry at
        most 2 packed terms (plain CPs or edge mirrors), so the result
        packs into the 4 slots exactly."""
        ia, wa = combo(slot_a)
        ib, wb = combo(slot_b)
        # sources carry their terms at positions (0, 2): plain CPs are
        # [x,0,0,0]; first-level mirrors are [2a,0,-b,0]
        sel = [0, 2]
        mi = np.concatenate([ia[:, sel], ib[:, sel]], axis=1)
        mw = np.concatenate([2.0 * wa[:, sel], -wb[:, sel]], axis=1)
        c = cond[:, None]
        idx[:, slot_out, :] = np.where(c, mi, idx[:, slot_out, :])
        w[:, slot_out, :] = np.where(c, mw, w[:, slot_out, :])

    s01, s12 = he_sharp[:, 0], he_sharp[:, 1]
    s23, s30 = he_sharp[:, 2], he_sharp[:, 3]
    # edge rows first
    mirror(S[1, 0], S[1, 1], S[1, 2], s01)
    mirror(S[2, 0], S[2, 1], S[2, 2], s01)
    mirror(S[3, 1], S[2, 1], S[1, 1], s12)
    mirror(S[3, 2], S[2, 2], S[1, 2], s12)
    mirror(S[2, 3], S[2, 2], S[2, 1], s23)
    mirror(S[1, 3], S[1, 2], S[1, 1], s23)
    mirror(S[0, 1], S[1, 1], S[2, 1], s30)
    mirror(S[0, 2], S[1, 2], S[2, 2], s30)
    # corners: prefer mirroring across the sharp direction(s)
    mirror(S[0, 0], S[0, 1], S[0, 2], s01 & ~s30)
    mirror(S[0, 0], S[1, 0], S[2, 0], s30 & ~s01)
    mirror(S[0, 0], S[1, 0], S[2, 0], s30 & s01)
    mirror(S[3, 0], S[3, 1], S[3, 2], s01 & ~s12)
    mirror(S[3, 0], S[2, 0], S[1, 0], s12 & ~s01)
    mirror(S[3, 0], S[2, 0], S[1, 0], s12 & s01)
    mirror(S[3, 3], S[3, 2], S[3, 1], s23 & ~s12)
    mirror(S[3, 3], S[2, 3], S[1, 3], s12 & ~s23)
    mirror(S[3, 3], S[2, 3], S[1, 3], s12 & s23)
    mirror(S[0, 3], S[0, 2], S[0, 1], s23 & ~s30)
    mirror(S[0, 3], S[1, 3], S[2, 3], s30 & ~s23)
    mirror(S[0, 3], S[1, 3], S[2, 3], s30 & s23)
    return idx, w, have


def _mesh_tables(quads, V, crease_pairs, crease_w, vsharp):
    """Adjacency + sharpness + corner classification of a quad mesh."""
    adj = _quad_adjacency(quads, V)
    edges, edge_faces, he_edge = adj[0], adj[1], adj[2]
    E = edges.shape[0]
    sharp = edge_faces[:, 1] < 0
    if crease_pairs is not None and len(crease_pairs):
        ce = np.asarray(crease_pairs, np.int64).reshape(-1, 2)
        cw = np.asarray(crease_w, np.float32).reshape(-1)
        lo = np.minimum(ce[:, 0], ce[:, 1])
        hi = np.maximum(ce[:, 0], ce[:, 1])
        ckey = lo * (1 << 31) + hi
        ekey = edges[:, 0] * (1 << 31) + edges[:, 1]
        pos = np.searchsorted(ekey, ckey)
        ok = pos < E
        ok[ok] &= ekey[pos[ok]] == ckey[ok]
        hard = ok & (np.nan_to_num(cw, posinf=1e9) >= 1.0)
        sharp[pos[hard]] = True
    cls = _classify_corners(quads, V, edges, sharp, adj[6], vsharp)
    sharp_he = sharp[he_edge]
    return adj, sharp, sharp_he, cls


def _corner_maps():
    """(s,t) -> child-local (s',t') affine maps per corner quadrant c and
    their jacobians (child v0 sits at parent corner c)."""
    # c0: (2s, 2t); c1: (2t, 2(1-s)); c2: (2(1-s), 2(1-t)); c3: (2(1-t), 2s)
    A = np.array([[[2, 0], [0, 2]],
                  [[0, 2], [-2, 0]],
                  [[-2, 0], [0, -2]],
                  [[0, -2], [2, 0]]], np.float32)   # d(s',t')/d(s,t)
    b = np.array([[0, 0], [0, 2], [2, 2], [2, 0]], np.float32)
    return A, b


_CMAP_A, _CMAP_B = _corner_maps()


def _refine_submesh(quads, V, crease_pairs, crease_w, vsharp):
    """One crease-aware refinement of an all-quad submesh; returns
    (stencil, new_quads, newV, new_crease_pairs, new_crease_w,
    new_vsharp, S) with S the dense (newV, V) refinement matrix."""
    fc = np.full(quads.shape[0], 4, np.int64)
    st = refine_topology(fc, quads.reshape(-1), V,
                         edge_sharp=crease_w, edge_sharp_edges=crease_pairs,
                         vertex_sharp=vsharp)
    newV = st.num_out_vertices
    S = np.zeros((newV, V), np.float32)
    np.add.at(S, (st.f_seg, st.f_idx), st.f_w)
    ep0 = st.F
    for k in range(2):
        np.add.at(S, (ep0 + np.arange(st.E), st.e_vidx[:, k]),
                  st.e_vw[:, k])
        # edge rows also reference face points (rows of S via f rows)
        S[ep0:ep0 + st.E] += st.e_fw[:, k:k + 1] * S[st.e_fidx[:, k]]
    vp0 = st.F + st.E
    S[vp0 + np.arange(st.V), np.arange(st.V)] += st.v_self_w
    np.add.at(S, (vp0 + st.vn_seg, st.vn_idx), st.vn_w)
    Sv = np.zeros((st.V, V), np.float32)
    np.add.at(Sv, (st.vf_seg,), st.vf_w[:, None] * S[st.vf_idx])
    S[vp0:vp0 + st.V] += Sv
    # child creases (plan_subdivision's propagation)
    dec = st.next_edge_sharp
    keep = dec > 0
    if keep.any():
        ids = np.nonzero(keep)[0]
        c0 = np.stack([vp0 + st.e_vidx[ids, 0], ep0 + ids], 1)
        c1 = np.stack([vp0 + st.e_vidx[ids, 1], ep0 + ids], 1)
        ncp = np.concatenate([c0, c1])
        ncw = np.concatenate([dec[ids], dec[ids]])
    else:
        ncp, ncw = None, None
    return st, st.out_quads, newV, ncp, ncw, st.next_vertex_sharp, S


def _ring2_faces(quads, center_face):
    """2-RING face set around a quad: faces touching any vertex of the
    faces that touch the quad's vertices. The 2-ring (not 1-ring!) is
    required for exact rung stencils: a submesh's outer vertices have
    incomplete face sets, so their refined vertex points use boundary
    rules; with a 2-ring those contaminated values stay outside every
    stencil the ladder reads (child-patch CPs and the descended ring
    live within one cell of the center, whose rules are complete)."""
    qv = quads[center_face]
    m1 = np.isin(quads, qv).any(axis=1)
    v1 = np.unique(quads[m1])
    m2 = np.isin(quads, v1).any(axis=1)
    faces = np.nonzero(m2)[0]
    return np.concatenate([[center_face], faces[faces != center_face]])


def _build_ladder(iso_quads, V_iso, q: int, r: int, crease_pairs, crease_w,
                  vsharp, M: int = M_LADDER) -> Ladder:
    """Feature-adaptive ladder for iso quad q with irregular corner r."""
    # 2-ring submesh of q (see _ring2_faces); extreme valences fall back
    # to the 1-ring (approximate, pre-r4 behavior) to bound table width
    faces = _ring2_faces(iso_quads, q)
    if np.unique(iso_quads[faces]).shape[0] > N0_MAX:
        qv = iso_quads[q]
        m1 = np.isin(iso_quads, qv).any(axis=1)
        f1 = np.nonzero(m1)[0]
        faces = np.concatenate([[q], f1[f1 != q]])
    sub = iso_quads[faces]
    vids, inv = np.unique(sub.reshape(-1), return_inverse=True)
    squads = inv.reshape(-1, 4)
    n0 = vids.shape[0]
    ring_ids = np.full(N0_MAX, -1, np.int64)
    ring_ids[:n0] = vids
    lut = {v: i for i, v in enumerate(vids)}

    def remap_creases(cp, cw):
        if cp is None or not len(cp):
            return None, None
        out_p, out_w = [], []
        for (a, b), wgt in zip(np.asarray(cp).reshape(-1, 2),
                               np.asarray(cw).reshape(-1)):
            if a in lut and b in lut:
                out_p.append((lut[a], lut[b]))
                out_w.append(wgt)
        if not out_p:
            return None, None
        return np.asarray(out_p, np.int64), np.asarray(out_w, np.float32)

    cp_pairs, cp_w = remap_creases(crease_pairs, crease_w)
    vs = None if vsharp is None else np.asarray(vsharp, np.float32)[vids]

    W = np.zeros((n0, N0_MAX), np.float32)
    W[np.arange(n0), np.arange(n0)] = 1.0
    quads_k, V_k = squads, n0
    child_w = np.zeros((M, 4, 16, N0_MAX), np.float32)
    child_ok = np.zeros((M, 4), bool)
    child_bw = np.zeros((M, 4, 4, N0_MAX), np.float32)
    r_k = r

    def rung(quads_k, V_k, cp_pairs, cp_w, vs, W, r_k):
        """One ladder rung: refine, child stencils, descend. Returns
        (cw (4,16,Ncol), cok, cbw, new state tuple, any_sharp)."""
        st, new_quads, newV, cp_pairs, cp_w, vs, S = _refine_submesh(
            quads_k, V_k, cp_pairs, cp_w, vs)
        Wn = S @ W
        # center = face 0 -> children are quads 0..3 (corner order)
        adj, sharp, sharp_he, cls = _mesh_tables(
            new_quads, newV, cp_pairs, cp_w, vs)
        cpi, cpw, _have = _extract_regular_cps(new_quads, newV, adj,
                                               sharp_he, cls)
        cw = np.zeros((4, 16, W.shape[1]), np.float32)
        cok = np.zeros(4, bool)
        cbw = np.zeros((4, 4, W.shape[1]), np.float32)
        for c in range(4):
            cbw[c] = Wn[new_quads[c]]
            if c == r_k:
                continue
            quad_cls = cls[new_quads[c]]
            if (quad_cls == 2).any():
                continue   # unexpected extra irregularity: cap fallback
            wmat = np.zeros((16, newV), np.float32)
            np.add.at(wmat, (np.repeat(np.arange(16), 4),
                             cpi[c].reshape(-1)), cpw[c].reshape(-1))
            cw[c] = wmat @ Wn
            cok[c] = True
        # descend into the irregular child: re-extract its 2-ring
        faces = _ring2_faces(new_quads, r_k)
        sub = new_quads[faces]
        vids2, inv2 = np.unique(sub.reshape(-1), return_inverse=True)
        nquads_k = inv2.reshape(-1, 4)
        nV_k = vids2.shape[0]
        nW = Wn[vids2]
        lut2 = {v: i for i, v in enumerate(vids2)}

        def remap2(cp, cwt):
            if cp is None:
                return None, None
            out_p, out_w = [], []
            for (a, b), wgt in zip(cp, cwt):
                if a in lut2 and b in lut2:
                    out_p.append((lut2[a], lut2[b]))
                    out_w.append(wgt)
            if not out_p:
                return None, None
            return np.asarray(out_p, np.int64), np.asarray(out_w, np.float32)

        ncp_pairs, ncp_w = remap2(cp_pairs, cp_w)
        nvs = vs[vids2] if vs is not None else None
        return (cw, cok, cbw,
                (nquads_k, nV_k, ncp_pairs, ncp_w, nvs, nW),
                bool(sharp.any()))

    for k in range(M):
        cw, cok, cbw, stt, _sh = rung(quads_k, V_k, cp_pairs, cp_w, vs,
                                      W, r_k)
        child_w[k], child_ok[k], child_bw[k] = cw, cok, cbw
        quads_k, V_k, cp_pairs, cp_w, vs, W = stt
        r_k = 0   # the EV is corner 0 of the new center from here on

    cap_w = W[quads_k[0]]    # (4, N0_MAX) center corners at the cap

    # ---- exact self-similar cap (interior EVs) --------------------------
    # Probe the cap submesh with identity weights: one rung gives the
    # ring->ring matrix A and the 3 regular child stencils M_c in the
    # CAP ring basis; a second rung must reproduce A (the submesh and the
    # np.unique ordering are stationary) or we keep the bilinear cap.
    stam_valid = False
    stam_Cw = stam_Apow = stam_M = None
    stam_K = V_k
    # r5: the cap also covers CREASE-ring EVs (VERDICT r4 #7) — infinite
    # crease rules are stationary too (catmullclark_ring.h crease rules
    # don't decay), so the identity probe runs WITH the surviving crease
    # data and the guard below additionally requires the crease STATE
    # (topology + crease sets) to reproduce itself between rungs, which
    # makes A^k exact by induction. Semi-sharp creases decay per level
    # (not stationary) and correctly fail the state check — but those
    # are already gone at the cap (iso_levels absorbs finite weights).
    if V_k <= N0_MAX:
        Wid = np.zeros((V_k, N0_MAX), np.float32)
        Wid[np.arange(V_k), np.arange(V_k)] = 1.0
        # NOTE: the 1-ring submesh always has an ARTIFICIAL boundary
        # (outer edges are one-sided), so rung() reports sharp edges;
        # they are two rings away from every center-child stencil and
        # from the child ring, so they cannot leak into A or M_c. The
        # stationarity check A1 == A2 below is the actual guard.
        cw1, cok1, _cbw1, st1, _sh1 = rung(quads_k, V_k, cp_pairs, cp_w,
                                           vs, Wid, 0)
        q2, V2, cp2, cw2_, vs2, A1 = st1
        if V2 == V_k and cok1[1] and cok1[2] and cok1[3]:
            Wid2 = np.zeros((V2, N0_MAX), np.float32)
            Wid2[np.arange(V2), np.arange(V2)] = 1.0
            _cw2, cok2, _cbw2, st2, _sh2 = rung(q2, V2, cp2, cw2_, vs2,
                                                Wid2, 0)
            A2 = st2[5]

            def _crease_state_eq():
                """Induction guard: the rung must reproduce its own
                crease state (same quads, crease pairs/weights, vertex
                sharpness) so every deeper rung applies the SAME map."""
                if not np.array_equal(np.asarray(q2),
                                      np.asarray(st2[0])):
                    return False
                a_p, a_w = cp2, cw2_
                b_p, b_w = st2[2], st2[3]
                if (a_p is None) != (b_p is None):
                    return False
                if a_p is not None:
                    ka = sorted(zip(map(tuple, np.sort(a_p, 1).tolist()),
                                    a_w.tolist()))
                    kb = sorted(zip(map(tuple, np.sort(b_p, 1).tolist()),
                                    b_w.tolist()))
                    if len(ka) != len(kb):
                        return False
                    for (pa, wa), (pb, wb) in zip(ka, kb):
                        if pa != pb or not np.isclose(wa, wb):
                            return False
                va = vs2 if vs2 is not None else None
                vb = st2[4] if st2[4] is not None else None
                if (va is None) != (vb is None):
                    return False
                if va is not None and not np.allclose(va, vb):
                    return False
                return True

            if (st2[1] == V_k
                    and np.allclose(A1[:, :V_k], A2[:, :V_k], atol=1e-5)
                    and _crease_state_eq()):
                A = np.zeros((N0_MAX, N0_MAX), np.float32)
                A[:V_k, :V_k] = A1[:, :V_k]
                stam_Apow = np.zeros((5, N0_MAX, N0_MAX), np.float32)
                Ak = A
                for i in range(5):
                    stam_Apow[i] = Ak
                    Ak = (Ak @ Ak).astype(np.float32)
                stam_M = np.zeros((4, 16, N0_MAX), np.float32)
                stam_M[1:] = cw1[1:]
                stam_Cw = np.zeros((N0_MAX, N0_MAX), np.float32)
                stam_Cw[:V_k] = W
                stam_valid = True

    return Ladder(ring_ids=ring_ids, r_corner=r, child_w=child_w,
                  child_ok=child_ok, child_bw=child_bw, cap_w=cap_w,
                  stam_valid=stam_valid, stam_K=stam_K, stam_Cw=stam_Cw,
                  stam_Apow=stam_Apow, stam_M=stam_M)


# --------------------------------------------------------------------------
# table build
# --------------------------------------------------------------------------

def build_patch_table(face_counts, face_indices, num_vertices,
                      edge_creases=None, edge_crease_weights=None,
                      vertex_creases=None, vertex_crease_weights=None,
                      iso_levels: Optional[int] = None) -> PatchTable:
    face_counts = np.asarray(face_counts, np.int64)
    face_indices = np.asarray(face_indices, np.int64)
    if iso_levels is None:
        max_w = 0.0
        if edge_crease_weights is not None and len(edge_crease_weights):
            fw = np.asarray(edge_crease_weights, np.float32)
            fin = fw[np.isfinite(fw)]
            if fin.size:
                max_w = float(fin.max())
        if vertex_crease_weights is not None and len(vertex_crease_weights):
            fw = np.asarray(vertex_crease_weights, np.float32)
            fin = fw[np.isfinite(fw)]
            if fin.size:
                max_w = max(max_w, float(fin.max()))
        iso_levels = int(np.clip(2 + np.ceil(max_w), 2, 8))

    plan = plan_subdivision(face_counts, face_indices, num_vertices,
                            iso_levels, edge_creases=edge_creases,
                            edge_crease_weights=edge_crease_weights,
                            vertex_creases=vertex_creases,
                            vertex_crease_weights=vertex_crease_weights)
    quads = plan.final_quads
    V = plan.num_final_vertices

    (patch, ci, cj, rot, depth, patch_face, patch_sub, P, is_quad) = \
        track_patches(plan)
    g = 1 << iso_levels
    qid = np.full((P, g, g), -1, np.int64)
    qid[patch, ci, cj] = np.arange(quads.shape[0])
    pdepth = np.zeros(P, np.int64)
    np.maximum.at(pdepth, patch, depth)

    patch_sizes = np.where(is_quad, 1, face_counts)
    pstart = np.zeros(face_counts.shape[0], np.int64)
    pstart[1:] = np.cumsum(patch_sizes)[:-1]

    adj, sharp, sharp_he, cls = _mesh_tables(
        quads, V, plan.final_edge_creases, plan.final_edge_crease_weights,
        plan.final_vertex_sharp)
    cp_idx, cp_w, _have = _extract_regular_cps(quads, V, adj, sharp_he, cls)

    corner_irr = cls[quads] == 2           # (Q, 4)
    kind = corner_irr.any(axis=1).astype(np.int64)
    # regular quads must have every CP slot resolved
    unresolved = (np.abs(cp_w).sum(axis=2) == 0).any(axis=1)
    kind = np.where((kind == 0) & unresolved, 1, kind)

    ladder_of_quad = np.full(quads.shape[0], -1, np.int64)
    ladders = []
    irr = np.nonzero(kind == 1)[0]
    for q in irr:
        r = int(np.argmax(corner_irr[q])) if corner_irr[q].any() else 0
        ladder_of_quad[q] = len(ladders)
        ladders.append(_build_ladder(
            quads, V, int(q), r, plan.final_edge_creases,
            plan.final_edge_crease_weights, plan.final_vertex_sharp))

    pt = PatchTable(plan=plan, iso_levels=iso_levels,
                    patch_of_face=pstart, face_is_quad=is_quad,
                    qid_grid=qid, patch_depth=pdepth, quad_rot=rot,
                    kind=kind, cp_idx=cp_idx, cp_w=cp_w,
                    ladder_of_quad=ladder_of_quad, ladders=ladders)
    if ladders:
        pt.lad_ring = np.stack([l.ring_ids for l in ladders])
        pt.lad_r = np.asarray([l.r_corner for l in ladders], np.int64)
        pt.lad_child_w = np.stack([l.child_w for l in ladders])
        pt.lad_child_ok = np.stack([l.child_ok for l in ladders])
        pt.lad_child_bw = np.stack([l.child_bw for l in ladders])
        pt.lad_cap_w = np.stack([l.cap_w for l in ladders])
        zC = np.zeros((N0_MAX, N0_MAX), np.float32)
        zA = np.zeros((5, N0_MAX, N0_MAX), np.float32)
        zM = np.zeros((4, 16, N0_MAX), np.float32)
        pt.lad_stam_ok = np.asarray([l.stam_valid for l in ladders])
        pt.lad_stam_Cw = np.stack(
            [l.stam_Cw if l.stam_valid else zC for l in ladders])
        pt.lad_stam_Apow = np.stack(
            [l.stam_Apow if l.stam_valid else zA for l in ladders])
        pt.lad_stam_M = np.stack(
            [l.stam_M if l.stam_valid else zM for l in ladders])
    return pt


# --------------------------------------------------------------------------
# evaluation (torch ops, differentiable w.r.t. iso vertices)
# --------------------------------------------------------------------------

_ROT_A = np.array([[[1, 0], [0, 1]],
                   [[0, 1], [-1, 0]],
                   [[-1, 0], [0, -1]],
                   [[0, -1], [1, 0]]], np.float32)
_ROT_B = np.array([[0, 0], [0, 1], [1, 1], [1, 0]], np.float32)



# ladder points evaluated together: bounds the (n, 16, N0_MAX) stencil
# gather of one rung to 400 MB. The evaluation is a few hundred small ops
# a chunk, whose dispatch and not their device time bounds a call on the
# card, so the chunks are large.
LADDER_CHUNK = 1 << 16


class PatchTensors(NamedTuple):
    """The arrays of a PatchTable that evaluation reads, on one device."""

    face_is_quad: torch.Tensor    # (F,) bool
    sub_count: torch.Tensor       # (F,) i64 sub-patches of each face
    patch_of_face: torch.Tensor   # (F,) i64
    patch_depth: torch.Tensor     # (P,) i64
    qid_grid: torch.Tensor        # (P, g, g) i64
    quad_rot: torch.Tensor        # (Q,) i64
    kind: torch.Tensor            # (Q,) i64
    cp_idx: torch.Tensor          # (Q, 16, 4) i64
    cp_w: torch.Tensor            # (Q, 16, 4) f32
    ladder_of_quad: torch.Tensor  # (Q,) i64
    lad: Optional[dict]           # the lad_* arrays, None without ladders
    stam_any: bool                # some ladder has the exact cap
    rot_a: torch.Tensor           # _ROT_A, _ROT_B, _CMAP_A, _CMAP_B
    rot_b: torch.Tensor
    cmap_a: torch.Tensor
    cmap_b: torch.Tensor


_LAD_FIELDS = ("lad_ring", "lad_r", "lad_child_w", "lad_child_ok",
               "lad_child_bw", "lad_cap_w", "lad_stam_ok", "lad_stam_Cw",
               "lad_stam_Apow", "lad_stam_M")


def patch_tensors(pt: PatchTable, device) -> PatchTensors:
    """The tensors of `pt` on `device`, uploaded at the first call there
    and kept in `pt.tensors`."""
    device = torch.device(device)
    got = pt.tensors.get(device)
    if got is not None:
        return got

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    F = pt.face_is_quad.shape[0]
    lad = None
    if pt.lad_child_w is not None:
        lad = {k: up(getattr(pt, k)) for k in _LAD_FIELDS}
    got = PatchTensors(
        face_is_quad=up(pt.face_is_quad),
        sub_count=up(np.bincount(pt.plan.levels[0].quad_parent,
                                 minlength=F).astype(np.int64)),
        patch_of_face=up(pt.patch_of_face), patch_depth=up(pt.patch_depth),
        qid_grid=up(pt.qid_grid), quad_rot=up(pt.quad_rot),
        kind=up(pt.kind), cp_idx=up(pt.cp_idx), cp_w=up(pt.cp_w),
        ladder_of_quad=up(pt.ladder_of_quad), lad=lad,
        stam_any=bool(pt.lad_stam_ok is not None and pt.lad_stam_ok.any()),
        rot_a=up(_ROT_A), rot_b=up(_ROT_B), cmap_a=up(_CMAP_A),
        cmap_b=up(_CMAP_B))
    pt.tensors[device] = got
    return got


def _affine(A, B, s, t):
    """A @ (s, t) + B for (n, 2, 2) maps whose entries are 0 or a power
    of two times a sign, so that every product is exact."""
    return (A[:, 0, 0] * s + A[:, 0, 1] * t + B[:, 0],
            A[:, 1, 0] * s + A[:, 1, 1] * t + B[:, 1])


def _bspline_patch_eval(cp, s, t):
    """cp (n, 16, 3); s, t (n,): returns P, Ps, Pt, Pss, Ptt, Pst."""
    bs, ds, gs = bspline_basis(s)
    bt, dt, gt = bspline_basis(t)
    cp4 = cp.reshape(cp.shape[:-2] + (4, 4, 3))

    def along_t(b):          # sum_j b_j cp[:, i, j]  -> (n, 4, 3)
        return (cp4 * b[:, None, :, None]).sum(-2)

    def along_s(a, x):       # sum_i a_i x[:, i]      -> (n, 3)
        return (a[:, :, None] * x).sum(-2)

    cb, cd, cg = along_t(bt), along_t(dt), along_t(gt)
    return (along_s(bs, cb), along_s(ds, cb), along_s(bs, cd),
            along_s(gs, cb), along_s(bs, cg), along_s(ds, cd))


def _bilinear_eval(cp, s, t):
    """cp (n, 4, 3) corners in local order; returns the 6-tuple."""
    s_ = s[..., None]
    t_ = t[..., None]
    c0, c1, c2, c3 = (cp[..., 0, :], cp[..., 1, :], cp[..., 2, :],
                      cp[..., 3, :])
    P = ((1 - s_) * (1 - t_) * c0 + s_ * (1 - t_) * c1
         + s_ * t_ * c2 + (1 - s_) * t_ * c3)
    Ps = (1 - t_) * (c1 - c0) + t_ * (c2 - c3)
    Pt = (1 - s_) * (c3 - c0) + s_ * (c2 - c1)
    Pst = c2 - c1 - c3 + c0
    z = torch.zeros_like(P)
    return P, Ps, Pt, z, z, Pst


def _chain(o, val, six, A):
    """Transform the o-th output of a child eval through d(child)/d(s,t)
    = A: derivatives compose linearly/quadratically; P passes through."""
    P, Ps, Pt, Pss, Ptt, Pst = six
    a00, a01 = A[..., 0, 0], A[..., 0, 1]
    a10, a11 = A[..., 1, 0], A[..., 1, 1]
    if o == 0:
        return val
    if o == 1:   # d/ds_parent
        return Ps * a00[..., None] + Pt * a10[..., None]
    if o == 2:
        return Ps * a01[..., None] + Pt * a11[..., None]
    if o == 3:
        return (Pss * (a00 * a00)[..., None] + Ptt * (a10 * a10)[..., None]
                + 2.0 * Pst * (a00 * a10)[..., None])
    if o == 4:
        return (Pss * (a01 * a01)[..., None] + Ptt * (a11 * a11)[..., None]
                + 2.0 * Pst * (a01 * a11)[..., None])
    return (Pss * (a00 * a01)[..., None] + Ptt * (a10 * a11)[..., None]
            + Pst * (a00 * a11 + a01 * a10)[..., None])


def _quadrant(s, t):
    """Child quadrant of (s, t) in corner order (c0 at (0, 0))."""
    hi_s, hi_t = s >= 0.5, t >= 0.5
    return torch.where(hi_s & ~hi_t, 1, torch.where(
        hi_s & hi_t, 2, torch.where(~hi_s & hi_t, 3, 0)))


def _ladder_eval(T: PatchTensors, verts_iso, quad, s, t):
    """The six outputs in (s, t) of the ladder quads `quad` at (s, t).

    A point descends rung by rung until its child is regular, then the
    child's B-spline patch answers; a point that is still at the
    irregular corner after the last rung takes the cap (exact where the
    table has it, bilinear otherwise). The JAX package evaluates every
    rung and the cap for every point and selects; here each rung runs
    only the points still descending and the cap only those left, which
    selects the same values."""
    L = T.lad
    n = quad.shape[0]
    dev = verts_iso.device
    lid = T.ladder_of_quad[quad].clamp_min(0)
    rid = L["lad_ring"][lid]
    ring = (verts_iso[rid.clamp_min(0)]
            * (rid >= 0).to(verts_iso.dtype)[..., None])      # (n, N0, 3)
    r0 = L["lad_r"][lid]
    CA, CB = T.cmap_a, T.cmap_b
    acc = [torch.zeros((n, 3), dtype=torch.float32, device=dev)
           for _ in range(6)]
    ls, lt = s.clone(), t.clone()
    lA = torch.eye(2, dtype=torch.float32, device=dev).repeat(n, 1, 1)
    act = torch.arange(n, device=dev)
    for k in range(L["lad_child_w"].shape[1]):
        if act.numel() == 0:
            break
        al = lid[act]
        c = _quadrant(ls[act], lt[act])
        Ac, Bc = CA[c], CB[c]
        n0, n1 = _affine(Ac, Bc, ls[act], lt[act])
        use = c != (r0[act] if k == 0 else 0)
        iu = use.nonzero().squeeze(1)
        if iu.numel():
            sel, lu, cu = act[iu], al[iu], c[iu]
            cpk = L["lad_child_w"][lu, k, cu] @ ring[sel]
            Pk = _bspline_patch_eval(cpk, n0[iu], n1[iu])
            ok = L["lad_child_ok"][lu, k, cu][:, None]
            if not bool(ok.all()):   # a child without a B-spline stencil
                cpb = L["lad_child_bw"][lu, k, cu] @ ring[sel]
                Bk = _bilinear_eval(cpb, n0[iu], n1[iu])
                Pk = tuple(torch.where(ok, p, b) for p, b in zip(Pk, Bk))
            Anew = Ac[iu] @ lA[sel]
            for o in range(6):
                acc[o][sel] = _chain(o, Pk[o], Pk, Anew)
        ik = (~use).nonzero().squeeze(1)
        act = act[ik]
        ls[act] = n0[ik]
        lt[act] = n1[ik]
        lA[act] = Ac[ik] @ lA[act]
    if act.numel() == 0:
        return acc
    # the cap: exact self-similar evaluation where available (interior
    # and stationary crease EVs: power-by-squaring on the ring matrix,
    # the eigen-free Stam form), bilinear otherwise
    l3, rg, cs_, ct_ = lid[act], ring[act], ls[act], lt[act]
    bl = _bilinear_eval(L["lad_cap_w"][l3] @ rg, cs_, ct_)
    if T.stam_any:
        sok = L["lad_stam_ok"][l3][:, None]
        # clamp away from the EV point itself (the surface is C1 but not
        # C2 there)
        cls_ = cs_.clamp_min(2.0 ** -18)
        clt = ct_.clamp_min(2.0 ** -18)
        kdep = torch.floor(-torch.log2(torch.maximum(cls_, clt))).to(
            torch.int32).clamp(0, 30)
        C = L["lad_stam_Cw"][l3] @ rg
        for i in range(5):
            bit = ((kdep >> i) & 1) != 0
            Ci = L["lad_stam_Apow"][l3, i] @ C
            C = torch.where(bit[:, None, None], Ci, C)
        sc = torch.exp2(kdep.to(torch.float32))
        us, ut = cls_ * sc, clt * sc
        c2 = torch.where((us >= 0.5) & (ut < 0.5), 1,
                         torch.where((us >= 0.5) & (ut >= 0.5), 2, 3))
        Ac2, Bc2 = CA[c2], CB[c2]
        m0, m1 = _affine(Ac2, Bc2, us, ut)
        sx = _bspline_patch_eval(L["lad_stam_M"][l3, c2] @ C, m0, m1)
        Asc = Ac2 * sc[:, None, None]
        sx = tuple(_chain(o, sx[o], sx, Asc) for o in range(6))
        bl = tuple(torch.where(sok, a, b) for a, b in zip(sx, bl))
    for o in range(6):
        acc[o][act] = _chain(o, bl[o], bl, lA[act])
    return acc


def eval_patch_table(pt: PatchTable, verts_iso: torch.Tensor, face, u, v):
    """Evaluate the limit surface at (face, u, v) on verts_iso's device.

    verts_iso: (V_iso, 3) f32 tensor, the vertices of the iso-refined
    CONTROL mesh (evaluate_plan(pt.plan, cage), NOT limit-projected — the
    B-spline patches perform the limit projection analytically); face,
    u, v: tensors or arrays of one batch shape.

    Returns dict with P, dPdu, dPdv, ddPdudu, ddPdvdv, ddPdudv, Ng —
    derivatives w.r.t. the face-local uv (rtcInterpolate semantics,
    rtcore_geometry.h:234-338)."""
    dev = verts_iso.device
    T = patch_tensors(pt, dev)
    face = torch.as_tensor(face, device=dev).long()
    u = torch.as_tensor(u, device=dev).to(torch.float32)
    v = torch.as_tensor(v, device=dev).to(torch.float32)
    face, u, v = torch.broadcast_tensors(face, u, v)
    shape = face.shape
    face, u, v = face.reshape(-1), u.reshape(-1), v.reshape(-1)
    N = face.shape[0]

    # n-gon: integer(u) selects the corner sub-patch
    isq = T.face_is_quad[face]
    sub = torch.minimum(torch.floor(u).to(torch.int32).clamp_min(0),
                        (T.sub_count[face] - 1).clamp_min(0).to(torch.int32))
    patch = T.patch_of_face[face] + torch.where(isq, 0, sub)
    pu = torch.where(isq, u, u - sub).clamp(0.0, 1.0)
    pv = v.clamp(0.0, 1.0)
    res = (1 << T.patch_depth[patch]).to(torch.float32)
    eps = 1e-6
    pu = pu.clamp(0.0, 1.0 - eps)
    pv = pv.clamp(0.0, 1.0 - eps)
    fi = pu * res
    fj = pv * res
    ci = torch.floor(fi).to(torch.int32)
    cj = torch.floor(fj).to(torch.int32)
    a = fi - ci
    b = fj - cj
    quad = T.qid_grid[patch, ci.long(), cj.long()].clamp_min(0)
    rot = T.quad_rot[quad]
    RA = T.rot_a[rot]                       # (N, 2, 2)
    s, t = _affine(RA, T.rot_b[rot], a, b)
    J = RA * res[:, None, None]             # d(s,t)/d(pu,pv)
    kind = T.kind[quad]

    raw = [torch.empty((N, 3), dtype=torch.float32, device=dev)
           for _ in range(6)]
    # regular patches
    ir = (kind == 0).nonzero().squeeze(1)
    if ir.numel():
        qr = quad[ir]
        cp = (verts_iso[T.cp_idx[qr].clamp_min(0)]
              * T.cp_w[qr][..., None]).sum(-2)
        for o, val in enumerate(_bspline_patch_eval(cp, s[ir], t[ir])):
            raw[o][ir] = val
    # ladder patches
    il = (kind != 0).nonzero().squeeze(1)
    for ch in il.split(LADDER_CHUNK):
        for o, val in enumerate(_ladder_eval(T, verts_iso, quad[ch], s[ch],
                                             t[ch])):
            raw[o][ch] = val
    P, Ps, Pt_, Pss, Ptt, Pst = raw

    # chain to face-uv through J (affine, so no curvature terms)
    j00, j01 = J[:, 0, 0], J[:, 0, 1]
    j10, j11 = J[:, 1, 0], J[:, 1, 1]
    dPdu = Ps * j00[:, None] + Pt_ * j10[:, None]
    dPdv = Ps * j01[:, None] + Pt_ * j11[:, None]
    dduu = (Pss * (j00 * j00)[:, None] + Ptt * (j10 * j10)[:, None]
            + 2.0 * Pst * (j00 * j10)[:, None])
    ddvv = (Pss * (j01 * j01)[:, None] + Ptt * (j11 * j11)[:, None]
            + 2.0 * Pst * (j01 * j11)[:, None])
    dduv = (Pss * (j00 * j01)[:, None] + Ptt * (j10 * j11)[:, None]
            + Pst * (j00 * j11 + j01 * j10)[:, None])
    ng = torch.linalg.cross(dPdu, dPdv)
    ng = ng / torch.linalg.norm(ng, dim=-1, keepdim=True).clamp_min(1e-20)
    out = {"P": P, "dPdu": dPdu, "dPdv": dPdv, "ddPdudu": dduu,
           "ddPdvdv": ddvv, "ddPdudv": dduv, "Ng": ng}
    return {k: x.reshape(shape + (3,)) for k, x in out.items()}
