"""Uniform tessellation: subdivision plan -> patch grids / triangle soup.

Host (numpy) copy of embree_tpu/subdiv/tessellate.py: the same arrays
for the same mesh, per-edge tessellation levels
(`tessellate_mesh_to_triangles_levels`) included.

The analog of the reference's evalGrid + grid leaves
(subdivpatch1base_eval.cpp:78-160, grid_soa.h): every base face becomes
quad patches (quad face -> 1 patch, n-gon -> n sub-patches, exactly
patch_eval_subdivision's split, patch_eval_grid.h:214-222), and each
patch owns a (g+1)x(g+1) index grid into the subdivided vertex array
(g = 2^L for quad patches, 2^(L-1) for n-gon sub-patches, with the fork's
uniform level L = subdivisionLevel).

Patch-cell provenance is tracked through the refinement levels as
(patch, i, j, rot): each output quad of a level is one cell of its patch
with a local frame rotated rot x 90deg against patch uv space. Rotation
bookkeeping follows from the child-quad construction
[v', e(c,c+1)', f', e(c-1,c)']: the child at corner c has its local u
axis rotated by c quarter-turns (validated by test_subdiv grid tests).

Displacement is applied at MESH level (per unique subdivided vertex,
along the vertex normal), so displaced surfaces are watertight by
construction — no stitching needed (tessellation.h:77 in the reference).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .core import (SubdivisionPlan, evaluate_plan, limit_project,
                   plan_subdivision)


@dataclasses.dataclass
class PatchGrids:
    """Per-patch vertex-index grids over the final subdivided mesh."""

    grids: np.ndarray        # (P, g+1, g+1) i64 vertex ids
    patch_face: np.ndarray   # (P,) base face id
    patch_sub: np.ndarray    # (P,) sub-patch index within the face (0 for quads)
    grid_res: int            # g cells per side
    num_vertices: int


def _rot_corner(rot: np.ndarray, corner: np.ndarray) -> np.ndarray:
    """Local corner index -> patch-space corner index under rot."""
    return (corner + rot) % 4


_CORNER_DIJ = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.int64)


def track_patches(plan: SubdivisionPlan):
    """Walk the levels assigning (patch, i, j, rot) to every quad.

    Returns (PatchGrids-builder inputs): per-final-quad patch/i/j/rot and
    the patch table.
    """
    lv0 = plan.levels[0]
    counts = plan.base_face_counts  # NOTE: these are the LAST level's...
    # base counts come from the plan's first level
    counts0 = np.zeros(lv0.F, np.int64)
    np.add.at(counts0, lv0.quad_parent, 1)  # face_counts of base mesh

    # patches: quads -> 1 patch; n-gons -> one per corner
    is_quad = counts0 == 4
    patch_of_face_start = np.zeros(lv0.F, np.int64)
    patch_sizes = np.where(is_quad, 1, counts0)
    patch_of_face_start[1:] = np.cumsum(patch_sizes)[:-1]
    P = int(patch_sizes.sum())
    patch_face = np.repeat(np.arange(lv0.F), patch_sizes)
    patch_sub = np.arange(P) - patch_of_face_start[patch_face]

    # level-1 quads: one per corner of each base face
    q_face = lv0.quad_parent
    q_corner = lv0.quad_corner
    quad_is_quadface = is_quad[q_face]
    patch = np.where(quad_is_quadface,
                     patch_of_face_start[q_face],
                     patch_of_face_start[q_face] + q_corner)
    # quad base face: corner c covers quadrant c (in patch space), local
    # frame rotated by c quarter turns; n-gon: each corner quad IS the
    # whole sub-patch, rot 0
    di = _CORNER_DIJ[q_corner % 4][:, 0]
    dj = _CORNER_DIJ[q_corner % 4][:, 1]
    i = np.where(quad_is_quadface, di, 0)
    j = np.where(quad_is_quadface, dj, 0)
    rot = np.where(quad_is_quadface, q_corner % 4, 0)
    depth = np.where(quad_is_quadface, 1, 0)  # cells subdivided so far

    # subsequent levels: child at corner c of quad (p,i,j,rot):
    #   rot' = (rot + c) % 4
    #   local quadrant c -> patch offset = rotate(CORNER_DIJ[c], rot)
    for lv in plan.levels[1:]:
        qp = lv.quad_parent
        qc = lv.quad_corner
        pi = patch[qp]
        # rotate local corner by parent rot to get patch-space quadrant
        pc = (qc + rot[qp]) % 4
        ddi = _CORNER_DIJ[pc][:, 0]
        ddj = _CORNER_DIJ[pc][:, 1]
        i = i[qp] * 2 + ddi
        j = j[qp] * 2 + ddj
        rot = (rot[qp] + qc) % 4
        depth = depth[qp] + 1
        patch = pi

    return patch, i, j, rot, depth, patch_face, patch_sub, P, is_quad


def build_patch_grids(plan: SubdivisionPlan) -> PatchGrids:
    """Assemble per-patch (g+1)^2 vertex-index grids (quad-face patches;
    n-gon sub-patches are half resolution and stored in the same array
    with their upper-left (g/2+1)^2 corner used)."""
    patch, ci, cj, rot, depth, patch_face, patch_sub, P, is_quad = \
        track_patches(plan)
    L = len(plan.levels)
    quads = plan.levels[-1].out_quads
    g = 1 << L                       # cells per side for quad-face patches
    grids = np.full((P, g + 1, g + 1), -1, np.int64)

    # each final quad writes its 4 corner vertices at patch-space corners
    # local corner k sits at patch cell corner (ci,cj) + rotate(DIJ[k], rot)
    for k in range(4):
        pk = (k + rot) % 4
        di = _CORNER_DIJ[pk][:, 0]
        dj = _CORNER_DIJ[pk][:, 1]
        grids[patch, ci + di, cj + dj] = quads[:, k]

    return PatchGrids(grids=grids, patch_face=patch_face,
                      patch_sub=patch_sub, grid_res=g,
                      num_vertices=plan.num_final_vertices)


def vertex_normals(verts: np.ndarray, quads: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals of the quad mesh (numpy)."""
    p0 = verts[quads[:, 0]]
    p1 = verts[quads[:, 1]]
    p2 = verts[quads[:, 2]]
    p3 = verts[quads[:, 3]]
    n = np.cross(p2 - p0, p3 - p1)  # quad normal via diagonals
    out = np.zeros_like(verts)
    for k in range(4):
        np.add.at(out, quads[:, k], n)
    ln = np.linalg.norm(out, axis=1, keepdims=True)
    return out / np.maximum(ln, 1e-20)


def tessellate_mesh_to_triangles(mesh, subdivision_level: int,
                                 with_uv: bool = False):
    """Scene.commit entry: SubdivMesh -> (v0, v1, v2, prim_id) triangle
    soup with displacement applied (eager path, the stand-in until the
    compressed cBVH accel consumes the patch grids directly).

    with_uv=True additionally returns (T, 3, 2) PATCH-space uv corners
    per triangle so hits can report reference-exact subdiv (u, v) —
    ray.u/v on GridSOA leaves are patch coordinates
    (grid_soa_intersector1.h:60-117), not micro-triangle barycentrics."""
    from .cache import global_cache, plan_nbytes, topology_key
    L = max(int(subdivision_level), 1)
    nv = int(np.asarray(mesh.vertices).shape[0])
    key = topology_key(mesh.face_counts, mesh.face_indices, nv, L,
                       mesh.edge_creases, mesh.edge_crease_weights,
                       mesh.vertex_creases, mesh.vertex_crease_weights)
    plan = global_cache().get_or_build(
        ("plan", key),
        lambda: plan_subdivision(
            mesh.face_counts, mesh.face_indices, nv, L,
            edge_creases=mesh.edge_creases,
            edge_crease_weights=mesh.edge_crease_weights,
            vertex_creases=mesh.vertex_creases,
            vertex_crease_weights=mesh.vertex_crease_weights),
        plan_nbytes)
    verts = evaluate_plan(plan, np.asarray(mesh.vertices, np.float32))
    verts = limit_project(plan, verts)  # push to the limit surface
    quads = plan.final_quads

    if mesh.displacement is not None:
        normals = vertex_normals(verts, quads)
        verts = np.asarray(
            mesh.displacement(verts, normals, None, None), np.float32)

    # prim id = base face id, tracked through the levels
    face_of_quad = plan.levels[0].quad_parent
    for lv in plan.levels[1:]:
        face_of_quad = face_of_quad[lv.quad_parent]

    p0 = verts[quads[:, 0]]
    p1 = verts[quads[:, 1]]
    p2 = verts[quads[:, 2]]
    p3 = verts[quads[:, 3]]
    v0 = np.concatenate([p0, p2])
    v1 = np.concatenate([p1, p3])
    v2 = np.concatenate([p3, p1])
    prim = np.concatenate([face_of_quad, face_of_quad]).astype(np.int64)
    out = (v0.astype(np.float32), v1.astype(np.float32),
           v2.astype(np.float32), prim)
    if not with_uv:
        return out

    # per-quad patch-space corner uvs from the (patch, i, j, rot) track:
    # quad corner k sits at patch grid cell corner (i,j) + DIJ[(k+rot)%4],
    # at scale 1/2^depth (matches build_patch_grids' vertex placement)
    patch, ci, cj, rot, depth, _pf, _ps, _P, _isq = track_patches(plan)
    g = (1 << depth).astype(np.float32)
    cuv = np.empty((quads.shape[0], 4, 2), np.float32)
    for k in range(4):
        pk = (k + rot) % 4
        cuv[:, k, 0] = (ci + _CORNER_DIJ[pk][:, 0]) / g
        cuv[:, k, 1] = (cj + _CORNER_DIJ[pk][:, 1]) / g
    # triangle split mirrors the vertex split: (q0,q1,q3) and (q2,q3,q1)
    uv3 = np.concatenate([cuv[:, [0, 1, 3]], cuv[:, [2, 3, 1]]])
    return out + (uv3,)


def tessellate_mesh_to_triangles_levels(mesh, edge_levels,
                                        max_level: int = 6,
                                        with_uv: bool = False):
    """Per-edge tessellation rates + crack-free stitching — the
    RTC_BUFFER_TYPE_LEVEL path (rtcore_geometry.h LEVEL buffer;
    tessellation.h:77 stitchUVGrid semantics).

    Formulation: refine uniformly to the power-of-two level
    covering the LARGEST requested rate, then per-face SUBSAMPLE the
    shared fine grid at the face's own rate, and per-edge SNAP boundary
    samples to the edge's (coarser) rate. Because every sample is an
    index into the SHARED refined-vertex array — and two faces index the
    same refined vertices along their common edge — stitched borders are
    watertight EXACTLY (vertex-id equality), stronger than the
    reference's float-uv snapping. Coarse-rate boundary rows simply
    repeat vertex ids, yielding harmless degenerate triangles exactly
    like stitchUVGrid's repeated uv samples.

    edge_levels: per face-corner float rate for edge (v_k, v_{k+1}), the
    LEVEL buffer layout. Quad faces get full per-edge treatment; n-gon
    faces use their max corner rate uniformly (no inter-sub-patch
    stitching yet). Rates clamp to [1, 2**max_level] powers of two.
    """
    from .cache import global_cache, plan_nbytes, topology_key

    levels = np.maximum(np.asarray(edge_levels, np.float32), 1.0)
    # power-of-two quantization (rates must nest for exact index math)
    lg = np.clip(np.ceil(np.log2(levels)), 0, max_level).astype(np.int64)
    L = max(1, int(lg.max()))

    nv = int(np.asarray(mesh.vertices).shape[0])
    key = topology_key(mesh.face_counts, mesh.face_indices, nv, L,
                       mesh.edge_creases, mesh.edge_crease_weights,
                       mesh.vertex_creases, mesh.vertex_crease_weights)
    plan = global_cache().get_or_build(
        ("plan", key),
        lambda: plan_subdivision(
            mesh.face_counts, mesh.face_indices, nv, L,
            edge_creases=mesh.edge_creases,
            edge_crease_weights=mesh.edge_crease_weights,
            vertex_creases=mesh.vertex_creases,
            vertex_crease_weights=mesh.vertex_crease_weights),
        plan_nbytes)
    verts = evaluate_plan(plan, np.asarray(mesh.vertices, np.float32))
    verts = limit_project(plan, verts)
    if mesh.displacement is not None:
        normals = vertex_normals(verts, plan.final_quads)
        verts = np.asarray(
            mesh.displacement(verts, normals, None, None), np.float32)

    pg = build_patch_grids(plan)
    g = pg.grid_res                       # fine cells per quad-face side
    counts = np.asarray(mesh.face_counts, np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])

    tri_v, tri_prim, tri_uv = [], [], []
    # patch index of quad faces = pg arrays keyed by face
    patch_start = {}
    pi = 0
    for f, c in enumerate(counts):
        patch_start[f] = pi
        pi += 1 if c == 4 else int(c)

    for f, c in enumerate(counts):
        e_rates = 1 << lg[starts[f]:starts[f] + c]       # per-edge rate
        rf = int(min(1 << L, max(1, e_rates.max())))     # face rate
        if c == 4:
            p = patch_start[f]
            step = g // rf
            ii = np.arange(rf + 1) * step
            iu = np.broadcast_to(ii[:, None], (rf + 1, rf + 1)).copy()
            jv = np.broadcast_to(ii[None, :], (rf + 1, rf + 1)).copy()
            # stitch each boundary row/col to its edge rate: snap the
            # along-edge fine-grid index onto the edge-rate lattice.
            # LEVEL layout: edge k runs corner k -> k+1; patch-uv corners
            # c0=(0,0) c1=(1,0) c2=(1,1) c3=(0,1), so in (i=u, j=v) grid
            # space: e0: j=0 (i varies), e1: i=g, e2: j=g, e3: i=0.
            # Any monotone snap gives both sides the same boundary
            # polyline over the shared edge-rate lattice (all rates are
            # nested powers of two and grids share refined vertex ids),
            # so stitching is EXACTLY watertight regardless of ties.
            def snap(idx, rate):
                cell = g // int(rate)
                return (np.round(idx / cell) * cell).astype(np.int64)
            if e_rates[0] < rf:
                iu[:, 0] = snap(iu[:, 0], e_rates[0])
            if e_rates[1] < rf:
                jv[-1, :] = snap(jv[-1, :], e_rates[1])
            if e_rates[2] < rf:
                iu[:, -1] = snap(iu[:, -1], e_rates[2])
            if e_rates[3] < rf:
                jv[0, :] = snap(jv[0, :], e_rates[3])
            sub = pg.grids[p][iu, jv]
            uvg = np.stack([iu / g, jv / g], axis=-1).astype(np.float32)
        else:
            # n-gon: uniform face rate on each sub-patch (half-res grids)
            gs = g // 2
            step = max(1, gs // min(rf, gs))
            ii = np.arange(0, gs + 1, step)
            subs, uvs = [], []
            for sp in range(int(c)):
                grid = pg.grids[patch_start[f] + sp][:gs + 1, :gs + 1]
                subs.append(grid[np.ix_(ii, ii)])
                uvg = np.stack(np.meshgrid(ii / gs, ii / gs,
                                           indexing="ij"),
                               axis=-1).astype(np.float32)
                uvs.append(uvg)
            for grid, uvg in zip(subs, uvs):
                q00 = grid[:-1, :-1].ravel()
                q10 = grid[1:, :-1].ravel()
                q11 = grid[1:, 1:].ravel()
                q01 = grid[:-1, 1:].ravel()
                u00 = uvg[:-1, :-1].reshape(-1, 2)
                u10 = uvg[1:, :-1].reshape(-1, 2)
                u11 = uvg[1:, 1:].reshape(-1, 2)
                u01 = uvg[:-1, 1:].reshape(-1, 2)
                tri_v.append(np.stack([q00, q10, q01], 1))
                tri_v.append(np.stack([q11, q01, q10], 1))
                tri_uv.append(np.stack([u00, u10, u01], 1))
                tri_uv.append(np.stack([u11, u01, u10], 1))
                n2 = 2 * q00.shape[0]
                tri_prim.append(np.full(n2, f, np.int64))
            continue
        q00 = sub[:-1, :-1].ravel()
        q10 = sub[1:, :-1].ravel()
        q11 = sub[1:, 1:].ravel()
        q01 = sub[:-1, 1:].ravel()
        u00 = uvg[:-1, :-1].reshape(-1, 2)
        u10 = uvg[1:, :-1].reshape(-1, 2)
        u11 = uvg[1:, 1:].reshape(-1, 2)
        u01 = uvg[:-1, 1:].reshape(-1, 2)
        tri_v.append(np.stack([q00, q10, q01], 1))
        tri_v.append(np.stack([q11, q01, q10], 1))
        tri_uv.append(np.stack([u00, u10, u01], 1))
        tri_uv.append(np.stack([u11, u01, u10], 1))
        tri_prim.append(np.full(2 * q00.shape[0], f, np.int64))

    ids = np.concatenate(tri_v)                  # (T, 3) refined-vert ids
    uv3 = np.concatenate(tri_uv).astype(np.float32)
    prim = np.concatenate(tri_prim)
    v0 = verts[ids[:, 0]].astype(np.float32)
    v1 = verts[ids[:, 1]].astype(np.float32)
    v2 = verts[ids[:, 2]].astype(np.float32)
    out = (v0, v1, v2, prim)
    if with_uv:
        out = out + (uv3,)
    return out
