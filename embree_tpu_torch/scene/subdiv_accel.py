"""Commit-time pipeline: SubdivMesh -> compressed-tile accel + eval data.

Counterpart of embree_tpu/scene/subdiv_accel.py: the host (numpy) build
is the same byte for byte, its results are uploaded as torch tensors on
the scene's device, and the samplers are torch ops.

The analog of BVHNSubdivPatch1OrientedBuilderSAH::build
(bvh_builder_subdiv.cpp:685-864): every patch is evaluated at the forced
uniform level 1<<subdivisionLevel (:772-781), chopped into (2^compLvl)^2-
cell tiles, one compressed cBVH per tile (createOriented :708-733), and a
standard SAH BVH4 with maxLeafSize=1 wraps the tile bounds (:842-846).

Also produces SubdivEval: the subdivided vertex/normal grids used by
Scene.interpolate (rtcInterpolate analog) — the reference renders
compressed hits with smooth normals fetched this way
(viewer_device.cpp:284-295).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..build.cbvh import CompressedBuildResult, build_compressed_tiles
from ..build.sah import BuildSettings, build_sah
from ..subdiv.cache import global_cache, plan_nbytes, topology_key
from ..subdiv.core import evaluate_plan, limit_project, plan_subdivision
from ..subdiv.tessellate import build_patch_grids, vertex_normals
from ..traverse.cbvh import CompressedAccel


class SubdivEval(NamedTuple):
    """Per-geometry evaluation grids for interpolate/smooth shading."""

    verts: torch.Tensor         # (V, 3) displaced subdivided vertices
    normals: torch.Tensor       # (V, 3) vertex normals
    grids: torch.Tensor         # (P, G+1, G+1) vertex ids per patch
    patch_of_face: torch.Tensor  # (F,) first patch id of each base face
    patches_per_face: torch.Tensor  # (F,)
    grid_res: int


def build_subdiv_geometry(mesh, subdivision_level: int, device):
    """Evaluate one SubdivMesh: plan, subdivide, displace, grids, normals
    (host numpy); the evaluation grids land on `device`.

    Returns (plan, verts_disp, verts_undisp, grids, eval_data)."""
    L = max(int(subdivision_level), 1)
    nv = int(np.asarray(mesh.vertices).shape[0])
    # topology plans are recompute-cached (SharedLazyTessellationCache
    # analog): dynamic re-commits with moved vertices skip the expensive
    # refinement planning entirely
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
    verts = limit_project(plan, verts)  # limit surface (getLimitVertex)
    quads = plan.final_quads
    normals = vertex_normals(verts, quads)

    if mesh.displacement is not None:
        verts_disp = np.asarray(mesh.displacement(verts, normals, None, None),
                                np.float32)
        normals_disp = vertex_normals(verts_disp, quads)
    else:
        verts_disp = verts
        normals_disp = normals

    grids = build_patch_grids(plan)

    F = int(np.asarray(mesh.face_counts).shape[0])
    ppf = np.zeros(F, np.int64)
    np.add.at(ppf, grids.patch_face, 1)
    pof = np.zeros(F, np.int64)
    pof[1:] = np.cumsum(ppf)[:-1]

    device = torch.device(device)

    def up(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    eval_data = SubdivEval(
        verts=up(verts_disp, np.float32),
        normals=up(normals_disp, np.float32),
        grids=up(grids.grids, np.int32),
        patch_of_face=up(pof, np.int32),
        patches_per_face=up(ppf, np.int32),
        grid_res=grids.grid_res,
    )
    return plan, verts_disp, verts, grids, eval_data


def chop_tiles(grids, verts_disp, verts_undisp, face_counts,
               comp_level: int, gid: int, need_undisp: bool):
    """Slice patch grids into (2^cl)^2-cell tile vertex batches.

    Quad-face patches span grid_res cells; n-gon sub-patches span
    grid_res/2 (their grids occupy the top-left quarter)."""
    G = grids.grid_res
    g = 1 << comp_level
    counts = np.asarray(face_counts)
    is_quad_patch = counts[grids.patch_face] == 4

    out_verts, out_undisp, out_uv0, out_uvd = [], [], [], []
    out_face = []

    for quad_sel, span in ((is_quad_patch, G), (~is_quad_patch, G // 2)):
        pids = np.nonzero(quad_sel)[0]
        if pids.size == 0:
            continue
        geff = min(g, span)
        nt = span // geff
        gv = grids.grids[pids]  # (P', G+1, G+1)
        for a in range(nt):
            for b in range(nt):
                idx = gv[:, a * geff:(a + 1) * geff + 1,
                         b * geff:(b + 1) * geff + 1]
                if geff < g:
                    # upsample index grid by repeating (degenerate cells) so
                    # tile shapes stay uniform; only hit when an n-gon patch
                    # is coarser than the compression tile
                    rep = g // geff
                    idx = np.repeat(np.repeat(idx, rep, axis=1), rep, axis=2)
                    idx = idx[:, :g + 1, :g + 1]
                out_verts.append(verts_disp[idx])
                out_undisp.append(verts_undisp[idx])
                uv0 = np.tile(np.array([[a * geff / span, b * geff / span]],
                                       np.float32), (pids.size, 1))
                uvd = np.full((pids.size, 2), geff / span, np.float32)
                out_uv0.append(uv0)
                out_uvd.append(uvd)
                out_face.append(grids.patch_face[pids])

    tile_verts = np.concatenate(out_verts)
    tile_undisp = np.concatenate(out_undisp) if need_undisp else None
    tile_uv0 = np.concatenate(out_uv0)
    tile_uvd = np.concatenate(out_uvd)
    prim_id = np.concatenate(out_face)
    geom_id = np.full(prim_id.shape[0], gid, np.int64)
    return (tile_verts.astype(np.float32),
            None if tile_undisp is None else tile_undisp.astype(np.float32),
            tile_uv0, tile_uvd, geom_id, prim_id)


def build_compressed_accel(subdiv_geoms, subdivision_level: int,
                           compression_level: int, mode: str,
                           flavor: str = "com", device="cpu"):
    """Full compressed-accel build over all subdiv geometries, on the
    host; the accel's tensors land on `device`.

    Returns (CompressedAccel, {gid: SubdivEval}, {gid: SubdivisionPlan},
    world_lo, world_hi)."""
    cl = min(max(int(compression_level), 1), 4, int(subdivision_level))
    tv, tu, uv0, uvd, gids, fids = [], [], [], [], [], []
    evals = {}
    plans = {}
    for gid, mesh in subdiv_geoms:
        plan, vd, vu, grids, ev = build_subdiv_geometry(
            mesh, subdivision_level, device)
        evals[gid] = ev
        plans[gid] = plan
        r = chop_tiles(grids, vd, vu, mesh.face_counts, cl, gid,
                       need_undisp=(mode == "leaf"))
        tv.append(r[0])
        if r[1] is not None:
            tu.append(r[1])
        uv0.append(r[2]); uvd.append(r[3]); gids.append(r[4]); fids.append(r[5])

    tile_verts = np.concatenate(tv)
    tile_undisp = np.concatenate(tu) if tu else None
    result: CompressedBuildResult = build_compressed_tiles(
        tile_verts, tile_undisp,
        np.concatenate(uv0), np.concatenate(uvd),
        np.concatenate(gids), np.concatenate(fids),
        cl, mode, flavor=flavor, device=device)

    # top-level SAH BVH4 over tile bounds, maxLeafSize=1
    # (bvh_builder_subdiv.cpp:842-846)
    top_np = build_sah(result.world_lower, result.world_upper,
                       BuildSettings(min_leaf_size=1, max_leaf_size=1))
    accel = CompressedAccel(top=top_np.to_device(device), tiles=result.tiles)
    return (accel, evals, plans,
            result.world_lower.min(0), result.world_upper.max(0))


def _cell(ev: SubdivEval, face, u, v):
    """(patch, i0, j0, du, dv) of patch-uv (face, u, v) in the grids."""
    G = ev.grid_res
    patch = ev.patch_of_face[face.long()].long()
    fu = u.clamp(0.0, 1.0) * G
    fv = v.clamp(0.0, 1.0) * G
    i0 = fu.to(torch.int32).clamp(0, G - 1).long()
    j0 = fv.to(torch.int32).clamp(0, G - 1).long()
    return patch, i0, j0, fu - i0, fv - j0


def grid_sample(ev: SubdivEval, face, u, v, arr):
    """Bilinear sample of a per-refined-vertex tensor at patch-uv
    (face, u, v) through the evaluation grids."""
    patch, i0, j0, du, dv = _cell(ev, face, u, v)
    a00 = arr[ev.grids[patch, i0, j0].long()]
    a10 = arr[ev.grids[patch, i0 + 1, j0].long()]
    a01 = arr[ev.grids[patch, i0, j0 + 1].long()]
    a11 = arr[ev.grids[patch, i0 + 1, j0 + 1].long()]
    w00 = ((1 - du) * (1 - dv))[..., None]
    w10 = (du * (1 - dv))[..., None]
    w01 = ((1 - du) * dv)[..., None]
    w11 = (du * dv)[..., None]
    return a00 * w00 + a10 * w10 + a01 * w01 + a11 * w11


def _unit(n):
    return n / torch.linalg.norm(n, dim=-1, keepdim=True).clamp_min(1e-20)


def interpolate_subdiv(ev: SubdivEval, face, u, v):
    """rtcInterpolate analog on the subdivided grids: returns (P, N) at
    patch-uv (face, u, v). Quad faces sample their single patch; n-gon
    faces sample sub-patch 0."""
    P = grid_sample(ev, face, u, v, ev.verts)
    N = grid_sample(ev, face, u, v, ev.normals)
    return P, _unit(N)


def fused_normal_table(ev: SubdivEval):
    """Pre-gather the normals through the per-patch index grids once:
    (P*(G+1)^2, 3) rows addressable by flat (patch, i, j) arithmetic, so
    that a smooth normal costs four row gathers instead of eight."""
    return ev.normals[ev.grids.reshape(-1).long()]


def sample_normal_fused(table, ev: SubdivEval, face, u, v):
    """Bilinear smooth normal via the fused table (one gather/corner)."""
    G = ev.grid_res
    patch, i0, j0, du, dv = _cell(ev, face, u, v)
    du, dv = du[..., None], dv[..., None]
    base = (patch * (G + 1) + i0) * (G + 1) + j0
    a00 = table[base]
    a10 = table[base + (G + 1)]
    a01 = table[base + 1]
    a11 = table[base + (G + 2)]
    n = (a00 * (1 - du) * (1 - dv) + a10 * du * (1 - dv)
         + a01 * (1 - du) * dv + a11 * du * dv)
    return _unit(n)
