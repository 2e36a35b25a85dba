"""Compressed per-patch quadtree BVH ("cBVH") builder — the paper's core.

Counterpart of embree_tpu/build/cbvh.py: the same host (numpy) build,
byte for byte, with the result uploaded as torch tensors.

Re-implements the fork's compressed, quantized per-tile hierarchy
(kernels/geometry/compressed.h:49-338 CompressedBVH ctor,
compressed_node.h "com" 4-byte nodes, compressed_leaf.h pizza-box leaves,
bvh_builder_subdiv.cpp:685-884 oriented builder) as dense *batched* numpy
passes: every tile has identical shape ((2^cl)^2 cells), so the whole
scene's tiles build as one vectorized computation in place of the
reference's per-tile recursive loop.

Pipeline per tile (batched over all tiles):
  1. local sheared frame from averaged patch edge directions
     (compressed.h:120-126; un-displaced corners for leaf mode :100-117)
  2. 8-DoF homography rectifying the xy footprint to [-1,1]^2 with the
     reference's validity checks and axis-aligned fallback
     (compressed_help.h:54-90, compressed.h:147-210)
  3. complete Morton-ordered quadtree over the cells; nodes encoded
     top-down against the RE-DECODED parent box so quantization error
     never accumulates (compressed.h:223-252)
  4. "com" node: children share x/y split planes — 8x3-bit offsets via
     border/mid lookup tables + 2x2-bit shared z slab = 4 bytes/node
     (compressed_node.h:262-296,408-512); floor-semantics lookUpIdx
     (:46-55) keeps boxes conservative
  5. 10-float frustum entry box + corner-uv remap + rcp_edges
     (compressed.h:277-290, :85-90)
  6. leaf payloads: box (none) / pizza-box (4x4-bit corner z refit by
     corner-ray casting + shared extent, compressed_leaf.h:115-251,
     MAX_EXTENT=1) / full vertex grid
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

# quantization lookup tables (compressed_node.h:22-39)
TABLE_BORDER = np.array([0.0, 0.005, 0.01, 0.05, 0.1, 0.2, 0.4, 0.6],
                        np.float32)
TABLE_MID = np.array([0.0, 0.40, 0.48, 0.49, 0.50, 0.51, 0.52, 0.60],
                     np.float32)
TABLE_Z = np.array([0.0, 0.25, 0.5, 0.75], np.float32)  # 2-bit uniform
MAX_EXTENT = 1.0


def lookup_idx(table: np.ndarray, val: np.ndarray) -> np.ndarray:
    """Floor semantics: largest index with table[i] <= val
    (compressed_node.h:46-55; conservative because offsets point inward)."""
    idx = np.searchsorted(table, val, side="right") - 1
    return np.clip(idx, 0, len(table) - 1).astype(np.int64)


def morton2_decode(code: np.ndarray):
    """(x, y) from interleaved 2D morton code (compressed_help.h:19-50)."""
    def compact(x):
        x = x & 0x55555555
        x = (x ^ (x >> 1)) & 0x33333333
        x = (x ^ (x >> 2)) & 0x0F0F0F0F
        x = (x ^ (x >> 4)) & 0x00FF00FF
        x = (x ^ (x >> 8)) & 0x0000FFFF
        return x
    code = np.asarray(code, np.uint32)
    return compact(code), compact(code >> 1)


def morton2_encode(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    def part(v):
        v = np.asarray(v, np.uint32) & 0x0000FFFF
        v = (v ^ (v << 8)) & 0x00FF00FF
        v = (v ^ (v << 4)) & 0x0F0F0F0F
        v = (v ^ (v << 2)) & 0x33333333
        v = (v ^ (v << 1)) & 0x55555555
        return v
    return (part(y) << 1) + part(x)


def homography_from_4pts(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Batched 8-DoF homography (ComputeLinearEstimate,
    compressed_help.h:54-84). src/dst: (N, 4, 2) -> (N, 3, 3)."""
    N = src.shape[0]
    A = np.zeros((N, 8, 8), np.float64)
    b = np.zeros((N, 8), np.float64)
    for i in range(4):
        q = src[:, i].astype(np.float64)
        p = dst[:, i].astype(np.float64)
        A[:, i, 0] = q[:, 0]; A[:, i, 1] = q[:, 1]; A[:, i, 2] = 1.0
        A[:, i, 6] = -q[:, 0] * p[:, 0]; A[:, i, 7] = -q[:, 1] * p[:, 0]
        A[:, 4 + i, 3] = q[:, 0]; A[:, 4 + i, 4] = q[:, 1]; A[:, 4 + i, 5] = 1.0
        A[:, 4 + i, 6] = -q[:, 0] * p[:, 1]; A[:, 4 + i, 7] = -q[:, 1] * p[:, 1]
        b[:, i] = p[:, 0]
        b[:, 4 + i] = p[:, 1]
    H = np.zeros((N, 3, 3), np.float32)
    ok = np.ones(N, bool)
    try:
        x = np.linalg.solve(A, b[..., None])[..., 0]
    except np.linalg.LinAlgError:  # singular batch: per-item fallback
        x = np.zeros((N, 8))
        for k in range(N):
            try:
                x[k] = np.linalg.solve(A[k], b[k])
            except np.linalg.LinAlgError:
                x[k] = np.array([1, 0, 0, 0, 1, 0, 0, 0], np.float64)
                ok[k] = False
    H[:, 0, :] = x[:, 0:3]
    H[:, 1, :] = x[:, 3:6]
    H[:, 2, 0:2] = x[:, 6:8]
    H[:, 2, 2] = 1.0
    bad = ~np.isfinite(x).all(axis=1)
    H[bad] = np.eye(3, dtype=np.float32)
    ok &= ~bad
    return H, ok


def project_pts(pts: np.ndarray, H: np.ndarray) -> np.ndarray:
    """Apply homography to xy, pass z through (compressed_help.h:86-90).
    pts: (..., 3), H broadcastable (..., 3, 3)."""
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    w = H[..., 2, 0] * x + H[..., 2, 1] * y + H[..., 2, 2]
    w = np.where(np.abs(w) < 1e-30, 1e-30, w)
    px = (H[..., 0, 0] * x + H[..., 0, 1] * y + H[..., 0, 2]) / w
    py = (H[..., 1, 0] * x + H[..., 1, 1] * y + H[..., 1, 2]) / w
    return np.stack([px, py, z], -1)


class CompressedTiles(NamedTuple):
    """Device-side batched tile data (the cBVH 'leaves' of the top-level
    BVH4). All tensors have leading dim num_tiles."""

    space: torch.Tensor       # (T, 3, 3) f32 world->local frame
    proj: torch.Tensor        # (T, 3, 3) f32 homography
    iproj: torch.Tensor       # (T, 3, 3) f32 inverse
    frustum: torch.Tensor     # (T, 10) f32 [z0, z1, p00, p10, p01, p11]
    nodes: torch.Tensor       # (T, n_nodes, W) u8-valued i32
    nodes_full: torch.Tensor  # (T, n_nodes, 4, 6) f32 ('full')
    uv0: torch.Tensor         # (T, 2) f32
    uvd: torch.Tensor         # (T, 2) f32
    geom_id: torch.Tensor     # (T,) i32
    prim_id: torch.Tensor     # (T,) i32 base face id
    leaf_z: torch.Tensor      # (T, cells, 2) i32 pizza-box z
    extent: torch.Tensor      # (T,) f32
    grid: torch.Tensor        # (T, g+1, g+1, 3) f32 world grid ('grid')
    comp_level: int
    mode: str                 # 'box' | 'leaf' | 'grid' | 'full'
    flavor: str = "com"       # 'com' (4 B) | 'non' (8 B) | 'mid' (2 B)

    ARRAYS = ("space", "proj", "iproj", "frustum", "nodes", "nodes_full",
              "uv0", "uvd", "geom_id", "prim_id", "leaf_z", "extent", "grid")

    @property
    def num_tiles(self):
        return self.geom_id.shape[0]


@dataclasses.dataclass
class CompressedBuildResult:
    tiles: CompressedTiles
    world_lower: np.ndarray  # (T, 3) per-tile world bounds for top BVH
    world_upper: np.ndarray


def _frames(c00, c10, c01, c11):
    """Local sheared frame + inverse (compressed.h:120-126)."""
    def norm(v):
        return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-20)
    vx = norm(c10 - c00 + c11 - c01)
    vy = norm(c01 - c00 + c11 - c10)
    vz = norm(np.cross(vx, vy))
    world = np.stack([vx, vy, vz], axis=-1)  # columns = frame axes
    space = np.linalg.inv(
        np.where(np.abs(np.linalg.det(world))[..., None, None] > 1e-12,
                 world, np.eye(3)))
    return world, space


def build_compressed_tiles(tile_verts: np.ndarray,
                           tile_verts_undisp: Optional[np.ndarray],
                           tile_uv0: np.ndarray, tile_uvd: np.ndarray,
                           geom_id: np.ndarray, prim_id: np.ndarray,
                           comp_level: int, mode: str,
                           flavor: str = "com",
                           device="cpu") -> CompressedBuildResult:
    """Build all tiles at once on the host; the tile tensors land on
    `device`.

    tile_verts: (T, g+1, g+1, 3) displaced local-grid vertices, i along u.
    tile_verts_undisp: same without displacement (frame source in 'leaf'
    mode, compressed.h:100-117); None -> use displaced.
    """
    if mode not in ("box", "leaf", "grid", "full"):
        raise ValueError(f"unknown compressed mode {mode!r}")
    if flavor not in ("com", "non", "mid"):
        raise ValueError(f"unknown node flavor {flavor!r}")
    T = tile_verts.shape[0]
    g = 1 << comp_level
    if tile_verts.shape[1] != g + 1:
        raise ValueError(f"tile grids of {tile_verts.shape[1]} vertices a "
                         f"side, expected {g + 1}")
    cells = g * g
    n_nodes = (4 ** comp_level - 1) // 3

    fv = tile_verts_undisp if (mode == "leaf" and tile_verts_undisp
                               is not None) else tile_verts
    c00, c10 = fv[:, 0, 0], fv[:, g, 0]
    c01, c11 = fv[:, 0, g], fv[:, g, g]
    world, space = _frames(c00, c10, c01, c11)

    # local-space vertices: v_local = space @ v
    v = np.einsum("tij,txyj->txyi", space, tile_verts)

    # --- homography (compressed.h:128-210) --------------------------------
    corners = np.stack([v[:, 0, 0], v[:, g, 0], v[:, 0, g], v[:, g, g]], 1)
    src = corners[..., :2]
    dst = np.broadcast_to(
        np.array([[-1, -1], [1, -1], [-1, 1], [1, 1]], np.float32),
        (T, 4, 2))
    H, h_ok = homography_from_4pts(src, dst)

    # patchOK: grid xy monotonic per cell (skipped for grid mode)
    dx_ok = (v[:, 1:, :, 0] >= v[:, :-1, :, 0]).all(axis=(1, 2))
    dy_ok = (v[:, :, 1:, 1] >= v[:, :, :-1, 1]).all(axis=(1, 2))
    patch_ok = h_ok & dx_ok & dy_ok & (mode != "grid")

    pv = project_pts(v, H[:, None, None])
    finite = np.isfinite(pv[..., 0]) & np.isfinite(pv[..., 1])
    inside = (np.abs(pv[..., 0]) <= 1.5) & (np.abs(pv[..., 1]) <= 1.5)
    patch_ok &= (finite & inside).all(axis=(1, 2))

    # rescale: homography (or identity fallback) composed with the
    # axis-aligned fit of the projected (or local) bbox to [-1,1]^2
    pbox_src = np.where(patch_ok[:, None, None, None], pv, v)
    lo = np.nanmin(np.where(np.isfinite(pbox_src), pbox_src, np.inf),
                   axis=(1, 2))
    hi = np.nanmax(np.where(np.isfinite(pbox_src), pbox_src, -np.inf),
                   axis=(1, 2))
    box_src = np.stack([
        np.stack([lo[:, 0], lo[:, 1]], -1),
        np.stack([hi[:, 0], lo[:, 1]], -1),
        np.stack([lo[:, 0], hi[:, 1]], -1),
        np.stack([hi[:, 0], hi[:, 1]], -1)], 1)
    S, _s_ok = homography_from_4pts(box_src, dst)
    base = np.where(patch_ok[:, None, None], H,
                    np.broadcast_to(np.eye(3, dtype=np.float32), (T, 3, 3)))
    proj = np.einsum("tij,tjk->tik", S, base).astype(np.float32)
    iproj = np.linalg.inv(
        np.where(np.abs(np.linalg.det(proj))[..., None, None] > 1e-30,
                 proj, np.eye(3, dtype=np.float32))).astype(np.float32)

    # --- per-cell leaf boxes in projected space, Morton order -------------
    pv = project_pts(v, proj[:, None, None])  # (T, g+1, g+1, 3)
    code = np.arange(cells, dtype=np.uint32)
    mx, my = morton2_decode(code)  # cell (x, y) == (i, j)
    cell4 = np.stack([pv[:, mx, my], pv[:, mx + 1, my],
                      pv[:, mx, my + 1], pv[:, mx + 1, my + 1]], 2)
    leaf_lo = cell4.min(axis=2)  # (T, cells, 3)
    leaf_hi = cell4.max(axis=2)

    # bottom-up merge: level arrays in Morton groups of 4
    levels_lo = [leaf_lo]
    levels_hi = [leaf_hi]
    while levels_lo[-1].shape[1] > 1:
        ll = levels_lo[-1].reshape(T, -1, 4, 3)
        hh = levels_hi[-1].reshape(T, -1, 4, 3)
        levels_lo.append(ll.min(axis=2))
        levels_hi.append(hh.max(axis=2))
    levels_lo.reverse()
    levels_hi.reverse()
    # levels_lo[0] = root (T, 1, 3) ... levels_lo[-1] = leaves

    # --- top-down encode vs reconstructed parents (compressed.h:223-252) --
    # node flavors (compressed_node.h): 'com' 4 B shared split planes,
    # 'non' 8 B independent per-child planes (:298-369, :516-658),
    # 'mid' 2 B inner planes only (:241-260); 'full'/ref handled below.
    W = {"com": 4, "non": 8, "mid": 2}[flavor]
    nodes = np.zeros((T, max(n_nodes, 1), W), np.int64)
    curr = 0
    for lvl in range(len(levels_lo) - 1):
        plo, phi = levels_lo[lvl], levels_hi[lvl]           # (T, K, 3)
        clo = levels_lo[lvl + 1].reshape(T, -1, 4, 3)       # (T, K, 4, 3)
        chi = levels_hi[lvl + 1].reshape(T, -1, 4, 3)
        K = plo.shape[1]

        dim = phi - plo
        F = np.where(np.isfinite(1.0 / np.maximum(dim, 1e-38)) & (dim > 0),
                     1.0 / np.maximum(dim, 1e-38), np.finfo(np.float32).tiny)

        if flavor == "non":
            # independent per-child quantized planes: border table on the
            # outer plane of each quadrant, mid table on the inner
            # (Node<non>::setAABB compressed_node.h:524-576)
            rel_lo = np.zeros((T, K, 4, 3), np.float32)
            rel_hi = np.zeros((T, K, 4, 3), np.float32)
            for c in range(4):
                qx, qy = c & 1, (c >> 1) & 1
                t_minx = TABLE_MID if qx else TABLE_BORDER
                t_maxx = TABLE_BORDER if qx else TABLE_MID
                t_miny = TABLE_MID if qy else TABLE_BORDER
                t_maxy = TABLE_BORDER if qy else TABLE_MID
                iminx = lookup_idx(t_minx,
                                   (clo[:, :, c, 0] - plo[:, :, 0]) * F[:, :, 0])
                imaxx = lookup_idx(t_maxx,
                                   (phi[:, :, 0] - chi[:, :, c, 0]) * F[:, :, 0])
                iminy = lookup_idx(t_miny,
                                   (clo[:, :, c, 1] - plo[:, :, 1]) * F[:, :, 1])
                imaxy = lookup_idx(t_maxy,
                                   (phi[:, :, 1] - chi[:, :, c, 1]) * F[:, :, 1])
                iminz = lookup_idx(TABLE_Z,
                                   (clo[:, :, c, 2] - plo[:, :, 2]) * F[:, :, 2])
                imaxz = lookup_idx(TABLE_Z,
                                   (phi[:, :, 2] - chi[:, :, c, 2]) * F[:, :, 2])
                nodes[:, curr:curr + K, 2 * c] = \
                    (iminx << 5) | (imaxx << 2) | iminz
                nodes[:, curr:curr + K, 2 * c + 1] = \
                    (iminy << 5) | (imaxy << 2) | imaxz
                rel_lo[:, :, c, 0] = t_minx[iminx]
                rel_lo[:, :, c, 1] = t_miny[iminy]
                rel_lo[:, :, c, 2] = TABLE_Z[iminz]
                rel_hi[:, :, c, 0] = 1 - t_maxx[imaxx]
                rel_hi[:, :, c, 1] = 1 - t_maxy[imaxy]
                rel_hi[:, :, c, 2] = 1 - TABLE_Z[imaxz]
            d = dim[:, :, None, :]
            p = plo[:, :, None, :]
            levels_lo[lvl + 1] = (rel_lo * d + p).reshape(T, -1, 3)
            levels_hi[lvl + 1] = (rel_hi * d + p).reshape(T, -1, 3)
            curr += K
            continue

        # shared split planes (com/mid); children morton order:
        # 0=(0,0) 1=(1,0) 2=(0,1) 3=(1,1)
        x1 = np.minimum(clo[:, :, 0, 0], clo[:, :, 2, 0])
        x2 = np.minimum(clo[:, :, 1, 0], clo[:, :, 3, 0])
        x3 = np.maximum(chi[:, :, 0, 0], chi[:, :, 2, 0])
        x4 = np.maximum(chi[:, :, 1, 0], chi[:, :, 3, 0])
        y1 = np.minimum(clo[:, :, 0, 1], clo[:, :, 1, 1])
        y2 = np.minimum(clo[:, :, 2, 1], clo[:, :, 3, 1])
        y3 = np.maximum(chi[:, :, 0, 1], chi[:, :, 1, 1])
        y4 = np.maximum(chi[:, :, 2, 1], chi[:, :, 3, 1])
        z1 = clo[:, :, :, 2].min(axis=2)
        z2 = chi[:, :, :, 2].max(axis=2)

        ix2 = lookup_idx(TABLE_MID, (x2 - plo[:, :, 0]) * F[:, :, 0])
        ix3 = lookup_idx(TABLE_MID, (phi[:, :, 0] - x3) * F[:, :, 0])
        iy2 = lookup_idx(TABLE_MID, (y2 - plo[:, :, 1]) * F[:, :, 1])
        iy3 = lookup_idx(TABLE_MID, (phi[:, :, 1] - y3) * F[:, :, 1])
        iz1 = lookup_idx(TABLE_Z, (z1 - plo[:, :, 2]) * F[:, :, 2])
        iz2 = lookup_idx(TABLE_Z, (phi[:, :, 2] - z2) * F[:, :, 2])

        if flavor == "mid":
            # inner planes only; outer planes reused from the parent
            # (NodeStorage<mid> compressed_node.h:241-260)
            nodes[:, curr:curr + K, 0] = (ix2 << 5) | (ix3 << 2) | iz1
            nodes[:, curr:curr + K, 1] = (iy2 << 5) | (iy3 << 2) | iz2
            zero = np.zeros_like(TABLE_MID[ix2])
            one = zero + 1.0
            rel_lo_x = np.stack([zero, TABLE_MID[ix2],
                                 zero, TABLE_MID[ix2]], 2)
            rel_hi_x = np.stack([1 - TABLE_MID[ix3], one,
                                 1 - TABLE_MID[ix3], one], 2)
            rel_lo_y = np.stack([zero, zero,
                                 TABLE_MID[iy2], TABLE_MID[iy2]], 2)
            rel_hi_y = np.stack([1 - TABLE_MID[iy3], 1 - TABLE_MID[iy3],
                                 one, one], 2)
        else:
            ix1 = lookup_idx(TABLE_BORDER, (x1 - plo[:, :, 0]) * F[:, :, 0])
            ix4 = lookup_idx(TABLE_BORDER, (phi[:, :, 0] - x4) * F[:, :, 0])
            iy1 = lookup_idx(TABLE_BORDER, (y1 - plo[:, :, 1]) * F[:, :, 1])
            iy4 = lookup_idx(TABLE_BORDER, (phi[:, :, 1] - y4) * F[:, :, 1])

            # byte layout (compressed_node.h:264-296):
            # xz = x1<<5 | x2<<2 | minZ ; x = x3<<5 | x4<<2
            # yz = y1<<5 | y2<<2 | maxZ ; y = y3<<5 | y4<<2
            nodes[:, curr:curr + K, 0] = (ix1 << 5) | (ix2 << 2) | iz1
            nodes[:, curr:curr + K, 1] = (ix3 << 5) | (ix4 << 2)
            nodes[:, curr:curr + K, 2] = (iy1 << 5) | (iy2 << 2) | iz2
            nodes[:, curr:curr + K, 3] = (iy3 << 5) | (iy4 << 2)

            rel_lo_x = np.stack([TABLE_BORDER[ix1], TABLE_MID[ix2],
                                 TABLE_BORDER[ix1], TABLE_MID[ix2]], 2)
            rel_hi_x = np.stack([1 - TABLE_MID[ix3], 1 - TABLE_BORDER[ix4],
                                 1 - TABLE_MID[ix3], 1 - TABLE_BORDER[ix4]], 2)
            rel_lo_y = np.stack([TABLE_BORDER[iy1], TABLE_BORDER[iy1],
                                 TABLE_MID[iy2], TABLE_MID[iy2]], 2)
            rel_hi_y = np.stack([1 - TABLE_MID[iy3], 1 - TABLE_MID[iy3],
                                 1 - TABLE_BORDER[iy4], 1 - TABLE_BORDER[iy4]], 2)

        # re-decode children (getAABB semantics) and REPLACE the next level
        # so deeper encodes quantize against reconstructed parents
        rel_lo_z = np.broadcast_to(TABLE_Z[iz1][:, :, None], rel_lo_x.shape)
        rel_hi_z = np.broadcast_to((1 - TABLE_Z[iz2])[:, :, None],
                                   rel_lo_x.shape)
        d = dim[:, :, None, :]
        p = plo[:, :, None, :]
        dec_lo = np.stack([rel_lo_x, rel_lo_y, rel_lo_z], -1) * d + p
        dec_hi = np.stack([rel_hi_x, rel_hi_y, rel_hi_z], -1) * d + p
        levels_lo[lvl + 1] = dec_lo.reshape(T, -1, 3)
        levels_hi[lvl + 1] = dec_hi.reshape(T, -1, 3)
        curr += K

    rec_leaf_lo = levels_lo[-1]  # reconstructed leaf boxes (T, cells, 3)
    rec_leaf_hi = levels_hi[-1]

    # full-precision mode ('ref' flavor, compressed_node.h:661-714):
    # exact float child boxes per node, no quantization error
    nodes_full = np.zeros((T, 0, 4, 6), np.float32)
    if mode == "full":
        exact_lo = [leaf_lo]
        exact_hi = [leaf_hi]
        while exact_lo[-1].shape[1] > 1:
            exact_lo.append(exact_lo[-1].reshape(T, -1, 4, 3).min(axis=2))
            exact_hi.append(exact_hi[-1].reshape(T, -1, 4, 3).max(axis=2))
        exact_lo.reverse()
        exact_hi.reverse()
        parts = []
        for lvl in range(len(exact_lo) - 1):
            clo = exact_lo[lvl + 1].reshape(T, -1, 4, 3)
            chi = exact_hi[lvl + 1].reshape(T, -1, 4, 3)
            parts.append(np.concatenate([clo, chi], -1))
        nodes_full = np.concatenate(parts, axis=1).astype(np.float32)
        rec_leaf_lo, rec_leaf_hi = leaf_lo, leaf_hi

    # --- frustum box (compressed.h:277-290) --------------------------------
    proj_lo = rec_leaf_lo.min(axis=1)
    proj_hi = rec_leaf_hi.max(axis=1)
    pb = np.zeros((T, 10), np.float32)
    p00 = project_pts(np.stack([proj_lo[:, 0], proj_lo[:, 1],
                                proj_lo[:, 2]], -1), iproj)
    p10 = project_pts(np.stack([proj_hi[:, 0], proj_lo[:, 1],
                                proj_lo[:, 2]], -1), iproj)
    p01 = project_pts(np.stack([proj_lo[:, 0], proj_hi[:, 1],
                                proj_hi[:, 2]], -1), iproj)
    p11 = project_pts(np.stack([proj_hi[:, 0], proj_hi[:, 1],
                                proj_hi[:, 2]], -1), iproj)
    pb[:, 0] = proj_lo[:, 2]
    pb[:, 1] = proj_hi[:, 2]
    pb[:, 2:4] = p00[:, :2]
    pb[:, 4:6] = p10[:, :2]
    pb[:, 6:8] = p01[:, :2]
    pb[:, 8:10] = p11[:, :2]

    # --- world bounds for the top-level BVH (compressed.h:252-276) ---------
    # unproject 8 corners of each reconstructed leaf box, take the local
    # axis-aligned box of those, then map its corners to world space
    def corners8(lo, hi):
        outs = []
        for cx in (0, 1):
            for cy in (0, 1):
                for cz in (0, 1):
                    outs.append(np.stack([
                        np.where(cx, hi[..., 0], lo[..., 0]),
                        np.where(cy, hi[..., 1], lo[..., 1]),
                        np.where(cz, hi[..., 2], lo[..., 2])], -1))
        return np.stack(outs, axis=-2)  # (..., 8, 3)

    c8 = corners8(rec_leaf_lo, rec_leaf_hi)  # (T, cells, 8, 3)
    un = project_pts(c8, iproj[:, None, None])
    tmp_lo = un.min(axis=2)
    tmp_hi = un.max(axis=2)
    t8 = corners8(tmp_lo, tmp_hi)            # (T, cells, 8, 3)
    wpts = np.einsum("tij,tckj->tcki", world, t8)
    world_lower = wpts.min(axis=(1, 2)).astype(np.float32)
    world_upper = wpts.max(axis=(1, 2)).astype(np.float32)

    # --- leaf payloads ------------------------------------------------------
    leaf_z = np.zeros((T, 0, 2), np.int64)
    extent = np.zeros((T,), np.float32)
    grid_store = np.zeros((T, 0, 0, 3), np.float32)
    if mode == "leaf":
        leaf_z, extent = _build_pizza_leaves(pv, rec_leaf_lo, rec_leaf_hi,
                                             mx, my)
    if mode == "grid":
        # grid mode intersects WORLD-space triangles (the reference stores
        # the raw evalGrid vertices and tests the un-transformed ray,
        # compressed.h:330-335 + :597-610)
        grid_store = np.ascontiguousarray(tile_verts).astype(np.float32)

    device = torch.device(device)

    def up(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    tiles = CompressedTiles(
        space=up(space, np.float32),
        proj=up(proj, np.float32),
        iproj=up(iproj, np.float32),
        frustum=up(pb, np.float32),
        nodes=up(nodes, np.int32),
        nodes_full=up(nodes_full, np.float32),
        uv0=up(tile_uv0, np.float32),
        uvd=up(tile_uvd, np.float32),
        geom_id=up(geom_id, np.int32),
        prim_id=up(prim_id, np.int32),
        leaf_z=up(leaf_z, np.int32),
        extent=up(extent, np.float32),
        grid=up(grid_store, np.float32),
        comp_level=comp_level,
        mode=mode,
        flavor=flavor,
    )
    return CompressedBuildResult(tiles=tiles, world_lower=world_lower,
                                 world_upper=world_upper)


def _ray_z_on_triangle(px, py, a, b, c):
    """z of vertical ray (px, py, 0, dir +z) on triangle plane
    (refitTriangle, compressed_leaf.h:115-170) — batched."""
    n = np.cross(b - a, c - a)
    nz = np.where(np.abs(n[..., 2]) < 1e-20, 1e-20, n[..., 2])
    d = -(n[..., 0] * (px - a[..., 0]) + n[..., 1] * (py - a[..., 1]))
    return a[..., 2] + d / nz


def _build_pizza_leaves(pv, rec_lo, rec_hi, mx, my):
    """Pizza-box z heights: corner rays against the two cell triangles,
    shared extent inflation (compressed_leaf.h:198-251, compressed.h:296-
    335)."""
    T = pv.shape[0]
    cells = rec_lo.shape[1]
    v1 = pv[:, mx, my]        # (T, cells, 3) cell corners in proj space
    v2 = pv[:, mx + 1, my]
    v3 = pv[:, mx, my + 1]
    v4 = pv[:, mx + 1, my + 1]
    blo, bhi = rec_lo, rec_hi

    # corner xy positions of the reconstructed box
    z1 = _ray_z_on_triangle(blo[..., 0], blo[..., 1], v1, v2, v3)
    z2 = _ray_z_on_triangle(bhi[..., 0], blo[..., 1], v1, v2, v4)
    z3 = _ray_z_on_triangle(blo[..., 0], bhi[..., 1], v1, v3, v4)
    z4 = _ray_z_on_triangle(bhi[..., 0], bhi[..., 1], v2, v3, v4)

    zf = bhi[..., 2] - blo[..., 2]
    zf_safe = np.where(zf == 0, 1.0, zf)

    def overshoot(z):
        return np.maximum(np.maximum(z - bhi[..., 2], 0.0),
                          np.abs(np.minimum(z - blo[..., 2], 0.0)))

    per_cell = np.maximum(np.maximum(overshoot(z1), overshoot(z2)),
                          np.maximum(overshoot(z3), overshoot(z4))) / zf_safe
    per_cell = np.where(zf == 0, 0.0, per_cell)
    extent = np.minimum(per_cell.max(axis=1), MAX_EXTENT).astype(np.float32)

    rng = (1.0 + 2.0 * extent[:, None]) * zf
    off = blo[..., 2] - extent[:, None] * zf
    rcpf = 16.0 / np.where(rng == 0, 1.0, rng)

    def q(z):
        return np.clip(((z - off) * rcpf), 0.0, 15.0).astype(np.int64)

    q1, q2, q3, q4 = q(z1), q(z2), q(z3), q(z4)
    q1 = np.where(zf[...] == 0, 0, q1)
    q2 = np.where(zf[...] == 0, 0, q2)
    q3 = np.where(zf[...] == 0, 0, q3)
    q4 = np.where(zf[...] == 0, 0, q4)
    z12 = (q1 << 4) | q2
    z34 = (q3 << 4) | q4
    return np.stack([z12, z34], -1), extent
