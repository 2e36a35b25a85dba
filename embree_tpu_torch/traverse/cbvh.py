"""Compressed-patch (cBVH) traversal in plain torch ops.

Counterpart of embree_tpu/traverse/cbvh.py. It implements the fork's
CompressedBVHIntersector1 (kernels/geometry/compressed.h:441-784):

  1. top-level BVH4 over the tiles, one tile a leaf
  2. ray -> tile-local frame (:457-459)
  3. frustum entry/exit: z slab + four 2D edge-line tests
     (intersect_frustum, compressed_help.h:93-133)
  4. ray projected through the homography: origin/target = projected
     entry/exit points; distances map back via zFactor = lDir.z/dir.z;
     tiny and flat local frames handled per :464-505
  5. implicit Morton quadtree walk with a parent-box stack; nodes
     decompressed against the popped parent box (getNode,
     compressed_node.h:489-512; non :578-658; mid :241-260)
  6. leaves by mode: reconstructed box = surface ('box' :614-656, also
     'full'), bilinear pizza-box slab with refit extent ('leaf' :541-590 +
     intersect_patch compressed_help.h:135-229), world-space grid
     triangles ('grid' :591-610)
  7. uv remapped to patch space (:570-571); Ng is the dummy (1,0,0) —
     consumers use smooth normals (scene/subdiv_accel.py)
  8. occluded() is conservatively true once a ray reaches any tile's
     top-level leaf box (compressed.h:754-756)

The JAX package walks a packet of rays behind one shared stack and
orders children by the packet's nearest ray. Here every ray walks on its
own, as in the CUDA kernel (csrc/cbvh.cu): `walk_closest` and
`walk_occluded` advance a batch of independent rays in lock-step, one pop
per ray and step, behind per-ray stack tensors. Per ray:

  * top level: a stack of (ref, entry distance), the root first; a popped
    entry is skipped when its entry distance exceeds the ray's current t;
    the children that pass the robust slab test (`tmin <= tmax`,
    `tmin <= t`, entry clamped to tnear) are pushed far to near by the
    ray's own entry distance, the lower slot on top among equal
    distances; a leaf child is tile `prim_order[child]`;
  * tile entry: a ray that misses the frustum leaves the tile at once;
  * quadtree: a stack of (node, parent box); the children of an inner
    node that pass the slab test against the tile-local tfar are pushed
    far to near the same way; a leaf applies its mode's rule, which only
    ever lowers the tile-local tfar.

The order of visits depends on the ray alone, so an answer does not
depend on how rays are batched. `walk_closest` reads the accel through a
tile source: `UnpackedSource` (this module: the `CompressedTiles`
tensors, every mode and node flavor) or the row layout of the CUDA
kernel (traverse/cbvh_kernel.py), whose plain version this walk is; the
arithmetic is written in the kernel's operation order, so the two agree
bit for bit.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..build.bvh import BVH
from ..build.cbvh import TABLE_BORDER, TABLE_MID, TABLE_Z, CompressedTiles
from ..core.math import (RCP_EPS, ROBUST_MAX_RCP as ROBUST_MAX,
                         ROBUST_MIN_RCP as ROBUST_MIN, rcp_safe)
from ..core.rayhit import Hits, Rays
from .moeller import intersect_triangle
from .packet_kernel import tree_depth

G_EPS = float(np.float32(1e-4))      # compressed.h g_epsilon
Z_HUGE = float(np.float32(3.4e38))   # zFactor / local tfar of a 'tiny' ray
DEGEN_EPS = float(np.float32(1e-6))
PLAIN_CHUNK = 65536                  # rays per lock-step batch
MAX_COMP_LEVEL = 4
# header columns shared by both tile sources (the kernel's header row:
# space 0, proj 9, iproj 18, frustum 27, uv0 37, uvd 39, extent 41)
H_IPROJ, H_EXTENT, H_WALK = 18, 41, 42


class CompressedAccel(NamedTuple):
    top: BVH                 # top-level BVH4 over tiles (leaf = tile id)
    tiles: CompressedTiles


# what a committed scene keeps of an accel whose kernels read its compact
# form (traverse/cbvh_kernel.py): the hits' ids and the uv remap
KEPT_WHEN_PACKED = ("uv0", "uvd", "geom_id", "prim_id")


def ids_only(accel: CompressedAccel) -> CompressedAccel:
    """The accel without the tiles' walk data and the top level: the
    arrays of KEPT_WHEN_PACKED and the scalars, every other array None.
    No walk over it is possible; the kernels' compact form answers."""
    t = accel.tiles
    return CompressedAccel(top=None, tiles=t._replace(
        **{k: None for k in t.ARRAYS if k not in KEPT_WHEN_PACKED}))


class _CHit(NamedTuple):
    """Per-ray compressed-hit state."""

    t: torch.Tensor     # world-space distance (tfar where no tile was hit)
    u: torch.Tensor     # patch-space uv
    v: torch.Tensor
    tile: torch.Tensor  # best tile index, -1 = none


def new_counters(num_nodes=None, num_tiles=None, device=None) -> dict:
    """Counters of one traversal: sums over rays of top-level node visits,
    tiles entered, quadtree nodes decoded, leaves tested and dropped
    pushes; with sizes given, which node rows and tiles were touched."""
    cnt = {"top_nodes": 0, "tiles": 0, "quad_nodes": 0, "leaves": 0,
           "drops": 0, "node_touched": None, "tile_touched": None}
    if num_nodes is not None:
        cnt["node_touched"] = torch.zeros(num_nodes, dtype=torch.bool,
                                          device=device)
        cnt["tile_touched"] = torch.zeros(num_tiles, dtype=torch.bool,
                                          device=device)
    return cnt


def _tables(device):
    return tuple(torch.from_numpy(t).to(device)
                 for t in (TABLE_BORDER, TABLE_MID, TABLE_Z))


def decode_com(xz, x, yz, y, blo, bhi, tables):
    """getNode for the 4-byte 'com' node: four child boxes (k, 4, 3) from
    the byte values (k,) and the parent box (k, 3); children in Morton
    order 0=(0,0) 1=(1,0) 2=(0,1) 3=(1,1)."""
    tb, tm, tz = tables
    xz, x, yz, y = xz.long(), x.long(), yz.long(), y.long()
    x1 = tb[(xz >> 5) & 7]
    x2 = tm[(xz >> 2) & 7]
    x3 = tm[(x >> 5) & 7]
    x4 = tb[(x >> 2) & 7]
    y1 = tb[(yz >> 5) & 7]
    y2 = tm[(yz >> 2) & 7]
    y3 = tm[(y >> 5) & 7]
    y4 = tb[(y >> 2) & 7]
    z1 = tz[xz & 3]
    z2 = tz[yz & 3]
    return _shared_planes(x1, x2, x3, x4, y1, y2, y3, y4, z1, z2, blo, bhi)


def _shared_planes(x1, x2, x3, x4, y1, y2, y3, y4, z1, z2, blo, bhi):
    blx, bly, blz = blo.unbind(1)
    dimx, dimy, dimz = (bhi - blo).unbind(1)
    l0x = blx + x1 * dimx
    h0x = blx + (1 - x3) * dimx
    l1x = blx + x2 * dimx
    h1x = blx + (1 - x4) * dimx
    l0y = bly + y1 * dimy
    h0y = bly + (1 - y3) * dimy
    l1y = bly + y2 * dimy
    h1y = bly + (1 - y4) * dimy
    lz = blz + z1 * dimz
    hz = blz + (1 - z2) * dimz
    lo = torch.stack([torch.stack([l0x, l1x, l0x, l1x], 1),
                      torch.stack([l0y, l0y, l1y, l1y], 1),
                      torch.stack([lz, lz, lz, lz], 1)], 2)
    hi = torch.stack([torch.stack([h0x, h1x, h0x, h1x], 1),
                      torch.stack([h0y, h0y, h1y, h1y], 1),
                      torch.stack([hz, hz, hz, hz], 1)], 2)
    return lo, hi


def _decode_mid(xz, yz, blo, bhi, tables):
    """2-byte 'mid' node: inner planes only, outer planes the parent's."""
    _tb, tm, tz = tables
    zero = torch.zeros_like(blo[:, 0])
    xz, yz = xz.long(), yz.long()
    x2 = tm[(xz >> 5) & 7]
    x3 = tm[(xz >> 2) & 7]
    y2 = tm[(yz >> 5) & 7]
    y3 = tm[(yz >> 2) & 7]
    return _shared_planes(zero, x2, x3, zero, zero, y2, y3, zero,
                          tz[xz & 3], tz[yz & 3], blo, bhi)


def _decode_non(node, blo, bhi, tables):
    """8-byte 'non' node: a byte pair (xz, yz) of independent planes per
    child, border table on the outer plane of each quadrant, mid table on
    the inner."""
    tb, tm, tz = tables
    dim = bhi - blo
    los, his = [], []
    for c in range(4):
        qx, qy = c & 1, (c >> 1) & 1
        xz, yz = node[:, 2 * c].long(), node[:, 2 * c + 1].long()
        t_minx, t_maxx = (tm, tb) if qx else (tb, tm)
        t_miny, t_maxy = (tm, tb) if qy else (tb, tm)
        los.append(torch.stack([t_minx[(xz >> 5) & 7], t_miny[(yz >> 5) & 7],
                                tz[xz & 3]], 1))
        his.append(torch.stack([1 - t_maxx[(xz >> 2) & 7],
                                1 - t_maxy[(yz >> 2) & 7],
                                1 - tz[yz & 3]], 1))
    lo = torch.stack(los, 1) * dim[:, None] + blo[:, None]
    hi = torch.stack(his, 1) * dim[:, None] + blo[:, None]
    return lo, hi


class UnpackedSource:
    """Tile source over a `CompressedAccel` as it is built: every mode
    ('box', 'leaf', 'grid', 'full') and node flavor ('com', 'non', 'mid')."""

    def __init__(self, accel: CompressedAccel):
        top, tiles = accel.top, accel.tiles
        if top is None:
            raise ValueError("the accel keeps only its ids (ids_only): walk "
                             "its compact form (traverse/cbvh_kernel.py)")
        if top.width != 4:
            raise ValueError("the compressed accel's top level is a BVH4")
        if not 1 <= tiles.comp_level <= MAX_COMP_LEVEL:
            raise ValueError(f"compression level {tiles.comp_level}")
        self.top = top
        self.tiles = tiles
        self.mode = tiles.mode
        self.comp_level = tiles.comp_level
        self.tile_of_leaf = top.prim_order
        T = tiles.num_tiles
        self.hdr = torch.cat([
            tiles.space.reshape(T, 9), tiles.proj.reshape(T, 9),
            tiles.iproj.reshape(T, 9), tiles.frustum, tiles.uv0, tiles.uvd,
            tiles.extent[:, None]], 1)
        self.top_depth = tree_depth(top.child.cpu().numpy(),
                                    top.count.cpu().numpy())
        self._tables = _tables(tiles.space.device)

    def top_node(self, node):
        """(lo_x, lo_y, lo_z, hi_x, hi_y, hi_z, child, count), each (k, 4)."""
        lo, hi = self.top.lower[node], self.top.upper[node]
        return (lo[:, :, 0], lo[:, :, 1], lo[:, :, 2],
                hi[:, :, 0], hi[:, :, 1], hi[:, :, 2],
                self.top.child[node], self.top.count[node])

    def children(self, ti, curr, blo, bhi):
        tiles = self.tiles
        if tiles.mode == "full":
            f = tiles.nodes_full[ti, curr]
            return f[:, :, 0:3], f[:, :, 3:6]
        node = tiles.nodes[ti, curr]
        if tiles.flavor == "non":
            return _decode_non(node, blo, bhi, self._tables)
        if tiles.flavor == "mid":
            return _decode_mid(node[:, 0], node[:, 1], blo, bhi, self._tables)
        return decode_com(node[:, 0], node[:, 1], node[:, 2], node[:, 3],
                          blo, bhi, self._tables)

    def leaf_z(self, ti, idx):
        z = self.tiles.leaf_z[ti, idx]
        return z[:, 0], z[:, 1]

    def grid_vertex(self, ti, ii, jj):
        return self.tiles.grid[ti, ii, jj]


def _compact(x):
    """Compact1By1: the even bits of x."""
    x = x & 0x55555555
    x = (x ^ (x >> 1)) & 0x33333333
    x = (x ^ (x >> 2)) & 0x0F0F0F0F
    x = (x ^ (x >> 4)) & 0x00FF00FF
    return (x ^ (x >> 8)) & 0x0000FFFF


def _clamp_den(a):
    return torch.where(a.abs() < RCP_EPS, torch.full_like(a, RCP_EPS), a)


def _top_slab(f, rd, ord_, tn, a):
    """Robust slab test of the four children of (k,) top-level nodes
    against rays `a`: (tmin clamped to tnear, tmax), each (k, 4)."""
    rdx, rdy, rdz = rd
    orx, ory, orz = ord_
    tx0 = f[0] * rdx[a, None] - orx[a, None]
    tx1 = f[3] * rdx[a, None] - orx[a, None]
    ty0 = f[1] * rdy[a, None] - ory[a, None]
    ty1 = f[4] * rdy[a, None] - ory[a, None]
    tz0 = f[2] * rdz[a, None] - orz[a, None]
    tz1 = f[5] * rdz[a, None] - orz[a, None]
    tmin = torch.maximum(torch.maximum(torch.minimum(tx0, tx1),
                                       torch.minimum(ty0, ty1)),
                         torch.minimum(tz0, tz1)) * ROBUST_MIN
    tmax = torch.minimum(torch.minimum(torch.maximum(tx0, tx1),
                                       torch.maximum(ty0, ty1)),
                         torch.maximum(tz0, tz1)) * ROBUST_MAX
    return torch.maximum(tmin, tn[a, None]), tmax


def _push_sorted(stacks, sp, rows, key, ok, payloads, depth, cnt):
    """Push the entries with `ok` (k, 4) onto the per-ray stacks of rays
    `rows`, far to near by `key`, the lower slot on top among equal keys.
    `stacks` and `payloads` are parallel lists: stack (n, depth, ...) and
    payload (k, 4, ...)."""
    skey, order = torch.sort(key.flip(1), dim=1, descending=True, stable=True)
    s_ok = ok.flip(1).gather(1, order)
    pos = sp[rows, None] + torch.cumsum(s_ok, dim=1) - 1
    can = s_ok & (pos < depth)
    cnt["drops"] += int((s_ok & ~can).sum())
    r = rows[:, None].expand(-1, 4)[can]
    p = pos[can]
    for stack, pay in zip(stacks, payloads):
        if pay is None:
            pay = skey
        else:
            idx = order.reshape(order.shape + (1,) * (pay.ndim - 2))
            pay = pay.flip(1).gather(1, idx.expand(-1, -1, *pay.shape[2:]))
        stack[r, p] = pay[can]
    sp[rows] += can.sum(dim=1)


class _Walk:
    """State of one lock-step batch of `walk_closest`."""

    def __init__(self, src, org, d, tn, tf, cnt):
        n, dev = tn.shape[0], tn.device
        f32 = torch.float32
        self.src, self.cnt = src, cnt
        self.o = org.unbind(1)
        self.d = d.unbind(1)
        self.rd = tuple(rcp_safe(c) for c in self.d)
        self.ord = tuple(o * r for o, r in zip(self.o, self.rd))
        self.tn = tn
        self.t = tf.clone()
        self.u = torch.zeros(n, dtype=f32, device=dev)
        self.v = torch.zeros(n, dtype=f32, device=dev)
        self.tile = torch.full((n,), -1, dtype=torch.int32, device=dev)
        cl = src.comp_level
        self.g = 1 << cl
        self.elems = (4 ** cl - 1) // 3
        self.rcp_edges = 1.0 / self.g
        # a depth-first walk holds at most 3 entries a level and one more
        self.D = 3 * src.top_depth + 1
        self.QD = 3 * cl + 1
        self.sref = torch.zeros((n, self.D), dtype=torch.int32, device=dev)
        self.sdist = torch.full((n, self.D), -math.inf, dtype=f32, device=dev)
        self.sp = torch.ones(n, dtype=torch.long, device=dev)  # root pushed
        self.qnode = torch.zeros((n, self.QD), dtype=torch.int32, device=dev)
        self.qbox = torch.zeros((n, self.QD, 6), dtype=f32, device=dev)
        self.qsp = torch.zeros(n, dtype=torch.long, device=dev)
        # per-ray state of the tile a ray is in
        self.ti = torch.zeros(n, dtype=torch.long, device=dev)
        z = lambda: torch.zeros(n, dtype=f32, device=dev)  # noqa: E731
        self.lo = [z(), z(), z()]     # local origin
        self.po = [z(), z(), z()]     # projected origin
        self.pd = [z(), z(), z()]     # projected direction
        self.prd = [z(), z(), z()]
        self.pord = [z(), z(), z()]   # po * prd
        self.near, self.zf, self.tloc = z(), z(), z()
        self.flat = torch.zeros(n, dtype=torch.bool, device=dev)

    def run(self):
        while True:
            qa = (self.qsp > 0).nonzero().squeeze(1)
            ta = ((self.qsp == 0) & (self.sp > 0)).nonzero().squeeze(1)
            if qa.numel() == 0 and ta.numel() == 0:
                break
            if qa.numel():
                self._quad_step(qa)
            if ta.numel():
                self._top_step(ta)
        return self.t, self.u, self.v, self.tile

    # ---- top level ---------------------------------------------------------
    def _top_step(self, a):
        self.sp[a] -= 1
        top = self.sp[a]
        ref = self.sref[a, top]
        keep = ~(self.sdist[a, top] > self.t[a])
        a, ref = a[keep], ref[keep]
        isnode = ref >= 0
        na = a[isnode]
        if na.numel():
            self._top_node(na, ref[isnode].long())
        ea = a[~isnode]
        if ea.numel():
            self._enter_tile(ea, -ref[~isnode].long() - 1)

    def _top_node(self, na, node):
        src, cnt = self.src, self.cnt
        cnt["top_nodes"] += na.shape[0]
        if cnt["node_touched"] is not None:
            cnt["node_touched"][node] = True
        f = src.top_node(node)
        tmin, tmax = _top_slab(f, self.rd, self.ord, self.tn, na)
        cc, cn = f[6].to(torch.int32), f[7].to(torch.int32)
        ok = (tmin <= tmax) & (tmin <= self.t[na, None]) & (cn >= 0)
        # a leaf child is one tile; a child slot that is not a leaf never
        # indexes tile_of_leaf out of range
        leaf = cn > 0
        tl = src.tile_of_leaf[torch.where(leaf, cc, 0).long()]
        cref = torch.where(leaf, -(tl + 1), cc)
        key = torch.where(ok, tmin, torch.full_like(tmin, -math.inf))
        _push_sorted([self.sref, self.sdist], self.sp, na, key, ok,
                     [cref, None], self.D, cnt)

    # ---- tile entry --------------------------------------------------------
    def _enter_tile(self, ea, ti):
        src, cnt = self.src, self.cnt
        cnt["tiles"] += ea.shape[0]
        if cnt["tile_touched"] is not None:
            cnt["tile_touched"][ti] = True
        h = src.hdr[ti, :H_WALK].unbind(1)
        ox, oy, oz = (c[ea] for c in self.o)
        dx, dy, dz = (c[ea] for c in self.d)
        t = self.t[ea]
        lox = h[0] * ox + h[1] * oy + h[2] * oz
        loy = h[3] * ox + h[4] * oy + h[5] * oz
        loz = h[6] * ox + h[7] * oy + h[8] * oz
        ldx = h[0] * dx + h[1] * dy + h[2] * dz
        ldy = h[3] * dx + h[4] * dy + h[5] * dz
        ldz = h[6] * dx + h[7] * dy + h[8] * dz

        # frustum entry (compressed_help.h:109-133)
        rdz_l = rcp_safe(ldz)
        t1z = h[27] * rdz_l - loz * rdz_l
        t2z = h[28] * rdz_l - loz * rdz_l

        def iline(p2x, p2y, p3x, p3y):
            vx = p2x - lox
            vy = p2y - loy
            lx = p3x - p2x
            ly = p3y - p2y
            den1 = _clamp_den(ly * ldx - lx * ldy)
            tt1 = (ly * vx - lx * vy) / den1
            tt2 = (ldx * vy - ldy * vx) / (-den1)
            return tt1, (tt2 >= 0.0) & (tt2 <= 1.0)

        t1x, v1x = iline(h[29], h[30], h[33], h[34])
        t2x, v2x = iline(h[31], h[32], h[35], h[36])
        t1y, v1y = iline(h[29], h[30], h[31], h[32])
        t2y, v2y = iline(h[33], h[34], h[35], h[36])
        inf = torch.full_like(t, math.inf)
        near1 = torch.minimum(
            torch.minimum(torch.where(v1x, t1x, inf),
                          torch.where(v2x, t2x, inf)),
            torch.minimum(torch.where(v1y, t1y, inf),
                          torch.where(v2y, t2y, inf)))
        far1 = torch.maximum(
            torch.maximum(torch.where(v1x, t1x, -inf),
                          torch.where(v2x, t2x, -inf)),
            torch.maximum(torch.where(v1y, t1y, -inf),
                          torch.where(v2y, t2y, -inf)))
        near = torch.maximum(torch.maximum(torch.minimum(t1z, t2z), near1),
                             self.tn[ea])
        far = torch.minimum(torch.minimum(torch.maximum(t1z, t2z), far1), t)
        alive = (near <= far) & (v1x | v2x | v1y | v2y)

        # a ray that misses the frustum leaves the tile here
        ea, ti = ea[alive], ti[alive]
        if ea.numel() == 0:
            return
        (lox, loy, loz, ldx, ldy, ldz, near, far, t) = (
            c[alive] for c in (lox, loy, loz, ldx, ldy, ldz, near, far, t))
        h = [c[alive] for c in h]

        # projected ray (compressed.h:464-505)
        def proj_pt(px, py, pz):
            w = _clamp_den(h[15] * px + h[16] * py + h[17])
            return ((h[9] * px + h[10] * py + h[11]) / w,
                    (h[12] * px + h[13] * py + h[14]) / w, pz)

        e1x, e1y, e1z = proj_pt(lox + near * ldx, loy + near * ldy,
                                loz + near * ldz)
        e2x, e2y, e2z = proj_pt(lox + far * ldx, loy + far * ldy,
                                loz + far * ldz)
        dxx, dyy, dzz = e2x - e1x, e2y - e1y, e2z - e1z
        ax, ay, az = dxx.abs(), dyy.abs(), dzz.abs()
        tiny = (ax < G_EPS) & (ay < G_EPS) & (az < G_EPS)
        flat = ~tiny & (az < G_EPS)
        dlen = torch.sqrt(dxx * dxx + dyy * dyy + dzz * dzz)
        inv = 1.0 / dlen.clamp_min(RCP_EPS)
        one = torch.ones_like(t)
        zero = torch.zeros_like(t)
        huge = torch.full_like(t, Z_HUGE)
        sgnz = torch.where(ldz >= 0, one, -one)
        pdx = torch.where(tiny, zero, dxx * inv)
        pdy = torch.where(tiny, zero, dyy * inv)
        pdz = torch.where(tiny, sgnz, dzz * inv)
        poz = torch.where(tiny, e1z - sgnz, e1z)
        zf = torch.where(tiny, huge, ldz / _clamp_den(pdz))
        tloc = torch.where(tiny, huge,
                           torch.where(flat, dlen, (t - near) * zf))

        self.ti[ea] = ti
        for dst, val in zip(self.lo, (lox, loy, loz)):
            dst[ea] = val
        for k, (o, dd) in enumerate(((e1x, pdx), (e1y, pdy), (poz, pdz))):
            r = rcp_safe(dd)
            self.po[k][ea] = o
            self.pd[k][ea] = dd
            self.prd[k][ea] = r
            self.pord[k][ea] = o * r
        self.near[ea] = near
        self.zf[ea] = zf
        self.tloc[ea] = tloc
        self.flat[ea] = flat
        # root of the quadtree: (-1, -1, z0) .. (1, 1, z1)
        self.qnode[ea, 0] = 0
        self.qbox[ea, 0] = torch.stack([-one, -one, h[27], one, one, h[28]], 1)
        self.qsp[ea] = 1

    # ---- quadtree ----------------------------------------------------------
    def _slab(self, a, lo, hi):
        """Slab test in the projected frame: lo/hi are tuples (x, y, z) of
        (k,) or (k, 4) tensors for rays `a`; tmin clamped to 0."""
        ex = (lambda c: c[:, None]) if lo[0].ndim == 2 else (lambda c: c)
        t0, t1 = [], []
        for k in range(3):
            prd, pord = ex(self.prd[k][a]), ex(self.pord[k][a])
            t0.append(lo[k] * prd - pord)
            t1.append(hi[k] * prd - pord)
        tmin = torch.maximum(
            torch.maximum(torch.minimum(t0[0], t1[0]),
                          torch.minimum(t0[1], t1[1])),
            torch.minimum(t0[2], t1[2])) * ROBUST_MIN
        tmax = torch.minimum(
            torch.minimum(torch.maximum(t0[0], t1[0]),
                          torch.maximum(t0[1], t1[1])),
            torch.maximum(t0[2], t1[2])) * ROBUST_MAX
        return tmin.clamp_min(0.0), tmax

    def _quad_step(self, a):
        self.qsp[a] -= 1
        top = self.qsp[a]
        curr = self.qnode[a, top].long()
        box = self.qbox[a, top]
        isleaf = curr >= self.elems
        ia = a[~isleaf]
        if ia.numel():
            self._inner(ia, curr[~isleaf], box[~isleaf])
        la = a[isleaf]
        if la.numel():
            self._leaf(la, curr[isleaf] - self.elems, box[isleaf])

    def _inner(self, ia, curr, box):
        cnt = self.cnt
        cnt["quad_nodes"] += ia.shape[0]
        lo, hi = self.src.children(self.ti[ia], curr, box[:, 0:3],
                                   box[:, 3:6])
        tmin, tmax = self._slab(ia, lo.unbind(2), hi.unbind(2))
        ok = (tmin <= tmax) & (tmin <= self.tloc[ia, None])
        key = torch.where(ok, tmin, torch.full_like(tmin, -math.inf))
        child = (curr[:, None] * 4 + 1
                 + torch.arange(4, device=curr.device)).to(torch.int32)
        _push_sorted([self.qnode, self.qbox], self.qsp, ia, key, ok,
                     [child, torch.cat([lo, hi], 2)], self.QD, cnt)

    def _world_t(self, a, th):
        """Local distance back to world distance (:583-590, :648-656)."""
        h = self.src.hdr[self.ti[a], H_IPROJ:H_IPROJ + 9].unbind(1)
        px = self.po[0][a] + th * self.pd[0][a]
        py = self.po[1][a] + th * self.pd[1][a]
        pz = self.po[2][a] + th * self.pd[2][a]
        w = _clamp_den(h[6] * px + h[7] * py + h[8])
        ux = (h[0] * px + h[1] * py + h[2]) / w
        uy = (h[3] * px + h[4] * py + h[5]) / w
        fx = ux - self.lo[0][a]
        fy = uy - self.lo[1][a]
        fz = pz - self.lo[2][a]
        flat_t = torch.sqrt(fx * fx + fy * fy + fz * fz)
        return torch.where(self.flat[a], flat_t, th / self.zf[a] + self.near[a])

    def _commit(self, a, hit, t, cu, cv, tloc):
        ha = a[hit]
        self.t[ha] = t[hit]
        self.u[ha] = cu[hit]
        self.v[ha] = cv[hit]
        self.tile[ha] = self.ti[ha].to(torch.int32)
        self.tloc[ha] = tloc[hit]

    def _leaf(self, la, idx, box):
        self.cnt["leaves"] += la.shape[0]
        mode = self.src.mode
        imx, imy = _compact(idx), _compact(idx >> 1)
        mx, my = imx.to(torch.float32), imy.to(torch.float32)
        if mode == "grid":
            self._leaf_grid(la, imx, imy, mx, my)
            return
        blx, bly, blz, bhx, bhy, bhz = box.unbind(1)
        tmin, tmax = self._slab(la, (blx, bly, blz), (bhx, bhy, bhz))
        box_ok = (tmin <= tmax) & (tmin <= self.tloc[la])
        pox, poy, poz = (c[la] for c in self.po)
        pdx, pdy, pdz = (c[la] for c in self.pd)
        if mode in ("box", "full"):
            dimx = (bhx - blx).clamp_min(RCP_EPS)
            dimy = (bhy - bly).clamp_min(RCP_EPS)
            cu = ((pox + pdx * tmin - blx) / dimx + mx) * self.rcp_edges
            cv = ((poy + pdy * tmin - bly) / dimy + my) * self.rcp_edges
            self._commit(la, box_ok, self._world_t(la, tmin), cu, cv, tmin)
            return
        # 'leaf': pizza box, four 4-bit corner heights and a shared extent
        ti = self.ti[la]
        z12, z34 = self.src.leaf_z(ti, idx)
        dimz = bhz - blz
        ext = self.src.hdr[ti, H_EXTENT]
        rng = (1.0 + 2.0 * ext) * dimz
        off = blz - dimz * ext
        rf = rng * (1.0 / 16.0)
        z1 = off + rf * ((z12 >> 4) & 15).to(torch.float32)
        z2 = off + rf * (z12 & 15).to(torch.float32)
        z3 = off + rf * ((z34 >> 4) & 15).to(torch.float32)
        z4 = off + rf * (z34 & 15).to(torch.float32)
        dz = rf
        p1x, p1y, p1z = pox + tmin * pdx, poy + tmin * pdy, poz + tmin * pdz
        p2x, p2y, p2z = pox + tmax * pdx, poy + tmax * pdy, poz + tmax * pdz
        lenx = 1.0 / (bhx - blx).clamp_min(RCP_EPS)
        leny = 1.0 / (bhy - bly).clamp_min(RCP_EPS)
        fx1, fy1 = (p1x - blx) * lenx, (p1y - bly) * leny
        fx2, fy2 = (p2x - blx) * lenx, (p2y - bly) * leny
        degen = (tmax - tmin) < DEGEN_EPS
        za1 = z1 * (1 - fx1) * (1 - fy1) + z2 * fx1 * (1 - fy1) \
            + z3 * (1 - fx1) * fy1 + z4 * fx1 * fy1
        za2 = z1 * (1 - fx2) * (1 - fy2) + z2 * fx2 * (1 - fy2) \
            + z3 * (1 - fx2) * fy2 + z4 * fx2 * fy2
        between = (p1z >= za1) & (p1z <= za1 + dz)
        above = p1z > za1 + dz
        z1s = torch.where(above, za1 + dz, za1)
        z2s = torch.where(above, za2 + dz, za2)
        alpha = p2z - z2s
        beta = z1s - p1z
        den = _clamp_den(alpha + beta)
        tsec = (tmin * alpha + tmax * beta) / den
        dfr = (tsec - tmin) / (tmax - tmin).clamp_min(RCP_EPS)
        sec_ok = (tsec < self.tloc[la]) & (tsec >= tmin) & (tsec <= tmax)
        first = degen | between
        th = torch.where(first, tmin, tsec)
        hit = box_ok & (first | sec_ok)
        fxh = torch.where(first, fx1, fx1 + (fx2 - fx1) * dfr)
        fyh = torch.where(first, fy1, fy1 + (fy2 - fy1) * dfr)
        cu = (fxh + mx) * self.rcp_edges
        cv = (fyh + my) * self.rcp_edges
        self._commit(la, hit, self._world_t(la, th), cu, cv, th)

    def _leaf_grid(self, la, imx, imy, mx, my):
        """Two triangles of WORLD-space vertices against the WORLD ray
        (compressed.h:591-610)."""
        ti = self.ti[la]
        gv = self.src.grid_vertex
        v0 = gv(ti, imx, imy)
        v1 = gv(ti, imx + 1, imy)
        v2 = gv(ti, imx, imy + 1)
        v3 = gv(ti, imx + 1, imy + 1)
        org = torch.stack([c[la] for c in self.o], 1)
        d = torch.stack([c[la] for c in self.d], 1)
        tn, t = self.tn[la], self.t[la]
        ok1, t1, u1, vv1, _ = intersect_triangle(org, d, tn, t, v0, v1, v2)
        ok2, t2, u2, vv2, _ = intersect_triangle(org, d, tn, t, v3, v2, v1)
        use2 = ok2 & (~ok1 | (t2 < t1))
        okg = ok1 | ok2
        tg = torch.where(use2, t2, t1)
        ug = torch.where(use2, mx + 1.0 - u2, mx + u1) * self.rcp_edges
        vg = torch.where(use2, my + 1.0 - vv2, my + vv1) * self.rcp_edges
        self._commit(la, okg, tg, ug, vg,
                     (tg - self.near[la]) * self.zf[la])


def walk_closest(src, org, d, tn, tf, cnt):
    """Closest hit of flat rays over tile source `src`: (t, tile-local u,
    tile-local v, tile), PLAIN_CHUNK rays at a time; `cnt` (see
    `new_counters`) is added to."""
    outs = ([], [], [], [])
    for s in range(0, max(tn.shape[0], 1), PLAIN_CHUNK):
        e = s + PLAIN_CHUNK
        for acc, x in zip(outs, _Walk(src, org[s:e], d[s:e], tn[s:e],
                                      tf[s:e], cnt).run()):
            acc.append(x)
    return tuple(torch.cat(x) for x in outs)


def walk_occluded(src, org, d, tn, tf, cnt):
    """Conservative occlusion of flat rays over the top level of tile
    source `src`: a ray is occluded when its slab test reaches a leaf
    child's box (`tmin <= tmax`, `tmin <= tfar`). Per ray a stack of inner
    nodes, the root first; a node's inner children that are reached are
    pushed in slot order. Returns bool (R,); adds node visits to `cnt`."""
    n, dev = tn.shape[0], tn.device
    o = org.unbind(1)
    rd = tuple(rcp_safe(c) for c in d.unbind(1))
    ord_ = tuple(a * b for a, b in zip(o, rd))
    D = 3 * src.top_depth + 1
    occ = torch.zeros(n, dtype=torch.bool, device=dev)
    stack = torch.zeros((n, D), dtype=torch.int32, device=dev)
    sp = torch.ones(n, dtype=torch.long, device=dev)
    while True:
        a = (sp > 0).nonzero().squeeze(1)
        if a.numel() == 0:
            break
        sp[a] -= 1
        node = stack[a, sp[a]].long()
        cnt["top_nodes"] += a.shape[0]
        if cnt["node_touched"] is not None:
            cnt["node_touched"][node] = True
        f = src.top_node(node)
        tmin, tmax = _top_slab(f, rd, ord_, tn, a)
        cc, cn = f[6].to(torch.int32), f[7].to(torch.int32)
        hit = (tmin <= tmax) & (tmin <= tf[a, None])
        found = (hit & (cn > 0)).any(dim=1)
        occ[a[found]] = True
        sp[a[found]] = 0
        a, hit, cc, cn = a[~found], hit[~found], cc[~found], cn[~found]
        push = hit & (cn == 0)
        pos = sp[a, None] + torch.cumsum(push, dim=1) - 1
        can = push & (pos < D)
        cnt["drops"] += int((push & ~can).sum())
        stack[a[:, None].expand(-1, 4)[can], pos[can]] = cc[can]
        sp[a] += can.sum(dim=1)
    return occ


def _flat(rays: Rays, t_in=None):
    tf = rays.tfar if t_in is None else t_in
    return (rays.org.reshape(-1, 3), rays.dir.reshape(-1, 3),
            rays.tnear.reshape(-1), tf.reshape(-1))


def remap_uv(uv0, uvd, u, v, tile):
    """Tile-local uv -> patch uv (:570-571); 0 where no tile was hit."""
    ti = tile.clamp_min(0).long()
    hit = tile >= 0
    zero = torch.zeros_like(u)
    return (torch.where(hit, uv0[ti, 0] + u * uvd[ti, 0], zero),
            torch.where(hit, uv0[ti, 1] + v * uvd[ti, 1], zero))


def intersect_compressed(accel: CompressedAccel, rays: Rays,
                         t_in=None) -> _CHit:
    """Closest hit over the compressed accel in torch ops, for every mode
    and node flavor; flat over rays. `t_in` seeds the per-ray tfar (the
    fold after the triangle accel)."""
    org, d, tn, tf = _flat(rays, t_in)
    t, u, v, tile = walk_closest(UnpackedSource(accel), org, d, tn, tf,
                                 new_counters())
    u, v = remap_uv(accel.tiles.uv0, accel.tiles.uvd, u, v, tile)
    return _CHit(t=t, u=u, v=v, tile=tile)


def occluded_compressed(accel: CompressedAccel, rays: Rays) -> torch.Tensor:
    """Conservative occlusion in torch ops: bool of the rays' batch shape."""
    org, d, tn, tf = _flat(rays)
    occ = walk_occluded(UnpackedSource(accel), org, d, tn, tf, new_counters())
    return occ.reshape(rays.batch_shape)


def compressed_hits(accel: CompressedAccel, rays: Rays, st: _CHit) -> Hits:
    """Convert tile-hit state to Hits (Ng = dummy (1,0,0), compressed.h
    :574 — consumers use smooth normals via interpolate_subdiv)."""
    shape = rays.batch_shape
    valid = st.tile >= 0
    ti = st.tile.clamp_min(0).long()
    ng = torch.zeros(st.t.shape + (3,), dtype=torch.float32,
                     device=st.t.device)
    ng[:, 0] = valid.to(torch.float32)
    minus = torch.full_like(st.tile, -1)
    zero = torch.zeros_like(st.t)
    return Hits(
        t=torch.where(valid, st.t, rays.tfar.reshape(-1)).reshape(shape),
        u=torch.where(valid, st.u, zero).reshape(shape),
        v=torch.where(valid, st.v, zero).reshape(shape),
        ng=ng.reshape(shape + (3,)),
        prim_id=torch.where(valid, accel.tiles.prim_id[ti], minus).reshape(shape),
        geom_id=torch.where(valid, accel.tiles.geom_id[ti], minus).reshape(shape),
        gprim=minus.reshape(shape),
        inst_id=minus.clone().reshape(shape),
    )
