"""BVH4 / BVH8 traversal over the packed scene: the kernel's wrapper, its
plain version and the scene packer.

Counterpart of embree_tpu/traverse/pallas_packet.py. `pack_scene` lays
the wide BVH of build/sah.py out exactly as the JAX package does (`PackedScene`
is its `PallasScene`): one 128-float row per node with 8 stride-W fields
[lo_x lo_y lo_z hi_x hi_y hi_z child count], triangles in BVH leaf order,
10 per 128-float row as [v0 e1 e2 Ng] (e1 = v0 - v1, e2 = v2 - v0,
Ng = e2 x e1) plus one pad row, and `bvh_to_orig` from BVH slot to
flattened prim index.

`compact_scene` cuts those rows to what the kernel reads (`CompactScene`,
the form a committed scene holds on the device): node records of the 8W
used floats (128 bytes for BVH4, 256 for BVH8) back to back, and
triangle records of 12 floats (three float4s) back to back in BVH order.
Every word is the one it came from, but a node's child fields: each
holds, as int32 bits, the ref the walk pushes for that child
(`push_refs`: the node index, -((start << 4 | count) + 1) for a leaf,
INT32_MIN for an empty slot), which spares the kernel W float-to-int
conversions a node.

`intersect_packet_kernel`, `intersect_packet_kernel_raw` and
`occluded_packet_kernel` are the entries. On CUDA tensors they launch the
hand-written kernel `csrc/packet.cu` (built and loaded at first use by
core/nvcc.py) over the compact form or raise; on CPU tensors they run
`packet_plain`, the same per-ray function written with masked tensor ops
over an (R, D) stack, over either form. Both compute, for every ray on
its own:

  * a stack of (ref, entry distance) with the root first; a popped entry
    is skipped when its entry distance exceeds the ray's current t;
  * a node's W children slab-tested in slot order against the current t;
    the ones hit, inner nodes and leaves alike, pushed far to near by the
    ray's own entry distance, the lower slot on top among equal
    distances;
  * a leaf's triangles (at most 8) in slot order; `t_s <= |den| * t`
    accepts, so a later candidate at equal t replaces an earlier one;
  * with masks, a hit stands only where (prim_mask[p] & ray_mask) != 0;
  * any-hit rays (`occluded`) stop at their first hit: t = -inf, no prim.

A ray with tfar = -inf costs one node visit. The order of visits depends
on the ray alone, so the result does not depend on how rays are grouped,
and the kernel (built with `-fmad=false`) and the plain version agree
bit for bit. The JAX package's kernel orders children by the nearest ray
of a whole packet instead, so against it `t` and the valid mask are the
contract and `prim` may differ where two triangles tie on t.

Not carried over from the JAX package, because they belong to its
schedule and not to the function: the packet tiles and their padding,
the grid buckets, the VMEM/HBM switch, the pop width and the iteration
cap.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..build.bvh import BVHArraysNP
from ..core.math import (ROBUST_MAX_RCP as ROBUST_MAX,
                         ROBUST_MIN_RCP as ROBUST_MIN, rcp_safe)
from ..core.nvcc import check_tensor, load_library
from ..core.rayhit import Hits, Rays
from ..core.stats import instance as _stat_instance, stats_enabled
from ..scene.prims import TrianglePrims
from .moeller import DEN_MIN
from .packet import _finalize_hits

NT_PER_ROW = 10                 # tris per row (10 x 12 floats + 8 pad)
TRI_FLOATS = 12
MAX_LEAF = 8                    # builder max_leaf_size must stay <= 11
MAX_DEPTH = 64                  # levels the kernel's compiled stack serves
EMPTY = -2 ** 31                # pushed ref of an empty child slot
PLAIN_CHUNK = 65536             # rays per lock-step batch of the plain version

KERNEL_NAME = "packet"          # csrc/packet.cu -> _build/libpacket.so

# number of kernel launches made by this module (plain-version calls do
# not count); a caller that wants to know whether a path went through
# the kernel sets it to 0 before and reads it after
launches = 0


class PackedScene(NamedTuple):
    """The packed accel produced at commit time."""

    nodes: torch.Tensor        # (M, 128) f32 node rows
    tdata: torch.Tensor        # (ceil(T/10)+1, 128) f32 leaf rows
    bvh_to_orig: torch.Tensor  # (T,) i32 BVH slot -> flattened prim index
    num_nodes: int
    num_prims: int
    width: int
    depth: int                 # levels of nodes, the root being level 1
    prim_mask: Optional[torch.Tensor] = None  # (T,) i32 geometry mask, BVH order

    @property
    def device_bytes(self) -> int:
        n = 4 * (self.nodes.numel() + self.tdata.numel()
                 + self.bvh_to_orig.numel())
        return n + (4 * self.prim_mask.numel()
                    if self.prim_mask is not None else 0)


class CompactScene(NamedTuple):
    """The compact device form of a packed scene (`compact_scene`), what
    the kernel reads and a committed scene holds."""

    nodes: torch.Tensor        # (M, 8W) f32 node records, child fields
                               # holding pushed refs as int32 bits
    tdata: torch.Tensor        # (max(T, 1), 12) f32 triangle records
    bvh_to_orig: torch.Tensor  # (T,) i32 BVH slot -> flattened prim index
    num_nodes: int
    num_prims: int
    width: int
    depth: int                 # levels of nodes, the root being level 1
    prim_mask: Optional[torch.Tensor] = None  # (T,) i32 geometry mask, BVH order

    @property
    def device_bytes(self) -> int:
        n = 4 * (self.nodes.numel() + self.tdata.numel()
                 + self.bvh_to_orig.numel())
        return n + (4 * self.prim_mask.numel()
                    if self.prim_mask is not None else 0)


def leaf_rows(num_prims: int) -> int:
    """Leaf rows of the JAX package's layout: ten triangles a row and one
    pad row. The counting build counts the rows it touches in these
    units in either form."""
    return -(-max(num_prims, 1) // NT_PER_ROW) + 1


def tree_depth(child: np.ndarray, count: np.ndarray) -> int:
    """Levels of nodes below and including the root (node 0)."""
    depth = 0
    frontier = np.zeros(1, np.int64)
    while frontier.size:
        depth += 1
        frontier = child[frontier][count[frontier] == 0].astype(np.int64)
    return depth


def pack_scene(bvh: BVHArraysNP, host_tris, device,
               prim_mask=None) -> PackedScene:
    """Repack the host BVH (build/sah.py) into the kernel's row layout
    (host numpy, the JAX package's bytes) and upload it. Works for any
    node width W <= 16; the kernel serves 4 and 8. `host_tris` is
    (v0, v1, v2) as numpy arrays in flattened prim order; `prim_mask`
    (T_flat,) i32, when given, is the per-prim geometry mask in the same
    order and is stored in BVH order."""
    device = torch.device(device)
    lower = np.asarray(bvh.lower)    # (M, W, 3)
    upper = np.asarray(bvh.upper)
    child = np.asarray(bvh.child)    # (M, W)
    count = np.asarray(bvh.count)
    order = np.asarray(bvh.prim_order).astype(np.int32)
    M, W = child.shape

    rows = np.zeros((M, 128), np.float32)
    for a in range(3):
        rows[:, W * a: W * a + W] = lower[:, :, a]
        rows[:, W * (3 + a): W * (3 + a) + W] = upper[:, :, a]
    rows[:, 6 * W: 7 * W] = child.astype(np.float32)
    rows[:, 7 * W: 8 * W] = count.astype(np.float32)

    # triangles in BVH order, 10 per row, +1 pad row so that the two rows
    # a leaf may span always exist
    T = order.shape[0]
    td = np.zeros((max(T, 1), TRI_FLOATS), np.float32)
    if T:
        p0, p1, p2 = (np.asarray(v, np.float32)[order] for v in host_tris)
        e1 = p0 - p1
        e2 = p2 - p0
        td[:, 0:3] = p0
        td[:, 3:6] = e1
        td[:, 6:9] = e2
        td[:, 9:12] = np.cross(e2, e1)
    nrow = -(-td.shape[0] // NT_PER_ROW)
    pad_prims = nrow * NT_PER_ROW - td.shape[0]
    td = np.concatenate([td, np.zeros((pad_prims, TRI_FLOATS), np.float32)])
    tdata = np.pad(td.reshape(nrow, NT_PER_ROW * TRI_FLOATS),
                   ((0, 1), (0, 128 - NT_PER_ROW * TRI_FLOATS)))

    pm = None
    if prim_mask is not None:
        pm = torch.from_numpy(np.ascontiguousarray(
            np.asarray(prim_mask, np.int32)[order])).to(device)
    return PackedScene(
        nodes=torch.from_numpy(rows).to(device),
        tdata=torch.from_numpy(tdata).to(device),
        bvh_to_orig=torch.from_numpy(order).to(device),
        num_nodes=M, num_prims=int(T), width=W,
        depth=tree_depth(child, count), prim_mask=pm)


def push_refs(child: np.ndarray, count: np.ndarray) -> np.ndarray:
    """The ref the walk pushes for each child slot, (M, W) i32: the node
    index for an inner child (count 0), -((start << 4 | count) + 1) for a
    leaf (count 1..15, `start` its first triangle), EMPTY for an empty
    slot (count < 0)."""
    child = child.astype(np.int64)
    count = count.astype(np.int64)
    if (count > 15).any():
        raise ValueError("a leaf of more than 15 triangles")
    leaf = -(((child << 4) | count) + 1)
    return np.where(count > 0, leaf,
                    np.where(count == 0, child, EMPTY)).astype(np.int32)


def compact_scene(ps: PackedScene, device=None) -> CompactScene:
    """`pack_scene`'s rows cut to the compact form (host numpy, then
    uploaded to `device`, by default the rows' own): the 8W used floats
    of each node row with the child fields replaced by `push_refs`, and
    the 12 floats of each triangle, back to back in BVH order."""
    device = ps.nodes.device if device is None else torch.device(device)
    W, T = ps.width, ps.num_prims
    nodes = ps.nodes.cpu().numpy()[:, :8 * W].copy()
    nodes[:, 6 * W:7 * W] = push_refs(nodes[:, 6 * W:7 * W],
                                      nodes[:, 7 * W:8 * W]).view(np.float32)
    td = ps.tdata.cpu().numpy()[:, :NT_PER_ROW * TRI_FLOATS]
    tris = td.reshape(-1, TRI_FLOATS)[:max(T, 1)]

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return CompactScene(
        nodes=up(nodes), tdata=up(tris), bvh_to_orig=ps.bvh_to_orig.to(device),
        num_nodes=ps.num_nodes, num_prims=T, width=W, depth=ps.depth,
        prim_mask=None if ps.prim_mask is None else ps.prim_mask.to(device))


# ---------------------------------------------------------------------------
# wrapper
# ---------------------------------------------------------------------------

def _load_kernel():
    lib = load_library(KERNEL_NAME)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.packet_launch.restype = i
    lib.packet_launch.argtypes = [
        p, p, i, i, p, p,                         # scene, masks
        p, p, p, p, ctypes.c_longlong,            # rays
        p, p, i, i,                               # out, variant
        p, p, p, p]                               # stats, stream
    lib.packet_max_depth.restype = i
    lib.packet_max_depth.argtypes = []
    lib.packet_error_string.restype = ctypes.c_char_p
    lib.packet_error_string.argtypes = [i]
    return lib


def _checked_inputs(ps: CompactScene, rays: Rays, ray_mask,
                    plain: bool = False):
    """Flat ray tensors and masks after the checks both versions share.
    `ps` is the compact form; the plain version (`plain`) also walks
    `pack_scene`'s rows, which the tests hold against the JAX package."""
    if not isinstance(ps, CompactScene) and not plain:
        raise ValueError("the kernel reads the compact form: "
                         "compact_scene(packed)")
    device = ps.nodes.device
    f32, i32 = torch.float32, torch.int32
    if ps.width not in (4, 8):
        raise ValueError(f"node width {ps.width}: the kernel serves 4 and 8")
    if not 1 <= ps.depth <= MAX_DEPTH:
        raise ValueError(
            f"tree of {ps.depth} levels: the kernel's stack serves at most "
            f"{MAX_DEPTH}")
    if isinstance(ps, CompactScene):
        check_tensor("nodes", ps.nodes, device, f32,
                     (ps.num_nodes, 8 * ps.width))
        check_tensor("tdata", ps.tdata, device, f32,
                     (max(ps.num_prims, 1), TRI_FLOATS))
    else:
        check_tensor("nodes", ps.nodes, device, f32, (ps.num_nodes, 128))
        check_tensor("tdata", ps.tdata, device, f32,
                     (leaf_rows(ps.num_prims), 128))
    check_tensor("bvh_to_orig", ps.bvh_to_orig, device, i32, (ps.num_prims,))
    R = rays.tnear.numel()
    org = rays.org.reshape(-1, 3)
    d = rays.dir.reshape(-1, 3)
    tn = rays.tnear.reshape(-1)
    tf = rays.tfar.reshape(-1)
    check_tensor("rays.org", org, device, f32, (R, 3))
    check_tensor("rays.dir", d, device, f32, (R, 3))
    check_tensor("rays.tnear", tn, device, f32, (R,))
    check_tensor("rays.tfar", tf, device, f32, (R,))
    pm = None
    if ray_mask is not None:
        if ps.prim_mask is None:
            raise ValueError("ray_mask given, but the packed scene carries "
                             "no prim_mask")
        pm = ps.prim_mask
        check_tensor("prim_mask", pm, device, i32, (ps.num_prims,))
        check_tensor("ray_mask", ray_mask, device, i32, (R,))
    return org, d, tn, tf, pm, ray_mask


class _StatBuffers(NamedTuple):
    counters: torch.Tensor      # i64[4]: nodes, tris, drops, leaves
    node_touched: torch.Tensor  # i32[M]
    row_touched: torch.Tensor   # i32[leaf_rows]


def _launch(ps: CompactScene, org, d, tn, tf, pm, rm, occluded: bool,
            cull: bool, stats: Optional[_StatBuffers]):
    """Launch the kernel on the current stream: (t, prim in BVH order)."""
    global launches
    lib = _load_kernel()
    if ps.depth > lib.packet_max_depth():
        raise ValueError(f"tree of {ps.depth} levels exceeds the compiled "
                         f"stack ({lib.packet_max_depth()} levels)")
    R = tn.shape[0]
    t = torch.empty(R, dtype=torch.float32, device=tn.device)
    prim = torch.empty(R, dtype=torch.int32, device=tn.device)

    def ptr(a):
        return None if a is None else a.data_ptr()

    with torch.cuda.device(tn.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.packet_launch(
            ps.nodes.data_ptr(), ps.tdata.data_ptr(), ps.width, ps.depth,
            ptr(pm), ptr(rm),
            org.data_ptr(), d.data_ptr(), tn.data_ptr(), tf.data_ptr(), R,
            t.data_ptr(), prim.data_ptr(), int(occluded), int(cull),
            ptr(stats and stats.counters), ptr(stats and stats.node_touched),
            ptr(stats and stats.row_touched), stream)
    launches += 1
    if err != 0:
        msg = lib.packet_error_string(err).decode()
        raise RuntimeError(f"packet kernel launch failed: {err} ({msg})")
    return t, prim


def _stats_dict(R, nodes, tris, drops, leaves, nodes_touched, rows_touched):
    return {"rays": int(R), "node_visits": int(nodes),
            "tri_tests": int(tris), "dropped_pushes": int(drops),
            "leaf_visits": int(leaves),
            "nodes_touched": int(nodes_touched),
            "rows_touched": int(rows_touched)}


def packet_trace(ps: CompactScene, rays: Rays, occluded: bool = False,
                 cull: bool = False, ray_mask=None, stats: bool = False):
    """One traversal: (t, prim in BVH order, counters or None), flat over
    rays. `prim` is -1 on a miss and for every any-hit ray; `t` is tfar
    on a miss and -inf on an any-hit ray that hit. With `stats` the
    counters of this call come back as a dict (sums over rays of node
    visits, leaf visits, triangle tests and dropped pushes; distinct
    node rows and leaf rows touched); on CUDA that launches the kernel's
    counting build, which is slower (atomics) and is not the main path.
    Carries no gradient. On CPU tensors `packet_plain` answers."""
    occluded, cull = bool(occluded), bool(cull)
    if rays.tnear.device.type == "cpu":
        out = packet_plain(ps, rays, occluded, cull, ray_mask=ray_mask,
                           stats=stats)
        return out if stats else out + (None,)
    org, d, tn, tf, pm, rm = _checked_inputs(ps, rays, ray_mask)
    if not stats:
        return _launch(ps, org, d, tn, tf, pm, rm, occluded, cull, None) \
            + (None,)
    buf = _StatBuffers(
        torch.zeros(4, dtype=torch.int64, device=tn.device),
        torch.zeros(ps.num_nodes, dtype=torch.int32, device=tn.device),
        torch.zeros(leaf_rows(ps.num_prims), dtype=torch.int32,
                    device=tn.device))
    t, prim = _launch(ps, org, d, tn, tf, pm, rm, occluded, cull, buf)
    c = buf.counters.tolist()
    return t, prim, _stats_dict(tn.shape[0], *c,
                                buf.node_touched.sum().item(),
                                buf.row_touched.sum().item())


def _record_stats(shadow: bool, st) -> None:
    """STAT3 accumulation (core/stats.py)."""
    if st is not None:
        _stat_instance().add(shadow, st["rays"],
                             [[st["node_visits"], st["tri_tests"]]])


def _to_orig(ps: CompactScene, prim_bvh):
    """BVH slot -> flattened prim index (-1 stays -1)."""
    if ps.num_prims == 0:
        return prim_bvh
    orig = ps.bvh_to_orig[prim_bvh.clamp_min(0).long()]
    return torch.where(prim_bvh >= 0, orig, torch.full_like(prim_bvh, -1))


def intersect_packet_kernel_raw(ps: CompactScene, rays: Rays,
                                cull: bool = False, ray_mask=None):
    """Kernel-only entry: flat (t, prim) in ORIGINAL (flattened) prim
    ids, without hit finalization."""
    t, prim_bvh, st = packet_trace(ps, rays, False, cull, ray_mask,
                                   stats=stats_enabled())
    _record_stats(False, st)
    return t, _to_orig(ps, prim_bvh)


def intersect_packet_kernel(ps: CompactScene, tris: TrianglePrims,
                            rays: Rays, cull: bool = False,
                            ray_mask=None) -> Hits:
    """Closest hit; u, v, Ng and the ids are recomputed from the winning
    prim outside the kernel. Keeps the rays' batch shape."""
    shape = rays.batch_shape
    flat = Rays(rays.org.reshape(-1, 3), rays.dir.reshape(-1, 3),
                rays.tnear.reshape(-1), rays.tfar.reshape(-1))
    if ray_mask is not None:
        ray_mask = ray_mask.reshape(-1)
    t, prim = intersect_packet_kernel_raw(ps, flat, cull, ray_mask)
    h = _finalize_hits(tris, flat, t, prim)
    return Hits(*(x.reshape(shape + x.shape[1:]) for x in h))


def occluded_packet_kernel(ps: CompactScene, rays: Rays, cull: bool = False,
                           ray_mask=None) -> torch.Tensor:
    """Any hit: bool tensor of the rays' batch shape."""
    if ray_mask is not None:
        ray_mask = ray_mask.reshape(-1)
    t, _prim, st = packet_trace(ps, rays, True, cull, ray_mask,
                                stats=stats_enabled())
    _record_stats(True, st)
    return (t == -math.inf).reshape(rays.batch_shape)


def traversal_stats(ps: CompactScene, rays: Rays) -> np.ndarray:
    """STAT3 analog: (1, 3) i64 [node visits, leaf triangle tests,
    dropped pushes] of one closest-hit launch over `rays` (the JAX
    package reports one such row per packet; here a launch is one)."""
    _t, _p, st = packet_trace(ps, rays, stats=True)
    return np.asarray([[st["node_visits"], st["tri_tests"],
                        st["dropped_pushes"]]], np.int64)


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def slab_tmin(lo, hi, rd, od, tn):
    """The robust slab test of boxes (k, 3, W) against rays (k, 3) with
    reciprocal directions `rd`, origins times reciprocals `od` and
    tnear `tn` (k,): (tmin, tmax) (k, W), tmin clamped to tnear; NaN
    propagates (the kernels' min.NaN / max.NaN)."""
    t0 = lo * rd[:, :, None] - od[:, :, None]
    t1 = hi * rd[:, :, None] - od[:, :, None]
    near, far = torch.minimum(t0, t1), torch.maximum(t0, t1)
    tmin = torch.maximum(torch.maximum(near[:, 0], near[:, 1]),
                         near[:, 2]) * ROBUST_MIN
    tmax = torch.minimum(torch.minimum(far[:, 0], far[:, 1]),
                         far[:, 2]) * ROBUST_MAX
    return torch.maximum(tmin, tn[:, None]), tmax


def pulled_refs(ref):
    """(child, count) of pushed refs (`push_refs`), i32 tensors."""
    v = -ref - 1
    return (torch.where(ref >= 0, ref, v >> 4),
            torch.where(ref >= 0, 0, torch.where(ref == EMPTY, -1, v & 15)))


def plain_walk(nodes, W: int, D: int, org, d, tn, tf, occluded: bool, cnt,
               leaf, children=None, max_leaf: int = MAX_LEAF,
               refs: bool = False):
    """The kernel's walk in masked tensor ops, all rays of a batch in
    lock-step, one pop per ray and step, over node rows `nodes` of width
    W behind an (R, D) stack. A popped leaf goes to `leaf(la, start,
    count, t, prim, sp)` for the rays `la` that popped one: it updates
    t, prim and (for any-hit rays that stop) sp in place. A popped node
    goes to `children(na, node, t)`, which returns (tmin, ok, child,
    count), each (k, W), for the rays `na` that popped `node`; by
    default the slab test of the node rows' 8 stride-W fields, whose
    child fields hold pushed refs (`push_refs`) when `refs` is set. A
    leaf child is pushed as -((start << 4 | count) + 1), its count cut to
    `max_leaf` when popped. Shared by
    the triangle leaves of this kernel, the curve leaves of kernel B3
    (traverse/hair_kernel.py) and the lerped boxes and triangles of
    kernel B6 (traverse/mb.py). Returns (t, prim)."""
    n = tn.shape[0]
    dev = tn.device
    rd = rcp_safe(d)
    od = org * rd
    neg_inf = torch.tensor(-math.inf, dtype=torch.float32, device=dev)

    if children is None:
        def children(na, node, t_na):
            f = nodes[node, :8 * W].view(-1, 8, W)
            tmin, tmax = slab_tmin(f[:, 0:3], f[:, 3:6], rd[na], od[na],
                                   tn[na])
            if refs:
                cc, cn = pulled_refs(f[:, 6].contiguous().view(torch.int32))
            else:
                # child and count are exact small floats in the row
                cc = f[:, 6].to(torch.int32)
                cn = f[:, 7].to(torch.int32)
            return (tmin, (tmin <= tmax) & (tmin <= t_na[:, None])
                    & (cn >= 0), cc, cn)

    t = tf.clone()
    prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    sref = torch.zeros((n, D), dtype=torch.int32, device=dev)
    sdist = torch.full((n, D), -math.inf, dtype=torch.float32, device=dev)
    sp = torch.ones((n,), dtype=torch.long, device=dev)   # root pushed

    while True:
        act = (sp > 0).nonzero().squeeze(1)
        if act.numel() == 0:
            break
        sp[act] -= 1
        top = sp[act]
        ref = sref[act, top]
        keep = ~(sdist[act, top] > t[act])
        act, ref = act[keep], ref[keep]

        # ---- inner nodes
        isnode = ref >= 0
        na = act[isnode]
        if na.numel():
            k = na.shape[0]
            cnt["nodes"] += k
            node = ref[isnode].long()
            if cnt["node_touched"] is not None:
                cnt["node_touched"][node] = True
            tmin, ok, cc, cn = children(na, node, t[na])
            cref = torch.where(cn > 0, -(((cc << 4) | cn) + 1), cc)
            key = torch.where(ok, tmin, neg_inf)
            # far to near; among equal distances the higher slot first,
            # so that the lower slot ends on top of the stack
            skey, order = torch.sort(key.flip(1), dim=1, descending=True,
                                     stable=True)
            s_ref = cref.flip(1).gather(1, order)
            s_ok = ok.flip(1).gather(1, order)
            pos = sp[na, None] + torch.cumsum(s_ok, dim=1) - 1
            can = s_ok & (pos < D)
            cnt["drops"] += int((s_ok & ~can).sum())
            rows = na[:, None].expand(-1, W)[can]
            sref[rows, pos[can]] = s_ref[can]
            sdist[rows, pos[can]] = skey[can]
            sp[na] += can.sum(dim=1)

        # ---- leaves
        la = act[~isnode]
        if la.numel():
            cnt["leaves"] += la.shape[0]
            v = -ref[~isnode].long() - 1
            leaf(la, v >> 4, (v & 15).clamp_max(max_leaf), t, prim, sp)
    return t, prim


def _plain_batch(ps: CompactScene | PackedScene, org, d, tn, tf, pm, rm,
                 occluded, cull, stack_depth, cnt):
    dev = tn.device
    ox, oy, oz = org.unbind(1)
    dx, dy, dz = d.unbind(1)
    tflat = ps.tdata.view(-1)
    fofs = torch.arange(TRI_FLOATS, device=dev)
    compact = isinstance(ps, CompactScene)

    def leaf(la, start, lcnt, t, prim, sp):
        for j in range(MAX_LEAF):
            m = j < lcnt
            if occluded:
                m &= t[la] != -math.inf
            sub = la[m]
            if sub.numel() == 0:
                break
            cnt["tris"] += sub.shape[0]
            p = start[m] + j
            trow = p // NT_PER_ROW
            if cnt["row_touched"] is not None:
                cnt["row_touched"][trow] = True
            base = (p * TRI_FLOATS if compact else
                    trow * 128 + (p - trow * NT_PER_ROW) * TRI_FLOATS)
            g = tflat[base[:, None] + fofs]                # (k, 12)
            v0x, v0y, v0z = g[:, 0], g[:, 1], g[:, 2]
            e1x, e1y, e1z = g[:, 3], g[:, 4], g[:, 5]
            e2x, e2y, e2z = g[:, 6], g[:, 7], g[:, 8]
            ngx, ngy, ngz = g[:, 9], g[:, 10], g[:, 11]
            rox, roy, roz = ox[sub], oy[sub], oz[sub]
            rdx_, rdy_, rdz_ = dx[sub], dy[sub], dz[sub]
            cx = v0x - rox
            cy = v0y - roy
            cz = v0z - roz
            rx = cy * rdz_ - cz * rdy_
            ry = cz * rdx_ - cx * rdz_
            rz = cx * rdy_ - cy * rdx_
            den = ngx * rdx_ + ngy * rdy_ + ngz * rdz_
            absden = den.abs()
            sgn = torch.where(den >= 0, 1.0, -1.0).to(den.dtype)
            u_s = (rx * e2x + ry * e2y + rz * e2z) * sgn
            v_s = (rx * e1x + ry * e1y + rz * e1z) * sgn
            t_s = (ngx * cx + ngy * cy + ngz * cz) * sgn
            front = (den < 0) if cull else (den != 0)
            # pad triangles are all zero, so den = 0: they never hit
            hit = (front & (u_s >= 0) & (v_s >= 0)
                   & (u_s + v_s <= absden) & (absden * tn[sub] < t_s)
                   & (t_s <= absden * t[sub]))
            if pm is not None:
                hit &= (pm[p] & rm[sub]) != 0
            hs = sub[hit]
            if occluded:
                t[hs] = -math.inf
                sp[hs] = 0
            else:
                t[hs] = (t_s / absden.clamp_min(DEN_MIN))[hit]
                prim[hs] = p[hit].to(torch.int32)

    return plain_walk(ps.nodes, ps.width, stack_depth, org, d, tn, tf,
                      occluded, cnt, leaf, refs=compact)


def packet_plain(ps: CompactScene | PackedScene, rays: Rays,
                 occluded: bool = False,
                 cull: bool = False, ray_mask=None, stats: bool = False,
                 stack_depth: Optional[int] = None):
    """The kernel's function in plain PyTorch ops, float32, on whatever
    device the tensors lie: all rays of a batch advance in lock-step, one
    pop per ray and step, behind an (R, D) stack tensor. Returns
    (t, prim in BVH order), and the counters dict as a third value with
    `stats`. D defaults to what a depth-first walk of this tree can need,
    (W - 1) * depth + 1; a smaller `stack_depth` drops pushes, which are
    counted. Rays are independent, so they are processed PLAIN_CHUNK at
    a time to bound memory. `ps` is a CompactScene or a PackedScene: the
    walk over either is the same, bit for bit, counters included (leaf
    rows are counted in rows of ten triangles in both)."""
    org, d, tn, tf, pm, rm = _checked_inputs(ps, rays, ray_mask, plain=True)
    dev = tn.device
    D = (ps.width - 1) * ps.depth + 1 if stack_depth is None else stack_depth
    cnt = {"nodes": 0, "tris": 0, "drops": 0, "leaves": 0,
           "node_touched": None, "row_touched": None}
    if stats:
        cnt["node_touched"] = torch.zeros(ps.num_nodes, dtype=torch.bool,
                                          device=dev)
        cnt["row_touched"] = torch.zeros(leaf_rows(ps.num_prims),
                                         dtype=torch.bool, device=dev)
    out_t = [torch.empty(0, dtype=torch.float32, device=dev)]
    out_p = [torch.empty(0, dtype=torch.int32, device=dev)]
    for s in range(0, tn.shape[0], PLAIN_CHUNK):
        e = s + PLAIN_CHUNK
        t, prim = _plain_batch(ps, org[s:e], d[s:e], tn[s:e], tf[s:e], pm,
                               None if rm is None else rm[s:e],
                               bool(occluded), bool(cull), D, cnt)
        out_t.append(t)
        out_p.append(prim)
    t, prim = torch.cat(out_t), torch.cat(out_p)
    if not stats:
        return t, prim
    return t, prim, _stats_dict(
        tn.shape[0], cnt["nodes"], cnt["tris"], cnt["drops"], cnt["leaves"],
        cnt["node_touched"].sum().item(), cnt["row_touched"].sum().item())
