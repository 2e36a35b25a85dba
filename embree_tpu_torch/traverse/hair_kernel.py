"""Kernel B3: hair clusters through BVH4 traversal with curve leaves — the
packer, the kernel's wrapper, its plain version and the finalize step.

Counterpart of embree_tpu/traverse/pallas_hair.py. `pack_hair_cluster`
tessellates a cluster's Bezier curves (in the cluster's rotated frame)
into M*K linear sub-segments, builds a SAH BVH4 over the sub-segment
bounds with leaves of at most 8, and lays it out as the JAX package does
(`PackedHair` is its `HairClusterPallas`): node rows of 128 floats with 8
stride-4 fields [lo_x lo_y lo_z hi_x hi_y hi_z child count], segments in
BVH leaf order 16 to a 128-float row as [p0 p1 r0 r1], one zero pad row,
and `seg` / `payload` (slot -> member * K + k) for the finalize step.

`pack_hair_set` concatenates a scene's clusters into one
`PackedHairSet` (node rows, segment rows, `seg`, `payload`, each
cluster's bases and 3x3 rotation), and `hair_set_trace` is the entry:
one launch walks a run of clusters of one leaf type. On CUDA tensors it
launches the hand-written kernel (csrc/packet.cu, `hair_kernel<occluded,
stats, CONE|RIBBON>` through `hair_set_launch`: kernel B2's walk as a
device function, templated on its leaf type, called once a cluster) or
raises; on CPU tensors it runs `hair_set_plain`, the same per-ray
function in masked torch ops (`hair_plain` a cluster:
traverse/packet_kernel.py::plain_walk with curve leaves). Both compute,
for every ray on its own, the clusters in order, each from the running
t, the ray rotated into the cluster's frame (products summed left to
right):

  * kernel B2's walk: a private stack of (ref, entry distance), the
    robust slab test, the children that are hit pushed far to near
    (lower slot on top among equals), a popped entry skipped when its
    distance exceeds t;
  * a leaf's segments (at most 8) in slot order through the swept-cone
    quadratic (round curves) or the ribbon closest-approach test (flat
    curves) of the JAX package's `_cone_leaf_test` / `_ribbon_leaf_test`,
    operation for operation; both accept `th < t` STRICTLY, so an
    earlier segment keeps an equal t (the triangle leaf's rule is the
    opposite);
  * the winning (t, slot within its cluster, cluster); any-hit rays stop
    at their first hit: t = -inf, no slot, no further cluster.

The kernel is built with `-fmad=false` and IEEE division and square root,
and agrees with the plain version bit for bit. `_finalize_set`
recomputes u, v, Ng and the member curve of the winning segment outside
the kernel once a launch, as the JAX package does once a cluster; the
result equals that cluster-by-cluster fold bit for bit. `hair_trace`,
`intersect_hair_kernel` and `occluded_hair_kernel` serve one cluster with
rays in its frame (the counterparts of `intersect_hair_pallas`), through
the same kernel over a set of that cluster alone without rotation.

Not carried over from the JAX package: the 32x128-ray packet tiles, the
K = 8 pops, the row DMAs, the pop-cull over a packet's largest t and its
`max_iters = 262144`, which stops a packet silently.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..build.sah import BuildSettings, build_sah
from ..core.math import cross, dot
from ..core.nvcc import check_tensor, load_library
from ..core.rayhit import Rays
from .packet_kernel import (KERNEL_NAME, MAX_DEPTH, PLAIN_CHUNK, _StatBuffers,
                            plain_walk, tree_depth)

NS_PER_ROW = 16        # segments per 128-float row (16 x 8 floats)
SEG_FLOATS = 8         # p0 p1 r0 r1
MAX_LEAF = 8           # the builder's max_leaf_size
WIDTH = 4
# clusters one launch walks: their bases and rotations fill 44 B of shared
# memory each, within the 48 KB a block gets without an opt-in
# (csrc/packet.cu MAX_HAIR_CLUSTERS)
MAX_CLUSTERS = 1024

# kernel launches by variant (plain-version calls do not count); a caller
# that wants to know whether a path went through the kernel sets them to
# 0 before and reads them after
launches = {"cone": 0, "ribbon": 0, "cone_occluded": 0,
            "ribbon_occluded": 0}


class PackedHair(NamedTuple):
    """One cluster's packed accel (in the cluster's rotated frame)."""

    nodes: torch.Tensor      # (M, 128) f32 node rows
    sdata: torch.Tensor      # (ceil(S/16)+1, 128) f32 segment rows
    seg: torch.Tensor        # (S, 8) f32 slot-ordered [p0 p1 r0 r1]
    payload: torch.Tensor    # (S,) i32 slot -> member * K + k
    num_nodes: int
    num_segments: int
    depth: int               # levels of nodes, the root being level 1
    K: int
    flat: bool

    @property
    def leaf(self) -> str:
        return "ribbon" if self.flat else "cone"

    @property
    def device_bytes(self) -> int:
        return 4 * (self.nodes.numel() + self.sdata.numel()
                    + self.seg.numel() + self.payload.numel())


def _bezier_points_np(cp, K):
    """cp (M, 4, C) -> (M, K+1, C) polyline samples."""
    t = np.linspace(0.0, 1.0, K + 1, dtype=np.float32)[None, :, None]
    cp = np.asarray(cp, np.float32)[:, :, None, :]
    b = np.stack([(1 - t) ** 3, 3 * t * (1 - t) ** 2,
                  3 * t * t * (1 - t), t ** 3], axis=0)  # (4,1,K+1,1)
    return (b[0] * cp[:, 0] + b[1] * cp[:, 1]
            + b[2] * cp[:, 2] + b[3] * cp[:, 3])


def pack_hair_arrays(rcps, rrad, K: int, builder: str = "auto"):
    """Host numpy: (nodes, sdata, seg, payload, child, count) of one
    cluster, the JAX package's bytes. rcps (M, 4, 3) / rrad (M, 4) are
    the cluster's ROTATED control points and radii."""
    rcps = np.asarray(rcps, np.float32)
    rrad = np.asarray(rrad, np.float32)
    pts = _bezier_points_np(rcps, K)                    # (M, K+1, 3)
    rs = _bezier_points_np(rrad[:, :, None], K)[..., 0]  # (M, K+1)
    p0 = pts[:, :-1].reshape(-1, 3)
    p1 = pts[:, 1:].reshape(-1, 3)
    r0 = rs[:, :-1].reshape(-1)
    r1 = rs[:, 1:].reshape(-1)
    rmax = np.maximum(r0, r1)[:, None]
    lo = np.minimum(p0, p1) - rmax
    hi = np.maximum(p0, p1) + rmax
    S = p0.shape[0]
    mk = np.arange(S, dtype=np.int32)                   # member*K + k

    bvh = build_sah(lo.astype(np.float32), hi.astype(np.float32),
                    BuildSettings(max_leaf_size=MAX_LEAF), backend=builder)
    lower = np.asarray(bvh.lower)
    upper = np.asarray(bvh.upper)
    child = np.asarray(bvh.child)
    count = np.asarray(bvh.count)
    order = np.asarray(bvh.prim_order)
    Mn, W = child.shape
    rows = np.zeros((Mn, 128), np.float32)
    for a in range(3):
        rows[:, W * a: W * a + W] = lower[:, :, a]
        rows[:, W * (3 + a): W * (3 + a) + W] = upper[:, :, a]
    rows[:, 6 * W: 7 * W] = child.astype(np.float32)
    rows[:, 7 * W: 8 * W] = count.astype(np.float32)

    seg = np.concatenate([p0[order], p1[order],
                          r0[order, None], r1[order, None]],
                         axis=1).astype(np.float32)     # (S, 8)
    nrow = -(-S // NS_PER_ROW)
    sd = np.zeros((nrow * NS_PER_ROW, SEG_FLOATS), np.float32)
    sd[:S] = seg
    sdata = np.pad(sd.reshape(nrow, NS_PER_ROW * SEG_FLOATS), ((0, 1), (0, 0)))
    return rows, sdata, seg, mk[order], child, count


def packed_from_arrays(nodes, sdata, seg, payload, child, count, K: int,
                       flat: bool, device) -> PackedHair:
    """Upload host arrays (the packer's, or the JAX package's) as a
    PackedHair on `device`."""
    device = torch.device(device)

    def up(a, dtype):
        return torch.from_numpy(np.array(a, dtype=dtype, order="C")).to(device)

    nodes = up(nodes, np.float32)
    seg = up(seg, np.float32)
    return PackedHair(
        nodes=nodes, sdata=up(sdata, np.float32), seg=seg,
        payload=up(payload, np.int32), num_nodes=int(nodes.shape[0]),
        num_segments=int(seg.shape[0]),
        depth=tree_depth(np.asarray(child), np.asarray(count)),
        K=int(K), flat=bool(flat))


def pack_hair_cluster(rcps, rrad, K: int, flat: bool, device,
                      builder: str = "auto") -> PackedHair:
    """Tessellate, build and pack one cluster (see the module docstring)
    and upload it to `device`."""
    nodes, sdata, seg, payload, child, count = pack_hair_arrays(
        rcps, rrad, K, builder)
    return packed_from_arrays(nodes, sdata, seg, payload, child, count, K,
                              flat, device)


# ---------------------------------------------------------------------------
# the packed set: every cluster of a scene in one launch
# ---------------------------------------------------------------------------

class PackedHairSet(NamedTuple):
    """Clusters packed for one launch of kernel B3: their node rows,
    segment rows, `seg` and `payload` tables concatenated in order, and
    each cluster's bases and rotation. Cluster c's node refs and slots
    are its own (0-based); `cluster(c)` gives its PackedHair as views."""

    nodes: torch.Tensor      # (sum M, 128) f32 node rows
    sdata: torch.Tensor      # (sum rows, 128) f32 segment rows
    seg: torch.Tensor        # (sum S, 8) f32
    payload: torch.Tensor    # (sum S,) i32
    bases: torch.Tensor      # (C, 4) i32: first node row, first segment
    #                          row, first slot in seg, sub-segments a curve
    rots: Optional[torch.Tensor]  # (C, 9) f32 world -> cluster frame
    #                          (x @ rot, row-major); None: rays given in
    #                          the clusters' frames
    rates: tuple             # (C,) sub-segments a curve (bases' column 3)
    flat: tuple              # (C,) bool, the leaf type of each cluster
    depth: tuple             # (C,) levels of each cluster's tree
    num_nodes: tuple         # (C,)
    num_rows: tuple          # (C,) segment rows, the pad row included
    num_segments: tuple      # (C,)

    @property
    def num_clusters(self) -> int:
        return len(self.flat)

    @property
    def device_bytes(self) -> int:
        return sum(a.numel() * a.element_size() for a in
                   (self.nodes, self.sdata, self.seg, self.payload,
                    self.bases)
                   + (() if self.rots is None else (self.rots,)))

    def cluster(self, c: int) -> PackedHair:
        """Cluster c as a PackedHair of views into the set."""
        nb, rb = sum(self.num_nodes[:c]), sum(self.num_rows[:c])
        sb = sum(self.num_segments[:c])
        ns = self.num_segments[c]
        return PackedHair(
            nodes=self.nodes[nb:nb + self.num_nodes[c]],
            sdata=self.sdata[rb:rb + self.num_rows[c]],
            seg=self.seg[sb:sb + ns], payload=self.payload[sb:sb + ns],
            num_nodes=self.num_nodes[c], num_segments=ns,
            depth=self.depth[c], K=self.rates[c], flat=self.flat[c])

    def runs(self):
        """(flat, first, count) of each run of consecutive clusters of one
        leaf type, at most MAX_CLUSTERS long: one launch each."""
        out = []
        for c, f in enumerate(self.flat):
            if out and out[-1][0] == f and out[-1][2] < MAX_CLUSTERS:
                out[-1][2] += 1
            else:
                out.append([f, c, 1])
        return [tuple(r) for r in out]


def pack_hair_set(clusters, rots=None) -> PackedHairSet:
    """Concatenate PackedHair clusters (on one device) into a set, with
    `rots` a (3, 3) rotation a cluster (world -> cluster frame, x @ rot)
    or None. One cluster keeps its tensors (no copy)."""
    clusters = list(clusters)
    dev = clusters[0].nodes.device

    def cat(name):
        parts = [getattr(ph, name) for ph in clusters]
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    nn = [ph.num_nodes for ph in clusters]
    nr = [ph.sdata.shape[0] for ph in clusters]
    ns = [ph.num_segments for ph in clusters]
    rates = [ph.K for ph in clusters]
    bases = np.stack([np.cumsum([0] + nn[:-1]), np.cumsum([0] + nr[:-1]),
                      np.cumsum([0] + ns[:-1]), rates], 1).astype(np.int32)
    return PackedHairSet(
        nodes=cat("nodes"), sdata=cat("sdata"), seg=cat("seg"),
        payload=cat("payload"), bases=torch.from_numpy(bases).to(dev),
        rots=(None if rots is None else torch.from_numpy(np.stack(
            [np.asarray(r, np.float32).reshape(9) for r in rots])).to(dev)),
        rates=tuple(rates),
        flat=tuple(ph.flat for ph in clusters),
        depth=tuple(ph.depth for ph in clusters), num_nodes=tuple(nn),
        num_rows=tuple(nr), num_segments=tuple(ns))


def rotate(x, m):
    """x @ rot for rows x (..., 3) and rotations m (..., 9) (row-major,
    broadcasting), each component summed left to right: the kernel's
    arithmetic, and core/math.py::rows_times' for one rotation."""
    x0, x1, x2 = x[..., 0], x[..., 1], x[..., 2]
    return torch.stack([x0 * m[..., j] + x1 * m[..., 3 + j]
                        + x2 * m[..., 6 + j] for j in range(3)], dim=-1)


def rotate_back(x, m):
    """x @ rot.T: the inverse of `rotate` for a rotation."""
    x0, x1, x2 = x[..., 0], x[..., 1], x[..., 2]
    return torch.stack([x0 * m[..., 3 * j] + x1 * m[..., 3 * j + 1]
                        + x2 * m[..., 3 * j + 2] for j in range(3)], dim=-1)


# ---------------------------------------------------------------------------
# wrapper
# ---------------------------------------------------------------------------

def _load_kernel():
    lib = load_library(KERNEL_NAME)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.hair_set_launch.restype = i
    lib.hair_set_launch.argtypes = [
        p, p, p, p, i, i,                         # set, first, count
        p, p, p, p, ctypes.c_longlong,            # rays
        p, p, p, i, i,                            # out, flat, occluded
        p, p, p, p]                               # stats, stream
    lib.packet_max_depth.restype = i
    lib.packet_max_depth.argtypes = []
    lib.packet_error_string.restype = ctypes.c_char_p
    lib.packet_error_string.argtypes = [i]
    return lib


def _flat_rays(rays: Rays, device):
    """Flat ray tensors after the checks every entry shares."""
    f32 = torch.float32
    R = rays.tnear.numel()
    org = rays.org.reshape(-1, 3)
    d = rays.dir.reshape(-1, 3)
    tn = rays.tnear.reshape(-1)
    tf = rays.tfar.reshape(-1)
    check_tensor("rays.org", org, device, f32, (R, 3))
    check_tensor("rays.dir", d, device, f32, (R, 3))
    check_tensor("rays.tnear", tn, device, f32, (R,))
    check_tensor("rays.tfar", tf, device, f32, (R,))
    return org, d, tn, tf


def _checked_inputs(ph: PackedHair, rays: Rays):
    """Flat ray tensors after the checks of one cluster."""
    device = ph.nodes.device
    f32, i32 = torch.float32, torch.int32
    if not 1 <= ph.depth <= MAX_DEPTH:
        raise ValueError(
            f"tree of {ph.depth} levels: the kernel's stack serves at most "
            f"{MAX_DEPTH}")
    check_tensor("nodes", ph.nodes, device, f32, (ph.num_nodes, 128))
    nrow = -(-ph.num_segments // NS_PER_ROW) + 1
    check_tensor("sdata", ph.sdata, device, f32, (nrow, 128))
    check_tensor("seg", ph.seg, device, f32, (ph.num_segments, SEG_FLOATS))
    check_tensor("payload", ph.payload, device, i32, (ph.num_segments,))
    return _flat_rays(rays, device)


def _checked_set(hs: PackedHairSet, rays: Rays, first: int, count: int):
    """Flat ray tensors after the checks of a set and a run of its
    clusters."""
    device = hs.nodes.device
    f32, i32 = torch.float32, torch.int32
    C = hs.num_clusters
    if not (0 <= first and 1 <= count <= MAX_CLUSTERS
            and first + count <= C):
        raise ValueError(f"clusters {first}..{first + count - 1} of {C}: a "
                         f"launch serves at most {MAX_CLUSTERS}")
    if len(set(hs.flat[first:first + count])) != 1:
        raise ValueError("a launch serves clusters of one leaf type")
    for c in range(C):
        rows = -(-hs.num_segments[c] // NS_PER_ROW) + 1
        if not 1 <= hs.depth[c] <= MAX_DEPTH or hs.num_rows[c] != rows:
            raise ValueError(
                f"cluster {c}: tree of {hs.depth[c]} levels (the kernel's "
                f"stack serves at most {MAX_DEPTH}), {hs.num_rows[c]} "
                f"segment rows for {hs.num_segments[c]} segments")
    S = sum(hs.num_segments)
    check_tensor("nodes", hs.nodes, device, f32, (sum(hs.num_nodes), 128))
    check_tensor("sdata", hs.sdata, device, f32, (sum(hs.num_rows), 128))
    check_tensor("seg", hs.seg, device, f32, (S, SEG_FLOATS))
    check_tensor("payload", hs.payload, device, i32, (S,))
    check_tensor("bases", hs.bases, device, i32, (C, 4))
    if hs.rots is not None:
        check_tensor("rots", hs.rots, device, f32, (C, 9))
    return _flat_rays(rays, device)


def _launch(hs: PackedHairSet, org, d, tn, tf, first: int, count: int,
            occluded: bool, stats: Optional[_StatBuffers]):
    """Launch the kernel on the current stream over clusters first ..
    first + count - 1: (t, slot, cluster)."""
    lib = _load_kernel()
    if max(hs.depth) > lib.packet_max_depth():
        raise ValueError(f"tree of {max(hs.depth)} levels exceeds the "
                         f"compiled stack ({lib.packet_max_depth()} levels)")
    R, dev = tn.shape[0], tn.device
    flat = hs.flat[first]
    t = torch.empty(R, dtype=torch.float32, device=dev)
    slot = torch.empty(R, dtype=torch.int32, device=dev)
    cl = torch.empty(R, dtype=torch.int32, device=dev)

    def ptr(a):
        return None if a is None else a.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.hair_set_launch(
            hs.nodes.data_ptr(), hs.sdata.data_ptr(), hs.bases.data_ptr(),
            ptr(hs.rots), first, count, org.data_ptr(), d.data_ptr(),
            tn.data_ptr(), tf.data_ptr(), R, t.data_ptr(), slot.data_ptr(),
            cl.data_ptr(), int(flat), int(occluded),
            ptr(stats and stats.counters), ptr(stats and stats.node_touched),
            ptr(stats and stats.row_touched), stream)
    launches[("ribbon" if flat else "cone")
             + ("_occluded" if occluded else "")] += 1
    if err != 0:
        msg = lib.packet_error_string(err).decode()
        raise RuntimeError(f"hair kernel launch failed: {err} ({msg})")
    return t, slot, cl


def _stats_dict(R, nodes, segs, drops, leaves, nodes_touched, rows_touched,
                entered=None):
    st = {"rays": int(R), "node_visits": int(nodes),
          "seg_tests": int(segs), "dropped_pushes": int(drops),
          "leaf_visits": int(leaves),
          "nodes_touched": int(nodes_touched),
          "rows_touched": int(rows_touched)}
    if entered is not None:
        st["clusters_entered"] = int(entered)
    return st


def hair_set_trace(hs: PackedHairSet, rays: Rays, first: int = 0,
                   count: Optional[int] = None, occluded: bool = False,
                   stats: bool = False):
    """Kernel B3 over clusters first .. first + count - 1 (all by
    default; one leaf type, at most MAX_CLUSTERS) of a set, rays in the world frame (or in the
    clusters' frame when the set has no rotations), each cluster from
    the running t: (t, slot, cluster, counters or None), flat over rays.
    `slot` is the winning segment's slot within `cluster`, both -1 on a
    miss and for every any-hit ray; `t` is tfar on a miss and -inf on an
    any-hit ray that hit, which stops at the first cluster that hits.
    With `stats` the counters come back as a dict (sums over rays and
    clusters of node visits, leaf visits, segment tests and dropped
    pushes; the clusters entered, summed over rays: an any-hit ray that
    hits enters no later cluster; distinct node rows and segment rows
    touched); on CUDA that launches the kernel's counting build, which is
    not the main path."""
    count = hs.num_clusters - first if count is None else count
    org, d, tn, tf = _checked_set(hs, rays, first, count)
    occluded = bool(occluded)
    if tn.device.type == "cpu":
        out = hair_set_plain(hs, Rays(org, d, tn, tf), first, count,
                             occluded, stats=stats)
        return out if stats else out + (None,)
    if not stats:
        return _launch(hs, org, d, tn, tf, first, count, occluded,
                       None) + (None,)
    buf = _StatBuffers(
        torch.zeros(5, dtype=torch.int64, device=tn.device),
        torch.zeros(hs.nodes.shape[0], dtype=torch.int32, device=tn.device),
        torch.zeros(hs.sdata.shape[0], dtype=torch.int32, device=tn.device))
    t, slot, cl = _launch(hs, org, d, tn, tf, first, count, occluded, buf)
    c = buf.counters.tolist()
    return t, slot, cl, _stats_dict(tn.shape[0], *c[:4],
                                    buf.node_touched.sum().item(),
                                    buf.row_touched.sum().item(), c[4])


def hair_trace(ph: PackedHair, rays: Rays, occluded: bool = False,
               stats: bool = False):
    """One cluster, rays in its frame: `hair_set_trace` of a set of this
    cluster alone without rotation, (t, slot, counters or None)."""
    _checked_inputs(ph, rays)
    t, slot, _cl, st = hair_set_trace(pack_hair_set([ph]), rays,
                                      occluded=occluded, stats=stats)
    return t, slot, st


def intersect_hair_set(hs: PackedHairSet, rays: Rays, t_in, first: int = 0,
                       count: Optional[int] = None):
    """Closest hit of flat world-frame rays over a run of clusters from
    the running t `t_in`, finalized once: (t, u, v, ng, member, cluster,
    hit_mask) with ng in the world frame and `member` the winning curve's
    index within its cluster."""
    org, d, tn = (rays.org.reshape(-1, 3), rays.dir.reshape(-1, 3),
                  rays.tnear.reshape(-1))
    t, slot, cl, _ = hair_set_trace(hs, Rays(org, d, tn, t_in), first, count)
    count = hs.num_clusters - first if count is None else count
    return _finalize_set(hs, org, d, t, slot, cl, first, count)


def occluded_hair_set(hs: PackedHairSet, rays: Rays, tfar, first: int = 0,
                      count: Optional[int] = None):
    """Any hit of flat world-frame rays over a run of clusters: bool."""
    org, d, tn = (rays.org.reshape(-1, 3), rays.dir.reshape(-1, 3),
                  rays.tnear.reshape(-1))
    t = hair_set_trace(hs, Rays(org, d, tn, tfar), first, count,
                       occluded=True)[0]
    return t == -math.inf


def intersect_hair_kernel(ph: PackedHair, org, d, tn, t_in):
    """Closest hit of flat rays already in the cluster's frame, t_in the
    running t: (t, u, v, ng, member, hit_mask) like the JAX package's
    `intersect_hair_pallas`; ng is in the cluster's frame."""
    t, slot, _ = hair_trace(ph, Rays(org, d, tn, t_in))
    return _finalize_hair(ph, org, d, t, slot)


def occluded_hair_kernel(ph: PackedHair, org, d, tn, tfar):
    """Any hit of flat rays in the cluster's frame: bool (R,)."""
    t, _slot, _ = hair_trace(ph, Rays(org, d, tn, tfar), occluded=True)
    return t == -math.inf


# ---------------------------------------------------------------------------
# leaf arithmetic, shared by the plain version and brute-force checks
# ---------------------------------------------------------------------------

def xyz(a):
    """The components of (..., 3) points as a 3-tuple."""
    return a[..., 0], a[..., 1], a[..., 2]


def seg_fields(g):
    """(p0, p1, r0, r1) of (..., 8) segment rows [p0 p1 r0 r1], the
    points as 3-tuples of components."""
    return ((g[..., 0], g[..., 1], g[..., 2]),
            (g[..., 3], g[..., 4], g[..., 5]), g[..., 6], g[..., 7])


def cone_candidates(o, dv, tnear, p0, p1, r0, r1):
    """The cone leaf test before its comparison with the running t:
    (ok, th, s) with ok = (disc >= 0) & (th > tnear) & 0 <= s <= 1 and s
    the (unclamped) axis parameter of the hit; the kernel hits where
    ok & (th < t). o, dv, p0, p1: 3-tuples of components, all
    broadcasting. The operation order is the kernel's
    (csrc/packet.cu::cone_hit)."""
    ox, oy, oz = o
    dx, dy, dz = dv
    ax0, ay0, az0 = p0
    ax1, ay1, az1 = p1
    vx = ax1 - ax0
    vy = ay1 - ay0
    vz = az1 - az0
    aa = (vx * vx + vy * vy + vz * vz).clamp_min(1e-20)
    rr = r1 - r0
    qx = ox - ax0
    qy = oy - ay0
    qz = oz - az0
    alpha = qx * vx + qy * vy + qz * vz
    beta = dx * vx + dy * vy + dz * vz
    dd = dx * dx + dy * dy + dz * dz
    q0d = qx * dx + qy * dy + qz * dz
    q0q0 = qx * qx + qy * qy + qz * qz
    rb = rr * beta
    aa2 = aa * aa
    A = dd - beta * beta / aa - rb * rb / aa2
    B = (2 * q0d - 2 * alpha * beta / aa - 2 * r0 * rr * beta / aa
         - 2 * rr * rr * alpha * beta / aa2)
    C = (q0q0 - alpha * alpha / aa - r0 * r0 - 2 * r0 * rr * alpha / aa
         - rr * rr * alpha * alpha / aa2)
    disc = B * B - 4 * A * C
    sq = torch.sqrt(disc.clamp_min(0.0))
    A_safe = torch.where(A.abs() < 1e-20, 1e-20, A)
    t0 = (-B - sq) / (2 * A_safe)
    t1 = (-B + sq) / (2 * A_safe)
    th = torch.where(t0 > tnear, t0, t1)
    s = (alpha + th * beta) / aa
    ok = (disc >= 0) & (th > tnear) & (s >= 0.0) & (s <= 1.0)
    return ok, th, s


def ribbon_candidates(o, dv, tnear, p0, p1, r0, r1):
    """The ribbon leaf test before its comparison with the running t:
    (ok, th, s, dist2, r) with ok = (dist2 <= r * r) & (th > tnear), s in
    [0, 1] the closest approach's segment parameter, r the radius there;
    arguments as for `cone_candidates` (csrc/packet.cu::ribbon_hit)."""
    ox, oy, oz = o
    dx, dy, dz = dv
    dd = (dx * dx + dy * dy + dz * dz).clamp_min(1e-20)
    ax = p0[0] - ox
    ay = p0[1] - oy
    az = p0[2] - oz
    bx = p1[0] - ox
    by = p1[1] - oy
    bz = p1[2] - oz
    za = (ax * dx + ay * dy + az * dz) / dd
    zb = (bx * dx + by * dy + bz * dz) / dd
    apx = ax - za * dx
    apy = ay - za * dy
    apz = az - za * dz
    bpx = bx - zb * dx
    bpy = by - zb * dy
    bpz = bz - zb * dz
    abx = bpx - apx
    aby = bpy - apy
    abz = bpz - apz
    denom = (abx * abx + aby * aby + abz * abz).clamp_min(1e-20)
    s = (-(apx * abx + apy * aby + apz * abz) / denom).clamp(0.0, 1.0)
    px = apx + s * abx
    py = apy + s * aby
    pz = apz + s * abz
    dist2 = px * px + py * py + pz * pz
    oms = 1.0 - s
    r = r0 * oms + r1 * s
    th = za * oms + zb * s
    return (dist2 <= r * r) & (th > tnear), th, s, dist2, r


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def _plain_batch(ph: PackedHair, org, d, tn, tf, occluded, D, cnt):
    dev = tn.device
    ox, oy, oz = org.unbind(1)
    dx, dy, dz = d.unbind(1)
    srows = ph.sdata.view(-1, SEG_FLOATS)       # segment slots, pads too
    last = srows.shape[0] - 1
    jj = torch.arange(MAX_LEAF, device=dev)
    test = ribbon_candidates if ph.flat else cone_candidates

    def leaf(la, start, lcnt, t, prim, sp):
        # every segment test of the popped leaves in one batch; only the
        # comparisons with the running t go in slot order. Slots past a
        # leaf's count are computed (on real or pad segments) and never
        # taken.
        p = start[:, None] + jj[None]                     # (k, 8)
        valid = jj[None] < lcnt[:, None]
        g = srows[p.clamp_max(last)]                      # (k, 8, 8)
        ok, th = test((ox[la, None], oy[la, None], oz[la, None]),
                      (dx[la, None], dy[la, None], dz[la, None]),
                      tn[la, None], *seg_fields(g))[:2]
        tl = t[la]
        pl = prim[la]
        for j in range(MAX_LEAF):
            m = valid[:, j]
            if occluded:
                m = m & (tl != -math.inf)
            cnt["segs"] = cnt["segs"] + m.sum()
            if cnt["row_touched"] is not None:
                cnt["row_touched"][(p[:, j] // NS_PER_ROW)[m]] = True
            hit = m & ok[:, j] & (th[:, j] < tl)
            if occluded:
                tl = torch.where(hit, -math.inf, tl)
            else:
                tl = torch.where(hit, th[:, j], tl)
                pl = torch.where(hit, p[:, j].to(torch.int32), pl)
        t[la] = tl
        prim[la] = pl
        if occluded:
            sp[la] = torch.where(tl == -math.inf, 0, sp[la])

    return plain_walk(ph.nodes, WIDTH, D, org, d, tn, tf, occluded, cnt,
                      leaf)


def hair_plain(ph: PackedHair, rays: Rays, occluded: bool = False,
               stats: bool = False, stack_depth: Optional[int] = None):
    """The kernel's function in plain PyTorch ops, float32, on whatever
    device the tensors lie (the leaf type from `ph.flat`). Returns
    (t, slot), and the counters dict as a third value with `stats`. The
    stack holds (W - 1) * depth + 1 entries unless `stack_depth` says
    otherwise; dropped pushes are counted."""
    org, d, tn, tf = _checked_inputs(ph, rays)
    dev = tn.device
    D = (WIDTH - 1) * ph.depth + 1 if stack_depth is None else stack_depth
    cnt = {"nodes": 0, "segs": torch.zeros((), dtype=torch.int64, device=dev),
           "drops": 0, "leaves": 0, "node_touched": None,
           "row_touched": None}
    if stats:
        cnt["node_touched"] = torch.zeros(ph.num_nodes, dtype=torch.bool,
                                          device=dev)
        cnt["row_touched"] = torch.zeros(ph.sdata.shape[0],
                                         dtype=torch.bool, device=dev)
    out_t = [torch.empty(0, dtype=torch.float32, device=dev)]
    out_s = [torch.empty(0, dtype=torch.int32, device=dev)]
    for s in range(0, tn.shape[0], PLAIN_CHUNK):
        e = s + PLAIN_CHUNK
        t, slot = _plain_batch(ph, org[s:e], d[s:e], tn[s:e], tf[s:e],
                               bool(occluded), D, cnt)
        out_t.append(t)
        out_s.append(slot)
    t, slot = torch.cat(out_t), torch.cat(out_s)
    if not stats:
        return t, slot
    return t, slot, _stats_dict(
        tn.shape[0], cnt["nodes"], int(cnt["segs"]), cnt["drops"],
        cnt["leaves"], cnt["node_touched"].sum().item(),
        cnt["row_touched"].sum().item())


def hair_set_plain(hs: PackedHairSet, rays: Rays, first: int = 0,
                   count: Optional[int] = None, occluded: bool = False,
                   stats: bool = False, stack_depth: Optional[int] = None):
    """The set kernel's function in plain PyTorch ops on whatever device
    the tensors lie: the clusters in order, each ray rotated into a
    cluster's frame (`rotate`) and walked by `hair_plain` from its running
    t; any-hit rays that hit walk no further cluster. Returns (t, slot,
    cluster), and the counters dict (summed over the clusters) as a
    fourth value with `stats`."""
    count = hs.num_clusters - first if count is None else count
    org, d, tn, tf = _checked_set(hs, rays, first, count)
    t = tf.clone()
    slot = torch.full_like(t, -1, dtype=torch.int32)
    cl = torch.full_like(t, -1, dtype=torch.int32)
    sums = dict.fromkeys(("node_visits", "seg_tests", "dropped_pushes",
                          "leaf_visits", "nodes_touched", "rows_touched",
                          "clusters_entered"), 0)
    for c in range(first, first + count):
        ph = hs.cluster(c)
        a = (t != -math.inf).nonzero().squeeze(1) if occluded else None
        sel = (lambda x: x) if a is None else (lambda x: x[a])
        o, dv = sel(org), sel(d)
        if hs.rots is not None:
            o, dv = rotate(o, hs.rots[c]), rotate(dv, hs.rots[c])
        out = hair_plain(ph, Rays(o, dv, sel(tn), sel(t)), occluded,
                         stats=stats, stack_depth=stack_depth)
        tc, sc = out[0], out[1]
        if a is None:
            hit = sc >= 0
            t = tc
            slot = torch.where(hit, sc, slot)
            cl = torch.where(hit, c, cl)
        else:
            t[a] = tc
        if stats:
            for k in sums:
                sums[k] += out[2].get(k, 0)
            sums["clusters_entered"] += int(o.shape[0])
    if not stats:
        return t, slot, cl
    return t, slot, cl, {"rays": int(tn.shape[0]), **sums}


# ---------------------------------------------------------------------------
# finalize
# ---------------------------------------------------------------------------

def _finalize_rows(g, pay, K, flat: bool, org, d, t, hitm, rates=()):
    """(t, u, v, ng, member, hit_mask) of the winning segments `g` (R, 8)
    with payloads `pay` and `K` sub-segments a curve (an int, or a tensor
    a ray taking the values `rates`), recomputed with the leaf test's
    math (pallas_hair.py:221-266); org, d and ng in the cluster frame,
    zero on a miss. u divides by K as a Python number (on CUDA, PyTorch
    multiplies by the scalar's reciprocal), so one finalize over many
    clusters gives the bits of one finalize a cluster."""
    p0, p1, r0, r1 = g[:, 0:3], g[:, 3:6], g[:, 6], g[:, 7]
    m = pay // K
    k = pay % K
    if flat:
        _ok, _th, s, dist2, r = ribbon_candidates(
            xyz(org), xyz(d), torch.zeros_like(t), xyz(p0), xyz(p1), r0, r1)
        v = 0.5 + 0.5 * torch.sqrt(dist2) / r.clamp_min(1e-20)
        tang = p1 - p0
        ng = cross(tang, cross(tang, d))
    else:
        axis = p1 - p0
        aa = dot(axis, axis).clamp_min(1e-20)
        alpha = dot(org - p0, axis)
        beta = dot(d, axis)
        s = ((alpha + t * beta) / aa).clamp(0.0, 1.0)
        pt = org + t[:, None] * d
        ng = pt - (p0 + s[:, None] * axis)
        v = torch.zeros_like(t)
    uk = k.to(torch.float32) + s
    if isinstance(K, int):
        u = uk / K
    else:
        u = torch.zeros_like(uk)
        for r in sorted(set(rates)):
            u = torch.where(K == r, uk / r, u)
    z = torch.zeros_like(t)
    return (t, torch.where(hitm, u, z), torch.where(hitm, v, z),
            torch.where(hitm[:, None], ng, 0.0),
            torch.where(hitm, m, -1), hitm)


def _finalize_hair(ph: PackedHair, org, d, t, slot):
    """`_finalize_rows` of one cluster's winning slots; ng in the
    cluster's frame."""
    hitm = slot >= 0
    sl = slot.clamp_min(0).long()
    return _finalize_rows(ph.seg[sl], ph.payload[sl], ph.K, ph.flat, org, d,
                          t, hitm)


def _finalize_set(hs: PackedHairSet, org, d, t, slot, cl, first: int,
                  count: int):
    """`_finalize_rows` once for a launch over clusters first .. first +
    count - 1 of a set (one leaf type):
    each ray's cluster's segment, payload, K and rotation gathered, the
    ray rotated into that frame and ng rotated back with the same
    summation order as a fold one cluster at a time. Returns (t, u, v,
    ng in the world frame, member, cluster, hit_mask)."""
    hitm = slot >= 0
    c = cl.clamp_min(0).long()
    b = hs.bases[c]
    sl = b[:, 2].long() + slot.clamp_min(0).long()
    if hs.rots is not None:
        m = hs.rots[c]
        org, d = rotate(org, m), rotate(d, m)
    t, u, v, ng, mem, hitm = _finalize_rows(
        hs.seg[sl], hs.payload[sl], b[:, 3], hs.flat[first], org, d, t, hitm,
        hs.rates[first:first + count])
    if hs.rots is not None:
        ng = rotate_back(ng, m)
    return t, u, v, ng, mem, cl, hitm
