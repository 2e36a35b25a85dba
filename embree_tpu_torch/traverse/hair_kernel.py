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

`hair_trace` is the entry. On CUDA tensors it launches the hand-written
kernel (csrc/packet.cu, `packet_kernel<4, occluded, stats, CONE|RIBBON>`
through `hair_launch`: kernel B2's walk templated on its leaf type) or
raises; on CPU tensors it runs `hair_plain`, the same per-ray function in
masked torch ops (traverse/packet_kernel.py::plain_walk with curve
leaves). Both compute, for every ray on its own, in the cluster frame:

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
  * any-hit rays stop at their first hit: t = -inf, no slot.

The kernel is built with `-fmad=false` and IEEE division and square root,
and agrees with the plain version bit for bit. `_finalize_hair`
recomputes u, v, Ng and the member curve of the winning segment outside
the kernel, as the JAX package does.

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
# wrapper
# ---------------------------------------------------------------------------

def _load_kernel():
    lib = load_library(KERNEL_NAME)
    p = ctypes.c_void_p
    lib.hair_launch.restype = ctypes.c_int
    lib.hair_launch.argtypes = [
        p, p,                                     # nodes, sdata
        p, p, p, p, ctypes.c_longlong,            # rays
        p, p, ctypes.c_int, ctypes.c_int,         # out, flat, occluded
        p, p, p, p]                               # stats, stream
    lib.packet_max_depth.restype = ctypes.c_int
    lib.packet_max_depth.argtypes = []
    lib.packet_error_string.restype = ctypes.c_char_p
    lib.packet_error_string.argtypes = [ctypes.c_int]
    return lib


def _checked_inputs(ph: PackedHair, rays: Rays):
    """Flat ray tensors after the checks both versions share."""
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


def _launch(ph: PackedHair, org, d, tn, tf, occluded: bool,
            stats: Optional[_StatBuffers]):
    """Launch the kernel on the current stream: (t, slot)."""
    lib = _load_kernel()
    if ph.depth > lib.packet_max_depth():
        raise ValueError(f"tree of {ph.depth} levels exceeds the compiled "
                         f"stack ({lib.packet_max_depth()} levels)")
    R = tn.shape[0]
    t = torch.empty(R, dtype=torch.float32, device=tn.device)
    slot = torch.empty(R, dtype=torch.int32, device=tn.device)

    def ptr(a):
        return None if a is None else a.data_ptr()

    with torch.cuda.device(tn.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.hair_launch(
            ph.nodes.data_ptr(), ph.sdata.data_ptr(),
            org.data_ptr(), d.data_ptr(), tn.data_ptr(), tf.data_ptr(), R,
            t.data_ptr(), slot.data_ptr(), int(ph.flat), int(occluded),
            ptr(stats and stats.counters), ptr(stats and stats.node_touched),
            ptr(stats and stats.row_touched), stream)
    launches[ph.leaf + ("_occluded" if occluded else "")] += 1
    if err != 0:
        msg = lib.packet_error_string(err).decode()
        raise RuntimeError(f"hair kernel launch failed: {err} ({msg})")
    return t, slot


def _stats_dict(R, nodes, segs, drops, leaves, nodes_touched, rows_touched):
    return {"rays": int(R), "node_visits": int(nodes),
            "seg_tests": int(segs), "dropped_pushes": int(drops),
            "leaf_visits": int(leaves),
            "nodes_touched": int(nodes_touched),
            "rows_touched": int(rows_touched)}


def hair_trace(ph: PackedHair, rays: Rays, occluded: bool = False,
               stats: bool = False):
    """One traversal of one cluster, rays in its frame: (t, slot,
    counters or None), flat over rays. `slot` is -1 on a miss and for
    every any-hit ray; `t` is tfar on a miss and -inf on an any-hit ray
    that hit. With `stats` the counters come back as a dict (sums over
    rays of node visits, leaf visits, segment tests and dropped pushes;
    distinct node rows and segment rows touched); on CUDA that launches
    the kernel's counting build, which is not the main path."""
    org, d, tn, tf = _checked_inputs(ph, rays)
    occluded = bool(occluded)
    if tn.device.type == "cpu":
        out = hair_plain(ph, Rays(org, d, tn, tf), occluded, stats=stats)
        return out if stats else out + (None,)
    if not stats:
        return _launch(ph, org, d, tn, tf, occluded, None) + (None,)
    buf = _StatBuffers(
        torch.zeros(4, dtype=torch.int64, device=tn.device),
        torch.zeros(ph.num_nodes, dtype=torch.int32, device=tn.device),
        torch.zeros(ph.sdata.shape[0], dtype=torch.int32, device=tn.device))
    t, slot = _launch(ph, org, d, tn, tf, occluded, buf)
    c = buf.counters.tolist()
    return t, slot, _stats_dict(tn.shape[0], *c,
                                buf.node_touched.sum().item(),
                                buf.row_touched.sum().item())


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


# ---------------------------------------------------------------------------
# finalize
# ---------------------------------------------------------------------------

def _finalize_hair(ph: PackedHair, org, d, t, slot):
    """(t, u, v, ng, member, hit_mask) of the winning segment, recomputed
    with the leaf test's math (pallas_hair.py:221-266); ng in the
    cluster's frame, zero on a miss."""
    hitm = slot >= 0
    sl = slot.clamp_min(0).long()
    g = ph.seg[sl]                                       # (R, 8)
    p0, p1, r0, r1 = g[:, 0:3], g[:, 3:6], g[:, 6], g[:, 7]
    pay = ph.payload[sl]
    m = pay // ph.K
    k = pay % ph.K
    if ph.flat:
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
    u = (k.to(torch.float32) + s) / ph.K
    z = torch.zeros_like(t)
    return (t, torch.where(hitm, u, z), torch.where(hitm, v, z),
            torch.where(hitm[:, None], ng, 0.0),
            torch.where(hitm, m, -1), hitm)
