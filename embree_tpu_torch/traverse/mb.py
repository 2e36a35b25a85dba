"""Multi-segment motion-blur accel and its traversal in plain torch ops
(N-timestep piecewise-linear motion).

Counterpart of embree_tpu/traverse/mb.py, the analog of the reference's
MB stack (AlignedNodeMB bvh.h:597, AlignedNodeMB4D :837, the
multi-segment builder bvh_builder_msmblur.h:587, the MB triangle
intersectors): the geometry stores S >= 2 vertex knots on a uniform time
grid, the BVH keeps per-node refit bounds at every knot, children of an
MB4D node carry a time gate, and a leaf lerps each triangle between the
two knots of the ray's segment.

`walk_mb` is the per-ray walk, the function of the CUDA kernel
csrc/mb.cu (traverse/mb_kernel.py) written in masked tensor ops, in the
kernel's order of operations, so that the two agree bit for bit. It is
kernel B2's walk (traverse/packet_kernel.py::plain_walk) with lerped
boxes and lerped triangles. For every ray on its own, with its own
time:

  * time is clamped to [0, 1] (a NaN stays NaN); x = time * (S - 1);
    the segment is seg = clip(int(x), 0, S - 2) (0 for a NaN) and the
    weight w = x - seg;
  * a stack of (ref, entry distance), the root first; a popped entry is
    skipped when its distance exceeds the ray's t;
  * a popped node's children: a child with count < 0 is skipped; the
    others are slab-tested against their box lerped to the ray's time,
    box[seg] * (1 - w) + box[seg + 1] * w (the linear bounds of
    AlignedNodeMB; entry scaled by 1 - 3*2^-23 and exit by 1 + 3*2^-23,
    entry clamped to tnear; hit when tmin <= tmax and tmin <= t) and
    gated by time_lo <= time <= time_hi; the children that pass, inner
    nodes and leaves alike, are pushed far to near by their entry
    distance, the lower slot on top among equal distances;
  * a popped leaf's triangles in order: vertices lerped as
    v[seg] * (1 - w) + v[seg + 1] * w, then the precomputed-cross Moeller
    test (e1 = v0 - v1, e2 = v2 - v0, Ng = e2 x e1) accepting
    `t_s <= |den| * t`, so a later triangle at equal t wins, and
    t = t_s / max(|den|, 1e-37);
  * an occlusion ray stops at its first hit with t = -inf and no prim.

The box lerp is the vertex lerp, same expression and order, so a box
that holds a triangle at both knots holds the lerped triangle exactly in
floats (rounding is monotone; csrc/mb.cu says more). A NaN time fails
every gate and misses.

The JAX package's kernel walks a packet of 1,024 rays behind one stack,
in slot order, and tests the union of the knot boxes that meet the
packet's whole time range; here a ray sees its own segment and its
nearest child first. Not carried over: its iteration cap (4,096 pops a
packet), its 96-deep stack that drops pushes silently and its
truncation of leaves beyond 8 triangles; here the stack holds what the
tree can need, (W - 1) * depth + 1 entries, and a leaf is walked to its
end.

`intersect_mb` runs the walk over an `MBAccel`'s own tensors; the scene
traces the packed rows instead (traverse/mb_kernel.py), which hold the
same floats.

`MBCurves` / `intersect_mb_curves` are the motion-blur curve accel and
its walk (the JAX package has no kernel for them): the lock-step walk of
traverse/user.py over per-knot refit boxes, round segments lerped at each
ray's time through the swept-cone test.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..build.bvh import BVH
from ..core.math import (ROBUST_MAX_RCP as ROBUST_MAX,
                         ROBUST_MIN_RCP as ROBUST_MIN, rcp_safe)
from ..core.rayhit import Hits, INVALID_ID, Rays
from .hair import _cone_hit
from .moeller import DEN_MIN, intersect_triangle
from .packet_kernel import plain_walk, slab_tmin, tree_depth
from .user import walk_shared

PLAIN_CHUNK = 65536              # rays per lock-step batch
# the most triangles a leaf may hold: a pushed leaf carries its count in
# 4 bits (the builder makes leaves of at most 4, the packer refuses more
# than 8, the kernel's limit)
MAX_WALK_LEAF = 15
_REFIND = float(np.float32(1.0 + 1e-6))
_REFIND_EPS = float(np.float32(1e-30))


class MBAccel(NamedTuple):
    bvh: BVH                     # structure (bounds field = knot 0)
    lower_ts: torch.Tensor       # (S, M, W, 3) per-knot refit bounds
    upper_ts: torch.Tensor
    v0_ts: torch.Tensor          # (S, T, 3) triangle vertices per knot
    v1_ts: torch.Tensor
    v2_ts: torch.Tensor
    geom_id: torch.Tensor        # (T,) i32
    prim_id: torch.Tensor
    uv_flip: torch.Tensor
    # MB4D temporal splits (AlignedNodeMB4D, bvh.h:837): per-child valid
    # time range; the children of the merged root carry the ranges of
    # their subtrees. None when the build made no split.
    time_lo: Optional[torch.Tensor] = None    # (M, W) f32
    time_hi: Optional[torch.Tensor] = None

    @property
    def num_timesteps(self) -> int:
        return self.lower_ts.shape[0]

    @property
    def has_time_splits(self) -> bool:
        return self.time_lo is not None


class MBRows(NamedTuple):
    """What `walk_mb` reads: views of an MBAccel or of the kernel's
    packed rows, the same floats either way."""

    child: torch.Tensor          # (M, W) long
    count: torch.Tensor          # (M, W) long
    boxes: torch.Tensor          # (M, S, 6, W) f32: lo xyz, hi xyz per knot
    gates: torch.Tensor          # (M, 2, W) f32: time_lo, time_hi
    prim_order: torch.Tensor     # (P,) long
    tris: torch.Tensor           # (T, S, 9) f32: v0 v1 v2 per knot
    S: int
    W: int
    depth: int                   # levels of nodes, the root being 1


def accel_rows(accel: MBAccel) -> MBRows:
    """The walk's view of an MBAccel."""
    bvh = accel.bvh
    M, W = bvh.child.shape
    boxes = torch.cat([accel.lower_ts, accel.upper_ts], dim=3)
    if accel.has_time_splits:
        gates = torch.stack([accel.time_lo, accel.time_hi], dim=1)
    else:
        gates = torch.stack([torch.zeros_like(bvh.lower[..., 0]),
                             torch.ones_like(bvh.lower[..., 0])], dim=1)
    tris = torch.cat([accel.v0_ts, accel.v1_ts, accel.v2_ts], dim=2)
    return MBRows(child=bvh.child.long(), count=bvh.count.long(),
                  boxes=boxes.permute(1, 0, 3, 2), gates=gates,
                  prim_order=bvh.prim_order.long(),
                  tris=tris.permute(1, 0, 2), S=accel.num_timesteps, W=W,
                  depth=tree_depth(bvh.child.cpu().numpy(),
                                   bvh.count.cpu().numpy()))


def _seg_weights(tm, S):
    """time in [0, 1] -> (segment index, local weight) over S - 1 uniform
    segments."""
    x = tm.clamp(0.0, 1.0) * float(S - 1)
    seg = x.to(torch.int32).clamp(0, S - 2)
    return seg.long(), x - seg.to(x.dtype)


def knot_ranges(S: int, device=None):
    """(k0, k1) float32 (S,): the time interval knot s serves, the
    float64 quotients rounded to float32."""
    s = np.arange(S, dtype=np.float64)
    k0 = ((s - 1) / (S - 1)).astype(np.float32)
    k1 = ((s + 1) / (S - 1)).astype(np.float32)
    return torch.from_numpy(k0).to(device), torch.from_numpy(k1).to(device)


def ray_times(time, R: int, device) -> torch.Tensor:
    """One float32 time a ray, (R,) contiguous: `time` is a scalar or
    holds R values in any shape."""
    tm = torch.as_tensor(time, dtype=torch.float32, device=device).reshape(-1)
    if tm.numel() == 1:
        return tm.expand(R).contiguous()
    if tm.numel() != R:
        raise ValueError(f"{tm.numel()} times for {R} rays")
    return tm.contiguous()


def new_counters(num_nodes=None, num_prims=None, device=None) -> dict:
    """Counters of one walk: sums over rays of nodes popped, child slab
    tests, triangles tested, leaves popped and dropped pushes; with
    sizes given, which node rows and which triangles' rows were
    touched."""
    cnt = {"nodes": 0, "slab_tests": 0, "tri_tests": 0,
           "leaves": 0, "drops": 0, "node_touched": None,
           "prim_touched": None}
    if num_nodes is not None:
        cnt["node_touched"] = torch.zeros(num_nodes, dtype=torch.bool,
                                          device=device)
        cnt["prim_touched"] = torch.zeros(num_prims, dtype=torch.bool,
                                          device=device)
    return cnt


def walk_mb(rows: MBRows, org, d, tn, tf, tm, occluded: bool, cnt: dict,
            stack_depth: Optional[int] = None):
    """The per-ray walk of flat rays at flat times `tm` (R,): (t, prim)
    with prim the MB triangle index (-1 on a miss and for every
    occlusion ray), PLAIN_CHUNK rays at a time through kernel B2's
    lock-step walk (traverse/packet_kernel.py::plain_walk) with lerped
    child boxes and lerped triangles. `cnt` (see `new_counters`) is
    added to. A `stack_depth` below what the tree can need drops pushes,
    which are counted."""
    D = ((rows.W - 1) * rows.depth + 1 if stack_depth is None
         else stack_depth)
    big = int(rows.count.max()) if rows.count.numel() else 0
    if big > MAX_WALK_LEAF:
        raise ValueError(f"a leaf of {big} triangles: the walk serves at "
                         f"most {MAX_WALK_LEAF}")
    out_t, out_p = [], []
    for s in range(0, max(tn.shape[0], 1), PLAIN_CHUNK):
        e = s + PLAIN_CHUNK
        t, prim = _walk_batch(rows, org[s:e], d[s:e], tn[s:e], tf[s:e],
                              tm[s:e], bool(occluded), cnt, D)
        out_t.append(t)
        out_p.append(prim)
    return torch.cat(out_t), torch.cat(out_p)


def _walk_batch(rows: MBRows, org, d, tn, tf, tm, occluded, cnt, D):
    W, S, dev = rows.W, rows.S, tn.device
    time = tm.clamp(0.0, 1.0)                 # a NaN time stays NaN
    x = time * float(S - 1)
    seg = torch.where(x >= 0, x.to(torch.int32), 0).clamp(max=S - 2).long()
    wgt = x - seg.to(torch.float32)
    omw = 1.0 - wgt
    rd = rcp_safe(d)
    od = org * rd
    L = max(int(rows.count.max()), 1) if rows.count.numel() else 1
    kk = torch.arange(L, device=dev)
    P = rows.prim_order.shape[0]
    # the counters stay tensors until the end: a step then waits for the
    # device only to find the rays that are still walking
    sums = {k: torch.zeros((), dtype=torch.long, device=dev)
            for k in ("slab_tests", "tri_tests")}
    touched = (torch.zeros(cnt["prim_touched"].shape[0], dtype=torch.long,
                           device=dev)
               if cnt["prim_touched"] is not None else None)

    def lerp(a, b, r):
        """a * (1 - w) + b * w for the rays `r`, broadcast over a's
        trailing axes: the kernel's expression, box and vertex alike."""
        sh = (-1,) + (1,) * (a.ndim - 1)
        return a * omw[r].view(sh) + b * wgt[r].view(sh)

    def children(na, node, t_na):
        sg = seg[na]
        box = lerp(rows.boxes[node, sg], rows.boxes[node, sg + 1], na)
        tmin, tmax = slab_tmin(box[:, 0:3], box[:, 3:6], rd[na], od[na],
                               tn[na])
        cn = rows.count[node]
        gate = rows.gates[node]                              # (k, 2, W)
        tt = time[na, None]
        ok = ((cn >= 0) & (tmin <= tmax) & (tmin <= t_na[:, None])
              & (tt >= gate[:, 0]) & (tt <= gate[:, 1]))
        sums["slab_tests"] += (cn >= 0).sum()
        return tmin, ok, rows.child[node].to(torch.int32), cn.to(torch.int32)

    def leaf(la, start, lcnt, t, prim, sp):
        # every triangle of the popped leaves lerped and put through the
        # Moeller test in one batch; only the comparisons with the
        # running t go in slot order
        p = rows.prim_order[(start[:, None] + kk).clamp(0, max(P - 1, 0))]
        sg = seg[la][:, None]
        v = lerp(rows.tris[p, sg], rows.tris[p, sg + 1], la)  # (k, L, 9)
        o, dv = org[la][:, None], d[la][:, None]
        ox, oy, oz = o.unbind(-1)
        dx, dy, dz = dv.unbind(-1)
        v0x, v0y, v0z = v[..., 0], v[..., 1], v[..., 2]
        e1x, e1y, e1z = v0x - v[..., 3], v0y - v[..., 4], v0z - v[..., 5]
        e2x, e2y, e2z = v[..., 6] - v0x, v[..., 7] - v0y, v[..., 8] - v0z
        ngx = e2y * e1z - e2z * e1y
        ngy = e2z * e1x - e2x * e1z
        ngz = e2x * e1y - e2y * e1x
        cx, cy, cz = v0x - ox, v0y - oy, v0z - oz
        rx = cy * dz - cz * dy
        ry = cz * dx - cx * dz
        rz = cx * dy - cy * dx
        den = ngx * dx + ngy * dy + ngz * dz
        absden = den.abs()
        sgn = torch.where(den >= 0.0, 1.0, -1.0)
        u_s = (rx * e2x + ry * e2y + rz * e2z) * sgn
        v_s = (rx * e1x + ry * e1y + rz * e1z) * sgn
        t_s = (ngx * cx + ngy * cy + ngz * cz) * sgn
        valid = kk[None] < lcnt[:, None]                     # (k, L)
        geo = (valid & (den != 0.0) & (u_s >= 0.0) & (v_s >= 0.0)
               & (u_s + v_s <= absden) & (absden * tn[la, None] < t_s))
        th = t_s / absden.clamp_min(DEN_MIN)
        tl, pl = t[la], prim[la]
        tested = []
        for j in range(L):
            m = valid[:, j]
            if occluded:
                m = m & (tl != -math.inf)
            tested.append(m)
            ok = m & geo[:, j] & (t_s[:, j] <= absden[:, j] * tl)
            if occluded:
                tl = torch.where(ok, -math.inf, tl)
            else:
                tl = torch.where(ok, th[:, j], tl)
                pl = torch.where(ok, p[:, j].to(torch.int32), pl)
        t[la], prim[la] = tl, pl
        if occluded:
            sp[la] = torch.where(tl == -math.inf, 0, sp[la])
        tested = torch.stack(tested, 1)
        sums["tri_tests"] += tested.sum()
        if touched is not None:
            touched.index_put_((p.reshape(-1),), tested.reshape(-1).long(),
                               accumulate=True)

    t, prim = plain_walk(None, W, D, org, d, tn, tf, occluded, cnt, leaf,
                         children, max_leaf=MAX_WALK_LEAF)
    cnt["slab_tests"] += int(sums["slab_tests"])
    cnt["tri_tests"] += int(sums["tri_tests"])
    if touched is not None:
        cnt["prim_touched"] |= touched > 0
    return t, prim


def _finalize_mb(accel: MBAccel, rays: Rays, t, prim, tm) -> Hits:
    """Hits of the rays' batch shape from (t, winning MB triangle):
    u, v and Ng of the triangle lerped at the ray's time, quads' second
    triangles remapped u -> 1 - u, v -> 1 - v; a miss keeps the rays'
    tfar."""
    S = accel.num_timesteps
    org, d = rays.org.reshape(-1, 3), rays.dir.reshape(-1, 3)
    tn, tf = rays.tnear.reshape(-1), rays.tfar.reshape(-1)
    seg, w = _seg_weights(tm, S)
    p = prim.clamp_min(0).long()
    w_ = w[:, None]
    lerp = [vt[seg, p] * (1.0 - w_) + vt[seg + 1, p] * w_
            for vt in (accel.v0_ts, accel.v1_ts, accel.v2_ts)]
    valid = prim >= 0
    _ok, _t2, u, v, ng = intersect_triangle(
        org, d, tn, t * _REFIND + _REFIND_EPS, *lerp)
    flip = accel.uv_flip[p] == 1
    u = torch.where(flip, 1.0 - u, u)
    v = torch.where(flip, 1.0 - v, v)
    invalid = torch.full_like(prim, INVALID_ID)
    shape = rays.batch_shape
    h = Hits(t=torch.where(valid, t, tf),
             u=torch.where(valid, u, 0.0),
             v=torch.where(valid, v, 0.0),
             ng=torch.where(valid[:, None], ng, 0.0),
             prim_id=torch.where(valid, accel.prim_id[p], invalid),
             geom_id=torch.where(valid, accel.geom_id[p], invalid),
             gprim=torch.where(valid, prim, invalid),
             inst_id=invalid.clone())
    return Hits(*(x.reshape(shape + x.shape[1:]) for x in h))


def _flat(rays: Rays, t_in=None):
    tf = rays.tfar if t_in is None else t_in
    return (rays.org.reshape(-1, 3).contiguous(),
            rays.dir.reshape(-1, 3).contiguous(),
            rays.tnear.reshape(-1).contiguous(), tf.reshape(-1).contiguous())


def intersect_mb(accel: MBAccel, rays: Rays, time, t_in=None) -> Hits:
    """Closest hit of every ray at its time in [0, 1] (`time` a scalar
    or one a ray), walked in torch ops over the accel's own tensors on
    whatever device they lie. `t_in` seeds the per-ray tfar; a miss
    keeps the rays' tfar."""
    org, d, tn, tf = _flat(rays, t_in)
    tm = ray_times(time, tn.shape[0], tn.device)
    t, prim = walk_mb(accel_rows(accel), org, d, tn, tf, tm, False,
                      new_counters())
    return _finalize_mb(accel, rays, t, prim, tm)


class MBCurves(NamedTuple):
    """Motion-blur CURVE accel (bvh_builder_msmblur_hair analog): one
    SAH topology over the all-knot union of segment bounds, refit at
    every knot; round segments lerped at the ray's time."""

    bvh: BVH                 # structure (bounds field = knot 0)
    lower_ts: torch.Tensor   # (S, M, W, 3) per-knot refit bounds
    upper_ts: torch.Tensor
    p0_ts: torch.Tensor      # (S, C, 4) xyzr segment starts per knot
    p1_ts: torch.Tensor      # (S, C, 4)
    geom_id: torch.Tensor    # (C,) i32
    prim_id: torch.Tensor    # (C,) i32 curve id within its geometry
    u0: torch.Tensor         # (C,) f32 curve-u at the segment's start
    du: torch.Tensor         # (C,) f32

    @property
    def num_timesteps(self) -> int:
        return self.lower_ts.shape[0]


def intersect_mb_curves(accel: MBCurves, rays: Rays, time):
    """Closest curve hit of flat rays, each at its own time (`time` a
    scalar or one a ray): flat (t, u, v, ng, prim_id, geom_id, hit_mask),
    t = tfar on a miss. The lock-step walk of traverse/user.py; a node's
    child boxes are, for each ray, the union of the knot boxes active at
    its time (`knot_ranges`), and a leaf's segments are lerped at the
    ray's time and run through the swept-cone test (traverse/hair.py::
    _cone_hit), an earlier segment keeping an equal t.

    The JAX package tests the union of the knots that meet the batch's
    whole time range, which gives the same hits; its leaf computes the
    cone's squared axis length summed over the whole batch instead of a
    ray's own (`ROADMAP.md` C), which is right for a batch of one ray."""
    S = accel.num_timesteps
    org, d = rays.org.reshape(-1, 3), rays.dir.reshape(-1, 3)
    tn, tf = rays.tnear.reshape(-1), rays.tfar.reshape(-1)
    R = tn.shape[0]
    dev = tn.device
    tm = ray_times(time, R, dev)
    seg, w = _seg_weights(tm, S)
    w_ = w[:, None]
    k0, k1 = knot_ranges(S, dev)
    act = (k1[None] >= tm[:, None]) & (k0[None] <= tm[:, None])  # (R, S)
    rdir = rcp_safe(d)
    org_rdir = org * rdir
    inf = torch.tensor(math.inf, dtype=torch.float32, device=dev)

    def node_test(node, t):
        a = act[:, :, None, None]                         # (R, S, 1, 1)
        lo = torch.where(a, accel.lower_ts[None, :, node], inf).amin(1)
        hi = torch.where(a, accel.upper_ts[None, :, node], -inf).amax(1)
        t_lo = lo * rdir[:, None] - org_rdir[:, None]     # (R, W, 3)
        t_hi = hi * rdir[:, None] - org_rdir[:, None]
        tmin = torch.minimum(t_lo, t_hi).amax(-1) * ROBUST_MIN
        tmax = torch.maximum(t_lo, t_hi).amin(-1) * ROBUST_MAX
        tmin = torch.maximum(tmin, tn[:, None])
        return ((tmin <= tmax) & (tmin <= t[:, None])).T

    def leaf(p, t, st):
        prim, u, ng = st
        a = accel.p0_ts[seg, p] * (1 - w_) + accel.p0_ts[seg + 1, p] * w_
        b = accel.p1_ts[seg, p] * (1 - w_) + accel.p1_ts[seg + 1, p] * w_
        ok, th, uh, ngh = _cone_hit(a[:, :3], b[:, :3], a[:, 3], b[:, 3],
                                    Rays(org, d, tn, t), t)
        return (torch.where(ok, th, t),
                (torch.where(ok, p, prim), torch.where(ok, uh, u),
                 torch.where(ok[:, None], ngh, ng)))

    st0 = (torch.full((R,), -1, dtype=torch.int32, device=dev),
           torch.zeros(R, dtype=torch.float32, device=dev),
           torch.zeros((R, 3), dtype=torch.float32, device=dev))
    t, (prim, uh, ng), _pops = walk_shared(accel.bvh, node_test, leaf,
                                           tf.clone(), st0)
    hitm = prim >= 0
    p = prim.clamp_min(0).long()
    u = torch.where(hitm, accel.u0[p] + uh * accel.du[p], 0.0)
    return (t, u, torch.zeros_like(u), ng,
            torch.where(hitm, accel.prim_id[p], -1),
            torch.where(hitm, accel.geom_id[p], -1), hitm)
