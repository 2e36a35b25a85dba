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
kernel's order of operations, so that the two agree bit for bit. For
every ray on its own, with its own time:

  * time is clamped to [0, 1]; x = time * (S - 1); the segment is
    seg = clip(int(x), 0, S - 2) and the weight w = x - seg;
  * knot s is active when k1 >= time and k0 <= time, with
    k0 = (s - 1) / (S - 1) and k1 = (s + 1) / (S - 1) float64 quotients
    rounded to float32 (how the JAX package compares them);
  * a stack of node refs, the root first; a popped node's children in
    slot order: a child with count < 0 is skipped; the others are
    slab-tested against the union of their active knot boxes (entry
    scaled by 1 - 3*2^-23 and exit by 1 + 3*2^-23, exit -inf where the
    union is empty along x, entry clamped to tnear; hit when
    tmin <= tmax and tmin <= t) and gated by time_lo <= time <= time_hi;
    an inner child that passes is pushed, a leaf child that passes is
    tested at once, so child c sees the t that the leaves of children
    0..c-1 left;
  * a leaf's triangles in order: vertices lerped as
    v[seg] * (1 - w) + v[seg + 1] * w, then the precomputed-cross Moeller
    test (e1 = v0 - v1, e2 = v2 - v0, Ng = e2 x e1) accepting
    `t_s <= |den| * t`, so a later triangle at equal t wins, and
    t = t_s / max(|den|, 1e-37);
  * an occlusion ray stops at its first hit with t = -inf and no prim.

The JAX package's kernel walks a packet of 1,024 rays behind one stack
and tests the union of the knots that meet the packet's whole time
range; here a ray sees only its own knots, which is what the JAX
package's kernel computes for a packet of one ray. Not carried over: its
iteration cap (4,096 pops a packet), its 96-deep stack that drops pushes
silently and its truncation of leaves beyond 8 triangles; here the stack
holds what the tree can need, (W - 1) * depth + 1 entries, and a leaf is
walked to its end.

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
from .packet_kernel import tree_depth
from .user import walk_shared

PLAIN_CHUNK = 65536              # rays per lock-step batch
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
    tests, knot boxes read (a slab test reads one box a knot the ray's
    time activates), triangles tested and dropped pushes; with sizes
    given, which node rows and which triangles' rows were touched."""
    cnt = {"nodes": 0, "slab_tests": 0, "knot_boxes": 0, "tri_tests": 0,
           "drops": 0, "node_touched": None, "prim_touched": None}
    if num_nodes is not None:
        cnt["node_touched"] = torch.zeros(num_nodes, dtype=torch.bool,
                                          device=device)
        cnt["prim_touched"] = torch.zeros(num_prims, dtype=torch.bool,
                                          device=device)
    return cnt


class _Walk:
    """State of one lock-step batch of `walk_mb`. A step pops one node a
    ray and decides its W children in slot order; what does not depend
    on the ray's running t (the slab distances of all children, the
    lerped Moeller test of every triangle of its leaf children) is
    computed for the whole node at once, the comparisons with t in
    order. The counters are tensors until the end, so a step waits for
    the device only to find the rays that are still walking."""

    def __init__(self, rows: MBRows, org, d, tn, tf, tm, occluded, cnt,
                 stack_depth):
        n, dev = tn.shape[0], tn.device
        self.rows, self.cnt, self.occluded = rows, cnt, occluded
        self.counting = cnt["node_touched"] is not None
        time = tm.clamp(0.0, 1.0)
        x = time * float(rows.S - 1)
        seg = x.to(torch.int32).clamp(0, max(rows.S - 2, 0))
        rd = rcp_safe(d)
        # the per-ray constants, gathered once a step: origin, direction,
        # its reciprocal, origin * reciprocal, tnear, time, segment weight
        self.ray = torch.cat([org, d, rd, org * rd, tn[:, None],
                              time[:, None],
                              (x - seg.to(torch.float32))[:, None]], dim=1)
        k0, k1 = knot_ranges(rows.S, dev)
        self.act = (k1[None] >= time[:, None]) & (k0[None] <= time[:, None])
        self.seg_nact = torch.stack([seg.long(), self.act.sum(dim=1)], 1)
        self.t = tf.clone()
        self.prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
        self.D = ((rows.W - 1) * rows.depth + 1 if stack_depth is None
                  else stack_depth)
        self.stack = torch.zeros((n, self.D), dtype=torch.long, device=dev)
        self.sp = torch.ones(n, dtype=torch.long, device=dev)  # root pushed
        # the most triangles a leaf of this tree holds
        self.L = max(int(rows.count.max()), 1) if rows.count.numel() else 1
        zero = torch.zeros((), dtype=torch.long, device=dev)
        self.sums = {k: zero.clone() for k in
                     ("slab_tests", "knot_boxes", "tri_tests", "drops")}
        self.touched = (torch.zeros(cnt["prim_touched"].shape[0],
                                    dtype=torch.long, device=dev)
                        if self.counting else None)

    def run(self):
        while True:
            a = (self.sp > 0).nonzero().squeeze(1)
            if a.numel() == 0:
                break
            self._node(a)
        for k, v in self.sums.items():
            self.cnt[k] += int(v)
        if self.counting:
            self.cnt["prim_touched"] |= self.touched > 0
        return self.t, self.prim

    def _node(self, a):
        rows, W, L = self.rows, self.rows.W, self.L
        self.sp[a] -= 1
        node = self.stack[a, self.sp[a]]
        self.cnt["nodes"] += a.numel()
        if self.counting:
            self.cnt["node_touched"][node] = True
        ray = self.ray[a]
        o, d, rd, od = (ray[:, 3 * i:3 * i + 3] for i in range(4))
        tn, time, wgt = ray[:, 12], ray[:, 13], ray[:, 14]
        seg, nact = self.seg_nact[a].unbind(1)
        ch, cn = rows.child[node], rows.count[node]          # (k, W)
        # the union of the active knot boxes and the slab test of every
        # child, but for the comparison with t
        act = self.act[a][:, :, None, None]
        bx = rows.boxes[node]                               # (k, S, 6, W)
        lo = torch.where(act, bx[:, :, :3], math.inf).amin(dim=1)
        hi = torch.where(act, bx[:, :, 3:], -math.inf).amax(dim=1)
        t0 = lo * rd[:, :, None] - od[:, :, None]           # (k, 3, W)
        t1 = hi * rd[:, :, None] - od[:, :, None]
        near, far = torch.minimum(t0, t1), torch.maximum(t0, t1)
        tmin = torch.maximum(torch.maximum(near[:, 0], near[:, 1]),
                             near[:, 2]) * ROBUST_MIN
        tmax = torch.minimum(torch.minimum(far[:, 0], far[:, 1]),
                             far[:, 2]) * ROBUST_MAX
        tmax = torch.where(lo[:, 0] <= hi[:, 0], tmax, -math.inf)
        tmin = torch.maximum(tmin, tn[:, None])
        gate = rows.gates[node]                             # (k, 2, W)
        passes = ((cn >= 0) & (tmin <= tmax) & (time[:, None] >= gate[:, 0])
                  & (time[:, None] <= gate[:, 1]))
        # every triangle of every leaf child, lerped at the ray's time,
        # through the Moeller test but for the comparison with t
        kk = torch.arange(L, device=a.device)
        P = rows.prim_order.shape[0]
        p = rows.prim_order[(ch[..., None] + kk).clamp(0, max(P - 1, 0))]
        sg = seg[:, None, None]
        w = wgt[:, None, None, None]
        v = rows.tris[p, sg] * (1.0 - w) + rows.tris[p, sg + 1] * w
        ox, oy, oz = o[:, None, None].unbind(-1)
        dx, dy, dz = d[:, None, None].unbind(-1)
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
        in_leaf = (kk < cn[..., None]) & (cn > 0)[..., None]  # (k, W, L)
        geo = (in_leaf & (den != 0.0) & (u_s >= 0.0) & (v_s >= 0.0)
               & (u_s + v_s <= absden) & (absden * tn[:, None, None] < t_s))
        th = t_s / absden.clamp_min(DEN_MIN)
        p32 = p.to(torch.int32)
        # the children in slot order against the running t
        t, prim, sp = self.t[a], self.prim[a], self.sp[a]
        stopped = torch.zeros_like(a, dtype=torch.bool)
        hits, before, drops = [], [], []
        for c in range(W):
            hit = passes[:, c] & (tmin[:, c] <= t)
            if self.occluded:
                hit = hit & ~stopped
            inner = hit & (cn[:, c] == 0)
            can = inner & (sp < self.D)
            pos = sp.clamp(max=self.D - 1)
            self.stack[a, pos] = torch.where(can, ch[:, c],
                                             self.stack[a, pos])
            sp = sp + can
            cand = hit[:, None] & geo[:, c]                  # (k, L)
            if self.counting:
                hits.append(hit)
                drops.append(inner & ~can)
            for k in range(L):
                if self.counting:
                    before.append(stopped)
                ok = cand[:, k] & (t_s[:, c, k] <= absden[:, c, k] * t)
                if self.occluded:
                    ok = ok & ~stopped
                    t = torch.where(ok, -math.inf, t)
                    stopped = stopped | ok
                else:
                    t = torch.where(ok, th[:, c, k], t)
                    prim = torch.where(ok, p32[:, c, k], prim)
        self.t[a], self.prim[a] = t, prim
        self.sp[a] = torch.where(stopped, 0, sp)
        if self.counting:
            self._count(cn, p, in_leaf, nact, hits, before, drops)

    def _count(self, cn, p, in_leaf, nact, hits, before, drops):
        """The kernel's counters for one step: a child is slab-tested
        unless its slot is empty or the ray stopped before it; a triangle
        is tested in a leaf child that was hit, unless the ray stopped
        before it."""
        sums, W, L = self.sums, self.rows.W, self.L
        stop = torch.stack(before, 1).view(-1, W, L)         # (k, W, L)
        valid = (cn >= 0) & ~stop[:, :, 0]
        sums["slab_tests"] += valid.sum()
        sums["knot_boxes"] += (nact[:, None] * valid).sum()
        tested = torch.stack(hits, 1)[..., None] & in_leaf & ~stop
        sums["tri_tests"] += tested.sum()
        sums["drops"] += torch.stack(drops).sum()
        self.touched.index_put_((p.reshape(-1),), tested.reshape(-1).long(),
                                accumulate=True)


def walk_mb(rows: MBRows, org, d, tn, tf, tm, occluded: bool, cnt: dict,
            stack_depth: Optional[int] = None):
    """The per-ray walk of flat rays at flat times `tm` (R,): (t, prim)
    with prim the MB triangle index (-1 on a miss and for every
    occlusion ray), PLAIN_CHUNK rays at a time. `cnt` (see
    `new_counters`) is added to. A `stack_depth` below what the tree can
    need drops pushes, which are counted."""
    out_t, out_p = [], []
    for s in range(0, max(tn.shape[0], 1), PLAIN_CHUNK):
        e = s + PLAIN_CHUNK
        t, prim = _Walk(rows, org[s:e], d[s:e], tn[s:e], tf[s:e], tm[s:e],
                        bool(occluded), cnt, stack_depth).run()
        out_t.append(t)
        out_p.append(prim)
    return torch.cat(out_t), torch.cat(out_p)


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
