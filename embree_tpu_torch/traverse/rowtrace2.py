"""Per-ray treelet traversal: the kernel's wrapper and its plain version.

Counterpart of embree_tpu/traverse/rowtrace2.py. `intersect_rowtrace2`
returns, per ray, the closest hit `(t, prim)` over a `TreeletScene`
(`prim = -1` and `t = tfar` on a miss) or, with `occluded=True`, any hit
(`t = -inf` marks a hit, `prim` stays -1).

On a CUDA tensor the wrapper launches the hand-written kernel
`csrc/rowtrace2.cu` (built and loaded at first use by core/nvcc.py) or
raises; on a CPU tensor it runs `rowtrace2_plain`, the
same per-ray state machine written with masked tensor ops. Both visit,
for every ray:

  * mids in ascending id, each box slab-tested against the ray's live t;
  * the fan treelets of an entered mid in ascending id, their boxes
    tested ONCE, against the t the ray has when it enters the mid;
  * in a treelet, all node tests against the t at walk start (they only
    mark leaf pairs), then the marked pairs in ascending pair id,
    triangle a then b, against the live t; `t_s <= |den| * t` accepts,
    so a later candidate at equal t replaces an earlier one.

That order depends on the ray alone, so the result does not depend on
how rays are grouped, and the two versions agree bit for bit as long as
the kernel is built without FMA contraction (`-fmad=false`): every
product is rounded before it is added, here as there.

Of the kernel's two roofline terms, counted float32 operations are the
larger at the 1M-triangle scene (the scan over all mid boxes dominates
them); it runs far from either, waiting on the latency of 4-byte loads
that the 128-lane block layout inherited from the JAX package scatters
512 bytes apart. PERF.md has the measured times and the bound.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from ..build.treelets import (BLOCK_ROWS, LEAF_FIELDS, N_INNER, NODE_ROWS,
                              TreeletScene)
from ..core.math import (ROBUST_MAX_RCP as ROBUST_MAX,
                         ROBUST_MIN_RCP as ROBUST_MIN, rcp_safe)
from ..core.nvcc import check_tensor, load_library
from ..core.rayhit import Rays
from .moeller import DEN_MIN

MAX_FAN = 128              # the kernel's fan mask is 4 x 32 bits
PLAIN_CHUNK = 65536        # rays per lock-step batch of the plain version

# number of kernel launches made by this module (plain-version calls do
# not count); a caller that wants to know whether a path went through
# the kernel sets it to 0 before and reads it after
launches = 0

KERNEL_NAME = "rowtrace2"      # csrc/rowtrace2.cu -> _build/librowtrace2.so


def _load_kernel():
    lib = load_library(KERNEL_NAME)
    p = ctypes.c_void_p
    lib.rowtrace2_launch.restype = ctypes.c_int
    lib.rowtrace2_launch.argtypes = [
        p, p, p, ctypes.c_int, ctypes.c_int,      # scene
        p, p, p, p, ctypes.c_longlong,            # rays
        p, p, ctypes.c_int, ctypes.c_int,         # out, variant
        p, p, p]                                  # stats, stream
    lib.rowtrace2_error_string.restype = ctypes.c_char_p
    lib.rowtrace2_error_string.argtypes = [ctypes.c_int]
    return lib


def _checked_inputs(ts: TreeletScene, rays: Rays):
    """Flat ray tensors after the checks both versions share."""
    device = ts.blocks.device
    M, fan = ts.num_mids, ts.fan
    if not 1 <= fan <= MAX_FAN:
        raise ValueError(f"fan {fan} outside 1..{MAX_FAN}")
    f32 = torch.float32
    check_tensor("blocks", ts.blocks, device, f32, (M * fan, BLOCK_ROWS, 128))
    check_tensor("mid_boxes", ts.mid_boxes, device, f32, (M, 6))
    check_tensor("tre_boxes", ts.tre_boxes, device, f32, (M, 6, 128))
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


def _launch(ts: TreeletScene, org, d, tn, tf, occluded: bool, cull: bool,
            stats):
    """Launch the kernel on the current stream; `stats` is None or a
    (counters u64[4], touched i32[num_treelets]) pair of device buffers."""
    global launches
    lib = _load_kernel()
    R = tn.shape[0]
    t = torch.empty(R, dtype=torch.float32, device=tn.device)
    prim = torch.empty(R, dtype=torch.int32, device=tn.device)
    counters, touched = stats if stats is not None else (None, None)
    with torch.cuda.device(tn.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rowtrace2_launch(
            ts.blocks.data_ptr(), ts.tre_boxes.data_ptr(),
            ts.mid_boxes.data_ptr(), ts.fan, ts.num_mids,
            org.data_ptr(), d.data_ptr(), tn.data_ptr(), tf.data_ptr(), R,
            t.data_ptr(), prim.data_ptr(), int(occluded), int(cull),
            None if counters is None else counters.data_ptr(),
            None if touched is None else touched.data_ptr(),
            stream)
    launches += 1
    if err != 0:
        msg = lib.rowtrace2_error_string(err).decode()
        raise RuntimeError(f"rowtrace2 kernel launch failed: {err} ({msg})")
    return t, prim


def intersect_rowtrace2(ts: TreeletScene, rays: Rays,
                        occluded: bool = False, cull: bool = False):
    """Full traversal: (t, prim) flat over rays (prim = -1 miss;
    occluded: t == -inf marks hits). Carries no gradient."""
    org, d, tn, tf = _checked_inputs(ts, rays)
    if tn.device.type == "cpu":
        return rowtrace2_plain(ts, Rays(org, d, tn, tf), occluded, cull)
    return _launch(ts, org, d, tn, tf, bool(occluded), bool(cull), None)


def rowtrace2_stats(ts: TreeletScene, rays: Rays, occluded: bool = False,
                    cull: bool = False):
    """The kernel's counting build (CUDA only): (t, prim, counters) where
    counters sums over rays the mids entered, treelets walked, node
    visits and leaf-pair tests, and counts the distinct treelets touched.
    It is slower than the main build (atomics) and is for the roofline
    bound, not for the main path."""
    org, d, tn, tf = _checked_inputs(ts, rays)
    if tn.device.type != "cuda":
        raise ValueError("rowtrace2_stats needs CUDA tensors")
    counters = torch.zeros(4, dtype=torch.int64, device=tn.device)
    touched = torch.zeros(ts.num_treelets, dtype=torch.int32,
                          device=tn.device)
    t, prim = _launch(ts, org, d, tn, tf, bool(occluded), bool(cull),
                      (counters, touched))
    c = counters.tolist()
    return t, prim, {"rays": int(tn.shape[0]), "mids_entered": c[0],
                     "treelets_walked": c[1], "node_visits": c[2],
                     "pair_tests": c[3],
                     "treelets_touched": int(touched.sum().item())}


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def _slab(lox, loy, loz, hix, hiy, hiz, rdx, rdy, rdz, orx, ory, orz, tn):
    tx0 = lox * rdx - orx
    tx1 = hix * rdx - orx
    ty0 = loy * rdy - ory
    ty1 = hiy * rdy - ory
    tz0 = loz * rdz - orz
    tz1 = hiz * rdz - orz
    tmin = torch.maximum(torch.maximum(torch.minimum(tx0, tx1),
                                       torch.minimum(ty0, ty1)),
                         torch.minimum(tz0, tz1)) * ROBUST_MIN
    tmax = torch.minimum(torch.minimum(torch.maximum(tx0, tx1),
                                       torch.maximum(ty0, ty1)),
                         torch.maximum(tz0, tz1)) * ROBUST_MAX
    # inverted/pad boxes miss
    tmax = torch.where(lox <= hix, tmax, torch.full_like(tmax, -math.inf))
    return torch.maximum(tmin, tn), tmax


def _unpack_bounds(v):
    """Split packed-bf16 f32 values into (lo, hi) f32: high 16 bits = lo
    bound, low 16 bits = hi bound (exact bf16 -> f32 widening)."""
    bits = v.view(torch.int32)
    lo = torch.bitwise_and(bits, -65536).view(torch.float32)
    hi = torch.bitwise_left_shift(bits, 16).view(torch.float32)
    return lo, hi


def _first_true(mask):
    """Index of the first True along dim 1 (0 where there is none)."""
    return mask.to(torch.uint8).argmax(dim=1)


class _RayTerms(NamedTuple):
    """Per-ray constants of one lock-step batch, each of shape (n,)."""

    ox: torch.Tensor
    oy: torch.Tensor
    oz: torch.Tensor
    dx: torch.Tensor
    dy: torch.Tensor
    dz: torch.Tensor
    rdx: torch.Tensor
    rdy: torch.Tensor
    rdz: torch.Tensor
    orx: torch.Tensor
    ory: torch.Tensor
    orz: torch.Tensor
    tn: torch.Tensor

    @classmethod
    def from_rays(cls, org, d, tn):
        ox, oy, oz = org.unbind(1)
        dx, dy, dz = d.unbind(1)
        rdx, rdy, rdz = rcp_safe(dx), rcp_safe(dy), rcp_safe(dz)
        return cls(ox, oy, oz, dx, dy, dz, rdx, rdy, rdz,
                   ox * rdx, oy * rdy, oz * rdz, tn)

    def take(self, idx):
        return _RayTerms(*(x[idx] for x in self))

    def slab_args(self, ndim):
        """Ray terms of `_slab`, with `ndim` trailing broadcast axes."""
        ix = (slice(None),) + (None,) * ndim
        return tuple(x[ix] for x in self[6:])


def _walk(ts: TreeletScene, tid, ray: _RayTerms, t, prim, occluded, cull):
    """Walk treelet tid[i] with ray i: node phase against the t at walk
    start, then the marked leaf pairs in ascending id against the live
    t. Returns the updated (t, prim)."""
    k = tid.shape[0]
    dev = tid.device
    # --- node phase: all 85 inner slots x 4 children at once; a child
    # counts only if its parent slot was itself reached
    packed = ts.blocks[tid, :NODE_ROWS, :N_INNER]          # (k, 12, 85)
    lo, hi = _unpack_bounds(packed)
    lo = lo.view(k, 3, 4, N_INNER)                         # [axis, child]
    hi = hi.view(k, 3, 4, N_INNER)
    tmin, tmax = _slab(lo[:, 0], lo[:, 1], lo[:, 2],
                       hi[:, 0], hi[:, 1], hi[:, 2], *ray.slab_args(2))
    hit = (tmin <= tmax) & (tmin <= t[:, None, None])      # (k, 4, 85)
    reached = torch.ones((k, 1), dtype=torch.bool, device=dev)
    for s, e in ((0, 1), (1, 5), (5, 21), (21, N_INNER)):
        # children of slot i are slots 4i+1+c; of an L3 slot, pairs
        # 4(i-21)+c: either way slot-major, child-minor
        reached = (reached[:, :, None]
                   & hit[:, :, s:e].permute(0, 2, 1)).reshape(k, 4 * (e - s))
    pm = reached                                           # (k, 256) pairs

    # --- leaf phase
    flat = ts.blocks.view(-1)
    fofs = torch.arange(LEAF_FIELDS, device=dev) * 128
    t = t.clone()
    prim = prim.clone()
    while True:
        live = pm.any(dim=1).nonzero().squeeze(1)
        if live.numel() == 0:
            break
        p = _first_true(pm[live])
        pm[live, p] = False
        base = ((tid[live] * BLOCK_ROWS + NODE_ROWS + (p >> 7) * LEAF_FIELDS)
                * 128 + (p & 127))
        f = flat[base[:, None] + fofs]                     # (n, 20)
        pid = f.view(torch.int32)
        r = ray.take(live)
        tl, pl = t[live], prim[live]
        for q, o in ((0, 0), (1, 9)):
            v0x, v0y, v0z = f[:, o], f[:, o + 1], f[:, o + 2]
            e1x, e1y, e1z = f[:, o + 3], f[:, o + 4], f[:, o + 5]
            e2x, e2y, e2z = f[:, o + 6], f[:, o + 7], f[:, o + 8]
            ngx = e2y * e1z - e2z * e1y
            ngy = e2z * e1x - e2x * e1z
            ngz = e2x * e1y - e2y * e1x
            cx = v0x - r.ox
            cy = v0y - r.oy
            cz = v0z - r.oz
            rx = cy * r.dz - cz * r.dy
            ry = cz * r.dx - cx * r.dz
            rz = cx * r.dy - cy * r.dx
            den = ngx * r.dx + ngy * r.dy + ngz * r.dz
            absden = den.abs()
            sgn = torch.where(den >= 0, 1.0, -1.0).to(den.dtype)
            u_s = (rx * e2x + ry * e2y + rz * e2z) * sgn
            v_s = (rx * e1x + ry * e1y + rz * e1z) * sgn
            t_s = (ngx * cx + ngy * cy + ngz * cz) * sgn
            front = (den < 0) if cull else (den != 0)
            ok = (front & (u_s >= 0) & (v_s >= 0) & (u_s + v_s <= absden)
                  & (absden * r.tn < t_s) & (t_s <= absden * tl))
            if occluded:
                tl = torch.where(ok, torch.full_like(tl, -math.inf), tl)
            else:
                tl = torch.where(ok, t_s / absden.clamp_min(DEN_MIN), tl)
                pl = torch.where(ok, pid[:, 18 + q], pl)
        t[live] = tl
        prim[live] = pl
        if occluded:
            pm[live[tl == -math.inf]] = False
    return t, prim


def _plain_batch(ts: TreeletScene, org, d, tn, tf, occluded, cull):
    n = tn.shape[0]
    dev = tn.device
    fan, M = ts.fan, ts.num_mids
    ray = _RayTerms.from_rays(org, d, tn)
    t = tf.clone()
    prim = torch.full((n,), -1, dtype=torch.int32, device=dev)

    # a mid's entry distance does not depend on t: slab every (ray, mid)
    # once, compare with the live t when the ray gets there
    mb = ts.mid_boxes
    mid_tmin, mid_tmax = _slab(*(mb[None, :, j] for j in range(6)),
                               *ray.slab_args(1))
    mid_geo = mid_tmin <= mid_tmax                         # (n, M)
    mid_ids = torch.arange(M, device=dev)

    mid = torch.full((n,), -1, dtype=torch.long, device=dev)
    fm = torch.zeros((n, fan), dtype=torch.bool, device=dev)
    done = torch.zeros((n,), dtype=torch.bool, device=dev)
    while True:
        # rays whose fan mask is drained move on to their next live mid
        # and seed its fan mask against the t they have now
        while True:
            idx = (~done & ~fm.any(dim=1)).nonzero().squeeze(1)
            if idx.numel() == 0:
                break
            live = (mid_geo[idx] & (mid_tmin[idx] <= t[idx, None])
                    & (mid_ids[None, :] > mid[idx, None]))
            has = live.any(dim=1)
            done[idx[~has]] = True
            sel = idx[has]
            m = _first_true(live[has])
            mid[sel] = m
            tb = ts.tre_boxes[m][:, :, :fan]               # (k, 6, fan)
            r = ray.take(sel)
            tmin, tmax = _slab(*(tb[:, j] for j in range(6)),
                               *r.slab_args(1))
            fm[sel] = (tmin <= tmax) & (tmin <= t[sel, None])
        act = (~done).nonzero().squeeze(1)
        if act.numel() == 0:
            break
        b = _first_true(fm[act])
        fm[act, b] = False
        t_new, prim_new = _walk(ts, mid[act] * fan + b, ray.take(act),
                                t[act], prim[act], occluded, cull)
        t[act] = t_new
        prim[act] = prim_new
        if occluded:
            done |= t == -math.inf
    if not occluded:
        t = torch.where(prim < 0, tf, t)
    return t, prim


def rowtrace2_plain(ts: TreeletScene, rays: Rays, occluded: bool = False,
                    cull: bool = False):
    """The kernel's function in plain PyTorch ops, float32, on whatever
    device the tensors lie: all rays of a batch advance in lock-step
    through the per-ray state machine (next mid -> seed fan mask -> next
    treelet -> node phase -> pair drain). Rays are independent, so they
    are processed PLAIN_CHUNK at a time to bound memory."""
    org, d, tn, tf = _checked_inputs(ts, rays)
    out_t, out_p = [], []
    for s in range(0, tn.shape[0], PLAIN_CHUNK):
        e = s + PLAIN_CHUNK
        t, prim = _plain_batch(ts, org[s:e], d[s:e], tn[s:e], tf[s:e],
                               bool(occluded), bool(cull))
        out_t.append(t)
        out_p.append(prim)
    if not out_t:
        return (torch.empty(0, dtype=torch.float32, device=tn.device),
                torch.empty(0, dtype=torch.int32, device=tn.device))
    return torch.cat(out_t), torch.cat(out_p)
