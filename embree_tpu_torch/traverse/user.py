"""User-geometry accel walk: a BVH over callback bounds, leaves tested by
a torch function.

Counterpart of embree_tpu/traverse/user.py (the analog of
kernels/geometry/object.h + object_intersector.h). The JAX package has
no Pallas kernel here: a leaf calls an arbitrary function on the whole
batch, so the walk is torch ops on the rays' device, with the JAX
package's lock-step semantics:

  * one stack for the whole batch, the root first; a popped node's W
    children are slab-tested against every ray (robust slab test, entry
    scaled by 1 - 3*2^-23 and exit by 1 + 3*2^-23, entry clamped to
    tnear, hit when tmin <= tmax and tmin <= t);
  * the leaf children that any ray hits are tested in slot order, each
    leaf's prims (at most LEAF_MAX) in order through
    `intersect_fn(prim, rays, tfar)`; a candidate stands where it is
    valid and tnear < t_hit < t, so an earlier prim keeps an equal t;
  * then the inner children that any ray hits are pushed in slot order,
    so the last slot pops first;
  * `pops` counts the (ray, real child slot) box tests that passed, the
    JAX package's statistic for comparing accels.

The tree structure is read on the host (one copy a call), the boxes and
the rays stay on their device; a pop waits once for the device to say
which children any ray hits. The stack is a python list: unlike the JAX
package's 96-entry array it cannot overflow.

Used by the scene for `UserGeometry` (the user's `intersect_fn`, the
ABI of scene/geometry.py::UserGeometry), for `LineSegments` and for
curves under `hair_accel=segment` (the segment soup), and by the
torch-op hair cluster walk (traverse/hair.py) and the motion-blur curve
walk (traverse/mb.py).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..build.bvh import BVH
from ..core.math import (ROBUST_MAX_RCP as ROBUST_MAX,
                         ROBUST_MIN_RCP as ROBUST_MIN, rcp_safe)
from ..core.rayhit import Rays

LEAF_MAX = 8   # prims of a leaf that are tested (the JAX package's max_leaf)


class UserAccel(NamedTuple):
    bvh: BVH
    geom_id: int
    num_prims: int


def _node_box_test(lower, upper, rdir, org_rdir, tnear, tcur):
    """Robust slab test of W child boxes (W, 3) against R rays:
    (tmin, hit), each (W, R) (node_intersector1.h:108-179)."""
    t_lo = lower[:, None, :] * rdir[None] - org_rdir[None]
    t_hi = upper[:, None, :] * rdir[None] - org_rdir[None]
    tmin = torch.minimum(t_lo, t_hi).amax(dim=-1) * ROBUST_MIN
    tmax = torch.maximum(t_lo, t_hi).amin(dim=-1) * ROBUST_MAX
    tmin = torch.maximum(tmin, tnear[None])
    return tmin, (tmin <= tmax) & (tmin <= tcur[None])


def walk_shared(bvh: BVH, node_test: Callable, leaf: Callable, t0, state):
    """The lock-step walk of the module docstring over `bvh` with a
    pluggable node test `node_test(node, t) -> hit (W, R)` and leaf
    `leaf(prim, t, state) -> (t, state)` called for every prim of every
    leaf that any ray hits. Returns (t, state, pops)."""
    child = bvh.child.cpu().tolist()
    count = bvh.count.cpu().tolist()
    order = bvh.prim_order.cpu().tolist()
    t = t0
    pops = torch.zeros((), dtype=torch.int64, device=t0.device)
    stack = [0]
    while stack:
        node = stack.pop()
        hit = node_test(node, t)
        cnt = count[node]
        hit = hit & (bvh.count[node] >= 0)[:, None]
        any_hit = hit.any(dim=1).tolist()
        pops = pops + hit.sum()
        for c in range(len(cnt)):
            if any_hit[c] and cnt[c] > 0:
                for i in range(min(cnt[c], LEAF_MAX)):
                    t, state = leaf(order[child[node][c] + i], t, state)
        stack.extend(child[node][c] for c in range(len(cnt))
                     if any_hit[c] and cnt[c] == 0)
    return t, state, int(pops)


def intersect_user(accel: UserAccel, intersect_fn: Callable, rays: Rays,
                   t_in, with_stats: bool = False):
    """Returns flat (t, u, v, ng, prim, hit_mask) min-combined against
    t_in, and `pops` (an int) with `with_stats`. `intersect_fn(prim,
    rays, tfar)` returns per-ray (valid, t, u, v, ng)."""
    bvh = accel.bvh
    org = rays.org.reshape(-1, 3)
    d = rays.dir.reshape(-1, 3)
    tn = rays.tnear.reshape(-1)
    R = tn.shape[0]
    dev = tn.device
    rdir = rcp_safe(d)
    org_rdir = org * rdir

    def node_test(node, t):
        return _node_box_test(bvh.lower[node], bvh.upper[node], rdir,
                              org_rdir, tn, t)[1]

    def leaf(p, t, st):
        u, v, ng, prim = st
        ok, th, uh, vh, ngh = intersect_fn(p, Rays(org, d, tn, t), t)
        ok = ok & (th < t) & (th > tn)
        return (torch.where(ok, th, t),
                (torch.where(ok, uh, u), torch.where(ok, vh, v),
                 torch.where(ok[:, None], ngh, ng),
                 torch.where(ok, p, prim)))

    zeros = torch.zeros(R, dtype=torch.float32, device=dev)
    st0 = (zeros, zeros, torch.zeros((R, 3), dtype=torch.float32,
                                     device=dev),
           torch.full((R,), -1, dtype=torch.int32, device=dev))
    t, (u, v, ng, prim), pops = walk_shared(
        bvh, node_test, leaf, t_in.reshape(-1).clone(), st0)
    out = (t, u, v, ng, prim, prim >= 0)
    return out + (pops,) if with_stats else out
