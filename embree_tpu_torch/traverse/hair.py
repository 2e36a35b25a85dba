"""Hair leaf intersectors and the per-cluster curve walk, in torch ops.

Counterpart of embree_tpu/traverse/hair.py. Leaves evaluate the cubic
Bezier directly, subdivided into K linear sub-segments per curve:

* RIBBON (bezier_ribbon semantics, bezier_hair_intersector.h): each
  sub-segment is a flat strip of width 2r facing the ray, hit when the
  2D closest approach of the ray to the segment, in a ray-centric frame,
  is under the interpolated radius. Ng faces the viewer:
  cross(tangent, cross(tangent, dir)).
* ROUND (swept cone, line_intersector.h): `_cone_hit` per sub-segment,
  the same arithmetic as kernel B3's cone leaf.

`intersect_hair_clusters` folds the clusters of build/hair.py: rays are
rotated into each cluster's frame and walk the cluster's BVH over CURVE
bounds through traverse/user.py. This is the JAX package's XLA cluster
walk; the scene does not take it (it runs kernel B3 over a BVH of
sub-segments, traverse/hair_kernel.py), but it is what compares the
strand-aligned clusters with an axis-aligned build by node pops.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.math import cross, rows_times
from ..core.rayhit import Rays
from .hair_kernel import cone_candidates, ribbon_candidates, xyz as _xyz
from .user import UserAccel, intersect_user


def _bezier_points(cp, K: int):
    """cp: (4, C) control points -> (K+1, C) polyline samples at
    t = i / K (float32 quotients, as jnp.linspace gives them)."""
    t = (torch.arange(K + 1, dtype=torch.float32, device=cp.device)
         / K)[:, None]
    s = 1 - t
    b0 = s * s * s
    b1 = 3 * t * (s * s)
    b2 = 3 * t * t * s
    b3 = t * t * t
    return b0 * cp[0] + b1 * cp[1] + b2 * cp[2] + b3 * cp[3]


def _curve_samples(CP, RA, cid, K):
    pts = _bezier_points(CP[cid], K)               # (K+1, 3)
    rs = _bezier_points(RA[cid][:, None], K)[:, 0]  # (K+1,)
    return pts, rs


def _upload(cps, radii, device):
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32))
                 .to(device) for a in (cps, radii))


def make_ribbon_intersector(cps, radii, prim_ids, K: int = 8, *, device):
    """intersect_fn(curve_id, rays, tfar) -> (ok, t, u, v, ng): the flat
    ribbon test per sub-segment. cps (M, 4, 3) / radii (M, 4) are the
    cluster's ROTATED numpy arrays, uploaded to `device`; rays arrive
    rotated; ng returns in the rotated frame. `prim_ids` (the cluster's
    curves) is not read, as in the JAX package."""
    CP, RA = _upload(cps, radii, device)

    def intersect_fn(cid, rays, tfar):
        pts, rs = _curve_samples(CP, RA, cid, K)
        o, d = rays.org, rays.dir
        t_best = tfar
        u_best = torch.zeros_like(tfar)
        v_best = torch.zeros_like(tfar)
        ng_best = torch.zeros(tfar.shape + (3,), device=tfar.device)
        ok_any = torch.zeros(tfar.shape, dtype=torch.bool,
                             device=tfar.device)
        for i in range(K):
            ok, th, s, dist2, r = ribbon_candidates(
                _xyz(o), _xyz(d), rays.tnear, _xyz(pts[i]), _xyz(pts[i + 1]),
                rs[i], rs[i + 1])
            ok = ok & (th < t_best)
            tang = pts[i + 1] - pts[i]
            ngr = cross(tang, cross(tang, d))
            t_best = torch.where(ok, th, t_best)
            u_best = torch.where(ok, (i + s) / K, u_best)
            v_best = torch.where(
                ok, 0.5 + 0.5 * torch.sqrt(dist2) / r.clamp_min(1e-20),
                v_best)
            ng_best = torch.where(ok[:, None], ngr, ng_best)
            ok_any = ok_any | ok
        return ok_any, t_best, u_best, v_best, ng_best

    return intersect_fn


def make_round_curve_intersector(cps, radii, prim_ids, K: int = 8, *,
                                 device):
    """intersect_fn over swept-cone sub-segments (round curves): the
    line_intersector.h cone test per Bezier sub-segment; the arguments
    as `make_ribbon_intersector`'s."""
    CP, RA = _upload(cps, radii, device)

    def intersect_fn(cid, rays, tfar):
        pts, rs = _curve_samples(CP, RA, cid, K)
        t_best = tfar
        u_best = torch.zeros_like(tfar)
        v_best = torch.zeros_like(tfar)
        ng_best = torch.zeros(tfar.shape + (3,), device=tfar.device)
        ok_any = torch.zeros(tfar.shape, dtype=torch.bool,
                             device=tfar.device)
        for i in range(K):
            ok, th, uh, ngh = _cone_hit(pts[i], pts[i + 1], rs[i],
                                        rs[i + 1], rays, t_best)
            t_best = torch.where(ok, th, t_best)
            u_best = torch.where(ok, (i + uh) / K, u_best)
            ng_best = torch.where(ok[:, None], ngh, ng_best)
            ok_any = ok_any | ok
        return ok_any, t_best, u_best, v_best, ng_best

    return intersect_fn


def _cone_hit(a0, a1, r0, r1, rays, tfar):
    """Swept-cone segment test, kernel B3's cone leaf arithmetic
    (hair_kernel.cone_candidates): (ok, t, s clamped to [0, 1], ng).
    a0, a1 are (3,) or (R, 3), r0, r1 scalars or (R,); every quantity is
    per ray."""
    ok, th, s = cone_candidates(_xyz(rays.org), _xyz(rays.dir), rays.tnear,
                                _xyz(a0), _xyz(a1), r0, r1)
    p = rays.org + th[:, None] * rays.dir
    onax = a0 + s[:, None] * (a1 - a0)
    return ok & (th < tfar), th, s.clamp(0.0, 1.0), p - onax


def intersect_hair_clusters(clusters, fns, rays: Rays, t_in, geom_id,
                            prim_of_curve, with_stats: bool = False):
    """Fold the per-cluster rotated BVH walks, min-combined against t_in:
    flat (t, u, v, ng, prim, hit_mask), and the summed pops with
    `with_stats`. clusters: [HairCluster] (build/hair.py); fns: one leaf
    intersector per cluster (over its rotated curves); prim_of_curve (C,)
    maps a curve to its prim id."""
    org = rays.org.reshape(-1, 3)
    d = rays.dir.reshape(-1, 3)
    tn = rays.tnear.reshape(-1)
    t = t_in.reshape(-1)
    dev = t.device
    u = torch.zeros_like(t)
    v = torch.zeros_like(t)
    ng = torch.zeros(t.shape + (3,), device=dev)
    prim = torch.full(t.shape, -1, dtype=torch.int32, device=dev)
    poc = torch.as_tensor(np.asarray(prim_of_curve, np.int32), device=dev)
    pops_total = 0
    for cl, fn in zip(clusters, fns):
        rrays = Rays(rows_times(org, cl.rot), rows_times(d, cl.rot), tn, t)
        res = intersect_user(
            UserAccel(cl.bvh.to_device(dev), geom_id,
                      int(cl.members.shape[0])),
            fn, rrays, t, with_stats=with_stats)
        tc, uc, vc, ngc, pc, hitm = res[:6]
        if with_stats:
            pops_total += res[6]
        use = hitm & (tc < t)
        t = torch.where(use, tc, t)
        u = torch.where(use, uc, u)
        v = torch.where(use, vc, v)
        ng = torch.where(use[:, None], rows_times(ngc, cl.rot.T), ng)
        mem = torch.as_tensor(cl.members, device=dev).long()
        gcurve = mem[pc.clamp_min(0).long()]
        prim = torch.where(use, poc[gcurve], prim)
    out = (t, u, v, ng, prim, prim >= 0)
    return out + (pops_total,) if with_stats else out
