"""Differentiable hit evaluation.

Counterpart of embree_tpu/diff/hit.py. BVH build and hit *selection* are
discrete and run under `torch.no_grad()`; the hit point is then
re-evaluated analytically from the winning primitive, so that gradients
flow from pixels to vertex positions — the reference's `rtcInterpolate`
derivative machinery (rtcore_geometry.h:234-338) defines which
derivatives exist (P, dPdu, dPdv); here they come from autograd through
the re-evaluation.

Usage: `tris` must be built from the differentiable vertex tensors (the
ones the loss differentiates), while the BVH can be stale — embree's
REFIT-vs-rebuild split.

`hit_t_grad` is the training step's loss surface: its forward is the
traversal kernel's own t, its backward the analytic dt/dcorner
scattered into the vertex table with `index_add_`. On CUDA `index_add_`
sums with atomics in an order that changes from run to run, so two runs
agree to float32 rounding of the sums (about 1e-6 relative per vertex
at a few dozen contributions), not bit for bit.
"""
from __future__ import annotations

import torch

from ..core.math import cross, dot
from ..core.rayhit import Hits, Rays
from ..scene.prims import TrianglePrims
from ..scene.scene import CommittedScene, scene_intersect


def _solve_hit(v0, v1, v2, rays: Rays):
    """(t, u, v, ng) of each ray against its own triangle, as
    differentiable tensor ops."""
    e1 = v1 - v0
    e2 = v2 - v0
    ng = cross(e1, e2)  # == reference Ng = cross(e2', e1') with their edges
    # solve ray/plane: t = dot(v0 - org, ng) / dot(dir, ng)
    den = dot(rays.dir, ng)
    den_safe = torch.where(den.abs() > 1e-30, den, torch.ones_like(den))
    t = dot(v0 - rays.org, ng) / den_safe
    pt = rays.org + t[..., None] * rays.dir
    w = pt - v0
    d00 = dot(e1, e1)
    d01 = dot(e1, e2)
    d11 = dot(e2, e2)
    d20 = dot(w, e1)
    d21 = dot(w, e2)
    denom = d00 * d11 - d01 * d01
    denom_safe = torch.where(denom.abs() > 1e-30, denom,
                             torch.ones_like(denom))
    u = (d11 * d20 - d01 * d21) / denom_safe
    v = (d00 * d21 - d01 * d20) / denom_safe
    return t, u, v, ng


def _gather(table, p):
    """table[p] through `index_select`, whose backward is one `index_add`
    (advanced indexing's sorts its indices first)."""
    return table.index_select(0, p.reshape(-1)).reshape(
        p.shape + table.shape[1:])


def reeval_hit(tris: TrianglePrims, rays: Rays, gprim, valid) -> Hits:
    """Recompute (t, u, v, Ng) differentiably for the selected prim."""
    p = gprim.clamp_min(0).long()
    t, u, v, ng = _solve_hit(_gather(tris.v0, p), _gather(tris.v1, p),
                             _gather(tris.v2, p), rays)
    flip = tris.uv_flip[p] == 1
    u = torch.where(flip, 1.0 - u, u)
    v = torch.where(flip, 1.0 - v, v)
    z = torch.zeros_like(t)
    invalid = torch.full_like(gprim, -1, dtype=torch.int32)
    return Hits(
        t=torch.where(valid, t, rays.tfar),
        u=torch.where(valid, u, z),
        v=torch.where(valid, v, z),
        ng=torch.where(valid[..., None], ng, torch.zeros_like(ng)),
        prim_id=torch.where(valid, tris.prim_id[p], invalid),
        geom_id=torch.where(valid, tris.geom_id[p], invalid),
        gprim=torch.where(valid, gprim.to(torch.int32), invalid),
        inst_id=invalid.clone(),
    )


def reeval_hit_verts(vertices, tri_idx, rays: Rays, gprim, valid):
    """Like reeval_hit but differentiates w.r.t. the VERTEX table
    directly: gathers the winning primitive's three corners from
    `vertices` through the static connectivity `tri_idx`. Returns
    (t, u, v) only — the training-loss surface.

    Reference analog: rtcInterpolate's vertex-buffer derivative path
    (rtcore_geometry.h:234-338) — gradients exist w.r.t. the vertex
    buffer, not a per-primitive copy.

    CONSTRAINT: `gprim` indexes `tri_idx` directly, so this is only
    correct for a SINGLE triangle-mesh geometry whose committed prim
    order equals the input connectivity order (no quad split, no
    multi-geometry remap, no uv_flip). For general scenes use
    reeval_hit, which goes through the committed per-prim tables
    (uv_flip included)."""
    vidx = tri_idx[gprim.clamp_min(0).long()].long()     # (..., 3) discrete
    g = vertices[vidx]                                   # (..., 3, 3)
    t, u, v, _ng = _solve_hit(g[..., 0, :], g[..., 1, :], g[..., 2, :], rays)
    z = torch.zeros_like(t)
    return (torch.where(valid, t, rays.tfar),
            torch.where(valid, u, z), torch.where(valid, v, z))


class _TFused(torch.autograd.Function):
    """Forward: where(valid, t_kernel, tfar). Backward: analytic
    d t / d corners. For t = dot(v0-org, n)/dot(d, n) with
    n = cross(v1-v0, v2-v0),
        g      = (q - t d) / den,      q = v0 - org
        dt/dv0 = n/den + (e1-e2) x g
        dt/dv1 = e2 x g
        dt/dv2 = g x e1
    (translation check: the three sum to n/den). The cotangent lands in
    the vertex table through one index_add_ of 3R rows."""

    @staticmethod
    def forward(ctx, vertices, tri_idx, p, corner_tables, org, d, tfar,
                t_kernel, valid):
        ctx.save_for_backward(vertices, tri_idx, p, org, d, t_kernel, valid,
                              *corner_tables)
        return torch.where(valid, t_kernel, tfar)

    @staticmethod
    def backward(ctx, ct):
        (vertices, tri_idx, p, org, d, t, valid,
         *corner_tables) = ctx.saved_tensors
        # every gather happens here, none in the forward
        vidx = tri_idx[p].long()                             # (R, 3)
        if corner_tables:
            v0, v1, v2 = (tab[p] for tab in corner_tables)
        else:
            g3 = vertices[vidx]
            v0, v1, v2 = g3[..., 0, :], g3[..., 1, :], g3[..., 2, :]
        e1 = v1 - v0
        e2 = v2 - v0
        n = cross(e1, e2)
        den = dot(d, n)
        den_safe = torch.where(den.abs() > 1e-30, den, torch.ones_like(den))
        q = v0 - org
        # sanitize miss lanes (t = tfar = inf would make inf * 0 = NaN
        # under the valid mask below)
        t_s = torch.where(valid, t, torch.zeros_like(t))
        gv = (q - t_s[..., None] * d) / den_safe[..., None]
        dv0 = n / den_safe[..., None] + cross(e1 - e2, gv)
        dv1 = cross(e2, gv)
        dv2 = cross(gv, e1)
        w = torch.where(valid, ct, torch.zeros_like(ct))[..., None]
        cts = torch.stack([dv0 * w, dv1 * w, dv2 * w], dim=-2)  # (R, 3, 3)
        gout = torch.zeros_like(vertices)
        gout.index_add_(0, vidx.reshape(-1), cts.reshape(-1, 3))
        return gout, None, None, None, None, None, None, None, None


def hit_t_grad(vertices, tri_idx, rays: Rays, gprim, valid, t_kernel,
               tris=None):
    """Fused training-loss surface for t: the PRIMAL is the traversal
    kernel's own t (no forward re-evaluation at all); the backward
    gathers the winning corners and applies the analytic dt/dcorner
    formulas. Same gradient as reeval_hit_verts' t output.

    Same single-triangle-mesh constraint as reeval_hit_verts. Pass the
    committed `tris` (TrianglePrims) to take corner positions from its
    per-triangle tables instead of a gather through `tri_idx`; they are
    coefficients only — the gradient still lands in `vertices`."""
    p = gprim.clamp_min(0).long()
    tables = () if tris is None else tuple(
        x.detach() for x in (tris.v0, tris.v1, tris.v2))
    return _TFused.apply(vertices, tri_idx, p, tables, rays.org, rays.dir,
                         rays.tfar, t_kernel.detach(), valid)


def intersect_diff(cs: CommittedScene, rays: Rays,
                   isa: str = "default") -> Hits:
    """Closest-hit with gradients: discrete traversal without gradient,
    differentiable analytic re-evaluation on the selected primitive."""
    with torch.no_grad():
        sel = scene_intersect(cs, Rays(*(x.detach() for x in rays)), isa=isa)
    return reeval_hit(cs.tris, rays, sel.gprim, sel.valid)
