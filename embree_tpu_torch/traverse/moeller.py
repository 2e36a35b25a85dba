"""Moeller-Trumbore triangle intersection (vectorized over rays).

Counterpart of embree_tpu/traverse/moeller.py: `intersect_triangle`, the
reference's precomputed-cross variant
(kernels/geometry/triangle_intersector_moeller.h:80-113):

    e1 = v0 - v1,  e2 = v2 - v0,  Ng = cross(e2, e1)        (:122,132-133)
    C = v0 - O,    R = cross(C, D),  den = dot(Ng, D)
    U = dot(R, e2) ^ sgn(den),  V = dot(R, e1) ^ sgn(den)
    valid: den != 0, U >= 0, V >= 0, U + V <= |den|
    T = dot(Ng, C) ^ sgn(den),  |den|*tnear < T <= |den|*tfar
    u = U/|den|, v = V/|den|, t = T/|den|                    (:42-47 finalize)

The division is deferred exactly like the reference (sign-flip instead
of divide). Broadcasts a single triangle against any ray batch shape, or
triangle batches against matching ray batches. Also the Pluecker
(watertight) variant and the barycentric hit point.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.math import cross, dot

DEN_MIN = float(np.float32(1e-37))
PLUECKER_EPS = float(np.float32(1e-8))


def intersect_triangle(org, direction, tnear, tfar, v0, v1, v2,
                       backface_cull: bool = False):
    """Returns (valid, t, u, v, ng); t/u/v are garbage where ~valid."""
    e1 = v0 - v1
    e2 = v2 - v0
    ng = cross(e2, e1)

    c = v0 - org
    r = cross(c, direction)
    den = dot(ng, direction)
    abs_den = den.abs()
    sgn = torch.where(den >= 0, 1.0, -1.0).to(den.dtype)

    u_s = dot(r, e2) * sgn
    v_s = dot(r, e1) * sgn
    front = (den < 0) if backface_cull else (den != 0)
    valid = front & (u_s >= 0) & (v_s >= 0) & (u_s + v_s <= abs_den)

    t_s = dot(ng, c) * sgn
    valid = valid & (abs_den * tnear < t_s) & (t_s <= abs_den * tfar)

    rcp = torch.where(abs_den > 0, 1.0 / abs_den.clamp_min(DEN_MIN),
                      torch.zeros_like(abs_den))
    return valid, t_s * rcp, u_s * rcp, v_s * rcp, ng


def triangle_uv_and_point(org, direction, t, u, v, v0, v1, v2):
    """The hit point re-evaluated from barycentrics (the diff pass's
    recompute-from-primID trick, SURVEY.md section 7.6); `org`,
    `direction` and `t` are not read, as in the JAX package."""
    return (v0 * (1.0 - u - v)[..., None] + v1 * u[..., None]
            + v2 * v[..., None])


def intersect_triangle_pluecker(org, direction, tnear, tfar, v0, v1, v2,
                                backface_cull: bool = False):
    """Pluecker-coordinate triangle test (triangle_intersector_pluecker.h):
    the watertight variant of robust mode; the edge tests share their
    terms between adjacent triangles, so a ray crossing a shared edge
    hits at least one of them. Returns (valid, t, u, v, ng) like
    intersect_triangle."""
    e0 = v2 - v0
    e1 = v0 - v1
    e2 = v1 - v2
    a0 = v0 - org
    a1 = v1 - org
    a2 = v2 - org
    # signed edge volumes (Pluecker inner products)
    u_ = dot(cross(a2 + a0, e0), direction)
    v_ = dot(cross(a0 + a1, e1), direction)
    w_ = dot(cross(a1 + a2, e2), direction)
    uvw = u_ + v_ + w_
    eps = PLUECKER_EPS * uvw.abs()
    valid = torch.minimum(torch.minimum(u_, v_), w_) >= -eps
    if not backface_cull:
        valid = valid | (torch.maximum(torch.maximum(u_, v_), w_) <= eps)

    ng = cross(e0, e1)  # == cross(v1 - v0, v2 - v0), Moeller's Ng
    den = 2.0 * dot(ng, direction)
    t_s = 2.0 * dot(a0, ng)
    abs_den = den.abs()
    sgn = torch.where(den >= 0, 1.0, -1.0).to(den.dtype)
    t_scaled = t_s * sgn
    valid = valid & (den != 0) & (abs_den * tnear < t_scaled) \
        & (t_scaled <= abs_den * tfar)

    rcp_uvw = torch.where(uvw.abs() > DEN_MIN, 1.0 / uvw,
                          torch.zeros_like(uvw))
    u_out = (u_ * rcp_uvw).clamp(0.0, 1.0)
    v_out = (v_ * rcp_uvw).clamp(0.0, 1.0)
    t_out = t_scaled / abs_den.clamp_min(DEN_MIN)
    return valid, t_out, u_out, v_out, ng
