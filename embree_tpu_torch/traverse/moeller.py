"""Moeller-Trumbore triangle intersection (vectorized over rays).

Counterpart of embree_tpu/traverse/moeller.py::intersect_triangle, the
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
triangle batches against matching ray batches.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.math import cross, dot

DEN_MIN = float(np.float32(1e-37))


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
