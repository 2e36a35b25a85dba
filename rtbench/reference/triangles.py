"""Closest hit of rays against a triangle soup by brute force, in plain
torch: every ray against every triangle, in blocks.

The triangle test is Embree's Moeller-Trumbore with the precomputed
cross product (kernels/geometry/triangle_intersector_moeller.h:80-113):

    e1 = v0 - v1,  e2 = v2 - v0,  Ng = cross(e2, e1)
    C = v0 - O,    R = cross(C, D),  den = dot(Ng, D)
    U = dot(R, e2) * sgn(den),  V = dot(R, e1) * sgn(den)
    valid: den != 0, U >= 0, V >= 0, U + V <= |den|, 0 < T
    T = dot(Ng, C) * sgn(den),  t = T * (1 / |den|), u = U * (1 / |den|)

The nearest valid t wins; on equal t the lowest triangle index. `dtype`
is the precision every operation runs in (float32 for the reference,
bfloat16 for its control); the answers come back in float32.
"""
from __future__ import annotations

import math

import torch

RAY_BLOCK = 64
TRI_BLOCK = 1 << 16
DEN_MIN = 1e-37


def _cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _test(org, d, v0, e1, e2, ng):
    """(valid, t, u, v) of rays (R, 1, 3) against triangles (1, T, 3)."""
    c = v0 - org
    r = _cross(c, d)
    den = _dot(ng, d)
    abs_den = den.abs()
    sgn = torch.where(den >= 0, 1.0, -1.0).to(den.dtype)
    u_s = _dot(r, e2) * sgn
    v_s = _dot(r, e1) * sgn
    t_s = _dot(ng, c) * sgn
    valid = ((den != 0) & (u_s >= 0) & (v_s >= 0) & (u_s + v_s <= abs_den)
             & (t_s > 0))
    rcp = 1.0 / abs_den.clamp_min(DEN_MIN)
    return valid, t_s * rcp, u_s * rcp, v_s * rcp


def closest(v0, v1, v2, org, d, dtype=torch.float32) -> dict:
    """Closest hit of rays (org, d) (R, 3) against triangles (T, 3) each:
    {"valid" (R,) bool, "tri" (R,) i64 (-1 where missed), "t", "u", "v"
    (R,) f32, "ng" (R, 3) f32}, computed on the tensors' device."""
    v0, v1, v2 = (a.to(dtype) for a in (v0, v1, v2))
    e1 = v0 - v1
    e2 = v2 - v0
    ng = _cross(e2, e1)
    org, d = org.to(dtype), d.to(dtype)
    R, T = org.shape[0], v0.shape[0]
    best_t = torch.full((R,), math.inf, dtype=torch.float32,
                        device=org.device)
    best_i = torch.full((R,), -1, dtype=torch.int64, device=org.device)
    for r0 in range(0, R, RAY_BLOCK):
        o = org[r0:r0 + RAY_BLOCK, None]
        dd = d[r0:r0 + RAY_BLOCK, None]
        bt, bi = best_t[r0:r0 + RAY_BLOCK], best_i[r0:r0 + RAY_BLOCK]
        for s in range(0, T, TRI_BLOCK):
            sl = slice(s, s + TRI_BLOCK)
            ok, t, _u, _v = _test(o, dd, v0[None, sl], e1[None, sl],
                                  e2[None, sl], ng[None, sl])
            t = torch.where(ok, t.float(), math.inf)
            tm, ti = t.min(dim=1)
            take = tm < bt       # strict: an earlier block keeps a tie
            bt.copy_(torch.where(take, tm, bt))
            bi.copy_(torch.where(take, ti + s, bi))
    valid = best_i >= 0
    k = best_i.clamp_min(0)
    ok, t, u, v = _test(org[:, None], d[:, None], v0[k][:, None],
                        e1[k][:, None], e2[k][:, None], ng[k][:, None])
    zero = torch.zeros(R, dtype=torch.float32, device=org.device)
    return {"valid": valid,
            "tri": torch.where(valid, best_i, -1),
            "t": torch.where(valid, t[:, 0].float(), math.inf),
            "u": torch.where(valid, u[:, 0].float(), zero),
            "v": torch.where(valid, v[:, 0].float(), zero),
            "ng": torch.where(valid[:, None], ng[k].float(), 0.0)}
