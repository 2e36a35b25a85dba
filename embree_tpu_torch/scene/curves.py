"""Curve and line-segment geometry (hair primitives).

Counterpart of embree_tpu/scene/curves.py, the analog of the reference's
curve stack (kernels/geometry/bezier1v.h, line_intersector.h,
kernels/subdiv/bezier_curve.h). The geometry types and their host
tessellation are numpy copies of the JAX package's, so they produce the
same bytes. A cubic Bezier or B-spline curve is tessellated at commit
into round linear segments (position + radius per endpoint);
`make_segment_intersector` is the swept-cone test with spherical end
caps over such a segment soup, in torch ops, for the user-geometry walk
(traverse/user.py).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.math import dot
from .geometry import Geometry


class LineSegments(Geometry):
    """RTC_GEOMETRY_TYPE_FLAT/ROUND_LINEAR_CURVE (Line4i analog).

    vertices: (V, 4) xyzr; indices: (S,) first-vertex index per segment."""

    def __init__(self, vertices, indices):
        super().__init__()
        self.vertices = np.asarray(vertices, np.float32)
        self.indices = np.asarray(indices, np.int32)

    @property
    def num_prims(self) -> int:
        return int(self.indices.shape[0])

    def to_segments(self):
        v = self.vertices
        i = self.indices
        p0 = v[i]
        p1 = v[i + 1]
        prim = np.arange(i.shape[0], dtype=np.int32)
        u0 = np.zeros(i.shape[0], np.float32)
        du = np.ones(i.shape[0], np.float32)
        return p0, p1, prim, u0, du


class BezierCurves(Geometry):
    """RTC_GEOMETRY_TYPE_*_BEZIER_CURVE (bezier1v.h / bezier_curve.h).

    vertices: (V, 4) xyzr control points; indices: (C,) first control
    point of each cubic curve; tessellation_rate segments per curve;
    `flat` selects the ribbon (FLAT) curve type over the round one."""

    def __init__(self, vertices, indices, tessellation_rate: int = 8,
                 flat: bool = False):
        super().__init__()
        self.vertices = np.asarray(vertices, np.float32)
        self.indices = np.asarray(indices, np.int32)
        self.tessellation_rate = int(tessellation_rate)
        self.flat = bool(flat)

    @property
    def num_prims(self) -> int:
        return int(self.indices.shape[0])

    def to_bezier(self):
        """(C, 4, 3) Bezier control points + (C, 4) radii."""
        v = self.vertices
        i = self.indices
        cp = np.stack([v[i], v[i + 1], v[i + 2], v[i + 3]], axis=1)
        return cp[:, :, :3].copy(), cp[:, :, 3].copy()

    def to_segments(self):
        """Uniformly tessellate each cubic Bezier into R segments."""
        v = self.vertices
        i = self.indices
        R = self.tessellation_rate
        c0, c1, c2, c3 = v[i], v[i + 1], v[i + 2], v[i + 3]  # (C, 4)
        ts = np.linspace(0.0, 1.0, R + 1, dtype=np.float32)[:, None, None]
        b = ((1 - ts) ** 3 * c0 + 3 * (1 - ts) ** 2 * ts * c1
             + 3 * (1 - ts) * ts ** 2 * c2 + ts ** 3 * c3)  # (R+1, C, 4)
        p0 = b[:-1].transpose(1, 0, 2).reshape(-1, 4)
        p1 = b[1:].transpose(1, 0, 2).reshape(-1, 4)
        C = i.shape[0]
        prim = np.repeat(np.arange(C, dtype=np.int32), R)
        u0 = np.tile(ts[:-1, 0, 0], C).astype(np.float32)
        du = np.full(C * R, 1.0 / R, np.float32)
        return p0, p1, prim, u0, du


class BSplineCurves(Geometry):
    """RTC_GEOMETRY_TYPE_*_BSPLINE_CURVE (kernels/subdiv/bspline_curve.h).

    Uniform cubic B-spline over (V, 4) xyzr control points; indices (C,)
    give the first of 4 consecutive control points per curve (so a shared
    control polygon yields C1-continuous hair, as in
    curve_geometry_device.cpp:66-76)."""

    def __init__(self, vertices, indices, tessellation_rate: int = 8,
                 flat: bool = False):
        super().__init__()
        self.vertices = np.asarray(vertices, np.float32)
        self.indices = np.asarray(indices, np.int32)
        self.tessellation_rate = int(tessellation_rate)
        self.flat = bool(flat)

    @property
    def num_prims(self) -> int:
        return int(self.indices.shape[0])

    def to_bezier(self):
        """(C, 4, 3) + (C, 4): B-spline spans converted to Bezier
        (bspline_curve.h basis conversion)."""
        from ..build.hair import bezier_from_bspline
        v = self.vertices
        i = self.indices
        cp = np.stack([v[i], v[i + 1], v[i + 2], v[i + 3]], axis=1)
        bz = bezier_from_bspline(cp)
        return (bz[:, :, :3].astype(np.float32),
                bz[:, :, 3].astype(np.float32))

    def to_segments(self):
        """Uniform cubic B-spline basis (bspline_curve.h BSplineBasis):
        N0..N3 over t in [0,1), tessellated into R round segments."""
        v = self.vertices
        i = self.indices
        R = self.tessellation_rate
        c0, c1, c2, c3 = v[i], v[i + 1], v[i + 2], v[i + 3]  # (C, 4)
        ts = np.linspace(0.0, 1.0, R + 1, dtype=np.float32)[:, None, None]
        t2, t3 = ts * ts, ts * ts * ts
        n0 = (1 - 3 * ts + 3 * t2 - t3) / 6.0
        n1 = (4 - 6 * t2 + 3 * t3) / 6.0
        n2 = (1 + 3 * ts + 3 * t2 - 3 * t3) / 6.0
        n3 = t3 / 6.0
        b = n0 * c0 + n1 * c1 + n2 * c2 + n3 * c3  # (R+1, C, 4)
        p0 = b[:-1].transpose(1, 0, 2).reshape(-1, 4)
        p1 = b[1:].transpose(1, 0, 2).reshape(-1, 4)
        C = i.shape[0]
        prim = np.repeat(np.arange(C, dtype=np.int32), R)
        u0 = np.tile(ts[:-1, 0, 0], C).astype(np.float32)
        du = np.full(C * R, 1.0 / R, np.float32)
        return p0, p1, prim, u0, du


class BezierCurvesMB(Geometry):
    """Motion-blur Bezier curves: N >= 2 control-point timesteps over
    one topology (the bvh_builder_msmblur_hair analog). Each timestep
    tessellates into the same R segments; the MB curve accel
    (traverse/mb.py MBCurves) lerps segment endpoints and radii at the
    ray's time and runs the swept-cone test."""

    def __init__(self, vertices_begin=None, vertices_end=None, indices=None,
                 timesteps=None, tessellation_rate: int = 8):
        super().__init__()
        if timesteps is not None:
            self.vertex_timesteps = [np.asarray(v, np.float32)
                                     for v in timesteps]
            assert len(self.vertex_timesteps) >= 2
        else:
            self.vertex_timesteps = [np.asarray(vertices_begin, np.float32),
                                     np.asarray(vertices_end, np.float32)]
        self.indices = np.asarray(indices, np.int32)
        self.tessellation_rate = int(tessellation_rate)

    @property
    def num_prims(self) -> int:
        return int(self.indices.shape[0])

    def timestep_segments(self):
        """Per-timestep (p0, p1, prim, u0, du) segment soups (p0/p1
        carry xyzr) over the SHARED tessellation."""
        return [BezierCurves(v, self.indices,
                             tessellation_rate=self.tessellation_rate
                             ).to_segments()
                for v in self.vertex_timesteps]


def segment_bounds(p0: np.ndarray, p1: np.ndarray):
    lo = np.minimum(p0[:, :3] - p0[:, 3:4], p1[:, :3] - p1[:, 3:4])
    hi = np.maximum(p0[:, :3] + p0[:, 3:4], p1[:, :3] + p1[:, 3:4])
    return lo.astype(np.float32), hi.astype(np.float32)


def make_segment_intersector(p0, p1, prim, u0, du, device):
    """intersect_fn(seg_id, rays, tfar) over the segment soup: swept cone
    plus the two endpoint sphere caps (line_intersector.h round
    segments), in torch ops on `device`. `seg_id` is a python int; rays
    are flat (R,) on `device`. Returns per-ray (valid, t, u, v, ng) with
    u the curve parameter and Ng the radial direction at the hit
    (embree's round-curve normal), and the segment -> prim map."""
    device = torch.device(device)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    P0, P1, U0, DU = up(p0), up(p1), up(u0), up(du)

    def intersect_fn(sid, rays, tfar):
        a0 = P0[sid, :3]
        a1 = P1[sid, :3]
        r0 = P0[sid, 3]
        r1 = P1[sid, 3]
        axis = a1 - a0
        aa = dot(axis, axis).clamp_min(1e-20)
        rr = r1 - r0

        q0 = rays.org - a0
        d = rays.dir
        alpha = dot(q0, axis)
        beta = dot(d, axis)
        dd = dot(d, d)
        q0d = dot(q0, d)
        q0q0 = dot(q0, q0)
        rb = rr * beta
        ra = rr * alpha
        A = dd - beta * beta / aa - rb * rb / (aa * aa)
        B = (2 * q0d - 2 * alpha * beta / aa - 2 * r0 * rr * beta / aa
             - 2 * rr * rr * alpha * beta / (aa * aa))
        C = (q0q0 - alpha * alpha / aa - r0 * r0 - 2 * r0 * rr * alpha / aa
             - ra * ra / (aa * aa))
        disc = B * B - 4 * A * C
        ok = disc >= 0
        sq = torch.sqrt(disc.clamp_min(0.0))
        A_safe = torch.where(A.abs() < 1e-20, 1e-20, A)
        tA = (-B - sq) / (2 * A_safe)
        tB = (-B + sq) / (2 * A_safe)

        def side_ok(t):
            s = (alpha + beta * t) / aa
            return (t > rays.tnear) & (t < tfar) & (s >= 0.0) & (s <= 1.0)

        inf = torch.full_like(tA, math.inf)
        tcone = torch.where(side_ok(tA), tA,
                            torch.where(side_ok(tB), tB, inf))
        cone_ok = ok & torch.isfinite(tcone)

        def cap(center, radius):
            oc = rays.org - center
            b2 = dot(oc, d)
            c2 = dot(oc, oc) - radius * radius
            d2 = b2 * b2 - dd * c2
            okc = d2 >= 0
            sqc = torch.sqrt(d2.clamp_min(0.0))
            t0 = (-b2 - sqc) / dd.clamp_min(1e-20)
            t1 = (-b2 + sqc) / dd.clamp_min(1e-20)
            tc = torch.where(t0 > rays.tnear, t0, t1)
            okc = okc & (tc > rays.tnear) & (tc < tfar)
            return torch.where(okc, tc, inf)

        t_all = torch.minimum(torch.where(cone_ok, tcone, inf),
                              torch.minimum(cap(a0, r0), cap(a1, r1)))
        valid = torch.isfinite(t_all)
        t_hit = torch.where(valid, t_all, tfar)

        s = ((alpha + beta * t_hit) / aa).clamp(0.0, 1.0)
        u = U0[sid] + s * DU[sid]
        pt = rays.org + t_hit[..., None] * d
        ng = pt - (a0 + s[..., None] * axis)
        return valid, t_hit, u, torch.zeros_like(u), ng

    return intersect_fn, np.asarray(prim, np.int32)
