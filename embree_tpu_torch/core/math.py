"""Vector math on torch tensors (last axis has size 3).

Counterpart of embree_tpu/core/math.py. `dot` sums the three products
left to right so that the float32 result does not depend on a
reduction's internal order.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

# python floats that are exactly representable in float32: a tensor op
# with one of these as a scalar gives the same bits on every backend
RCP_EPS = float(np.float32(1e-30))
RCP_HUGE = float(np.float32(1e30))


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] \
        + a[..., 2] * b[..., 2]


def rows_times(x, m):
    """x @ m for rows x (..., 3) and a 3x3 numpy matrix m, each output
    component summed left to right in float32 (no matmul library, so the
    bits do not depend on the device)."""
    m = np.asarray(m, np.float32)
    x0, x1, x2 = x[..., 0], x[..., 1], x[..., 2]
    return torch.stack([x0 * float(m[0, j]) + x1 * float(m[1, j])
                        + x2 * float(m[2, j]) for j in range(3)], dim=-1)


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by,
                        az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def length(a):
    return torch.sqrt(dot(a, a))


def normalize(a):
    return a / length(a).clamp_min(1e-30)[..., None]


def deg2rad(d):
    return d * (np.pi / 180.0)


class AffineSpace(NamedTuple):
    """3x3 linear part + translation, mirroring reference affinespace.h."""

    vx: torch.Tensor  # (..., 3)
    vy: torch.Tensor
    vz: torch.Tensor
    p: torch.Tensor

    def xfm_point(self, q):
        return (q[..., 0:1] * self.vx + q[..., 1:2] * self.vy
                + q[..., 2:3] * self.vz + self.p)

    def xfm_vector(self, q):
        return q[..., 0:1] * self.vx + q[..., 1:2] * self.vy \
            + q[..., 2:3] * self.vz


def lookat(eye, point, up):
    """Reference common/math/affinespace.h:76-81: Z=to-from, U=up x Z,
    V=Z x U. Float32 tensors on the device of `eye`."""
    eye = torch.as_tensor(eye, dtype=torch.float32)
    dev = eye.device
    z = normalize(torch.as_tensor(point, dtype=torch.float32, device=dev)
                  - eye)
    u = normalize(cross(torch.as_tensor(up, dtype=torch.float32, device=dev),
                        z))
    v = normalize(cross(z, u))
    return AffineSpace(u, v, z, eye)


# float ulp scale factors for robust ("watertight") traversal, following
# reference kernels/bvh/node_intersector1.h:108-179 (1+-3ulp rounding guards)
ROBUST_MIN_RCP = float(np.float32(1.0 - 3.0 * 2.0 ** -23))
ROBUST_MAX_RCP = float(np.float32(1.0 + 3.0 * 2.0 ** -23))


def rcp_safe(a):
    """Reciprocal with +-0 mapped to a huge finite value (embree rcp_safe)."""
    huge = torch.where(a < 0, -RCP_HUGE, RCP_HUGE).to(a.dtype)
    return torch.where(a.abs() < RCP_EPS, huge, 1.0 / a)


# ---------------------------------------------------------------------------
# Axis-aligned bounding boxes: stored as a pair of (..., 3) tensors.
# ---------------------------------------------------------------------------

def bbox_empty(shape=(), device="cpu"):
    lower = torch.full(tuple(shape) + (3,), math.inf, dtype=torch.float32,
                       device=device)
    upper = torch.full(tuple(shape) + (3,), -math.inf, dtype=torch.float32,
                       device=device)
    return lower, upper


def bbox_merge(lower_a, upper_a, lower_b, upper_b):
    return torch.minimum(lower_a, lower_b), torch.maximum(upper_a, upper_b)


def bbox_half_area(lower, upper):
    d = (upper - lower).clamp_min(0.0)
    return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] \
        + d[..., 2] * d[..., 0]


def bbox_area(lower, upper):
    """Surface-area metric used by the SAH (reference bbox.h halfArea x2)."""
    return 2.0 * bbox_half_area(lower, upper)
