"""Vector math on torch tensors (last axis has size 3).

Counterpart of embree_tpu/core/math.py: only what the ported modules
use. `dot` sums the three products left to right so that the float32
result does not depend on a reduction's internal order.
"""
from __future__ import annotations

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
