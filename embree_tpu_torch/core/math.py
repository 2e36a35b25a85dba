"""Vector math on torch tensors (last axis has size 3).

Counterpart of embree_tpu/core/math.py: only what the ported modules
use. `dot` sums the three products left to right so that the float32
result does not depend on a reduction's internal order.
"""
from __future__ import annotations

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


def rcp_safe(a):
    """Reciprocal with +-0 mapped to a huge finite value (embree rcp_safe)."""
    huge = torch.where(a < 0, -RCP_HUGE, RCP_HUGE).to(a.dtype)
    return torch.where(a.abs() < RCP_EPS, huge, 1.0 / a)
