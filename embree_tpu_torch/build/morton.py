"""30-bit Morton codes.

Counterpart of embree_tpu/build/morton.py::morton3d only (the analog of
bvh_builder_morton.h:77); the device-side Morton BVH builder of that
module (build quality LOW) is not ported yet. Codes are int64 tensors:
the values are those of the JAX package's uint32 codes.
"""
from __future__ import annotations

import torch


def morton3d(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Interleave 10-bit coords (integer tensors) -> 30-bit morton code."""
    def part(v):
        v = v.to(torch.int64) & 0x3FF
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v
    return part(x) | (part(y) << 1) | (part(z) << 2)
