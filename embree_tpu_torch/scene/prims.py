"""Flattened primitive arrays shared by builders and traversal kernels.

Counterpart of embree_tpu/scene/prims.py: at commit time the scene
flattens every triangle/quad geometry into one global SoA triangle soup
(quads become two triangles sharing an edge with a uv-flip flag,
matching the reference Quad4v convention, kernels/geometry/quadv.h).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class TrianglePrims(NamedTuple):
    v0: torch.Tensor       # (T, 3) f32
    v1: torch.Tensor       # (T, 3) f32
    v2: torch.Tensor       # (T, 3) f32
    geom_id: torch.Tensor  # (T,) i32
    prim_id: torch.Tensor  # (T,) i32 prim index inside its geometry
    uv_flip: torch.Tensor  # (T,) i32 1 => second quad triangle: uv -> 1-uv

    @property
    def num_prims(self):
        return self.v0.shape[0]


def empty_triangle_prims(*, device) -> TrianglePrims:
    z3 = torch.zeros((0, 3), dtype=torch.float32, device=device)
    zi = torch.zeros((0,), dtype=torch.int32, device=device)
    return TrianglePrims(z3, z3, z3, zi, zi, zi)


def prim_bounds_np(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray):
    lower = np.minimum(np.minimum(v0, v1), v2)
    upper = np.maximum(np.maximum(v0, v1), v2)
    return lower, upper
