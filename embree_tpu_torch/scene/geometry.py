"""Geometry types (host-side containers bound into a Scene).

Counterpart of embree_tpu/scene/geometry.py (reference
kernels/common/geometry.h + scene_*_mesh.*): buffer binding happens on
the host; Scene.commit() flattens everything into immutable device
tensors. Triangle and quad meshes only so far.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


class Geometry:
    """Base geometry (geometry.h): enable/disable, user data, vertex attrs."""

    def __init__(self):
        self.enabled = True
        self.user_data = None
        self.geom_id: Optional[int] = None
        # rtcSetGeometryMask analog (geometry.h mask; default all bits).
        # Hits stand only when (geom.mask & ray.mask) != 0 for rays traced
        # with a mask (EMBREE_RAY_MASK semantics).
        self.mask = -1
        self.vertex_attributes = []  # list of (V, K) arrays (rtcSetGeometryVertexAttributeCount)

    def enable(self):
        self.enabled = True

    def disable(self):
        self.enabled = False

    @property
    def num_prims(self) -> int:
        raise NotImplementedError


class TriangleMesh(Geometry):
    """RTC_GEOMETRY_TYPE_TRIANGLE (scene_triangle_mesh.h)."""

    def __init__(self, vertices, indices):
        super().__init__()
        self.vertices = vertices          # (V, 3) f32
        self.indices = np.asarray(indices, np.int32)  # (T, 3)

    @property
    def num_prims(self) -> int:
        return int(self.indices.shape[0])


class QuadMesh(Geometry):
    """RTC_GEOMETRY_TYPE_QUAD (scene_quad_mesh.h): quad = two triangles
    (v0,v1,v3) + (v2,v3,v1) sharing the diagonal, uv in [0,1]^2 over the
    quad with the second triangle remapped u->1-u, v->1-v (quadv.h)."""

    def __init__(self, vertices, indices):
        super().__init__()
        self.vertices = vertices          # (V, 3) f32
        self.indices = np.asarray(indices, np.int32)  # (Q, 4)

    @property
    def num_prims(self) -> int:
        return int(self.indices.shape[0])
