"""Geometry types (host-side containers bound into a Scene).

Counterpart of embree_tpu/scene/geometry.py (reference
kernels/common/geometry.h + scene_*_mesh.*): buffer binding happens on
the host; Scene.commit() flattens everything into immutable device
tensors. Triangle, quad and subdivision meshes, each also with N >= 2
vertex timesteps (motion blur); instances of committed scenes; user
geometry. The curve types live in scene/curves.py.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.device import Error, RaytracerError


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


class SubdivMesh(Geometry):
    """RTC_GEOMETRY_TYPE_SUBDIVISION (scene_subdiv_mesh.{h,cpp}).

    Face-vertex topology with optional crease tags; evaluated by the
    subdiv/ package (Catmull-Clark limit surface + optional displacement).
    `displacement` is a *function* (P, Ng, u, v) -> P' on numpy arrays of
    the subdivided vertices and their normals, replacing the reference's
    C displacement callback ABI (subdivpatch1base_eval.cpp:139-156); it
    runs on the host at commit. Per-edge tessellation levels
    (`edge_levels`, one rate a face corner for the edge that starts
    there) drive the eager tessellation with crack-free stitching.
    """

    def __init__(self, vertices, face_counts, face_indices,
                 edge_creases=None, edge_crease_weights=None,
                 vertex_creases=None, vertex_crease_weights=None,
                 holes=None, displacement=None,
                 tessellation_rate: int = 2, edge_levels=None):
        super().__init__()
        self.vertices = vertices                              # (V, 3)
        self.face_counts = np.asarray(face_counts, np.int32)  # (F,)
        self.face_indices = np.asarray(face_indices, np.int32)  # (sum counts,)
        # RTC_BUFFER_TYPE_LEVEL analog: per face-corner tessellation rate
        # for the edge (v_k, v_{k+1}) of each face, or None for uniform
        self.edge_levels = (None if edge_levels is None
                            else np.asarray(edge_levels, np.float32))
        self.edge_creases = edge_creases
        self.edge_crease_weights = edge_crease_weights
        self.vertex_creases = vertex_creases
        self.vertex_crease_weights = vertex_crease_weights
        self.holes = holes
        self.displacement = displacement
        self.tessellation_rate = tessellation_rate

    @property
    def num_prims(self) -> int:
        return int(self.face_counts.shape[0])


class Instance(Geometry):
    """RTC_GEOMETRY_TYPE_INSTANCE (scene_instance.{h,cpp}): places a
    child Scene under an affine transform (local -> world, (3, 4) or
    (4, 4)). The child is committed at the parent's commit if it was
    not, and must live on the parent's device. Rays are transformed into
    instance space at traversal (instance_intersector.{h,cpp}); hit
    distances are preserved (directions stay unnormalized). The child's
    committed form is shared by every instance of it, never copied."""

    def __init__(self, child_scene, transform):
        super().__init__()
        self.child_scene = child_scene
        t = np.asarray(transform, np.float32)
        if t.shape == (4, 4):
            t = t[:3, :]
        if t.shape != (3, 4):
            raise RaytracerError(
                Error.INVALID_ARGUMENT,
                f"an instance transform is (3, 4) or (4, 4), not {t.shape}")
        self.transform = t  # local -> world

    @property
    def num_prims(self) -> int:
        return 1


class UserGeometry(Geometry):
    """RTC_GEOMETRY_TYPE_USER (scene_user_geometry + object_intersector):
    callback-based bounds and intersection. The C callback ABI becomes a
    pair of python functions:

        bounds_fn(ids: np.ndarray (N,) int64)
            -> (lower (N, 3), upper (N, 3))          numpy, on the host,
                                                       once at commit
        intersect_fn(prim: int, rays: Rays, tfar (R,))
            -> (valid (R,) bool, t, u, v (R,) f32, ng (R, 3) f32)

    `intersect_fn` works on torch tensors on the rays' device: `rays`
    is a flat batch of R rays whose `tfar` is the running closest t, and
    it is called once for each prim of each BVH leaf that any ray
    reaches (traverse/user.py). A candidate stands where it is valid and
    tnear < t < tfar."""

    def __init__(self, num_prims, bounds_fn, intersect_fn):
        super().__init__()
        self._num = int(num_prims)
        self.bounds_fn = bounds_fn
        self.intersect_fn = intersect_fn

    @property
    def num_prims(self) -> int:
        return self._num


def _timesteps(vertices_begin, vertices_end, timesteps):
    """The vertex timesteps of an MB geometry: `timesteps` (N >= 2) or
    the two-argument linear form."""
    if timesteps is None:
        timesteps = [vertices_begin, vertices_end]
    out = [np.asarray(v, np.float32) for v in timesteps]
    assert len(out) >= 2
    return out


class TriangleMeshMB(Geometry):
    """Motion-blur triangle mesh with N >= 2 vertex timesteps
    (RTC_GEOMETRY_TYPE_TRIANGLE with rtcSetGeometryTimeStepCount;
    multi-segment per bvh_builder_msmblur.h). The 2-argument form keeps
    the linear-motion API; pass `timesteps=[v_t0, v_t1, ...]` for
    multi-segment motion."""

    def __init__(self, vertices_begin=None, vertices_end=None, indices=None,
                 timesteps=None):
        super().__init__()
        self.vertex_timesteps = _timesteps(vertices_begin, vertices_end,
                                           timesteps)
        self.indices = np.asarray(indices, np.int32)

    @property
    def vertices_begin(self):
        return self.vertex_timesteps[0]

    @property
    def vertices_end(self):
        return self.vertex_timesteps[-1]

    @property
    def num_prims(self) -> int:
        return int(self.indices.shape[0])


class QuadMeshMB(Geometry):
    """Motion-blur quad mesh (RTC_GEOMETRY_TYPE_QUAD with N timesteps).
    Quads split into the same two triangles as QuadMesh at every
    timestep, so the lerped leaves stay watertight across the shared
    diagonal."""

    def __init__(self, vertices_begin=None, vertices_end=None, indices=None,
                 timesteps=None):
        super().__init__()
        self.vertex_timesteps = _timesteps(vertices_begin, vertices_end,
                                           timesteps)
        self.indices = np.asarray(indices, np.int32)   # (Q, 4)

    @property
    def num_prims(self) -> int:
        return int(self.indices.shape[0])


class SubdivMeshMB(Geometry):
    """Motion-blur Catmull-Clark subdivision mesh: N >= 2 cage-vertex
    timesteps over one topology (verify.cpp:4367-4416 `_subdiv ... MB`).
    Commit tessellates every timestep with the shared refinement plan;
    the triangle soups feed the multi-segment MB accel."""

    def __init__(self, vertices_begin=None, vertices_end=None,
                 face_counts=None, face_indices=None, timesteps=None,
                 edge_creases=None, edge_crease_weights=None,
                 vertex_creases=None, vertex_crease_weights=None,
                 displacement=None):
        super().__init__()
        self.vertex_timesteps = _timesteps(vertices_begin, vertices_end,
                                           timesteps)
        self.face_counts = np.asarray(face_counts, np.int64)
        self.face_indices = np.asarray(face_indices, np.int64)
        self.edge_creases = edge_creases
        self.edge_crease_weights = edge_crease_weights
        self.vertex_creases = vertex_creases
        self.vertex_crease_weights = vertex_crease_weights
        self.displacement = displacement

    @property
    def vertices(self):
        return self.vertex_timesteps[0]

    @property
    def num_prims(self) -> int:
        return int(self.face_counts.shape[0])
