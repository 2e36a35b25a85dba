"""embree_tpu_torch — the PyTorch/CUDA port of embree_tpu.

Same sub-package and function names as the JAX package, so the
counterpart of a module is found by its path; plain functions on torch
tensors inside, an explicit `torch.device` everywhere, and hand-written
CUDA kernels (`csrc/`) where the JAX package has Pallas kernels:
triangle, quad and subdivision-surface scenes; commit (SAH BVH4/BVH8 +
packing, treelet scene for large meshes, the compressed per-tile
quadtree for displaced Catmull-Clark surfaces); closest-hit / any-hit
queries through the per-ray treelet traversal (large incoherent
batches), the BVH packet kernel (everything else on triangles) and the
compressed-tile kernels, with ray masks and intersection filters;
motion blur: triangle, quad and subdivision meshes with N >= 2 vertex
timesteps, closest hit at a time a ray through the MB kernel; curves:
line segments, round and flat Bezier and B-spline hair in strand-aligned
OBB clusters through the hair kernel, motion-blur Bezier curves;
instances of committed scenes (nested too) and user geometry, each
instance through its child's own kernels; the rtcore API facade
(`rtcore.py`, `rtcBuildBVH` through `build/user_builder.py`); the
differentiable hit (`diff.hit`), the differentiable subdivision renderer
and its train step (`diff.render`) and the material gradients, one bounce
at frozen hits or through the pathtracer (`diff.materials`); the device
morton build (`build.morton`) and tree rotations (`build.rotate`);
rtcInterpolate (`Scene.interpolate`,
`interpolate_normal`: positions, normals, vertex attributes and the
analytic limit-surface derivatives of subdiv/patches.py); the OBJ/MTL,
XML, PLY and Corona scene loaders, textures, the materials (evaluation
and sampling, Medium tracking) and lights; the wavefront `pathtracer`;
the `convert` tool; the `triangle_geometry`,
`displacement_geometry`, `motion_blur_geometry`, `hair_geometry`,
`curve_geometry`, `viewer`, `interpolation`, `subdivision_geometry`,
`instanced_geometry`, `user_geometry`, `intersection_filter`,
`lazy_geometry`, `bvh_builder`, `bvh_access`, `viewer_stream`,
`dynamic_scene` and `viewer_anim` tutorials (`render.tutorials`); the
`buildbench` microbenchmark (`verify.buildbench`); distribution on
`torch.distributed` (`dist.sharding`: data-parallel rays and the sharded
train step; `dist.prim_shard`: the primitive-sharded ray ring), the
packet walks' public entries (`traverse.packet`), `verify.scalebench`
and the traversal benchmark matrix `verify.benchmarks`.

Quick start::

    import embree_tpu_torch as ett
    dev = ett.Device("verbose=1")            # the CUDA device; raises without one
    scene = ett.Scene(dev)
    scene.attach(ett.TriangleMesh(vertices, indices))
    scene.commit()
    hits = scene.intersect(ett.make_rays(org, dir, device=dev.device))
"""
from .core.config import State
from .core.device import Device, Error, RaytracerError
from .core.rayhit import Hits, INVALID_ID, Rays, make_rays, miss_hits
from .scene.curves import (BezierCurves, BezierCurvesMB, BSplineCurves,
                           LineSegments)
from .scene.geometry import (Geometry, Instance, QuadMesh, QuadMeshMB,
                             SubdivMesh, SubdivMeshMB, TriangleMesh,
                             TriangleMeshMB, UserGeometry)
from .scene.scene import (BuildQuality, CommittedScene, Scene, scene_intersect,
                          scene_occluded)

__version__ = "0.1.0"

__all__ = [
    "State", "Device", "Error", "RaytracerError",
    "Rays", "Hits", "make_rays", "miss_hits", "INVALID_ID",
    "Geometry", "TriangleMesh", "QuadMesh", "SubdivMesh",
    "TriangleMeshMB", "QuadMeshMB", "SubdivMeshMB", "Instance",
    "UserGeometry",
    "LineSegments", "BezierCurves", "BSplineCurves", "BezierCurvesMB",
    "Scene", "BuildQuality", "CommittedScene",
    "scene_intersect", "scene_occluded",
]
