"""embree_tpu_torch — the PyTorch/CUDA port of embree_tpu.

Same sub-package and function names as the JAX package, so the
counterpart of a module is found by its path; plain functions on torch
tensors inside, an explicit `torch.device` everywhere, and hand-written
CUDA kernels (`csrc/`) where the JAX package has Pallas kernels. So far:
triangle and quad scenes; commit (SAH BVH4/BVH8 + packing, treelet
scene for large meshes); closest-hit / any-hit queries through the
per-ray treelet traversal (large incoherent batches) or the BVH packet
kernel (everything else), with ray masks and intersection filters; the
differentiable hit (`diff.hit`); the `triangle_geometry` tutorial
(`render.tutorials`).

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
from .scene.geometry import Geometry, QuadMesh, TriangleMesh
from .scene.scene import (BuildQuality, CommittedScene, Scene, scene_intersect,
                          scene_occluded)

__version__ = "0.1.0"

__all__ = [
    "State", "Device", "Error", "RaytracerError",
    "Rays", "Hits", "make_rays", "miss_hits", "INVALID_ID",
    "Geometry", "TriangleMesh", "QuadMesh",
    "Scene", "BuildQuality", "CommittedScene",
    "scene_intersect", "scene_occluded",
]
