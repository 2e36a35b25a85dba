"""Scene: geometry container + commit orchestration.

Counterpart of embree_tpu/scene/scene.py, triangle and quad meshes only.
`Scene` is the mutable host container (attach/detach); `commit()`
flattens the enabled geometries into one triangle soup, builds the
two-level treelet scene on the host (SAH cut + packing,
build/treelets.py) and publishes an immutable `CommittedScene` of
tensors on the Device's device.

Every non-empty scene is served by the per-ray treelet traversal
(traverse/rowtrace2.py), whatever the prim and ray counts. Arguments
that need a module which is not ported yet raise
`RaytracerError(INVALID_OPERATION, "not ported yet: ...")`.
"""
from __future__ import annotations

import enum
import math
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..build.treelets import TreeletScene, build_treelet_scene, choose_fan
from ..core.device import Device, Error, RaytracerError
from ..core.profile import global_profiler, profile_phase, trace
from ..core.rayhit import Hits, Rays, miss_hits
from ..traverse.packet import _finalize_hits
from ..traverse.rowtrace2 import intersect_rowtrace2
from .geometry import Geometry, QuadMesh, TriangleMesh
from .prims import TrianglePrims, empty_triangle_prims, prim_bounds_np


class BuildQuality(enum.IntEnum):
    LOW = 0      # morton/LBVH (not ported yet)
    MEDIUM = 1   # binned SAH (default)
    HIGH = 2     # binned SAH; spatial splits do not reach the treelet cut
    REFIT = 3    # not ported yet


class CommittedScene(NamedTuple):
    """Immutable device-side scene (the accel + leaf data)."""

    tris: TrianglePrims
    rowtrace: Optional[TreeletScene]  # None for an empty scene
    prim_mask: torch.Tensor           # (T,) i32 per-prim geometry mask
    world_lower: torch.Tensor         # (3,) f32
    world_upper: torch.Tensor         # (3,) f32
    backface_cull: bool               # EMBREE_BACKFACE_CULLING analog

    @property
    def device(self) -> torch.device:
        return self.world_lower.device


def _not_ported(what: str):
    return RaytracerError(Error.INVALID_OPERATION, f"not ported yet: {what}")


def _as_np_f32(a):
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float32)


class Scene:
    def __init__(self, device: Device,
                 quality: BuildQuality = BuildQuality.MEDIUM):
        self.device = device
        self.quality = quality
        self.geometries: dict[int, Geometry] = {}
        self._next_id = 0
        self.committed: Optional[CommittedScene] = None
        self.progress_monitor: Optional[Callable[[float], bool]] = None
        self.build_time_s: float = 0.0
        # intersection-filter callback; setting one makes intersect raise
        # until the filter restart is ported
        self.intersection_filter = None

    # --- geometry management (scene.cpp:585-620 bind/detachGeometry) -------
    def attach(self, geom: Geometry) -> int:
        gid = self._next_id
        self._next_id += 1
        geom.geom_id = gid
        self.geometries[gid] = geom
        return gid

    def attach_by_id(self, geom: Geometry, gid: int) -> None:
        """rtcAttachGeometryByID analog."""
        if gid in self.geometries:
            self.device.raise_error(Error.INVALID_ARGUMENT, f"geomID {gid} in use")
        geom.geom_id = gid
        self.geometries[gid] = geom
        self._next_id = max(self._next_id, gid + 1)

    def detach(self, geom_id: int) -> None:
        if geom_id not in self.geometries:
            self.device.raise_error(Error.INVALID_ARGUMENT, "bad geomID")
        del self.geometries[geom_id]

    # --- commit (scene.cpp:632 commit_task) --------------------------------
    def commit(self) -> CommittedScene:
        trace("rtcCommitScene", id(self))
        if self.quality in (BuildQuality.LOW, BuildQuality.REFIT):
            raise _not_ported(f"BuildQuality.{self.quality.name}")
        t0 = time.perf_counter()
        self._progress(0.0)
        dev = self.device.device

        tri_v0, tri_v1, tri_v2 = [], [], []
        tri_geom, tri_prim, tri_flip = [], [], []
        with profile_phase("scene.flatten"):
            for gid, g in sorted(self.geometries.items()):
                if not g.enabled:
                    continue
                if isinstance(g, TriangleMesh):
                    v = _as_np_f32(g.vertices)
                    idx = g.indices
                    tri_v0.append(v[idx[:, 0]])
                    tri_v1.append(v[idx[:, 1]])
                    tri_v2.append(v[idx[:, 2]])
                    n = idx.shape[0]
                    tri_geom.append(np.full(n, gid, np.int32))
                    tri_prim.append(np.arange(n, dtype=np.int32))
                    tri_flip.append(np.zeros(n, np.int32))
                elif isinstance(g, QuadMesh):
                    v = _as_np_f32(g.vertices)
                    idx = g.indices
                    n = idx.shape[0]
                    # tri A = (v0, v1, v3), tri B = (v2, v3, v1)  (quadv.h)
                    tri_v0 += [v[idx[:, 0]], v[idx[:, 2]]]
                    tri_v1 += [v[idx[:, 1]], v[idx[:, 3]]]
                    tri_v2 += [v[idx[:, 3]], v[idx[:, 1]]]
                    tri_geom.append(np.full(2 * n, gid, np.int32))
                    tri_prim.append(
                        np.concatenate([np.arange(n, dtype=np.int32)] * 2))
                    tri_flip.append(np.concatenate(
                        [np.zeros(n, np.int32), np.ones(n, np.int32)]))
                else:
                    raise _not_ported(f"geometry type {type(g).__name__}")

        rowtrace = None
        if tri_v0:
            v0 = np.concatenate(tri_v0)
            v1 = np.concatenate(tri_v1)
            v2 = np.concatenate(tri_v2)
            geom = np.concatenate(tri_geom)
            prim = np.concatenate(tri_prim)
            flip = np.concatenate(tri_flip)
            # per-prim geometry mask via gid lookup (rtcSetGeometryMask)
            lut = np.full(max(self.geometries.keys(), default=0) + 1, -1,
                          np.int32)
            for _gid, _g in self.geometries.items():
                lut[_gid] = np.int32(getattr(_g, "mask", -1))
            lower, upper = prim_bounds_np(v0, v1, v2)
            lo_all, hi_all = lower.min(0), upper.max(0)
            self._progress(0.3)
            nprims = v0.shape[0]
            with profile_phase("scene.build_treelets"):
                ts_np = build_treelet_scene(
                    v0, v1, v2, np.arange(nprims, dtype=np.int64),
                    fan=choose_fan(nprims))
            self._progress(0.9)
            with profile_phase("scene.upload"):
                tris = TrianglePrims(*(torch.from_numpy(a).to(dev) for a in
                                       (v0, v1, v2, geom, prim, flip)))
                prim_mask = torch.from_numpy(lut[geom]).to(dev)
                rowtrace = ts_np.to_device(dev)
        else:
            tris = empty_triangle_prims(device=dev)
            prim_mask = torch.zeros((0,), dtype=torch.int32, device=dev)
            lo_all = np.zeros(3, np.float32)
            hi_all = np.zeros(3, np.float32)

        self.committed = CommittedScene(
            tris=tris, rowtrace=rowtrace, prim_mask=prim_mask,
            world_lower=torch.from_numpy(lo_all.astype(np.float32)).to(dev),
            world_upper=torch.from_numpy(hi_all.astype(np.float32)).to(dev),
            backface_cull=bool(self.device.state.backface_culling))
        self.device.memory_monitor(_scene_bytes(self.committed), True)
        self.build_time_s = time.perf_counter() - t0
        self._progress(1.0)
        if self.device.state.verbose >= 2:
            self.print_statistics()
            global_profiler().print("  profile ")
        return self.committed

    def _progress(self, f: float) -> None:
        """Progress-monitor cancellation (scene.cpp:871-879)."""
        if self.progress_monitor is not None:
            if not self.progress_monitor(f):
                self.committed = None
                self.device.raise_error(Error.CANCELLED, "build cancelled")

    # --- queries ------------------------------------------------------------
    def _require_commit(self) -> CommittedScene:
        if self.committed is None:
            self.device.raise_error(Error.INVALID_OPERATION, "scene not committed")
        return self.committed

    def set_intersection_filter(self, fn) -> None:
        """Register the intersection-filter callback (filter.h)."""
        self.intersection_filter = fn

    def intersect(self, rays: Rays, time=None, coherent: bool = False,
                  mask=None) -> Hits:
        """rtcIntersect1/K/stream analog (batched over all rays).
        `coherent` is the RTC_INTERSECT_CONTEXT_FLAG_COHERENT hint; the
        per-ray traversal serves coherent and incoherent batches alike.
        `time` (motion blur) and `mask` (ray masks) are not ported yet."""
        cs = self._require_commit()
        return scene_intersect(cs, rays, isa=self.device.state.isa,
                               time=time, filter_fn=self.intersection_filter,
                               coherent=coherent, ray_mask=mask)

    def occluded(self, rays: Rays, mask=None) -> torch.Tensor:
        cs = self._require_commit()
        return scene_occluded(cs, rays, isa=self.device.state.isa,
                              ray_mask=mask)

    @property
    def bounds(self):
        cs = self._require_commit()
        return cs.world_lower.cpu().numpy(), cs.world_upper.cpu().numpy()

    def print_statistics(self) -> None:
        """Scene::printStatistics (scene.cpp:77-129) analog."""
        cs = self._require_commit()
        ts = cs.rowtrace
        print(f"embree_tpu_torch scene: {len(self.geometries)} geometries, "
              f"{cs.tris.num_prims} flattened triangles, "
              f"{ts.num_treelets if ts else 0} treelets in "
              f"{ts.num_mids if ts else 0} mids, "
              f"build {self.build_time_s * 1e3:.1f} ms")


def _scene_bytes(cs: CommittedScene) -> int:
    tensors = list(cs.tris) + [cs.prim_mask, cs.world_lower, cs.world_upper]
    n = sum(a.numel() * a.element_size() for a in tensors)
    return n + (cs.rowtrace.device_bytes if cs.rowtrace is not None else 0)


def _flat_rays(cs: CommittedScene, rays: Rays) -> Rays:
    if rays.tnear.device != cs.device:
        raise RaytracerError(
            Error.INVALID_ARGUMENT,
            f"rays are on {rays.tnear.device}, the scene is on {cs.device}")
    return Rays(rays.org.reshape(-1, 3).contiguous(),
                rays.dir.reshape(-1, 3).contiguous(),
                rays.tnear.reshape(-1).contiguous(),
                rays.tfar.reshape(-1).contiguous())


def scene_intersect(cs: CommittedScene, rays: Rays, isa: str = "default",
                    time=None, filter_fn=None, coherent: bool = False,
                    ray_mask=None) -> Hits:
    """Functional entry: closest hit of every ray against the committed
    triangle soup. `isa` and `coherent` are accepted and select nothing."""
    if filter_fn is not None:
        raise _not_ported("intersection filters (filter_fn)")
    if ray_mask is not None:
        raise _not_ported("ray masks (ray_mask)")
    if time is not None:
        raise _not_ported("motion blur (time)")
    shape = rays.batch_shape
    if cs.tris.num_prims == 0:
        return miss_hits(shape, rays.tfar, device=cs.device)
    flat = _flat_rays(cs, rays)
    t, prim = intersect_rowtrace2(cs.rowtrace, flat, cull=cs.backface_cull)
    h = _finalize_hits(cs.tris, flat, t, prim)
    return Hits(*(x.reshape(shape + x.shape[1:]) for x in h))


def scene_occluded(cs: CommittedScene, rays: Rays, isa: str = "default",
                   coherent: bool = False, ray_mask=None) -> torch.Tensor:
    if ray_mask is not None:
        raise _not_ported("ray masks (ray_mask)")
    shape = rays.batch_shape
    if cs.tris.num_prims == 0:
        return torch.zeros(shape, dtype=torch.bool, device=cs.device)
    flat = _flat_rays(cs, rays)
    t, _ = intersect_rowtrace2(cs.rowtrace, flat, occluded=True,
                               cull=cs.backface_cull)
    return (t == -math.inf).reshape(shape)
