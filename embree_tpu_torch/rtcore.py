"""rtcore-compatible API facade.

Counterpart of embree_tpu/rtcore.py: a thin procedural layer mirroring
the reference's public C API (include/embree3/rtcore_*.h +
kernels/common/rtcore.cpp) so code written against embree's call shapes
ports mechanically:

    import embree_tpu_torch.rtcore as rtc
    device = rtc.rtcNewDevice("verbose=1")      # the CUDA device
    scene = rtc.rtcNewScene(device)
    geom = rtc.rtcNewGeometry(device, rtc.RTC_GEOMETRY_TYPE_TRIANGLE)
    rtc.rtcSetSharedGeometryBuffer(geom, rtc.RTC_BUFFER_TYPE_VERTEX, 0, verts)
    rtc.rtcSetSharedGeometryBuffer(geom, rtc.RTC_BUFFER_TYPE_INDEX, 0, tris)
    rtc.rtcCommitGeometry(geom)
    rtc.rtcAttachGeometry(scene, geom)
    rtc.rtcSetSceneLevels(scene, 6, 3)          # the fork's extension
    rtc.rtcCommitScene(scene)
    hits = rtc.rtcIntersect1M(scene, make_rays(org, dir, device=device.device))

`rtcNewDevice(cfg)` binds the CUDA device unless `cfg` says
`device=cpu`, and raises where there is no card. Rays and hits are the
package's batched tensors on the device's device: the packet/stream API
family (rtcIntersect1/4/8/16/1M) collapses into one batched entry.
Buffers are host arrays (numpy) until the scene's commit uploads them.
"""
from __future__ import annotations

import numpy as np

from .core.device import Device
from .core.rayhit import Rays
from .scene.curves import BezierCurves, LineSegments
from .scene.geometry import (Instance, QuadMesh, SubdivMesh, TriangleMesh,
                             UserGeometry)
from .scene.scene import BuildQuality, Scene

# geometry types (rtcore_geometry.h)
RTC_GEOMETRY_TYPE_TRIANGLE = "triangle"
RTC_GEOMETRY_TYPE_QUAD = "quad"
RTC_GEOMETRY_TYPE_SUBDIVISION = "subdivision"
RTC_GEOMETRY_TYPE_INSTANCE = "instance"
RTC_GEOMETRY_TYPE_USER = "user"
RTC_GEOMETRY_TYPE_FLAT_LINEAR_CURVE = "linear_curve"
RTC_GEOMETRY_TYPE_ROUND_BEZIER_CURVE = "bezier_curve"

# buffer types (rtcore_buffer.h)
RTC_BUFFER_TYPE_VERTEX = "vertex"
RTC_BUFFER_TYPE_INDEX = "index"
RTC_BUFFER_TYPE_FACE = "face"
RTC_BUFFER_TYPE_LEVEL = "level"
RTC_BUFFER_TYPE_EDGE_CREASE_INDEX = "edge_crease_index"
RTC_BUFFER_TYPE_EDGE_CREASE_WEIGHT = "edge_crease_weight"
RTC_BUFFER_TYPE_VERTEX_CREASE_INDEX = "vertex_crease_index"
RTC_BUFFER_TYPE_VERTEX_CREASE_WEIGHT = "vertex_crease_weight"
RTC_BUFFER_TYPE_HOLE = "hole"

RTC_BUILD_QUALITY_LOW = BuildQuality.LOW
RTC_BUILD_QUALITY_MEDIUM = BuildQuality.MEDIUM
RTC_BUILD_QUALITY_HIGH = BuildQuality.HIGH
RTC_BUILD_QUALITY_REFIT = BuildQuality.REFIT

RTC_INVALID_GEOMETRY_ID = -1


class _GeometryHandle:
    """Pre-commit geometry under construction (rtcNewGeometry)."""

    def __init__(self, device: Device, gtype: str):
        self.device = device
        self.type = gtype
        self.buffers: dict = {}
        self.displacement = None
        self.user = None           # (count, bounds_fn, intersect_fn)
        self.instance = None       # (scene, transform)
        self.committed_obj = None
        self.tessellation_rate = 8
        self.mask = -1              # rtcSetGeometryMask, default all bits


def rtcNewDevice(cfg: str | None = None) -> Device:
    return Device(cfg)


def rtcGetDeviceError(device: Device):
    return device.get_error()


def rtcSetDeviceErrorFunction(device: Device, fn, user_ptr=None) -> None:
    device.set_error_function(fn)


def rtcSetDeviceMemoryMonitorFunction(device: Device, fn, user_ptr=None):
    device.set_memory_monitor_function(fn)


def rtcNewScene(device: Device) -> Scene:
    return Scene(device)


def rtcSetSceneBuildQuality(scene: Scene, quality) -> None:
    scene.quality = BuildQuality(quality)


def rtcNewGeometry(device: Device, gtype: str) -> _GeometryHandle:
    return _GeometryHandle(device, gtype)


def rtcSetSharedGeometryBuffer(geom: _GeometryHandle, btype: str, slot: int,
                               data, *args, **kw) -> None:
    geom.buffers[(btype, slot)] = np.asarray(data)


rtcSetNewGeometryBuffer = rtcSetSharedGeometryBuffer


def rtcSetGeometryDisplacementFunction(geom: _GeometryHandle, fn) -> None:
    geom.displacement = fn


def rtcSetGeometryUserData(geom, data):
    geom.user_data = data


def rtcSetGeometryMask(geom: _GeometryHandle, mask: int) -> None:
    """rtcSetGeometryMask (rtcore_geometry.h): hits stand only when
    (geometry.mask & ray.mask) != 0 for rays traced with a mask."""
    geom.mask = int(np.int32(np.uint32(mask)))


def rtcSetGeometryUserPrimitiveCount(geom: _GeometryHandle, n: int) -> None:
    geom.user = (n, None, None)


def rtcSetGeometryBoundsFunction(geom: _GeometryHandle, fn, user=None) -> None:
    n = geom.user[0] if geom.user else 0
    geom.user = (n, fn, geom.user[2] if geom.user else None)


def rtcSetGeometryIntersectFunction(geom: _GeometryHandle, fn) -> None:
    n, b, _ = geom.user or (0, None, None)
    geom.user = (n, b, fn)


def rtcSetGeometryInstancedScene(geom: _GeometryHandle, scene: Scene) -> None:
    geom.instance = (scene, np.eye(3, 4, dtype=np.float32))


def rtcSetGeometryTransform(geom: _GeometryHandle, time_step, fmt_or_xfm,
                            xfm=None) -> None:
    m = np.asarray(xfm if xfm is not None else fmt_or_xfm, np.float32)
    scene = geom.instance[0] if geom.instance else None
    geom.instance = (scene, m)


def rtcSetGeometryTessellationRate(geom: _GeometryHandle, rate: float) -> None:
    geom.tessellation_rate = int(rate)


def rtcCommitGeometry(geom: _GeometryHandle) -> None:
    """Materialize the buffers into a framework geometry object."""
    b = geom.buffers
    t = geom.type
    if t == RTC_GEOMETRY_TYPE_TRIANGLE:
        geom.committed_obj = TriangleMesh(
            b[(RTC_BUFFER_TYPE_VERTEX, 0)][:, :3],
            b[(RTC_BUFFER_TYPE_INDEX, 0)].reshape(-1, 3))
    elif t == RTC_GEOMETRY_TYPE_QUAD:
        geom.committed_obj = QuadMesh(
            b[(RTC_BUFFER_TYPE_VERTEX, 0)][:, :3],
            b[(RTC_BUFFER_TYPE_INDEX, 0)].reshape(-1, 4))
    elif t == RTC_GEOMETRY_TYPE_SUBDIVISION:
        ec = b.get((RTC_BUFFER_TYPE_EDGE_CREASE_INDEX, 0))
        ew = b.get((RTC_BUFFER_TYPE_EDGE_CREASE_WEIGHT, 0))
        vc = b.get((RTC_BUFFER_TYPE_VERTEX_CREASE_INDEX, 0))
        vw = b.get((RTC_BUFFER_TYPE_VERTEX_CREASE_WEIGHT, 0))
        geom.committed_obj = SubdivMesh(
            b[(RTC_BUFFER_TYPE_VERTEX, 0)][:, :3],
            b[(RTC_BUFFER_TYPE_FACE, 0)].reshape(-1),
            b[(RTC_BUFFER_TYPE_INDEX, 0)].reshape(-1),
            edge_creases=None if ec is None else ec.reshape(-1, 2),
            edge_crease_weights=ew,
            vertex_creases=vc, vertex_crease_weights=vw,
            holes=b.get((RTC_BUFFER_TYPE_HOLE, 0)),
            displacement=geom.displacement)
    elif t == RTC_GEOMETRY_TYPE_FLAT_LINEAR_CURVE:
        geom.committed_obj = LineSegments(
            b[(RTC_BUFFER_TYPE_VERTEX, 0)],
            b[(RTC_BUFFER_TYPE_INDEX, 0)].reshape(-1))
    elif t == RTC_GEOMETRY_TYPE_ROUND_BEZIER_CURVE:
        geom.committed_obj = BezierCurves(
            b[(RTC_BUFFER_TYPE_VERTEX, 0)],
            b[(RTC_BUFFER_TYPE_INDEX, 0)].reshape(-1),
            tessellation_rate=geom.tessellation_rate)
    elif t == RTC_GEOMETRY_TYPE_USER:
        n, bounds_fn, isect_fn = geom.user
        geom.committed_obj = UserGeometry(n, bounds_fn, isect_fn)
    elif t == RTC_GEOMETRY_TYPE_INSTANCE:
        scene, xfm = geom.instance
        geom.committed_obj = Instance(scene, xfm)
    else:
        raise ValueError(f"unknown geometry type {t}")
    geom.committed_obj.mask = geom.mask


def rtcAttachGeometry(scene: Scene, geom: _GeometryHandle) -> int:
    return scene.attach(geom.committed_obj)


def rtcAttachGeometryByID(scene: Scene, geom: _GeometryHandle, gid: int):
    scene.attach_by_id(geom.committed_obj, gid)


def rtcDetachGeometry(scene: Scene, gid: int) -> None:
    scene.detach(gid)


def rtcReleaseGeometry(geom) -> None:
    pass  # python GC


def rtcSetSceneLevels(scene: Scene, subdivision_level: int,
                      compression_level: int) -> None:
    """The fork's API extension (rtcore_scene.h:64-65, rtcore.cpp:1469)."""
    scene.set_levels(subdivision_level, compression_level)


def rtcCommitScene(scene: Scene) -> None:
    scene.commit()


rtcJoinCommitScene = rtcCommitScene  # single-process: joins are trivial


def rtcIntersect1M(scene: Scene, rays: Rays):
    """The whole packet/stream family (rtcIntersect1/4/8/16/1M/NM/Np,
    rtcore_ray.h) as one batched entry."""
    return scene.intersect(rays)


rtcIntersect1 = rtcIntersect1M
rtcIntersect4 = rtcIntersect1M
rtcIntersect8 = rtcIntersect1M
rtcIntersect16 = rtcIntersect1M


def rtcOccluded1M(scene: Scene, rays: Rays):
    return scene.occluded(rays)


rtcOccluded1 = rtcOccluded1M
rtcOccluded4 = rtcOccluded1M
rtcOccluded8 = rtcOccluded1M
rtcOccluded16 = rtcOccluded1M


def rtcInterpolate1(scene: Scene, geom_id: int, prim_ids, u, v, slot=None):
    """rtcInterpolate analog: (P, N) for positions, or the interpolated
    vertex attribute when `slot` names one (rtcore.cpp interpolate)."""
    return scene.interpolate(geom_id, prim_ids, u, v, slot=slot)


def rtcGetSceneBounds(scene: Scene):
    return scene.bounds


def rtcReleaseScene(scene) -> None:
    pass


def rtcReleaseDevice(device) -> None:
    pass


# --- user-space BVH builder (rtcore_builder.cpp analog) ---------------------

class _BVHHandle:
    """RTCBVH: owns nothing until rtcBuildBVH; kept for API-shape parity."""

    def __init__(self, device: Device):
        self.device = device
        self.root = None


def rtcNewBVH(device: Device) -> _BVHHandle:
    return _BVHHandle(device)


def rtcDefaultBuildArguments():
    from .build.user_builder import BuildArguments
    return BuildArguments()


def rtcBuildBVH(bvh: _BVHHandle, args, lower, upper,
                geom_ids=None, prim_ids=None):
    """rtcBuildBVH (rtcore_builder.cpp:370-425): primitives are passed as
    bounds arrays (the RTCBuildPrimitive array) and the user callbacks in
    `args` construct the tree; returns the user root."""
    from .build.user_builder import build_user_bvh
    bvh.root = build_user_bvh(args, lower, upper, geom_ids, prim_ids)
    return bvh.root


def rtcThreadLocalAlloc(alloc, nbytes: int, align: int = 16):
    """No-op: Python user nodes are heap objects (parity shim)."""
    return None


def rtcReleaseBVH(bvh) -> None:
    pass
