"""Scene: geometry container + commit orchestration.

Counterpart of embree_tpu/scene/scene.py, triangle and quad meshes only.
`Scene` is the mutable host container (attach/detach); `commit()`
flattens the enabled geometries into one triangle soup, builds on the
host and publishes an immutable `CommittedScene` of tensors on the
Device's device:

  * always: the binned-SAH wide BVH (build/sah.py; BVH4, or BVH8 when
    `tri_accel` starts with "bvh8") and its packed form for the packet
    kernel (traverse/packet_kernel.py);
  * when the scene has at least ROWTRACE_MIN_PRIMS triangles or
    `tri_accel` ends in ".rowtrace", and `tri_accel` does not end in
    ".packet": the two-level treelet scene (build/treelets.py) as well.

Dispatch of `scene_intersect` / `scene_occluded`, the JAX package's:
the per-ray treelet traversal (traverse/rowtrace2.py) serves a batch
when the scene has a treelet scene, the batch has at least
ROWTRACE_MIN_RAYS rays, it is not flagged `coherent` and carries no
`ray_mask`; the packet kernel serves everything else — small scenes,
small batches, coherent (camera, shadow) rays, masked rays, and every
round of the intersection-filter restart. Each path has one kernel on
this card, and its plain version is taken for CPU tensors only, so
`isa` is accepted and selects nothing. The JAX package stream-sorts
large incoherent batches (traverse/stream.py) before its packet kernel;
on this card the sort costs more than it saves (PERF.md), so no path
here sorts.

Arguments that need a module which is not ported yet (`time`,
BuildQuality.LOW / REFIT, other geometry types) raise
`RaytracerError(INVALID_OPERATION, "not ported yet: ...")`.
"""
from __future__ import annotations

import enum
import math
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..build.bvh import BVH
from ..build.sah import BuildSettings, build_sah
from ..build.treelets import TreeletScene, build_treelet_scene, choose_fan
from ..core.device import Device, Error, RaytracerError
from ..core.profile import global_profiler, profile_phase, trace
from ..core.rayhit import Hits, Rays, miss_hits
from ..traverse.packet import _finalize_hits
from ..traverse.packet_kernel import (PackedScene, intersect_packet_kernel_raw,
                                      occluded_packet_kernel, pack_scene)
from ..traverse.rowtrace2 import intersect_rowtrace2
from .geometry import Geometry, QuadMesh, TriangleMesh
from .prims import TrianglePrims, empty_triangle_prims, prim_bounds_np

# Treelet path thresholds (the JAX package's): build the treelet scene
# for scenes at or above this many triangles, and route only batches of
# at least this many rays through it.
ROWTRACE_MIN_PRIMS = 100_000
ROWTRACE_MIN_RAYS = 65_536
FILTER_MAX_ROUNDS = 1 << 16


class BuildQuality(enum.IntEnum):
    LOW = 0      # morton/LBVH (not ported yet)
    MEDIUM = 1   # binned SAH (default)
    HIGH = 2     # binned SAH with spatial splits (packet path's BVH only)
    REFIT = 3    # not ported yet


class CommittedScene(NamedTuple):
    """Immutable device-side scene (the accel + leaf data)."""

    tris: TrianglePrims
    bvh: BVH                          # the wide BVH (one empty node if no prims)
    packet: Optional[PackedScene]     # None for an empty scene
    rowtrace: Optional[TreeletScene]  # None below ROWTRACE_MIN_PRIMS
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
        # intersection-filter callback (rtcSetGeometryIntersectFilterFunction
        # analog, scene-level): fn(org, dir, t, u, v, ng, geom, prim) -> keep,
        # on tensors of the scene's device
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

        # node width from the tri_accel override string (BVH4Factory /
        # BVH8Factory analog)
        ta = self.device.state.tri_accel
        settings = BuildSettings(
            branching_factor=8 if ta.startswith("bvh8") else 4,
            spatial_factor=1.2 if self.quality == BuildQuality.HIGH else 1.0)
        packet = None
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
            nprims = v0.shape[0]
        else:
            lower = upper = np.zeros((0, 3), np.float32)
            lo_all = np.zeros(3, np.float32)
            hi_all = np.zeros(3, np.float32)
            nprims = 0
        self._progress(0.3)
        with profile_phase("scene.build_sah"):
            # HIGH quality gets triangle vertices for exact spatial-split
            # clipping (heuristic_spatial_array splitPrimitive semantics)
            tv = ((v0, v1, v2)
                  if nprims and self.quality == BuildQuality.HIGH else None)
            bvh_np = build_sah(lower, upper, settings,
                               backend=self.device.state.builder,
                               tri_verts=tv)
        ts_np = None
        if nprims and ((nprims >= ROWTRACE_MIN_PRIMS
                        or ta.endswith(".rowtrace"))
                       and not ta.endswith(".packet")):
            with profile_phase("scene.build_treelets"):
                ts_np = build_treelet_scene(
                    v0, v1, v2, np.arange(nprims, dtype=np.int64),
                    fan=choose_fan(nprims))
        self._progress(0.9)
        if nprims:
            with profile_phase("scene.pack_packet"):
                packet = pack_scene(bvh_np, (v0, v1, v2), dev,
                                    prim_mask=lut[geom])
        with profile_phase("scene.upload"):
            bvh = bvh_np.to_device(dev)
            if nprims:
                tris = TrianglePrims(*(torch.from_numpy(a).to(dev) for a in
                                       (v0, v1, v2, geom, prim, flip)))
                prim_mask = torch.from_numpy(lut[geom]).to(dev)
                if ts_np is not None:
                    rowtrace = ts_np.to_device(dev)
            else:
                tris = empty_triangle_prims(device=dev)
                prim_mask = torch.zeros((0,), dtype=torch.int32, device=dev)

        self.committed = CommittedScene(
            tris=tris, bvh=bvh, packet=packet, rowtrace=rowtrace,
            prim_mask=prim_mask,
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
        """Register the intersection-filter callback (filter.h); None
        clears it."""
        self.intersection_filter = fn

    def intersect(self, rays: Rays, time=None, coherent: bool = False,
                  mask=None) -> Hits:
        """rtcIntersect1/K/stream analog (batched over all rays).
        `coherent` is the RTC_INTERSECT_CONTEXT_FLAG_COHERENT hint:
        camera and shadow rays go to the packet kernel whatever their
        count. `mask` is the per-ray mask (EMBREE_RAY_MASK): an int or
        an integer array of the rays' batch shape; a hit stands only
        where (geometry.mask & mask) != 0. `time` (motion blur) is not
        ported yet."""
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
              f"{cs.bvh.num_nodes} BVH{cs.bvh.width} nodes, "
              f"{ts.num_treelets if ts else 0} treelets in "
              f"{ts.num_mids if ts else 0} mids, "
              f"build {self.build_time_s * 1e3:.1f} ms")


def _scene_bytes(cs: CommittedScene) -> int:
    tensors = (list(cs.tris) + list(cs.bvh)
               + [cs.prim_mask, cs.world_lower, cs.world_upper])
    n = sum(a.numel() * a.element_size() for a in tensors)
    n += cs.packet.device_bytes if cs.packet is not None else 0
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


def _flat_mask(cs: CommittedScene, ray_mask, shape):
    """None, or the per-ray mask as a flat contiguous i32 tensor on the
    scene's device."""
    if ray_mask is None:
        return None
    m = torch.as_tensor(ray_mask, device=cs.device).to(torch.int32)
    return m.broadcast_to(shape).reshape(-1).contiguous()


def _use_rowtrace(cs: CommittedScene, flat: Rays, coherent: bool,
                  ray_mask) -> bool:
    return (cs.rowtrace is not None and not coherent and ray_mask is None
            and flat.tnear.shape[0] >= ROWTRACE_MIN_RAYS)


def _closest_flat(cs: CommittedScene, flat: Rays, coherent: bool,
                  ray_mask) -> Hits:
    """Unfiltered closest hit of a flat batch through the kernel that
    the dispatch rule names."""
    if _use_rowtrace(cs, flat, coherent, ray_mask):
        t, prim = intersect_rowtrace2(cs.rowtrace, flat,
                                      cull=cs.backface_cull)
    else:
        t, prim = intersect_packet_kernel_raw(
            cs.packet, flat, cull=cs.backface_cull, ray_mask=ray_mask)
    return _finalize_hits(cs.tris, flat, t, prim)


def _intersect_filter_restart(cs: CommittedScene, flat: Rays, filter_fn,
                              coherent: bool, ray_mask) -> Hits:
    """Intersection filters as a restart wavefront (the JAX package's
    formulation): run the unfiltered kernel for the closest hit, apply
    the filter to the whole batch as tensor ops, and re-traverse the
    rejected rays with tnear advanced just past the rejected hit. Rays
    that accept or miss are retired with tfar = -inf, which costs the
    kernels one node visit, so late rounds pay only for the undecided
    rays. One `bool(...any())` per round is the only host sync.

    Hits reach the filter in increasing t per ray. After a rejected hit
    at distance t, other primitives at exactly the same t are skipped; a
    forward-progress guard refuses the same primitive at a t that did
    not grow, so the loop always ends (and is capped at 2^16 rounds)."""
    org, d, tnear_cur, tf = flat
    R = tf.shape[0]
    dev = tf.device
    best = miss_hits((R,), tf, device=dev)
    done = torch.zeros(R, dtype=torch.bool, device=dev)
    prev_prim = torch.full((R,), -2, dtype=torch.int32, device=dev)
    prev_t = torch.full((R,), -math.inf, dtype=torch.float32, device=dev)
    inf = torch.tensor(math.inf, dtype=torch.float32, device=dev)
    for _ in range(FILTER_MAX_ROUNDS if R else 0):
        tf_eff = torch.where(done, -inf, tf)
        h = _closest_flat(cs, Rays(org, d, tnear_cur, tf_eff), coherent,
                          ray_mask)
        hitm = h.valid & ~done
        accept = torch.as_tensor(
            filter_fn(org, d, h.t, h.u, h.v, h.ng, h.geom_id, h.prim_id),
            device=dev).to(torch.bool).broadcast_to(hitm.shape)
        same = hitm & (h.gprim == prev_prim) & (h.t <= prev_t)
        acc = hitm & accept & ~same
        rej = hitm & ~acc
        best = Hits(*(torch.where(
            acc.reshape(acc.shape + (1,) * (a.ndim - acc.ndim)), a, b)
            for a, b in zip(h, best)))
        done = done | acc | ~h.valid
        # strictly monotone: past the rejected t, and past the previous
        # tnear if rounding re-found the same hit
        adv = torch.nextafter(torch.maximum(h.t, tnear_cur), inf)
        tnear_cur = torch.where(rej, adv, tnear_cur)
        prev_prim = torch.where(rej, h.gprim, prev_prim)
        prev_t = torch.where(rej, h.t, prev_t)
        if not bool((~done).any()):
            break
    return best


def scene_intersect(cs: CommittedScene, rays: Rays, isa: str = "default",
                    time=None, filter_fn=None, coherent: bool = False,
                    ray_mask=None) -> Hits:
    """Functional entry: closest hit of every ray against the committed
    triangle soup, through the kernel the module docstring's dispatch
    rule names. `isa` is accepted and selects nothing."""
    if time is not None:
        raise _not_ported("motion blur (time)")
    shape = rays.batch_shape
    if cs.tris.num_prims == 0:
        return miss_hits(shape, rays.tfar, device=cs.device)
    flat = _flat_rays(cs, rays)
    rm = _flat_mask(cs, ray_mask, shape)
    if filter_fn is not None:
        h = _intersect_filter_restart(cs, flat, filter_fn, coherent, rm)
    else:
        h = _closest_flat(cs, flat, coherent, rm)
    return Hits(*(x.reshape(shape + x.shape[1:]) for x in h))


def scene_occluded(cs: CommittedScene, rays: Rays, isa: str = "default",
                   coherent: bool = False, ray_mask=None) -> torch.Tensor:
    """Functional entry: any hit of every ray (bool, the rays' batch
    shape); the same dispatch as `scene_intersect`."""
    shape = rays.batch_shape
    if cs.tris.num_prims == 0:
        return torch.zeros(shape, dtype=torch.bool, device=cs.device)
    flat = _flat_rays(cs, rays)
    rm = _flat_mask(cs, ray_mask, shape)
    if _use_rowtrace(cs, flat, coherent, rm):
        t, _ = intersect_rowtrace2(cs.rowtrace, flat, occluded=True,
                                   cull=cs.backface_cull)
        occ = t == -math.inf
    else:
        occ = occluded_packet_kernel(cs.packet, flat, cull=cs.backface_cull,
                                     ray_mask=rm)
    return occ.reshape(shape)
