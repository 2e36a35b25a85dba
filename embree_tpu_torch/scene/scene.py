"""Scene: geometry container + commit orchestration.

Counterpart of embree_tpu/scene/scene.py for triangle, quad and
subdivision meshes. `Scene` is the mutable host container
(attach/detach); `commit()` flattens the enabled triangle and quad
meshes into one triangle soup, builds on the host and publishes an
immutable `CommittedScene` of tensors on the Device's device:

  * always: the binned-SAH wide BVH (build/sah.py; BVH4, or BVH8 when
    `tri_accel` starts with "bvh8") and its packed form for the packet
    kernel (traverse/packet_kernel.py);
  * when the scene has at least ROWTRACE_MIN_PRIMS triangles or
    `tri_accel` ends in ".rowtrace", and `tri_accel` does not end in
    ".packet": the two-level treelet scene (build/treelets.py) as well;
  * a `SubdivMesh` under `subdiv_accel=default` is tessellated eagerly
    to the uniform level of `set_levels` and joins the triangle soup
    (its hits report patch uv); under
    `subdiv_accel=bvh4.compressed.{box,leaf,grid,full}` all subdivision
    meshes go into one compressed accel instead (scene/subdiv_accel.py:
    one quantized quadtree per tile under a BVH4), packed for the
    compressed kernels (traverse/cbvh_kernel.py) unless the mode is
    `full` or `compressed_node` is not `com`.

Dispatch of `scene_intersect` / `scene_occluded`, the JAX package's:
the per-ray treelet traversal (traverse/rowtrace2.py) serves a batch
when the scene has a treelet scene, the batch has at least
ROWTRACE_MIN_RAYS rays, it is not flagged `coherent` and carries no
`ray_mask`; the packet kernel serves everything else — small scenes,
small batches, coherent (camera, shadow) rays, masked rays, and every
round of the intersection-filter restart. Each path has one kernel on
this card, and its plain version is taken for CPU tensors only, so
`isa` is accepted and selects nothing. A scene with a compressed accel
folds it in after the triangles, as the JAX package does: the
compressed walk starts from the triangles' t and wins where it finds a
tile; occlusion is the OR of both. The packed accel goes through the
compressed kernels, an unpacked one (`full`, `non`, `mid`) through the
torch-op traversal (traverse/cbvh.py). Ray masks act on triangles only.
The JAX package stream-sorts
large incoherent batches (traverse/stream.py) before its packet kernel;
on this card the sort costs more than it saves (PERF.md), so no path
here sorts.

Arguments that need a module which is not ported yet (`time`,
BuildQuality.LOW / REFIT, per-edge tessellation levels, other geometry
types) raise
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
from ..subdiv.tessellate import tessellate_mesh_to_triangles
from ..traverse.cbvh import (CompressedAccel, compressed_hits,
                             intersect_compressed, occluded_compressed)
from ..traverse.cbvh_kernel import (PackedCompressed,
                                    intersect_compressed_kernel,
                                    occluded_compressed_kernel,
                                    pack_compressed)
from ..traverse.packet import _finalize_hits
from ..traverse.packet_kernel import (PackedScene, intersect_packet_kernel_raw,
                                      occluded_packet_kernel, pack_scene)
from ..traverse.rowtrace2 import intersect_rowtrace2
from .geometry import Geometry, QuadMesh, SubdivMesh, TriangleMesh
from .subdiv_accel import build_compressed_accel
from .prims import TrianglePrims, empty_triangle_prims, prim_bounds_np

# Treelet path thresholds (the JAX package's): build the treelet scene
# for scenes at or above this many triangles, and route only batches of
# at least this many rays through it.
ROWTRACE_MIN_PRIMS = 100_000
ROWTRACE_MIN_RAYS = 65_536
FILTER_MAX_ROUNDS = 1 << 16

# createSubdivAccel mode select (scene.cpp:491-510)
SUBDIV_MODES = {
    "bvh4.compressed.grid": "grid",
    "bvh4.compressed.leaf": "leaf",
    "bvh4.compressed.box": "box",
    "bvh4.compressed.full": "full",
}
# identity patch-uv corners: the remap w0*c0 + u*c1 + v*c2 returns (u, v)
# unchanged for plain triangle and quad prims
_IDENT_UV3_ROW = np.asarray([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]], np.float32)


def _ident_uv3(n):
    return np.broadcast_to(_IDENT_UV3_ROW, (n, 3, 2))


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
    # (T, 3, 2) f32 patch-uv corners per triangle when the soup holds an
    # eagerly tessellated SubdivMesh, else None
    tri_patch_uv: Optional[torch.Tensor] = None
    compressed: Optional[CompressedAccel] = None   # fork's subdiv modes
    compressed_kernel: Optional[PackedCompressed] = None  # its packed form

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
        # fork extension rtcSetSceneLevels (rtcore_scene.h:64-65), defaults
        # from scene.cpp:41-42
        self.subdivision_level = 6
        self.compression_level = 3
        self.progress_monitor: Optional[Callable[[float], bool]] = None
        self.build_time_s: float = 0.0
        self.subdiv_eval = {}  # gid -> SubdivEval (compressed mode)
        self.subdiv_plan = {}  # gid -> SubdivisionPlan
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

    def _subdiv_mode(self):
        """'grid' | 'leaf' | 'box' | 'full' for the fork's compressed
        modes, None for the stock eager path."""
        return SUBDIV_MODES.get(self.device.state.subdiv_accel)

    def set_levels(self, subdivision_level: int,
                   compression_level: int) -> None:
        """Fork API rtcSetSceneLevels (rtcore.cpp:1469)."""
        self.subdivision_level = int(subdivision_level)
        self.compression_level = int(compression_level)

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
        tri_uv3 = []          # (n, 3, 2) patch-uv corners per triangle
        any_patch_uv = False  # an eagerly tessellated SubdivMesh is present
        subdiv_compressed = []
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
                    tri_uv3.append(_ident_uv3(n))
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
                    tri_uv3.append(_ident_uv3(2 * n))
                elif isinstance(g, SubdivMesh):
                    if g.edge_levels is not None:
                        raise _not_ported("per-edge tessellation levels")
                    if self._subdiv_mode() is not None:
                        subdiv_compressed.append((gid, g))
                        continue
                    # stock path: eager uniform tessellation to triangles
                    # (BVHNSubdivPatch1EagerBuilderSAH analog)
                    with profile_phase("scene.tessellate"):
                        v0, v1, v2, prim, uv3 = tessellate_mesh_to_triangles(
                            g, self.subdivision_level, with_uv=True)
                    tri_v0.append(v0)
                    tri_v1.append(v1)
                    tri_v2.append(v2)
                    tri_geom.append(np.full(v0.shape[0], gid, np.int32))
                    tri_prim.append(prim.astype(np.int32))
                    tri_flip.append(np.zeros(v0.shape[0], np.int32))
                    tri_uv3.append(uv3)
                    any_patch_uv = True
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
        # compressed subdiv accel (fork modes, scene.cpp:507-510)
        compressed = None
        compressed_kernel = None
        self.subdiv_eval = {}
        self.subdiv_plan = {}
        if subdiv_compressed:
            flavor = self.device.state.compressed_node
            with profile_phase("scene.build_compressed"):
                (compressed, self.subdiv_eval, self.subdiv_plan, clo,
                 chi) = build_compressed_accel(
                    subdiv_compressed, self.subdivision_level,
                    self.compression_level, self._subdiv_mode(),
                    flavor=flavor, device=dev)
            # the kernels decode the production 'com' layout only; the
            # non / mid flavors and mode 'full' traverse in torch ops
            if flavor == "com":
                with profile_phase("scene.pack_compressed"):
                    compressed_kernel = pack_compressed(compressed)
            if nprims:
                lo_all = np.minimum(lo_all, clo)
                hi_all = np.maximum(hi_all, chi)
            else:
                lo_all, hi_all = clo, chi
        tri_patch_uv = None
        with profile_phase("scene.upload"):
            bvh = bvh_np.to_device(dev)
            if nprims:
                tris = TrianglePrims(*(torch.from_numpy(a).to(dev) for a in
                                       (v0, v1, v2, geom, prim, flip)))
                prim_mask = torch.from_numpy(lut[geom]).to(dev)
                if any_patch_uv:
                    tri_patch_uv = torch.from_numpy(
                        np.concatenate(tri_uv3)).to(dev)
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
            backface_cull=bool(self.device.state.backface_culling),
            tri_patch_uv=tri_patch_uv, compressed=compressed,
            compressed_kernel=compressed_kernel)
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
        ct = cs.compressed.tiles if cs.compressed is not None else None
        print(f"embree_tpu_torch scene: {len(self.geometries)} geometries, "
              f"{cs.tris.num_prims} flattened triangles, "
              f"{cs.bvh.num_nodes} BVH{cs.bvh.width} nodes, "
              f"{ts.num_treelets if ts else 0} treelets in "
              f"{ts.num_mids if ts else 0} mids, "
              f"{ct.num_tiles if ct else 0} compressed tiles"
              + (f" ({ct.mode}, level {ct.comp_level})" if ct else "")
              + f", build {self.build_time_s * 1e3:.1f} ms")


def _scene_bytes(cs: CommittedScene) -> int:
    tensors = (list(cs.tris) + list(cs.bvh)
               + [cs.prim_mask, cs.world_lower, cs.world_upper])
    n = sum(a.numel() * a.element_size() for a in tensors)
    n += cs.packet.device_bytes if cs.packet is not None else 0
    n += cs.rowtrace.device_bytes if cs.rowtrace is not None else 0
    if cs.tri_patch_uv is not None:
        n += cs.tri_patch_uv.numel() * 4
    if cs.compressed is not None:
        ct = cs.compressed.tiles
        n += sum(a.numel() * a.element_size()
                 for a in list(cs.compressed.top)
                 + [getattr(ct, k) for k in ct.ARRAYS])
    if cs.compressed_kernel is not None:
        n += cs.compressed_kernel.device_bytes
    return n


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


def _apply_patch_uv(cs: CommittedScene, h: Hits) -> Hits:
    """Remap triangle-barycentric (u, v) to PATCH uv for eager-subdiv
    prims (GridSOA hit semantics, grid_soa_intersector1.h:60-117):
    uv = w0*c0 + u*c1 + v*c2 with the per-triangle corner table; plain
    prims carry identity corners."""
    if cs.tri_patch_uv is None:
        return h
    c = cs.tri_patch_uv[h.gprim.clamp_min(0).long()]
    w0 = (1.0 - h.u - h.v)[..., None]
    uv = (c[..., 0, :] * w0 + c[..., 1, :] * h.u[..., None]
          + c[..., 2, :] * h.v[..., None])
    keep = h.gprim >= 0
    return h._replace(u=torch.where(keep, uv[..., 0], h.u),
                      v=torch.where(keep, uv[..., 1], h.v))


def _fold_compressed(cs: CommittedScene, flat: Rays, hits: Hits) -> Hits:
    """The AccelN step for the compressed accel (acceln.cpp:51): the walk
    starts from the running t and wins where it finds a tile."""
    if cs.compressed_kernel is not None:
        st = intersect_compressed_kernel(cs.compressed_kernel, flat,
                                         t_in=hits.t)
    else:
        st = intersect_compressed(cs.compressed, flat, t_in=hits.t)
    ch = compressed_hits(cs.compressed, flat, st)
    use_c = st.tile >= 0
    return Hits(*(torch.where(
        use_c.reshape(use_c.shape + (1,) * (a.ndim - use_c.ndim)), a, b)
        for a, b in zip(ch, hits)))


def _closest_flat(cs: CommittedScene, flat: Rays, coherent: bool,
                  ray_mask) -> Hits:
    """Unfiltered closest hit of a flat batch: the triangles through the
    kernel that the dispatch rule names, then the compressed accel."""
    if cs.tris.num_prims == 0:
        hits = miss_hits(flat.batch_shape, flat.tfar, device=cs.device)
    else:
        if _use_rowtrace(cs, flat, coherent, ray_mask):
            t, prim = intersect_rowtrace2(cs.rowtrace, flat,
                                          cull=cs.backface_cull)
        else:
            t, prim = intersect_packet_kernel_raw(
                cs.packet, flat, cull=cs.backface_cull, ray_mask=ray_mask)
        hits = _apply_patch_uv(cs, _finalize_hits(cs.tris, flat, t, prim))
    if cs.compressed is not None:
        hits = _fold_compressed(cs, flat, hits)
    return hits


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
    not grow, so the loop always ends (and is capped at 2^16 rounds).

    A box or leaf hit of the compressed accel is the entry into a volume,
    not a point on a surface: a ray restarted just past it starts inside
    the same slab and meets it again a float further on, round after
    round. Such a rejection raises instead (grid mode tests triangles
    and restarts like any triangle mesh)."""
    org, d, tnear_cur, tf = flat
    R = tf.shape[0]
    dev = tf.device
    best = miss_hits((R,), tf, device=dev)
    done = torch.zeros(R, dtype=torch.bool, device=dev)
    prev_prim = torch.full((R,), -2, dtype=torch.int32, device=dev)
    prev_t = torch.full((R,), -math.inf, dtype=torch.float32, device=dev)
    inf = torch.tensor(math.inf, dtype=torch.float32, device=dev)
    slabs = cs.compressed is not None and cs.compressed.tiles.mode != "grid"
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
        # a compressed hit carries gprim = -1
        open_, stuck = torch.stack(
            [(~done).any(), (rej & (h.gprim < 0)).any()]).tolist()
        if slabs and stuck:
            raise _not_ported(
                "an intersection filter that rejects a hit of a "
                f"bvh4.compressed.{cs.compressed.tiles.mode} accel")
        if not open_:
            break
    return best


def scene_intersect(cs: CommittedScene, rays: Rays, isa: str = "default",
                    time=None, filter_fn=None, coherent: bool = False,
                    ray_mask=None) -> Hits:
    """Functional entry: closest hit of every ray against the committed
    triangle soup, through the kernel the module docstring's dispatch
    rule names, then against the compressed accel where the scene has
    one. `isa` is accepted and selects nothing."""
    if time is not None:
        raise _not_ported("motion blur (time)")
    shape = rays.batch_shape
    if cs.tris.num_prims == 0 and cs.compressed is None:
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
    flat = _flat_rays(cs, rays)
    rm = _flat_mask(cs, ray_mask, shape)
    if cs.tris.num_prims == 0:
        occ = torch.zeros(flat.batch_shape, dtype=torch.bool,
                          device=cs.device)
    elif _use_rowtrace(cs, flat, coherent, rm):
        t, _ = intersect_rowtrace2(cs.rowtrace, flat, occluded=True,
                                   cull=cs.backface_cull)
        occ = t == -math.inf
    else:
        occ = occluded_packet_kernel(cs.packet, flat, cull=cs.backface_cull,
                                     ray_mask=rm)
    if cs.compressed_kernel is not None:
        occ = occ | occluded_compressed_kernel(cs.compressed_kernel, flat)
    elif cs.compressed is not None:
        occ = occ | occluded_compressed(cs.compressed, flat)
    return occ.reshape(shape)
