"""Scene: geometry container + commit orchestration.

Counterpart of embree_tpu/scene/scene.py for triangle, quad and
subdivision meshes, static and with motion blur, and for curves (line
segments, Bezier and B-spline hair, motion-blur Bezier curves). `Scene`
is the mutable host container (attach/detach); `commit()` flattens the
enabled triangle and quad meshes into one triangle soup, builds on the
host and publishes an immutable `CommittedScene` of tensors on the Device's
device:

  * always: the binned-SAH wide BVH (build/sah.py; BVH4, or BVH8 when
    `tri_accel` starts with "bvh8") and its compact form for the packet
    kernel (traverse/packet_kernel.py::compact_scene; the row layout it
    is cut from stays on the host);
  * when the scene has at least ROWTRACE_MIN_PRIMS triangles or
    `tri_accel` ends in ".rowtrace", and `tri_accel` does not end in
    ".packet": the two-level treelet scene (build/treelets.py) as well;
  * a `SubdivMesh` under `subdiv_accel=default` is tessellated eagerly
    to the uniform level of `set_levels` and joins the triangle soup
    (its hits report patch uv); under
    `subdiv_accel=bvh4.compressed.{box,leaf,grid,full}` all subdivision
    meshes go into one compressed accel instead (scene/subdiv_accel.py:
    one quantized quadtree per tile under a BVH4), packed into the
    compressed kernels' compact form (traverse/cbvh_kernel.py) unless the
    mode is `full` or `compressed_node` is not `com`; the committed scene
    then keeps of the accel itself only the ids and uv tables;
  * `TriangleMeshMB`, `QuadMeshMB` and `SubdivMeshMB` (N >= 2 vertex
    timesteps) go into one motion-blur accel (`_build_mb`: a common knot
    grid, one SAH topology refit at every knot, a temporal-split
    competition that may put time-gated subtrees under an MB4D root),
    packed for the MB kernel (traverse/mb_kernel.py);
  * `BezierCurves` and `BSplineCurves` under `hair_accel=default|obb|
    bvh4obb.bezier1v` become strand-aligned OBB clusters (build/hair.py),
    each tessellated into sub-segments, built and packed for kernel B3
    (traverse/hair_kernel.py: ribbon leaves for flat curves, swept cones
    for round ones); `LineSegments`, and curves under any other
    `hair_accel`, become segment soups walked in torch ops
    (traverse/user.py, the swept cone with end caps of scene/curves.py);
    `BezierCurvesMB` go into one motion-blur curve accel
    (`_build_mb_curves`, walked by traverse/mb.py::intersect_mb_curves);
  * a `UserGeometry` gets a SAH BVH over its `bounds_fn` boxes, walked
    with its `intersect_fn` by traverse/user.py like a segment soup;
  * an `Instance` keeps a reference to its child's committed scene (the
    child is committed first if it was not; every instance of a child
    shares its one device form), the float32 world-to-local transform
    inverted on the host as the JAX package does, and, where the child
    has a triangle BVH with a valid root, the child's BVH opened in
    world space for the entry cull (build/twolevel.py: a budget of 8
    entry boxes, which the last node opened may pass). The scene keeps
    its host BVH arrays (`_bvh_host`) for a parent's cull.

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
torch-op traversal (traverse/cbvh.py). The motion-blur accel folds in
last, at each ray's time (0 when `time` is None), starting from the t
that the other accels left. The curve accels fold in after it, in the
JAX package's order: motion-blur curves (at each ray's time), the hair
clusters (one kernel B3 launch over all clusters of a leaf type, each
ray rotated into each cluster's frame in the kernel and walked from its
running t, the hits finalized once; a scene that mixes round and flat
curves puts the first type's clusters first and makes a launch a type,
so there a hit at exactly the t of a cluster of the other type can go
to another curve than in the JAX package's scene order), the segment
soups and user geometries in geometry-id order. A curve or user hit
carries gprim = -1. Instances fold in last, in geometry-id order (the
JAX package's `scene_intersect` over TransformNodes): the rays are
slab-tested against the instance's entry boxes (`_entry_cull`: the JAX
package's test, not the robust one), moved into the child's space, and
the child's own closest hit walks them from the running t, the rays
that missed every entry box with tfar = -inf. Only the rays that pass
the test against the boxes' union are gathered for this (`_reaching`),
which changes no answer, and the child's kernel is chosen for the
whole request's ray count, as the JAX package's recursion sees it.
The child's hit wins where it is valid and nearer, its Ng comes back
through the transposed inverse, and `inst_id` becomes this instance's
id, so a hit inside nested instances reports the outermost. The
recursion passes what the JAX package passes: no `coherent` hint,
`time`, `ray_mask` or filter, so the child's own dispatch rule picks
its kernel (B1 for a child with a treelet scene under a request of at
least ROWTRACE_MIN_RAYS rays, else B2; B4 for a compressed child) and
a motion-blur child is met at time 0. Occlusion
ORs kernel B3's any-hit variant, the segment soups and user geometries
into the answer (the JAX package runs its closest-hit walk there, which
gives the same booleans), then each instance's child `scene_occluded`
with tfar = tnear for rays already occluded and no entry cull, the JAX
package's form; a child with motion blur raises, as the top level does.
Ray masks act on the top level's triangles only.
The JAX package stream-sorts
large incoherent batches (traverse/stream.py) before its packet kernel;
on this card the sort costs more than it saves (PERF.md), so no path
here sorts.

`Scene.interpolate` (rtcInterpolate: positions, normals, vertex
attributes, and the full derivative set through the analytic patches of
subdiv/patches.py) and `interpolate_normal` (the smooth-normal fast
path) answer on triangle, quad and subdivision meshes in torch ops on
the scene's device.

Build quality, as in the JAX package, selects nothing for the triangle
BVH apart from HIGH's spatial splits: LOW and REFIT commit what MEDIUM
commits (the JAX package routes no commit to `build/morton.py` or
`build/refit.py`). What needs a module which is not ported yet raises
`RaytracerError(INVALID_OPERATION, "not ported yet: ...")`: occlusion
over motion-blur geometry (meshes and curves). World bounds, as in the
JAX package, count neither instances nor user geometry.
"""
from __future__ import annotations

import enum
import math
import time
from types import SimpleNamespace
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..build.bvh import BVH, sah_cost
from ..build.hair import cluster_curves
from ..build.refit import plan_refit, refit
from ..build.sah import BuildSettings, build_sah
from ..build.twolevel import open_merge_entries
from ..build.treelets import TreeletScene, build_treelet_scene, choose_fan
from ..core.device import Device, Error, RaytracerError
from ..core.profile import global_profiler, profile_phase, trace
from ..core.math import cross, rcp_safe, rows_times
from ..core.rayhit import Hits, Rays, miss_hits
from ..subdiv.core import evaluate_plan
from ..subdiv.patches import build_patch_table, eval_patch_table
from ..subdiv.tessellate import (tessellate_mesh_to_triangles,
                                 tessellate_mesh_to_triangles_levels)
from ..traverse.cbvh import (CompressedAccel, compressed_hits, ids_only,
                             intersect_compressed, occluded_compressed)
from ..traverse.cbvh_kernel import (CompactCompressed,
                                    intersect_compressed_kernel,
                                    occluded_compressed_kernel, pack_compact)
from ..traverse.hair_kernel import (PackedHair, PackedHairSet,
                                    intersect_hair_set, occluded_hair_set,
                                    pack_hair_cluster, pack_hair_set)
from ..traverse.mb import MBAccel, MBCurves, intersect_mb_curves, ray_times
from ..traverse.mb_kernel import PackedMB, intersect_mb_kernel, pack_mb
from ..traverse.packet import _finalize_hits, filter_restart
from ..traverse.packet_kernel import (CompactScene, compact_scene,
                                      intersect_packet_kernel_raw,
                                      occluded_packet_kernel, pack_scene)
from ..traverse.rowtrace2 import intersect_rowtrace2
from ..traverse.user import UserAccel, intersect_user
from .curves import (BezierCurves, BezierCurvesMB, BSplineCurves,
                     LineSegments, make_segment_intersector, segment_bounds)
from .geometry import (Geometry, Instance, QuadMesh, QuadMeshMB, SubdivMesh,
                       SubdivMeshMB, TriangleMesh, TriangleMeshMB,
                       UserGeometry)
from .subdiv_accel import (_unit, build_compressed_accel,
                           build_subdiv_geometry, fused_normal_table,
                           grid_sample, interpolate_subdiv,
                           sample_normal_fused)
from .prims import TrianglePrims, empty_triangle_prims, prim_bounds_np

# Treelet path thresholds (the JAX package's): build the treelet scene
# for scenes at or above this many triangles, and route only batches of
# at least this many rays through it.
ROWTRACE_MIN_PRIMS = 100_000
ROWTRACE_MIN_RAYS = 65_536
# the entry cull's slack on a box's exit distance (the JAX package's
# `tmin <= tmax * 1.0000004`)
CULL_SLACK = float(np.float32(1.0000004))
# hair_accel values that select the strand-aligned OBB clusters; any other
# value puts curves into the segment soup
HAIR_OBB_ACCELS = ("default", "obb", "bvh4obb.bezier1v")

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
    LOW = 0      # the binned SAH, as MEDIUM (the JAX package's commit)
    MEDIUM = 1   # binned SAH (default)
    HIGH = 2     # binned SAH with spatial splits (packet path's BVH only)
    REFIT = 3    # the binned SAH, as MEDIUM (the JAX package's commit)


class HairEntry(NamedTuple):
    """One strand-aligned hair cluster (build/hair.py) of one geometry."""

    gid: int
    rot: np.ndarray           # (3, 3) world -> cluster frame (x @ rot)
    members: torch.Tensor     # (M,) i32 cluster member -> curve index
    packed: PackedHair        # kernel B3's accel, in the cluster frame


class HairSet(NamedTuple):
    """Every hair cluster of a scene packed for kernel B3 in one set, in
    the order of `CommittedScene.hairs` (whose `packed` are views into
    it), and what maps a hit back to its curve."""

    packed: PackedHairSet
    members: torch.Tensor      # every cluster's members, concatenated
    member_base: torch.Tensor  # (C,) i64 first member of each cluster
    gid: torch.Tensor          # (C,) i32 geometry of each cluster


def hair_set(hairs):
    """(HairSet, entries) of HairEntry clusters: the set in the entries'
    order, and the entries re-pointed at views into it (one copy of the
    packed rows on the device)."""
    dev = hairs[0].members.device
    packed = pack_hair_set([h.packed for h in hairs],
                           [h.rot for h in hairs])
    sizes = [h.members.numel() for h in hairs]
    hs = HairSet(packed=packed,
                 members=torch.cat([h.members for h in hairs]),
                 member_base=torch.from_numpy(
                     np.cumsum([0] + sizes[:-1])).to(dev),
                 gid=torch.tensor([h.gid for h in hairs], dtype=torch.int32,
                                  device=dev))
    return hs, tuple(h._replace(packed=packed.cluster(c))
                     for c, h in enumerate(hairs))


class UserEntry(NamedTuple):
    """One accel walked by traverse/user.py: a segment soup
    (LineSegments, or curves outside the OBB accel), or a UserGeometry
    (`prim_map` None: the hit's prim is the user's prim)."""

    gid: int
    accel: UserAccel
    intersect_fn: Callable    # make_segment_intersector's, or the user's
    prim_map: Optional[torch.Tensor]  # (S,) i32 segment -> prim id
    device_bytes: int


class InstanceEntry(NamedTuple):
    """One committed instance (scene_instance analog)."""

    inst_id: int
    child: "CommittedScene"    # shared by every instance of the child
    local2world: np.ndarray    # (3, 4) f32
    world2local: np.ndarray    # (3, 4) f32, inverted on the host
    # world boxes of the child's BVH opened for the entry cull
    # (build/twolevel.py), on the scene's device; None when the child has
    # no triangle BVH with a valid root
    cull_lower: Optional[torch.Tensor] = None   # (E, 3) f32
    cull_upper: Optional[torch.Tensor] = None


class CommittedScene(NamedTuple):
    """Immutable device-side scene (the accel + leaf data)."""

    tris: TrianglePrims
    bvh: BVH                          # the wide BVH (one empty node if no prims)
    packet: Optional[CompactScene]    # None for an empty scene
    rowtrace: Optional[TreeletScene]  # None below ROWTRACE_MIN_PRIMS
    prim_mask: torch.Tensor           # (T,) i32 per-prim geometry mask
    world_lower: torch.Tensor         # (3,) f32
    world_upper: torch.Tensor         # (3,) f32
    backface_cull: bool               # EMBREE_BACKFACE_CULLING analog
    # (T, 3, 2) f32 patch-uv corners per triangle when the soup holds an
    # eagerly tessellated SubdivMesh, else None
    tri_patch_uv: Optional[torch.Tensor] = None
    # the fork's subdiv modes; of a packed accel only its ids and uv
    # tables (traverse/cbvh.py::ids_only)
    compressed: Optional[CompressedAccel] = None
    compressed_kernel: Optional[CompactCompressed] = None  # its compact form
    mb: Optional[MBAccel] = None              # motion-blur accel
    mb_kernel: Optional[PackedMB] = None      # its packed form
    hairs: tuple = ()                         # HairEntry a cluster
    users: tuple = ()                 # UserEntry a soup or user geometry
    mb_curves: Optional[MBCurves] = None      # motion-blur curve accel
    hair_set: Optional[HairSet] = None        # `hairs` packed in one set
    instances: tuple = ()                     # InstanceEntry an instance

    @property
    def device(self) -> torch.device:
        return self.world_lower.device


def _not_ported(what: str):
    return RaytracerError(Error.INVALID_OPERATION, f"not ported yet: {what}")


def _as_np_f32(a):
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float32)


def _mesh_point(c, uu, vv):
    """The barycentric (3 corners) or bilinear (4) sum at (u, v)."""
    if len(c) == 3:
        return (1.0 - uu - vv) * c[0] + uu * c[1] + vv * c[2]
    return ((1 - uu) * (1 - vv) * c[0] + uu * (1 - vv) * c[1]
            + uu * vv * c[2] + (1 - uu) * vv * c[3])


def _tri_soup(v, idx):
    """(v0, v1, v2, prim) of a triangle mesh's vertices `v`."""
    return (v[idx[:, 0]], v[idx[:, 1]], v[idx[:, 2]],
            np.arange(idx.shape[0], dtype=np.int32))


def _quad_soup(v, q):
    """(v0, v1, v2, prim, uv_flip) of a quad mesh's vertices `v`: tri
    A = (v0, v1, v3), tri B = (v2, v3, v1) (quadv.h), all A first."""
    n = q.shape[0]
    return (np.concatenate([v[q[:, 0]], v[q[:, 2]]]),
            np.concatenate([v[q[:, 1]], v[q[:, 3]]]),
            np.concatenate([v[q[:, 3]], v[q[:, 1]]]),
            np.concatenate([np.arange(n, dtype=np.int32)] * 2),
            np.concatenate([np.zeros(n, np.int32), np.ones(n, np.int32)]))


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
        # (gid, slot) -> a SubdivMesh's refined attribute tensor, or a
        # mesh's device (values, indices); ("nrm_fused", gid) -> table
        self._attr_cache = {}
        self._patch_tables = {}  # gid -> (PatchTable, verts_iso tensor)
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
        t0 = time.perf_counter()
        self._progress(0.0)
        dev = self.device.device

        tri_v0, tri_v1, tri_v2 = [], [], []
        tri_geom, tri_prim, tri_flip = [], [], []
        tri_uv3 = []          # (n, 3, 2) patch-uv corners per triangle
        any_patch_uv = False  # an eagerly tessellated SubdivMesh is present
        subdiv_compressed = []
        mb_geoms = []
        mb_curve_geoms = []
        hairs, users, instances = [], [], []
        curve_lo, curve_hi = [], []   # bounds of the curves, for world bounds
        with profile_phase("scene.flatten"):
            for gid, g in sorted(self.geometries.items()):
                if not g.enabled:
                    continue
                if isinstance(g, (TriangleMesh, QuadMesh)):
                    soup = (_tri_soup if isinstance(g, TriangleMesh)
                            else _quad_soup)(_as_np_f32(g.vertices),
                                             g.indices)
                    n = soup[0].shape[0]
                    tri_v0.append(soup[0])
                    tri_v1.append(soup[1])
                    tri_v2.append(soup[2])
                    tri_geom.append(np.full(n, gid, np.int32))
                    tri_prim.append(soup[3])
                    tri_flip.append(soup[4] if len(soup) > 4
                                    else np.zeros(n, np.int32))
                    tri_uv3.append(_ident_uv3(n))
                elif isinstance(g, SubdivMesh):
                    if self._subdiv_mode() is not None:
                        subdiv_compressed.append((gid, g))
                        continue
                    # stock path: eager tessellation to triangles
                    # (BVHNSubdivPatch1EagerBuilderSAH analog), uniform or
                    # at per-edge rates with crack-free stitching
                    # (RTC_BUFFER_TYPE_LEVEL, tessellation.h:77)
                    with profile_phase("scene.tessellate"):
                        if g.edge_levels is not None:
                            v0, v1, v2, prim, uv3 = \
                                tessellate_mesh_to_triangles_levels(
                                    g, g.edge_levels,
                                    max_level=self.subdivision_level,
                                    with_uv=True)
                        else:
                            v0, v1, v2, prim, uv3 = \
                                tessellate_mesh_to_triangles(
                                    g, self.subdivision_level, with_uv=True)
                    tri_v0.append(v0)
                    tri_v1.append(v1)
                    tri_v2.append(v2)
                    tri_geom.append(np.full(v0.shape[0], gid, np.int32))
                    tri_prim.append(prim.astype(np.int32))
                    tri_flip.append(np.zeros(v0.shape[0], np.int32))
                    tri_uv3.append(uv3)
                    any_patch_uv = True
                elif isinstance(g, (TriangleMeshMB, QuadMeshMB,
                                    SubdivMeshMB)):
                    mb_geoms.append((gid, g))
                elif isinstance(g, BezierCurvesMB):
                    mb_curve_geoms.append((gid, g))
                elif (isinstance(g, (BezierCurves, BSplineCurves))
                      and self.device.state.hair_accel in HAIR_OBB_ACCELS):
                    with profile_phase("scene.build_hair"):
                        hairs += self._hair_clusters(gid, g, dev, curve_lo,
                                                     curve_hi)
                elif isinstance(g, (LineSegments, BezierCurves,
                                    BSplineCurves)):
                    with profile_phase("scene.build_segments"):
                        users.append(self._segment_accel(gid, g, dev,
                                                         curve_lo, curve_hi))
                elif isinstance(g, UserGeometry):
                    with profile_phase("scene.build_user"):
                        users.append(self._user_accel(gid, g, dev))
                elif isinstance(g, Instance):
                    with profile_phase("scene.instance"):
                        instances.append(self._instance_entry(gid, g, dev))
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
        # the host arrays stay for a parent's entry cull (build/twolevel.py)
        self._bvh_host = bvh_np
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
                # the rows stay on the host: the card holds the compact form
                packet = compact_scene(
                    pack_scene(bvh_np, (v0, v1, v2), "cpu",
                               prim_mask=lut[geom]), dev)
        # compressed subdiv accel (fork modes, scene.cpp:507-510)
        compressed = None
        compressed_kernel = None
        self.subdiv_eval = {}
        self.subdiv_plan = {}
        self._attr_cache = {}
        self._patch_tables = {}
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
                    compressed_kernel = pack_compact(compressed)
            if compressed_kernel is not None:
                # after packing only the hits' ids and the uv remap are
                # read of the accel itself
                compressed = ids_only(compressed)
            if nprims:
                lo_all = np.minimum(lo_all, clo)
                hi_all = np.maximum(hi_all, chi)
            else:
                lo_all, hi_all = clo, chi
        # motion-blur accel (per-knot refit bounds; traverse/mb.py)
        mb = mb_kernel = None
        if mb_geoms:
            mb = self._build_mb(mb_geoms, dev)
            with profile_phase("scene.pack_mb"):
                mb_kernel = pack_mb(mb)
            # the vertices at every knot bound the whole motion
            knots = torch.stack([mb.v0_ts, mb.v1_ts, mb.v2_ts])
            mlo = knots.amin(dim=(0, 1, 2)).cpu().numpy()
            mhi = knots.amax(dim=(0, 1, 2)).cpu().numpy()
            if nprims or subdiv_compressed:
                lo_all = np.minimum(lo_all, mlo)
                hi_all = np.maximum(hi_all, mhi)
            else:
                lo_all, hi_all = mlo, mhi
        # motion-blur curves (per-knot refit bounds; traverse/mb.py)
        mb_curves = None
        if mb_curve_geoms:
            with profile_phase("scene.build_mb_curves"):
                mb_curves = self._build_mb_curves(mb_curve_geoms, dev,
                                                  curve_lo, curve_hi)
        if curve_lo:
            clo = np.min(curve_lo, axis=0)
            chi = np.max(curve_hi, axis=0)
            if nprims or subdiv_compressed or mb_geoms:
                lo_all = np.minimum(lo_all, clo)
                hi_all = np.maximum(hi_all, chi)
            else:
                lo_all, hi_all = clo, chi
        # the hair clusters in one set for kernel B3, grouped by leaf type
        # in the order the types first appear (one launch a type), each
        # type's clusters in scene order; an equal-t tie across the types
        # goes to the earlier group, not the earlier geometry
        hset = None
        if hairs:
            kinds = list(dict.fromkeys(h.packed.flat for h in hairs))
            hairs = sorted(hairs, key=lambda h: kinds.index(h.packed.flat))
            hset, hairs = hair_set(hairs)
        hairs = tuple(hairs)
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
            compressed_kernel=compressed_kernel, mb=mb, mb_kernel=mb_kernel,
            hairs=hairs, users=tuple(users), mb_curves=mb_curves,
            hair_set=hset, instances=tuple(instances))
        # each child's bytes were counted at its own commit
        self.device.memory_monitor(_scene_bytes(self.committed), True)
        self.build_time_s = time.perf_counter() - t0
        self._progress(1.0)
        if self.device.state.verbose >= 2:
            self.print_statistics()
            global_profiler().print("  profile ")
        return self.committed

    def _hair_clusters(self, gid, g, dev, curve_lo, curve_hi):
        """Strand-aligned OBB clusters of one Bezier or B-spline curve
        geometry (the JAX package's first-class hair accel): each
        cluster's curves, rotated into its frame, tessellated into K
        sub-segments and packed for kernel B3 (ribbon leaves for flat
        curves, swept cones for round ones)."""
        cps, radii = g.to_bezier()
        curve_lo.append((cps.min(1) - radii.max(1, keepdims=True)).min(0))
        curve_hi.append((cps.max(1) + radii.max(1, keepdims=True)).max(0))
        K = max(2, int(g.tessellation_rate))
        out = []
        for rot, members in cluster_curves(cps):
            packed = pack_hair_cluster(
                cps[members] @ rot, radii[members], K=K, flat=g.flat,
                device=dev, builder=self.device.state.builder)
            out.append(HairEntry(gid, rot, torch.from_numpy(members).to(dev),
                                 packed))
        return out

    def _segment_accel(self, gid, g, dev, curve_lo, curve_hi) -> UserEntry:
        """The segment soup of a curve geometry: round segments under a
        SAH BVH, walked by traverse/user.py with the swept-cone and cap
        test of scene/curves.py."""
        p0, p1, prim, u0, du = g.to_segments()
        blo, bhi = segment_bounds(p0, p1)
        curve_lo.append(blo.min(0))
        curve_hi.append(bhi.max(0))
        ub = build_sah(blo, bhi, BuildSettings(),
                       backend=self.device.state.builder)
        fn, prim_map = make_segment_intersector(p0, p1, prim, u0, du, dev)
        return UserEntry(gid, UserAccel(ub.to_device(dev), gid, p0.shape[0]),
                         fn, torch.from_numpy(prim_map).to(dev),
                         p0.nbytes + p1.nbytes + u0.nbytes + du.nbytes
                         + prim_map.nbytes)

    def _user_accel(self, gid, g, dev) -> UserEntry:
        """A UserGeometry: a SAH BVH over the boxes its `bounds_fn` gives
        for every prim, walked with its `intersect_fn`."""
        blo, bhi = g.bounds_fn(np.arange(g.num_prims, dtype=np.int64))
        ub = build_sah(_as_np_f32(blo), _as_np_f32(bhi), BuildSettings(),
                       backend=self.device.state.builder)
        return UserEntry(gid, UserAccel(ub.to_device(dev), gid, g.num_prims),
                         g.intersect_fn, None, 0)

    def _instance_entry(self, gid, g, dev) -> InstanceEntry:
        """An Instance: its child's committed scene (committed now if it
        was not), the transforms, and the child's BVH opened in world
        space for the entry cull; the JAX package's commit branch."""
        child = g.child_scene
        if child.device.device != dev:
            self.device.raise_error(
                Error.INVALID_ARGUMENT,
                f"instance {gid}: the child scene is on "
                f"{child.device.device}, this scene on {dev}")
        child_cs = (child.committed if child.committed is not None
                    else child.commit())
        l2w = np.asarray(g.transform, np.float32)
        inv = np.linalg.inv(l2w[:, :3])
        w2l = np.concatenate([inv, (-inv @ l2w[:, 3:])],
                             axis=1).astype(np.float32)
        lo = hi = None
        host = getattr(child, "_bvh_host", None)
        if (host is not None and host.lower.shape[0]
                and (np.asarray(host.count)[0] >= 0).any()):
            ent = open_merge_entries([(l2w, np.asarray(host.lower),
                                       np.asarray(host.upper),
                                       np.asarray(host.child),
                                       np.asarray(host.count))])
            lo = torch.from_numpy(ent.lower).to(dev)
            hi = torch.from_numpy(ent.upper).to(dev)
        return InstanceEntry(gid, child_cs, l2w, w2l, lo, hi)

    def _build_mb_curves(self, mb_curve_geoms, dev, curve_lo,
                         curve_hi) -> MBCurves:
        """MB curve accel (bvh_builder_msmblur_hair analog): segment soups
        resampled on the common knot grid, one SAH topology over their
        union bounds, refit at every knot; the JAX package's build,
        array for array."""
        S = self._knot_count(mb_curve_geoms)
        knots = np.linspace(0.0, 1.0, S)
        per_ts = [[] for _ in range(S)]
        geoms, prims, u0s, dus = [], [], [], []
        for gid, g in mb_curve_geoms:
            soups = g.timestep_segments()
            Sg = len(soups)
            prims.append(soups[0][2])
            u0s.append(soups[0][3])
            dus.append(soups[0][4])
            geoms.append(np.full(soups[0][0].shape[0], gid, np.int32))
            for s, tk in enumerate(knots):
                x = tk * (Sg - 1)
                a = int(np.clip(np.floor(x), 0, Sg - 2))
                w = np.float32(x - a)
                per_ts[s].append(tuple(
                    (1 - w) * soups[a][k] + w * soups[a + 1][k]
                    for k in range(2)))
        p0_ts = np.stack([np.concatenate([t[0] for t in ts])
                          for ts in per_ts])          # (S, C, 4)
        p1_ts = np.stack([np.concatenate([t[1] for t in ts])
                          for ts in per_ts])
        los, his = zip(*(segment_bounds(p0_ts[s], p1_ts[s])
                         for s in range(S)))
        curve_lo.append(np.min(los, axis=(0, 1)))
        curve_hi.append(np.max(his, axis=(0, 1)))
        bvh_u = build_sah(np.minimum.reduce(los), np.maximum.reduce(his),
                          BuildSettings(),
                          backend=self.device.state.builder).to_device(dev)
        sched = plan_refit(bvh_u)
        boxes = [refit(bvh_u, sched, torch.from_numpy(los[s]).to(dev),
                       torch.from_numpy(his[s]).to(dev)) for s in range(S)]

        def up(a, dtype=np.float32):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

        return MBCurves(
            bvh=bvh_u._replace(lower=boxes[0].lower, upper=boxes[0].upper),
            lower_ts=torch.stack([b.lower for b in boxes]),
            upper_ts=torch.stack([b.upper for b in boxes]),
            p0_ts=up(p0_ts), p1_ts=up(p1_ts),
            geom_id=up(np.concatenate(geoms), np.int32),
            prim_id=up(np.concatenate(prims), np.int32),
            u0=up(np.concatenate(u0s)), du=up(np.concatenate(dus)))

    def _knot_count(self, mb_geoms) -> int:
        """Knots of the common grid of MB geometries: one more than the LCM
        of their segment counts, so that every geometry's own knots land on
        common knots (the piecewise-linear resampling is then exact);
        capped at 65, beyond which the motion between knots is chorded."""
        seg_counts = [max(1, len(g.vertex_timesteps) - 1)
                      for _gid, g in mb_geoms]
        L = 1
        for c in seg_counts:
            L = L * c // math.gcd(L, c)
        if L + 1 > 65:
            if self.device.state.verbose >= 1:
                print(f"embree_tpu_torch: MB knot LCM {L + 1} exceeds cap; "
                      f"non-aligned motion will be chorded")
            L = max(seg_counts)
        return L + 1

    def _mb_timestep_soups(self, g):
        """Per-timestep (v0, v1, v2, prim[, flip]) triangle soups of one
        MB geometry (triangle MB directly; quad MB splits each quad into
        the standard diagonal pair; subdiv MB tessellates every cage
        timestep through the shared plan)."""
        if isinstance(g, (TriangleMeshMB, QuadMeshMB)):
            soup = _tri_soup if isinstance(g, TriangleMeshMB) else _quad_soup
            return [soup(v, g.indices) for v in g.vertex_timesteps]
        # SubdivMeshMB: tessellate each timestep (same topology and plan)
        out = []
        for v in g.vertex_timesteps:
            cage = SimpleNamespace(
                vertices=v, face_counts=g.face_counts,
                face_indices=g.face_indices, edge_creases=g.edge_creases,
                edge_crease_weights=g.edge_crease_weights,
                vertex_creases=g.vertex_creases,
                vertex_crease_weights=g.vertex_crease_weights,
                displacement=g.displacement)
            v0, v1, v2, prim = tessellate_mesh_to_triangles(
                cage, self.subdivision_level)
            out.append((v0, v1, v2, prim.astype(np.int32)))
        return out

    def _build_mb(self, mb_geoms, dev) -> MBAccel:
        """Multi-segment MB accel (bvh_builder_msmblur.h analog): one
        SAH build over all-knot union bounds, then a refit at every knot
        — exact linear bounds per uniform segment — and a temporal-split
        competition; the JAX package's build, array for array."""
        S = self._knot_count(mb_geoms)
        knots = np.linspace(0.0, 1.0, S)

        with profile_phase("scene.mb_soups"):
            per_ts = [[] for _ in range(S)]   # [(v0, v1, v2)] per knot
            geoms, prims, flips = [], [], []
            for gid, g in mb_geoms:
                soups = self._mb_timestep_soups(g)
                Sg = len(soups)
                prims.append(soups[0][3])
                flips.append(soups[0][4] if len(soups[0]) > 4
                             else np.zeros(soups[0][0].shape[0], np.int32))
                geoms.append(np.full(soups[0][0].shape[0], gid, np.int32))
                for s, tk in enumerate(knots):
                    # resample this geometry's piecewise-linear motion at
                    # the common knot (exact when the knot grids align)
                    x = tk * (Sg - 1)
                    a = int(np.clip(np.floor(x), 0, Sg - 2))
                    w = np.float32(x - a)
                    per_ts[s].append(tuple(
                        (1 - w) * soups[a][k] + w * soups[a + 1][k]
                        for k in range(3)))
            geom = np.concatenate(geoms)
            prim = np.concatenate(prims)
            flip = np.concatenate(flips)
            v_ts = [np.stack([np.concatenate([t[k] for t in ts])
                              for ts in per_ts]) for k in range(3)]
            los, his = [], []
            for s in range(S):
                lo, hi = prim_bounds_np(v_ts[0][s], v_ts[1][s], v_ts[2][s])
                los.append(lo)
                his.append(hi)

        def build_range(k0: int, k1: int):
            """Union topology over knots [k0..k1] + refit bounds at ALL
            knots (out-of-range knots clamp to the range's edge, so
            unions over a time range stay conservative and tight).
            Returns (host topology, per-knot lower and upper tensors,
            refit SAH cost at each in-range knot)."""
            lo_u = np.minimum.reduce(los[k0:k1 + 1])
            hi_u = np.maximum.reduce(his[k0:k1 + 1])
            bvh_np = build_sah(lo_u, hi_u, BuildSettings(),
                               backend=self.device.state.builder)
            bvh_u = bvh_np.to_device(dev)
            sched = plan_refit(bvh_u)
            lows, ups, costs = [], [], []
            for s in range(S):
                sc = min(max(s, k0), k1)
                b = refit(bvh_u, sched, torch.from_numpy(los[sc]).to(dev),
                          torch.from_numpy(his[sc]).to(dev))
                lows.append(b.lower)
                ups.append(b.upper)
                if k0 <= s <= k1:
                    costs.append(sah_cost(bvh_np._replace(
                        lower=b.lower.cpu().numpy(),
                        upper=b.upper.cpu().numpy())))
            return bvh_np, lows, ups, costs

        # temporal-split competition (bvh_builder_msmblur.h /
        # heuristic_timesplit_array.h semantics): halve the time domain
        # while per-range topologies beat the union topology's worst
        # refit knot by more than 25 %
        def temporal_ranges(k0, k1, depth):
            bvh_np, lows, ups, costs = build_range(k0, k1)
            if depth == 0 or k1 - k0 < 2:
                return [(k0, k1, bvh_np, lows, ups)]
            worst = max(costs)
            km = (k0 + k1) // 2
            left = build_range(k0, km)
            right = build_range(km, k1)
            split_worst = max(max(left[3]), max(right[3]))
            if worst > 1.25 * split_worst:
                return (temporal_ranges(k0, km, depth - 1)
                        + temporal_ranges(km, k1, depth - 1))
            return [(k0, k1, bvh_np, lows, ups)]

        with profile_phase("scene.build_mb"):
            ranges = (temporal_ranges(0, S - 1, depth=2) if S > 2
                      else [(0, S - 1) + build_range(0, S - 1)[:3]])
        def up(a, dtype=np.float32):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

        v0_ts, v1_ts, v2_ts = (up(v) for v in v_ts)
        ids = dict(geom_id=up(geom, np.int32), prim_id=up(prim, np.int32),
                   uv_flip=up(flip, np.int32))
        if len(ranges) == 1:
            _k0, _k1, bvh_np, lows, ups = ranges[0]
            bvh0 = bvh_np.to_device(dev)._replace(lower=lows[0],
                                                  upper=ups[0])
            return MBAccel(bvh=bvh0, lower_ts=torch.stack(lows),
                           upper_ts=torch.stack(ups), v0_ts=v0_ts,
                           v1_ts=v1_ts, v2_ts=v2_ts, **ids)
        # merge the range subtrees under one MB4D root whose children
        # carry the time subranges (AlignedNodeMB4D, bvh.h:837)
        if self.device.state.verbose >= 1:
            print(f"embree_tpu_torch: MB temporal splits -> "
                  f"{len(ranges)} time ranges "
                  f"{[(r[0], r[1]) for r in ranges]}")
        W = ranges[0][2].child.shape[1]
        assert len(ranges) <= W
        Ms = [r[2].child.shape[0] for r in ranges]
        ords = [np.asarray(r[2].prim_order) for r in ranges]
        M_tot = 1 + sum(Ms)
        child = np.zeros((M_tot, W), np.int64)
        count = np.full((M_tot, W), -1, np.int64)
        tlo = np.zeros((M_tot, W), np.float32)
        thi = np.ones((M_tot, W), np.float32)
        lower_ts = np.zeros((S, M_tot, W, 3), np.float32)
        upper_ts = np.zeros((S, M_tot, W, 3), np.float32)
        node_base = 1
        prim_base = 0
        for ri, (k0, k1, b, lows, ups) in enumerate(ranges):
            cn = np.asarray(b.count)
            M = cn.shape[0]
            # offset node refs and leaf prim starts into the concatenation
            ch = np.where(cn == 0, b.child + node_base,
                          np.where(cn > 0, b.child + prim_base, b.child))
            child[node_base:node_base + M] = ch
            count[node_base:node_base + M] = cn
            for s in range(S):
                lower_ts[s, node_base:node_base + M] = lows[s].cpu().numpy()
                upper_ts[s, node_base:node_base + M] = ups[s].cpu().numpy()
            # root child ri -> this subtree's root, gated to its range
            child[0, ri] = node_base
            count[0, ri] = 0
            tlo[0, ri] = k0 / (S - 1)
            thi[0, ri] = k1 / (S - 1)
            vmask = cn[0] >= 0
            for s in range(S):
                lower_ts[s, 0, ri] = lower_ts[s, node_base][vmask].min(0)
                upper_ts[s, 0, ri] = upper_ts[s, node_base][vmask].max(0)
            node_base += M
            prim_base += ords[ri].shape[0]
        bvh0 = BVH(lower=up(lower_ts[0]), upper=up(upper_ts[0]),
                   child=up(child, np.int32), count=up(count, np.int32),
                   prim_order=up(np.concatenate(ords), np.int32))
        return MBAccel(bvh=bvh0, lower_ts=up(lower_ts),
                       upper_ts=up(upper_ts), v0_ts=v0_ts, v1_ts=v1_ts,
                       v2_ts=v2_ts, **ids, time_lo=up(tlo),
                       time_hi=up(thi))

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
        where (geometry.mask & mask) != 0; masks act on the static
        triangles only. `time` in [0, 1] (a scalar or one a ray) samples
        motion-blur geometry (ray.time); None means 0."""
        cs = self._require_commit()
        return scene_intersect(cs, rays, isa=self.device.state.isa,
                               time=time, filter_fn=self.intersection_filter,
                               coherent=coherent, ray_mask=mask)

    def occluded(self, rays: Rays, mask=None) -> torch.Tensor:
        cs = self._require_commit()
        return scene_occluded(cs, rays, isa=self.device.state.isa,
                              ray_mask=mask)

    def interpolate(self, geom_id: int, prim_id, u, v, slot=None,
                    derivatives: bool = False):
        """rtcInterpolate analog: position + smooth normal at (prim, u,
        v) (smooth shading of compressed hits, viewer_device.cpp:284-295;
        vertex-attribute interpolation per interpolation_device.cpp).
        `prim_id`, `u`, `v` are tensors on the scene's device (or arrays),
        one batch shape; the results are tensors on the scene's device.

        slot=None interpolates positions and returns (P, N); slot=k
        interpolates vertex_attributes[k] and returns the attribute value
        (for subdiv, smoothed through the same subdivision stencils the
        limit surface uses).

        derivatives=True returns the full rtcInterpolate derivative set
        (rtcore_geometry.h:234-338) as a dict {P, dPdu, dPdv, ddPdudu,
        ddPdvdv, ddPdudv, Ng}; for subdiv geometries these are ANALYTIC
        limit-surface derivatives (subdiv/patches.py). For quads
        ddPdudv is returned as zero, as the JAX package does, although
        the bilinear patch's is p0 - p1 + p2 - p3."""
        g = self.geometries.get(geom_id)
        dev = self.device.device
        prim_id = torch.as_tensor(prim_id, device=dev).long()
        u = torch.as_tensor(u, device=dev).to(torch.float32)
        v = torch.as_tensor(v, device=dev).to(torch.float32)
        if derivatives:
            return self._interpolate_derivs(g, geom_id, prim_id, u, v)
        if isinstance(g, (TriangleMesh, QuadMesh)):
            c = self._mesh_corners(g, geom_id, slot, prim_id)
            P = _mesh_point(c, u[..., None], v[..., None])
            if slot is not None:
                return P
            return P, _unit(cross(c[1] - c[0], c[-1] - c[0]))
        if not isinstance(g, SubdivMesh):
            self.device.raise_error(Error.INVALID_ARGUMENT,
                                    f"geom {geom_id} not interpolatable")
        ev = self._subdiv_eval(g, geom_id)
        if slot is None:
            return interpolate_subdiv(ev, prim_id, u, v)
        key = (geom_id, slot)
        refined = self._attr_cache.get(key)
        if refined is None:
            refined = torch.from_numpy(evaluate_plan(
                self.subdiv_plan[geom_id],
                _as_np_f32(g.vertex_attributes[slot]))).to(dev)
            self._attr_cache[key] = refined
        return grid_sample(ev, prim_id, u, v, refined)

    def interpolate_normal(self, geom_id: int, prim_id, u, v):
        """Smooth-normal-only interpolate fast path (the viewer's
        per-frame need, viewer_device.cpp:284-295): samples a FUSED normal
        table (subdiv_accel.fused_normal_table), built once a geometry and
        kept, with one row gather per bilinear corner. Falls back to
        interpolate() for non-subdiv geometry."""
        g = self.geometries.get(geom_id)
        if not isinstance(g, SubdivMesh):
            return self.interpolate(geom_id, prim_id, u, v)[1]
        dev = self.device.device
        ev = self._subdiv_eval(g, geom_id)
        key = ("nrm_fused", geom_id)
        table = self._attr_cache.get(key)
        if table is None:
            table = fused_normal_table(ev)
            self._attr_cache[key] = table
        return sample_normal_fused(
            table, ev, torch.as_tensor(prim_id, device=dev).clamp_min(0),
            torch.as_tensor(u, device=dev).to(torch.float32),
            torch.as_tensor(v, device=dev).to(torch.float32))

    def _mesh_corners(self, g, geom_id, slot, prim_id):
        """Of a triangle or quad mesh, the values of its vertices (slot
        None) or of vertex_attributes[slot] at the 3 or 4 corners of each
        prim, as f32 tensors on the scene's device. The device copies of
        the values and the indices are kept in `_attr_cache` until the
        next commit."""
        key = (geom_id, slot)
        ent = self._attr_cache.get(key)
        if ent is None:
            dev = self.device.device
            a = g.vertices if slot is None else g.vertex_attributes[slot]
            ent = (torch.from_numpy(_as_np_f32(a)).to(dev),
                   torch.from_numpy(np.asarray(g.indices, np.int64)).to(dev))
            self._attr_cache[key] = ent
        arr, idx = ent
        idx = idx[prim_id]
        return [arr[idx[..., k]] for k in range(idx.shape[-1])]

    def _subdiv_eval(self, g, geom_id):
        """The SubdivEval of a SubdivMesh: the compressed accel's, or for
        the stock eager path one built now and kept (the rtcInterpolate
        eval-tree path the tessellation cache backs in the reference)."""
        ev = self.subdiv_eval.get(geom_id)
        if ev is None:
            plan, _vd, _vu, _grids, ev = build_subdiv_geometry(
                g, self.subdivision_level, self.device.device)
            self.subdiv_eval[geom_id] = ev
            self.subdiv_plan[geom_id] = plan
        return ev

    def _interpolate_derivs(self, g, geom_id, prim_id, u, v):
        """Full-derivative rtcInterpolate (rtcore_geometry.h:234-338)."""
        if isinstance(g, (TriangleMesh, QuadMesh)):
            c = self._mesh_corners(g, geom_id, None, prim_id)
            uu, vv = u[..., None], v[..., None]
            P = _mesh_point(c, uu, vv)
            if len(c) == 3:
                du, dv = c[1] - c[0], c[2] - c[0]
            else:
                du = (1 - vv) * (c[1] - c[0]) + vv * (c[2] - c[3])
                dv = (1 - uu) * (c[3] - c[0]) + uu * (c[2] - c[1])
            z = torch.zeros_like(P)
            return {"P": P, "dPdu": du, "dPdv": dv, "ddPdudu": z,
                    "ddPdvdv": z, "ddPdudv": z,
                    "Ng": _unit(cross(du, dv))}
        if not isinstance(g, SubdivMesh):
            self.device.raise_error(Error.INVALID_ARGUMENT,
                                    f"geom {geom_id} not interpolatable")
        pt, verts_iso = self._patch_table(g, geom_id)
        return eval_patch_table(pt, verts_iso, prim_id, u, v)

    def _patch_table(self, g, geom_id):
        """Lazily build (and cache) the analytic patch table + iso-level
        control vertices of a SubdivMesh."""
        ent = self._patch_tables.get(geom_id)
        if ent is None:
            pt = build_patch_table(
                g.face_counts, g.face_indices,
                int(np.asarray(g.vertices).shape[0]),
                edge_creases=g.edge_creases,
                edge_crease_weights=g.edge_crease_weights,
                vertex_creases=g.vertex_creases,
                vertex_crease_weights=g.vertex_crease_weights)
            verts_iso = torch.from_numpy(evaluate_plan(
                pt.plan, _as_np_f32(g.vertices))).to(self.device.device)
            ent = (pt, verts_iso)
            self._patch_tables[geom_id] = ent
        return ent

    @property
    def bounds(self):
        cs = self._require_commit()
        return cs.world_lower.cpu().numpy(), cs.world_upper.cpu().numpy()

    def print_statistics(self) -> None:
        """Scene::printStatistics (scene.cpp:77-129) analog."""
        cs = self._require_commit()
        ts = cs.rowtrace
        ct = cs.compressed.tiles if cs.compressed is not None else None
        soups = [u for u in cs.users if u.prim_map is not None]
        ug = [u for u in cs.users if u.prim_map is None]
        children = {id(i.child) for i in cs.instances}
        boxes = sum(i.cull_lower.shape[0] for i in cs.instances
                    if i.cull_lower is not None)
        print(f"embree_tpu_torch scene: {len(self.geometries)} geometries, "
              f"{cs.tris.num_prims} flattened triangles, "
              f"{cs.bvh.num_nodes} BVH{cs.bvh.width} nodes, "
              f"{ts.num_treelets if ts else 0} treelets in "
              f"{ts.num_mids if ts else 0} mids, "
              f"{ct.num_tiles if ct else 0} compressed tiles"
              + (f" ({ct.mode}, level {ct.comp_level})" if ct else "")
              + (f", {cs.mb.v0_ts.shape[1]} motion-blur triangles at "
                 f"{cs.mb.num_timesteps} knots in {cs.mb.bvh.num_nodes} "
                 f"nodes" if cs.mb is not None else "")
              + (f", {len(cs.hairs)} hair clusters of "
                 f"{sum(h.packed.num_segments for h in cs.hairs)} "
                 f"sub-segments" if cs.hairs else "")
              + (f", {sum(u.accel.num_prims for u in soups)} curve "
                 f"segments" if soups else "")
              + (f", {len(ug)} user geometries of "
                 f"{sum(u.accel.num_prims for u in ug)} prims" if ug else "")
              + (f", {cs.mb_curves.p0_ts.shape[1]} motion-blur curve "
                 f"segments" if cs.mb_curves is not None else "")
              + (f", {len(cs.instances)} instances of {len(children)} "
                 f"child scenes ({boxes} entry boxes)" if cs.instances
                 else "")
              + f", {_scene_bytes(cs, children=True) / 1e6:.1f} MB on "
                f"{cs.device}, build {self.build_time_s * 1e3:.1f} ms")


def _scene_bytes(cs: CommittedScene, children: bool = False,
                 _seen=None) -> int:
    """Device bytes of a committed scene: its own tensors and its
    instance tables, and with `children` every child scene reached
    through its instances counted once, however many instances share
    it."""
    seen = set() if _seen is None else _seen
    tensors = (list(cs.tris) + list(cs.bvh)
               + [cs.prim_mask, cs.world_lower, cs.world_upper])
    n = sum(a.numel() * a.element_size() for a in tensors)
    n += cs.packet.device_bytes if cs.packet is not None else 0
    n += cs.rowtrace.device_bytes if cs.rowtrace is not None else 0
    if cs.tri_patch_uv is not None:
        n += cs.tri_patch_uv.numel() * 4
    if cs.compressed is not None:
        # the compact form shares the accel's uv tables: count each once
        ct = cs.compressed.tiles
        parts = [getattr(ct, k) for k in ct.ARRAYS]
        if cs.compressed.top is not None:
            parts += list(cs.compressed.top)
        if cs.compressed_kernel is not None:
            parts += list(cs.compressed_kernel[:5])
        n += sum({a.data_ptr(): a.numel() * a.element_size()
                  for a in parts if a is not None}.values())
    if cs.mb is not None:
        n += sum(a.numel() * a.element_size()
                 for a in list(cs.mb.bvh) + list(cs.mb[1:])
                 if a is not None)
        n += cs.mb_kernel.device_bytes
    if cs.hair_set is not None:
        hs = cs.hair_set
        n += hs.packed.device_bytes + sum(
            a.numel() * a.element_size()
            for a in (hs.members, hs.member_base, hs.gid))
    for u in cs.users:
        n += u.device_bytes + sum(a.numel() * a.element_size()
                                  for a in u.accel.bvh)
    if cs.mb_curves is not None:
        n += sum(a.numel() * a.element_size()
                 for a in list(cs.mb_curves.bvh) + list(cs.mb_curves[1:]))
    for i in cs.instances:
        if i.cull_lower is not None:
            n += 2 * i.cull_lower.numel() * 4
        if children and id(i.child) not in seen:
            seen.add(id(i.child))
            n += _scene_bytes(i.child, True, seen)
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


def _use_rowtrace(cs: CommittedScene, n: int, coherent: bool,
                  ray_mask) -> bool:
    """B1 or B2 for a batch of `n` rays (the whole request's, also where
    an instance's child walks only the rays that reach it)."""
    return (cs.rowtrace is not None and not coherent and ray_mask is None
            and n >= ROWTRACE_MIN_RAYS)


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


def _fold_mb(cs: CommittedScene, flat: Rays, hits: Hits, tm) -> Hits:
    """The AccelN step for the motion-blur accel: the walk at each ray's
    time `tm` (R,) starts from the running t and wins where it hits."""
    hm = intersect_mb_kernel(cs.mb_kernel, cs.mb,
                             Rays(flat.org, flat.dir, flat.tnear, hits.t), tm)
    use_m = hm.valid
    return Hits(*(torch.where(
        use_m.reshape(use_m.shape + (1,) * (a.ndim - use_m.ndim)), a, b)
        for a, b in zip(hm, hits)))


def _fold(hits: Hits, use, t, u, v, ng, prim_id, geom_id) -> Hits:
    """The AccelN min-combine of a curve accel's flat hits (gprim and
    inst_id -1) where `use`."""
    return Hits(
        t=torch.where(use, t, hits.t), u=torch.where(use, u, hits.u),
        v=torch.where(use, v, hits.v),
        ng=torch.where(use[:, None], ng, hits.ng),
        prim_id=torch.where(use, prim_id, hits.prim_id),
        geom_id=torch.where(use, geom_id, hits.geom_id),
        gprim=torch.where(use, -1, hits.gprim),
        inst_id=torch.where(use, -1, hits.inst_id))


def _fold_hair(cs: CommittedScene, flat: Rays, hits: Hits) -> Hits:
    """The AccelN step for the hair clusters: one kernel B3 launch a leaf
    type walks its clusters in order, each from the running t, the rays
    rotated into each cluster's frame in the kernel, and the hits are
    finalized once a launch (Ng rotated back); the result equals a fold
    one cluster at a time."""
    hs = cs.hair_set
    for _flat, first, count in hs.packed.runs():
        t, u, v, ng, m, cl, hitm = intersect_hair_set(
            hs.packed, flat, hits.t.contiguous(), first, count)
        c = cl.clamp_min(0).long()
        use = hitm & (t < hits.t)
        hits = _fold(hits, use, t, u, v, ng,
                     hs.members[hs.member_base[c] + m.clamp_min(0).long()],
                     hs.gid[c])
    return hits


def _fold_curves(cs: CommittedScene, flat: Rays, hits: Hits, tm) -> Hits:
    """The curve accels after the motion-blur accel, in the JAX
    package's order: motion-blur curves at the rays' times, the hair
    clusters, the segment soups."""
    if cs.mb_curves is not None:
        t, u, v, ng, prim, geom, hitm = intersect_mb_curves(
            cs.mb_curves, Rays(flat.org, flat.dir, flat.tnear, hits.t), tm)
        hits = _fold(hits, hitm, t, u, v, ng, prim, geom)
    if cs.hair_set is not None:
        hits = _fold_hair(cs, flat, hits)
    for e in cs.users:
        t, u, v, ng, prim, hitm = intersect_user(
            e.accel, e.intersect_fn,
            Rays(flat.org, flat.dir, flat.tnear, hits.t), hits.t)
        if e.prim_map is not None:
            prim = e.prim_map[prim.clamp_min(0).long()]
        hits = _fold(hits, hitm, t, u, v, ng, prim, e.gid)
    return hits


def _to_local(inst: InstanceEntry, flat: Rays):
    """(org, dir) of flat rays in the instance's local space, each
    component summed left to right in float32 (core/math.py::
    rows_times)."""
    w2l = inst.world2local
    lorg = rows_times(flat.org, w2l[:, :3].T)
    lorg = torch.stack([lorg[:, j] + float(w2l[j, 3]) for j in range(3)],
                       dim=-1)
    return lorg, rows_times(flat.dir, w2l[:, :3].T)


def _entry_cull(lower, upper, flat: Rays, tfar) -> torch.Tensor:
    """Any-hit slab test of flat rays against an instance's opened entry
    boxes (E, 3) (build/twolevel.py): (R,) bool, True where a ray may
    reach the child. The JAX package's test, copied: `rcp_safe`, entry
    clamped to tnear, `tmin <= tmax * 1.0000004` and `tmin <= tfar`."""
    rd = rcp_safe(flat.dir)
    ord_ = flat.org * rd
    t_lo = lower[None] * rd[:, None, :] - ord_[:, None, :]   # (R, E, 3)
    t_hi = upper[None] * rd[:, None, :] - ord_[:, None, :]
    tmin = torch.minimum(t_lo, t_hi).amax(dim=-1)
    tmax = torch.maximum(t_lo, t_hi).amin(dim=-1)
    tmin = torch.maximum(tmin, flat.tnear[:, None])
    hit = (tmin <= tmax * CULL_SLACK) & (tmin <= tfar[:, None])
    return hit.any(dim=1)


def _reaching(inst: InstanceEntry, flat: Rays, tfar):
    """The rays of a flat batch that an instance's child walks: (indices
    (K,) into the batch, or None for all of them; the tfar (K,) each
    enters the child with). Where the instance has entry boxes, only the
    rays that pass the slab test of the boxes' union are gathered, and
    of those the ones that miss every box (`_entry_cull`) enter with
    tfar = -inf, as in the JAX package. The union test drops no ray that
    the box test keeps: in float the slab interval of a box holds that
    of every box inside it, since each step of the test is monotone in
    the box's bounds."""
    if inst.cull_lower is None:
        return None, tfar
    sel = _entry_cull(inst.cull_lower.amin(0, keepdim=True),
                      inst.cull_upper.amax(0, keepdim=True), flat,
                      tfar).nonzero().squeeze(1)
    sub = Rays(*(a[sel] for a in flat))
    tfar = tfar[sel]
    reach = _entry_cull(inst.cull_lower, inst.cull_upper, sub, tfar)
    return sel, torch.where(reach, tfar, -math.inf)


def _child_hits(child: CommittedScene, flat: Rays, n: int) -> Hits:
    """An instance's child answering its share of a request of `n` rays
    as the JAX package's recursion into `scene_intersect` does: no
    `coherent` hint, ray mask or filter, time 0, and the kernel the
    dispatch rule names for all `n` rays."""
    tm = (ray_times(0.0, flat.tnear.shape[0], child.device)
          if child.mb is not None or child.mb_curves is not None else None)
    return _closest_flat(child, flat, False, None, tm, n)


def _fold_instances(cs: CommittedScene, flat: Rays, hits: Hits,
                    n: int) -> Hits:
    """The AccelN step over the instances (instance_intersector): each
    instance's reaching rays (`_reaching`), moved into its local space,
    through the child's closest hit from the running t; the child's hit
    wins where valid and nearer, Ng transformed back and `inst_id` set
    to this instance's id. Only the gathered rays are transformed, walked
    and merged, so an instance costs in proportion to the rays that come
    near it; the answer is the JAX package's, which walks every ray."""
    hits = Hits(*(x.clone() for x in hits))    # merged into in place
    for inst in cs.instances:
        sel, tfar_in = _reaching(inst, flat, hits.t)
        if sel is not None and sel.numel() == 0:
            continue
        sub = flat if sel is None else Rays(*(a[sel] for a in flat))
        old = hits if sel is None else Hits(*(x[sel] for x in hits))
        lorg, ldir = _to_local(inst, sub)
        h = _child_hits(inst.child, Rays(lorg, ldir, sub.tnear, tfar_in), n)
        use = h.valid & (h.t < old.t)
        # normals transform by (L^-1)^T: row form ng @ w2l_lin
        ng = rows_times(h.ng, inst.world2local[:, :3])
        new = Hits(
            t=torch.where(use, h.t, old.t), u=torch.where(use, h.u, old.u),
            v=torch.where(use, h.v, old.v),
            ng=torch.where(use[:, None], ng, old.ng),
            prim_id=torch.where(use, h.prim_id, old.prim_id),
            geom_id=torch.where(use, h.geom_id, old.geom_id),
            gprim=torch.where(use, h.gprim, old.gprim),
            inst_id=torch.where(use, inst.inst_id, old.inst_id))
        if sel is None:
            hits = new
        else:
            for x, y in zip(hits, new):
                x[sel] = y
    return hits


def _closest_flat(cs: CommittedScene, flat: Rays, coherent: bool,
                  ray_mask, tm, n: int) -> Hits:
    """Unfiltered closest hit of a flat batch: the triangles through the
    kernel that the dispatch rule names for a request of `n` rays, then
    the compressed accel, then the motion-blur accel at the rays' times
    `tm`, then the curves and user geometries, then the instances."""
    if cs.tris.num_prims == 0:
        hits = miss_hits(flat.batch_shape, flat.tfar, device=cs.device)
    else:
        if _use_rowtrace(cs, n, coherent, ray_mask):
            t, prim = intersect_rowtrace2(cs.rowtrace, flat,
                                          cull=cs.backface_cull)
        else:
            t, prim = intersect_packet_kernel_raw(
                cs.packet, flat, cull=cs.backface_cull, ray_mask=ray_mask)
        hits = _apply_patch_uv(cs, _finalize_hits(cs.tris, flat, t, prim))
    if cs.compressed is not None:
        hits = _fold_compressed(cs, flat, hits)
    if cs.mb is not None:
        hits = _fold_mb(cs, flat, hits, tm)
    hits = _fold_curves(cs, flat, hits, tm)
    return _fold_instances(cs, flat, hits, n) if cs.instances else hits


def _slab_accels(cs: CommittedScene, outer: int = -1) -> list:
    """[(inst_id, geometry ids, mode)] of the compressed accels in a box,
    leaf or full mode whose hits `cs` can report (their hits, like curve
    hits, carry gprim = -1): its own under `outer` (-1 at the top), and
    those of every instance's child, nested ones too, under the id the
    hit reports, the outermost instance's."""
    out = []
    if cs.compressed is not None and cs.compressed.tiles.mode != "grid":
        out.append((outer, torch.unique(cs.compressed.tiles.geom_id),
                    cs.compressed.tiles.mode))
    for inst in cs.instances:
        out += _slab_accels(inst.child, inst.inst_id if outer < 0 else outer)
    return out


def _intersect_filter_restart(cs: CommittedScene, flat: Rays, filter_fn,
                              coherent: bool, ray_mask, tm) -> Hits:
    """Intersection filters as a restart wavefront
    (traverse/packet.py::filter_restart) over the unfiltered closest hit
    of the whole scene.

    A box or leaf hit of the compressed accel is the entry into a volume,
    not a point on a surface: a ray restarted just past it starts inside
    the same slab and meets it again a float further on, round after
    round. Such a rejection, of the scene's own accel or one inside an
    instance, raises instead (grid mode tests triangles and restarts
    like any triangle mesh)."""
    refusals = [
        (lambda h, rej, iid=iid, gids=gids: rej & (h.gprim < 0)
         & (h.inst_id == iid) & torch.isin(h.geom_id, gids),
         _not_ported("an intersection filter that rejects a hit of a "
                     f"bvh4.compressed.{mode} accel"))
        for iid, gids, mode in _slab_accels(cs)]
    R = flat.tnear.shape[0]
    return filter_restart(
        lambda r: _closest_flat(cs, r, coherent, ray_mask, tm, R),
        flat, filter_fn, refusals)


def scene_intersect(cs: CommittedScene, rays: Rays, isa: str = "default",
                    time=None, filter_fn=None, coherent: bool = False,
                    ray_mask=None) -> Hits:
    """Functional entry: closest hit of every ray against the committed
    triangle soup, through the kernel the module docstring's dispatch
    rule names, then against the compressed accel, the motion-blur
    accel, the curves, user geometries and instances where the scene has
    them. `time` (a scalar, or one value in
    [0, 1] a ray in any shape; 0 when None) places the rays in the
    shutter; only motion-blur geometry reads it. `isa` is accepted and
    selects nothing."""
    shape = rays.batch_shape
    if (cs.tris.num_prims == 0 and cs.compressed is None and cs.mb is None
            and cs.mb_curves is None and not cs.hairs and not cs.users
            and not cs.instances):
        return miss_hits(shape, rays.tfar, device=cs.device)
    flat = _flat_rays(cs, rays)
    rm = _flat_mask(cs, ray_mask, shape)
    tm = (ray_times(0.0 if time is None else time, flat.tnear.shape[0],
                    cs.device)
          if cs.mb is not None or cs.mb_curves is not None else None)
    if filter_fn is not None:
        h = _intersect_filter_restart(cs, flat, filter_fn, coherent, rm, tm)
    else:
        h = _closest_flat(cs, flat, coherent, rm, tm,
                          flat.tnear.shape[0])
    return Hits(*(x.reshape(shape + x.shape[1:]) for x in h))


def scene_occluded(cs: CommittedScene, rays: Rays, isa: str = "default",
                   coherent: bool = False, ray_mask=None) -> torch.Tensor:
    """Functional entry: any hit of every ray (bool, the rays' batch
    shape); the same dispatch as `scene_intersect`, instances last. A
    scene with motion-blur geometry, or an instance of one, raises:
    occlusion takes no time, and the JAX package answers it without the
    motion-blur accel."""
    if cs.mb is not None or cs.mb_curves is not None:
        raise _not_ported("occluded over motion-blur geometry")
    shape = rays.batch_shape
    flat = _flat_rays(cs, rays)
    rm = _flat_mask(cs, ray_mask, shape)
    if cs.tris.num_prims == 0:
        occ = torch.zeros(flat.batch_shape, dtype=torch.bool,
                          device=cs.device)
    elif _use_rowtrace(cs, flat.tnear.shape[0], coherent, rm):
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
    # curves: rays already occluded are retired with tfar = -inf
    inf = torch.tensor(math.inf, dtype=torch.float32, device=cs.device)
    if cs.hair_set is not None:
        hs = cs.hair_set.packed
        for _flat, first, count in hs.runs():
            occ = occ | occluded_hair_set(hs, flat,
                                          torch.where(occ, -inf, flat.tfar),
                                          first, count)
    for e in cs.users:
        tf = torch.where(occ, -inf, flat.tfar)
        occ = occ | intersect_user(e.accel, e.intersect_fn,
                                   Rays(flat.org, flat.dir, flat.tnear, tf),
                                   tf)[5]
    for inst in cs.instances:
        lorg, ldir = _to_local(inst, flat)
        occ = occ | scene_occluded(
            inst.child, Rays(lorg, ldir, flat.tnear,
                             torch.where(occ, flat.tnear, flat.tfar)))
    return occ.reshape(shape)
