"""State carried across from the JAX package.

`committed_scene_from_reference` takes the committed state of
`embree_tpu` as plain numpy arrays (the caller does the `np.asarray` on
the JAX side; nothing here sees a JAX object) and returns this
package's `CommittedScene` on the given device;
`compressed_accel_from_reference` does the same for a compressed
subdivision accel, so that both packages trace the same tiles, and
`mb_accel_from_reference` for a motion-blur accel and its packed rows,
`hair_clusters_from_reference` for the hair clusters of a curve
geometry, `mb_curves_from_reference` for a motion-blur curve accel and
`instance_entries_from_reference` for the instances of a scene,
`prim_sharded_from_reference` for one shard of a primitive-sharded
scene;
`material_table_from_reference` and `light_table_from_reference` carry
the renderer's material and light tables across, so that both packages
shade the same scene.
"""
from __future__ import annotations

import numpy as np
import torch

from .build.bvh import BVH
from .build.cbvh import CompressedTiles
from .build.treelets import BLOCK_ROWS, TreeletScene, compact_treelets
from .dist.prim_shard import PlacedShard, PrimShardedScene, place_shard
from .render.lights import LightTable
from .render.materials import MaterialTable
from .scene.prims import TrianglePrims
from .scene.scene import CommittedScene, HairEntry, InstanceEntry
from .traverse.cbvh import CompressedAccel
from .traverse.hair_kernel import WIDTH as HAIR_WIDTH, packed_from_arrays
from .traverse.mb import MBAccel, MBCurves
from .traverse.mb_kernel import PackedMB, pack_rows, packed_from_rows
from .traverse.packet_kernel import PackedScene, compact_scene, tree_depth


def _tensor(a, dtype, device, shape=None):
    # a copy: the result never aliases the other package's buffers
    a = np.array(a, dtype=dtype, order="C")
    if shape is not None:
        a = a.reshape(shape)
    return torch.from_numpy(a).to(device)


def committed_scene_from_reference(arrays: dict, device) -> CommittedScene:
    """Build a CommittedScene from the JAX package's committed state.

    `arrays` holds numpy arrays / python scalars under these keys:
    `tris.v0`, `tris.v1`, `tris.v2` (T, 3) f32; `tris.geom_id`,
    `tris.prim_id`, `tris.uv_flip` (T,) i32; `bvh.lower`, `bvh.upper`
    (M, W, 3) f32, `bvh.child`, `bvh.count` (M, W) i32, `bvh.prim_order`
    (P,) i32; `packet.nodes` (M, 128) f32, `packet.tdata`
    (ceil(P/10)+1, 128) f32, `packet.bvh_to_orig` (P,) i32,
    `packet.num_nodes`, `packet.num_prims`, `packet.width` (cut to the
    compact form, traverse/packet_kernel.py::compact_scene);
    `rowtrace.blocks`
    (Ntr, 52, 128) f32, `rowtrace.mid_boxes` (M, 6) or flat (M*6,) f32,
    `rowtrace.tre_boxes` (M, 6, 128) f32, `rowtrace.fan`,
    `rowtrace.num_mids`, `rowtrace.num_treelets`, `rowtrace.num_prims`
    (compacted here, build/treelets.py::compact_treelets); `prim_mask`
    (T,) i32; `world_lower`, `world_upper` (3,) f32; `backface_cull` bool.
    The `rowtrace.*` keys are absent for a scene without a treelet scene,
    the `packet.*` keys for an empty scene."""
    device = torch.device(device)
    f32, i32 = np.float32, np.int32
    tris = TrianglePrims(
        _tensor(arrays["tris.v0"], f32, device, (-1, 3)),
        _tensor(arrays["tris.v1"], f32, device, (-1, 3)),
        _tensor(arrays["tris.v2"], f32, device, (-1, 3)),
        _tensor(arrays["tris.geom_id"], i32, device),
        _tensor(arrays["tris.prim_id"], i32, device),
        _tensor(arrays["tris.uv_flip"], i32, device))
    prim_mask = _tensor(arrays["prim_mask"], i32, device)
    bvh_child = np.asarray(arrays["bvh.child"], i32)
    bvh_count = np.asarray(arrays["bvh.count"], i32)
    W = bvh_child.shape[1]
    bvh = BVH(lower=_tensor(arrays["bvh.lower"], f32, device, (-1, W, 3)),
              upper=_tensor(arrays["bvh.upper"], f32, device, (-1, W, 3)),
              child=_tensor(bvh_child, i32, device),
              count=_tensor(bvh_count, i32, device),
              prim_order=_tensor(arrays["bvh.prim_order"], i32, device))
    packet = None
    if "packet.nodes" in arrays:
        M = int(arrays["packet.num_nodes"])
        P = int(arrays["packet.num_prims"])
        if int(arrays["packet.width"]) != W or M != bvh_child.shape[0]:
            raise ValueError("packet.* and bvh.* describe different trees")
        order = _tensor(arrays["packet.bvh_to_orig"], i32, "cpu", (P,))
        pm = prim_mask.cpu()
        packet = compact_scene(PackedScene(
            nodes=_tensor(arrays["packet.nodes"], f32, "cpu", (M, 128)),
            tdata=_tensor(arrays["packet.tdata"], f32, "cpu", (-1, 128)),
            bvh_to_orig=order, num_nodes=M, num_prims=P, width=W,
            depth=tree_depth(bvh_child, bvh_count),
            prim_mask=pm[order.long()].contiguous() if P else pm), device)
    elif tris.num_prims:
        raise ValueError("a non-empty scene needs the packet.* arrays")
    rowtrace = None
    if "rowtrace.blocks" in arrays:
        fan = int(arrays["rowtrace.fan"])
        M = int(arrays["rowtrace.num_mids"])
        n_tre = int(arrays["rowtrace.num_treelets"])
        if n_tre != M * fan:
            raise ValueError(f"num_treelets {n_tre} != num_mids {M} x fan {fan}")
        # blocks keep their bit patterns (prim ids live in the f32 planes)
        blocks = np.asarray(arrays["rowtrace.blocks"])
        if blocks.dtype != f32 or blocks.shape != (n_tre, BLOCK_ROWS, 128):
            raise ValueError(f"rowtrace.blocks: {blocks.dtype} {blocks.shape}")
        tre_boxes = np.asarray(arrays["rowtrace.tre_boxes"], f32)
        if tre_boxes.shape != (M, 6, 128):
            raise ValueError(f"rowtrace.tre_boxes: {tre_boxes.shape}")
        compact = compact_treelets(
            blocks, np.asarray(arrays["rowtrace.mid_boxes"], f32).reshape(M, 6),
            tre_boxes, fan)
        rowtrace = TreeletScene(
            **{k: _tensor(v, f32, device) for k, v in compact.items()},
            fan=fan, num_mids=M, num_treelets=n_tre,
            num_prims=int(arrays["rowtrace.num_prims"]))
    return CommittedScene(
        tris=tris, bvh=bvh, packet=packet, rowtrace=rowtrace,
        prim_mask=prim_mask,
        world_lower=_tensor(arrays["world_lower"], f32, device, (3,)),
        world_upper=_tensor(arrays["world_upper"], f32, device, (3,)),
        backface_cull=bool(arrays["backface_cull"]))


def prim_sharded_from_reference(arrays: dict, device,
                                shard: int) -> PlacedShard:
    """Shard `shard` of the JAX package's `PrimShardedScene` on `device`,
    placed as dist/prim_shard.py::place_prim_sharded places it (padding
    dropped, packed once for kernel B2). `arrays` maps each field of
    `PrimShardedScene` (`lower`, `upper` (D, M, W, 3) f32, `child`,
    `count` (D, M, W) i32, `prim_order` (D, P) i32, `v0`, `v1`, `v2`
    (D, T, 3) f32, `geom_id`, `prim_id`, `uv_flip`, `gmap` (D, T) i32)
    to a numpy array."""
    f32, i32 = np.float32, np.int32
    ps = PrimShardedScene(**{
        k: np.array(arrays[k], f32 if k in ("lower", "upper", "v0", "v1",
                                            "v2") else i32)
        for k in PrimShardedScene._fields})
    D, M, W = ps.child.shape
    if ps.lower.shape != (D, M, W, 3) or ps.v0.shape[:1] != (D,):
        raise ValueError(f"lower {ps.lower.shape}, child {ps.child.shape}, "
                         f"v0 {ps.v0.shape}: not one stacked scene")
    if not 0 <= shard < D:
        raise ValueError(f"shard {shard} of {D}")
    return place_shard(ps, shard, device)


def compressed_accel_from_reference(arrays: dict, device) -> CompressedAccel:
    """Build a CompressedAccel from the JAX package's.

    `arrays` holds numpy arrays / python scalars: the top-level BVH4 as
    `top.lower`, `top.upper` (M, 4, 3) f32, `top.child`, `top.count`
    (M, 4) i32, `top.prim_order` (T,) i32; every array field of the
    reference's `CompressedTiles` as `tiles.<name>` (space, proj, iproj,
    frustum, nodes, nodes_full, uv0, uvd, geom_id, prim_id, leaf_z,
    extent, grid); and `tiles.comp_level`, `tiles.mode`, `tiles.flavor`.
    `traverse.cbvh_kernel.accel_arrays` gives the same dict for an accel
    of this package."""
    device = torch.device(device)
    f32, i32 = np.float32, np.int32
    top = BVH(lower=_tensor(arrays["top.lower"], f32, device, (-1, 4, 3)),
              upper=_tensor(arrays["top.upper"], f32, device, (-1, 4, 3)),
              child=_tensor(arrays["top.child"], i32, device, (-1, 4)),
              count=_tensor(arrays["top.count"], i32, device, (-1, 4)),
              prim_order=_tensor(arrays["top.prim_order"], i32, device))
    ints = ("nodes", "geom_id", "prim_id", "leaf_z")
    fields = {k: _tensor(arrays[f"tiles.{k}"], i32 if k in ints else f32,
                         device) for k in CompressedTiles.ARRAYS}
    T = fields["space"].shape[0]
    if top.prim_order.shape[0] != T:
        raise ValueError(f"{top.prim_order.shape[0]} top-level leaves for "
                         f"{T} tiles")
    tiles = CompressedTiles(**fields,
                            comp_level=int(arrays["tiles.comp_level"]),
                            mode=str(arrays["tiles.mode"]),
                            flavor=str(arrays["tiles.flavor"]))
    return CompressedAccel(top=top, tiles=tiles)


def mb_accel_from_reference(arrays: dict, device):
    """Build an MBAccel and its PackedMB from the JAX package's MBAccel.

    `arrays` holds numpy arrays under the field names: `bvh.lower`,
    `bvh.upper` (M, W, 3) f32, `bvh.child`, `bvh.count` (M, W) i32,
    `bvh.prim_order` (P,) i32; `lower_ts`, `upper_ts` (S, M, W, 3) f32;
    `v0_ts`, `v1_ts`, `v2_ts` (S, T, 3) f32; `geom_id`, `prim_id`,
    `uv_flip` (T,) i32; `time_lo`, `time_hi` (M, W) f32, absent or None
    for an accel without temporal splits. The rows are packed from these
    fields, as the JAX package packs them."""
    device = torch.device(device)
    f32, i32 = np.float32, np.int32
    arrs = {k: (None if arrays.get(k) is None else np.asarray(arrays[k]))
            for k in ("bvh.lower", "bvh.upper", "bvh.child", "bvh.count",
                      "bvh.prim_order", "lower_ts", "upper_ts", "v0_ts",
                      "v1_ts", "v2_ts", "geom_id", "prim_id", "uv_flip",
                      "time_lo", "time_hi")}
    S, M, W, _ = arrs["lower_ts"].shape
    if arrs["bvh.child"].shape != (M, W) or arrs["v0_ts"].shape[0] != S:
        raise ValueError("bvh.*, *_ts describe different accels")
    bvh = BVH(lower=_tensor(arrs["bvh.lower"], f32, device),
              upper=_tensor(arrs["bvh.upper"], f32, device),
              child=_tensor(arrs["bvh.child"], i32, device),
              count=_tensor(arrs["bvh.count"], i32, device),
              prim_order=_tensor(arrs["bvh.prim_order"], i32, device))
    opt = {k: None if arrs[k] is None else _tensor(arrs[k], f32, device)
           for k in ("time_lo", "time_hi")}
    accel = MBAccel(
        bvh=bvh,
        **{k: _tensor(arrs[k], f32, device)
           for k in ("lower_ts", "upper_ts", "v0_ts", "v1_ts", "v2_ts")},
        **{k: _tensor(arrs[k], i32, device)
           for k in ("geom_id", "prim_id", "uv_flip")}, **opt)
    packed: PackedMB = packed_from_rows(pack_rows(arrs), S, W,
                                        arrs["bvh.child"],
                                        arrs["bvh.count"], device)
    return accel, packed


def hair_clusters_from_reference(arrays, device) -> tuple:
    """The HairEntry tuple of a CommittedScene from the JAX package's
    hair clusters.

    `arrays` is a list with one dict a cluster, in fold order: `gid`
    (int), `rot` (3, 3) f32 and `members` (M,) i32 (build/hair.py's
    HairCluster), and the fields of its `HairClusterPallas`
    (traverse/pallas_hair.py): `nodes` (N, 128) f32, `sdata` (rows, 128)
    f32, `seg` (S, 8) f32, `payload` (S,) i32, `K`, `flat`."""
    device = torch.device(device)
    out = []
    for c in arrays:
        nodes = np.asarray(c["nodes"], np.float32)
        W = HAIR_WIDTH
        child = nodes[:, 6 * W:7 * W].astype(np.int64)
        count = nodes[:, 7 * W:8 * W].astype(np.int64)
        packed = packed_from_arrays(nodes, c["sdata"], c["seg"],
                                    c["payload"], child, count, int(c["K"]),
                                    bool(c["flat"]), device)
        out.append(HairEntry(
            gid=int(c["gid"]), rot=np.array(c["rot"], np.float32),
            members=_tensor(c["members"], np.int32, device), packed=packed))
    return tuple(out)


def mb_curves_from_reference(arrays: dict, device) -> MBCurves:
    """Build an MBCurves from the JAX package's (traverse/mb.py).

    `arrays` holds numpy arrays under the field names: `bvh.lower`,
    `bvh.upper` (M, W, 3) f32, `bvh.child`, `bvh.count` (M, W) i32,
    `bvh.prim_order` (C,) i32; `lower_ts`, `upper_ts` (S, M, W, 3) f32;
    `p0_ts`, `p1_ts` (S, C, 4) f32; `geom_id`, `prim_id` (C,) i32; `u0`,
    `du` (C,) f32."""
    device = torch.device(device)
    f32, i32 = np.float32, np.int32
    S, M, W, _ = np.asarray(arrays["lower_ts"]).shape
    if np.asarray(arrays["bvh.child"]).shape != (M, W):
        raise ValueError("bvh.* and lower_ts describe different trees")
    bvh = BVH(lower=_tensor(arrays["bvh.lower"], f32, device),
              upper=_tensor(arrays["bvh.upper"], f32, device),
              child=_tensor(arrays["bvh.child"], i32, device),
              count=_tensor(arrays["bvh.count"], i32, device),
              prim_order=_tensor(arrays["bvh.prim_order"], i32, device))
    return MBCurves(
        bvh=bvh, **{k: _tensor(arrays[k], f32, device)
                    for k in ("lower_ts", "upper_ts", "p0_ts", "p1_ts",
                              "u0", "du")},
        **{k: _tensor(arrays[k], i32, device)
           for k in ("geom_id", "prim_id")})


def instance_entries_from_reference(arrays, device) -> tuple:
    """The `instances` of a CommittedScene from the JAX package's
    `InstanceEntry`s. `arrays` holds one dict an instance, in the JAX
    package's order, with `inst_id` (int), `local2world` and
    `world2local` (3, 4) f32, `cull_lower` and `cull_upper` (E, 3) f32
    (both absent or None for an instance without entry boxes), all numpy,
    and `child`: this package's CommittedScene of the child (for example
    from `committed_scene_from_reference`), shared between the instances
    that name the same object."""
    device = torch.device(device)
    out = []
    for a in arrays:
        lo, hi = a.get("cull_lower"), a.get("cull_upper")
        if (lo is None) != (hi is None):
            raise ValueError("cull_lower and cull_upper come together")
        if a["child"].device != device:
            raise ValueError(f"the child scene is on {a['child'].device}, "
                             f"not {device}")
        out.append(InstanceEntry(
            inst_id=int(a["inst_id"]), child=a["child"],
            local2world=np.array(a["local2world"], np.float32).reshape(3, 4),
            world2local=np.array(a["world2local"], np.float32).reshape(3, 4),
            cull_lower=None if lo is None else _tensor(lo, np.float32,
                                                       device, (-1, 3)),
            cull_upper=None if hi is None else _tensor(hi, np.float32,
                                                       device, (-1, 3))))
    return tuple(out)


def material_table_from_reference(arrays: dict, device) -> MaterialTable:
    """The MaterialTable of the JAX package's: `arrays` maps each field
    name (`type` (M,) i32, `kd`, `ks`, `le`, `trans_in`, `trans_out`
    (M, 3) f32, `ns`, `d`, `eta`, `k`, `rough`, `eta_out` (M,) f32) to a
    numpy array."""
    device = torch.device(device)
    return MaterialTable(**{
        k: _tensor(arrays[k], np.int32 if k == "type" else np.float32,
                   device) for k in MaterialTable._fields})


def light_table_from_reference(arrays: dict, device) -> LightTable:
    """The LightTable of the JAX package's: `arrays` holds `type` (a
    sequence of ints), `pos`, `e1`, `e2`, `radiance` (L, 3), `angles`
    (L, 2) and `ambient` (3,) f32, as numpy arrays."""
    device = torch.device(device)
    return LightTable(
        np.asarray(arrays["type"], np.int32),
        *(_tensor(arrays[k], np.float32, device, s) for k, s in (
            ("pos", (-1, 3)), ("e1", (-1, 3)), ("e2", (-1, 3)),
            ("radiance", (-1, 3)), ("angles", (-1, 2)), ("ambient", (3,)))))
