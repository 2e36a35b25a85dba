"""Primitive-sharded scenes: the rays travel a ring of ranks.

Counterpart of embree_tpu/dist/prim_shard.py. When a scene does not fit
one card, its primitives are sharded instead of replicated: the
triangles are cut into D spatially contiguous chunks (morton order of
the centroids), one BVH a chunk, and shard `i` lives on rank `i` of the
ring. The rays travel: in D hops every rank walks its resident shard
with the ray block it holds (from the running best t), keeps the closer
hit, and sends the block with its best hit to rank (i + 1) % D, so every
block meets every shard and is home again after D hops with the global
closest hit. Ring traffic is rays and hits (17 words a ray), never the
scene.

`build_prim_sharded` is the JAX package's host build, byte for byte:
the stable morton argsort, `np.array_split`, one SAH build a chunk, the
arrays padded to common shapes and stacked along a leading (D,) axis
(padded node slots have child = count = -1, padded triangles geom_id
-1). `place_prim_sharded` keeps this rank's shard, drops its padding and
packs it once into kernel B2's compact form on the rank's device.

A hop's walk is B2 (traverse/packet.py::walk_closest, the raw kernel
then `_finalize_hits` against the shard's triangles); the hop's send and
receive are one `dist.batch_isend_irecv`, staged through the buffers
that the group's backend takes (dist/sharding.py::buffer_device). With
D = 1 a hop moves nothing: the JAX package's ppermute is the identity
there, and torch does not send to the sending rank.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..build.bvh import BVHArraysNP
from ..build.sah import BuildSettings, build_sah
from ..core.rayhit import Hits, Rays, miss_hits
from ..scene.prims import TrianglePrims
from ..traverse.packet import packed_bvh, walk_closest
from ..traverse.packet_kernel import CompactScene
from .sharding import buffer_device


class PrimShardedScene(NamedTuple):
    """Stacked per-shard accels (host numpy); every array has a leading
    (D,) shard axis."""

    lower: np.ndarray       # (D, M, W, 3) f32
    upper: np.ndarray       # (D, M, W, 3) f32
    child: np.ndarray       # (D, M, W) i32
    count: np.ndarray       # (D, M, W) i32
    prim_order: np.ndarray  # (D, T) i32
    v0: np.ndarray          # (D, T, 3) f32
    v1: np.ndarray
    v2: np.ndarray
    geom_id: np.ndarray     # (D, T) i32
    prim_id: np.ndarray     # (D, T) i32
    uv_flip: np.ndarray     # (D, T) i32
    gmap: np.ndarray        # (D, T) i32 shard-local -> global prim index

    @property
    def num_shards(self):
        return self.lower.shape[0]


class PlacedShard(NamedTuple):
    """One rank's shard on its device, padding dropped."""

    packet: CompactScene    # B2's compact form of the shard's BVH
    tris: TrianglePrims     # the shard's triangles, shard-local order
    gmap: torch.Tensor      # (T,) i32 shard-local -> global prim index


def _morton_u32(x: np.ndarray) -> np.ndarray:
    """Interleave 10-bit x/y/z (build/morton.py codec, host side)."""
    def spread(v):
        v = v.astype(np.uint64) & 0x3FF
        v = (v | (v << 16)) & 0x30000FF
        v = (v | (v << 8)) & 0x300F00F
        v = (v | (v << 4)) & 0x30C30C3
        v = (v | (v << 2)) & 0x9249249
        return v
    return (spread(x[:, 0]) | (spread(x[:, 1]) << 1)
            | (spread(x[:, 2]) << 2))


def build_prim_sharded(v0, v1, v2, geom_id, prim_id, uv_flip,
                       n_shards: int,
                       settings: BuildSettings = BuildSettings(),
                       backend: str = "default") -> PrimShardedScene:
    """Host-side: partition triangles into `n_shards` morton-contiguous
    chunks, build one BVH per chunk, pad to common shapes and stack.
    Shard `i` of the result goes to rank `i` of the ring."""
    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    geom_id = np.asarray(geom_id, np.int32)
    prim_id = np.asarray(prim_id, np.int32)
    uv_flip = np.asarray(uv_flip, np.int32)
    T = v0.shape[0]

    # morton order of centroids -> equal contiguous chunks (spatial
    # locality keeps per-shard BVHs tight)
    cent = (v0 + v1 + v2) / 3.0
    lo = cent.min(0) if T else np.zeros(3, np.float32)
    hi = cent.max(0) if T else np.ones(3, np.float32)
    q = ((cent - lo) / np.maximum(hi - lo, 1e-30) * 1023).astype(np.int64)
    order = np.argsort(_morton_u32(np.clip(q, 0, 1023)), kind="stable")
    chunks = np.array_split(order, n_shards)

    per = []
    for ch in chunks:
        clo = np.minimum(np.minimum(v0[ch], v1[ch]), v2[ch])
        chi = np.maximum(np.maximum(v0[ch], v1[ch]), v2[ch])
        per.append((ch, build_sah(clo, chi, settings, backend=backend)))

    Mmax = max(b.lower.shape[0] for _, b in per)
    Tmax = max(max(len(ch) for ch, _ in per),
               max(b.prim_order.shape[0] for _, b in per), 1)

    def pad_nodes(a, fill, dtype):
        out = np.full((len(per), Mmax) + a(per[0][1]).shape[1:], fill, dtype)
        for i, (_, b) in enumerate(per):
            x = a(b)
            out[i, :x.shape[0]] = x
        return out

    def pad_tris(src, fill, dtype, trailing=()):
        out = np.full((len(per), Tmax) + trailing, fill, dtype)
        for i, (ch, b) in enumerate(per):
            x = src(ch, b)
            out[i, :x.shape[0]] = x
        return out

    return PrimShardedScene(
        lower=pad_nodes(lambda b: b.lower, 0.0, np.float32),
        upper=pad_nodes(lambda b: b.upper, 0.0, np.float32),
        child=pad_nodes(lambda b: b.child, -1, np.int32),
        count=pad_nodes(lambda b: b.count, -1, np.int32),
        prim_order=pad_tris(lambda ch, b: b.prim_order.astype(np.int32),
                            0, np.int32),
        v0=pad_tris(lambda ch, b: v0[ch], 0.0, np.float32, (3,)),
        v1=pad_tris(lambda ch, b: v1[ch], 0.0, np.float32, (3,)),
        v2=pad_tris(lambda ch, b: v2[ch], 0.0, np.float32, (3,)),
        geom_id=pad_tris(lambda ch, b: geom_id[ch], -1, np.int32),
        prim_id=pad_tris(lambda ch, b: prim_id[ch], -1, np.int32),
        uv_flip=pad_tris(lambda ch, b: uv_flip[ch], 0, np.int32),
        gmap=pad_tris(lambda ch, b: ch.astype(np.int32), 0, np.int32))


def place_shard(ps: PrimShardedScene, shard: int, device) -> PlacedShard:
    """Shard `shard` of `ps` on `device`, its padding dropped: the node
    rows up to the last that has a valid slot (at least the root), the
    triangles up to the last with a geom_id other than -1, and the
    prim_order entries that the leaves reach; packed once for B2."""
    device = torch.device(device)
    count = np.asarray(ps.count[shard])
    live = np.nonzero((count >= 0).any(axis=1))[0]
    M = int(live[-1]) + 1 if live.size else 1
    count = count[:M]
    child = np.asarray(ps.child[shard])[:M]
    leaf = count > 0
    P = int((child[leaf] + count[leaf]).max()) if leaf.any() else 0
    real = np.nonzero(np.asarray(ps.geom_id[shard]) != -1)[0]
    T = int(real[-1]) + 1 if real.size else 0
    host = BVHArraysNP(np.asarray(ps.lower[shard])[:M],
                       np.asarray(ps.upper[shard])[:M], child, count,
                       np.asarray(ps.prim_order[shard])[:P])

    def up(a, dtype):
        return torch.from_numpy(np.array(a[shard][:T], dtype)).to(device)

    tris = TrianglePrims(up(ps.v0, np.float32), up(ps.v1, np.float32),
                         up(ps.v2, np.float32), up(ps.geom_id, np.int32),
                         up(ps.prim_id, np.int32), up(ps.uv_flip, np.int32))
    return PlacedShard(packet=packed_bvh(host, tris), tris=tris,
                       gmap=up(ps.gmap, np.int32))


def place_prim_sharded(ps: PrimShardedScene, mesh: DeviceMesh,
                       axis: str = "sp", device=None) -> PlacedShard:
    """This rank's shard of `ps` (its place on the mesh's `axis`) on
    `device`, by default the current CUDA device."""
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device())
    D = mesh.size(mesh.mesh_dim_names.index(axis))
    if D != ps.num_shards:
        raise ValueError(f"{ps.num_shards} shards on a ring of {D} ranks")
    return place_shard(ps, mesh.get_local_rank(axis), device)


def _merge_hits(best: Hits, h: Hits, gmap: torch.Tensor) -> Hits:
    """Keep the closer of the running best and this shard's hit; remap
    the shard-local gprim to the global prim index so the differentiable
    re-evaluation (diff/hit.py) keeps working unchanged."""
    better = h.valid & (h.t < best.t)
    g = gmap[h.gprim.clamp_min(0).long()]
    h = h._replace(gprim=torch.where(h.valid, g, h.gprim))
    return Hits(*(torch.where(
        better.reshape(better.shape + (1,) * (a.ndim - better.ndim)), a, b)
        for a, b in zip(h, best)))


_F_FIELDS = (3, 3, 1, 1, 1, 1, 1, 3)   # org, dir, tnear, tfar, t, u, v, ng
_I_FIELDS = 4                          # prim_id, geom_id, gprim, inst_id


def _pack(rays: Rays, best: Hits):
    f = torch.cat([rays.org, rays.dir, rays.tnear[:, None],
                   rays.tfar[:, None], best.t[:, None], best.u[:, None],
                   best.v[:, None], best.ng], dim=1)
    i = torch.stack([best.prim_id, best.geom_id, best.gprim, best.inst_id],
                    dim=1)
    return f.contiguous(), i.contiguous()


def _unpack(f: torch.Tensor, i: torch.Tensor):
    org, d, tn, tf, t, u, v, ng = torch.split(f, _F_FIELDS, dim=1)
    rays = Rays(org.contiguous(), d.contiguous(), tn[:, 0].contiguous(),
                tf[:, 0].contiguous())
    best = Hits(t[:, 0], u[:, 0], v[:, 0], ng, *i.unbind(1))
    return rays, best


def _hop(rays: Rays, best: Hits, group, rank: int, D: int):
    """Send (rays, best) to the next rank of the ring and receive the
    previous rank's, through the group's buffer device."""
    dev = rays.tnear.device
    buf = buffer_device(group, dev)
    f, i = (x.to(buf) for x in _pack(rays, best))
    rf, ri = torch.empty_like(f), torch.empty_like(i)
    nxt = dist.get_global_rank(group, (rank + 1) % D)
    prv = dist.get_global_rank(group, (rank - 1) % D)
    ops = [dist.P2POp(dist.isend, f, nxt, group),
           dist.P2POp(dist.isend, i, nxt, group),
           dist.P2POp(dist.irecv, rf, prv, group),
           dist.P2POp(dist.irecv, ri, prv, group)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return _unpack(rf.to(dev), ri.to(dev))


def make_prim_sharded_intersect(mesh: DeviceMesh, axis: str = "sp",
                                packet_size: int = 1024):
    """Returns intersect(shard, rays) -> Hits for this rank's placed
    shard and ray block: D hops, each walking the resident shard from
    the running best t and passing (rays, best hit) to the next rank.
    `packet_size` is the JAX package's schedule and selects nothing
    (traverse/packet.py)."""
    D = mesh.size(mesh.mesh_dim_names.index(axis))
    group = mesh.get_group(axis)
    rank = mesh.get_local_rank(axis)

    def intersect(shard: PlacedShard, rays: Rays) -> Hits:
        rays = Rays(rays.org.reshape(-1, 3), rays.dir.reshape(-1, 3),
                    rays.tnear.reshape(-1), rays.tfar.reshape(-1))
        best = miss_hits(rays.tnear.shape, rays.tfar,
                         device=rays.tnear.device)
        best = best._replace(t=best.t.clone())
        for _ in range(D):
            walk = rays._replace(tfar=torch.minimum(rays.tfar, best.t))
            h = walk_closest(shard.packet, shard.tris, walk)
            best = _merge_hits(best, h, shard.gmap)
            if D > 1:
                rays, best = _hop(rays, best, group, rank, D)
        # D hops of +1 on a ring of D ranks: every block is home again
        return best

    return intersect


def prim_sharded_intersect(ps: PlacedShard, rays: Rays, mesh: DeviceMesh,
                           axis: str = "sp",
                           packet_size: int = 1024) -> Hits:
    """Convenience wrapper: this rank's block of a flat ray batch (padded
    to a multiple of the ring's size and cut by
    dist/sharding.py::shard_rays) against its placed shard."""
    return make_prim_sharded_intersect(mesh, axis, packet_size)(ps, rays)
