"""The packet walks' public entries, hit finalization and the
intersection-filter restart shared by the traversal paths.

Counterpart of embree_tpu/traverse/packet.py. `_finalize_hits`
recomputes u, v, Ng and the ids from the winning primitive: the
traversal kernels return only (t, prim).

`intersect_packet`, `intersect_chunked`, `occluded_packet` and
`occluded_chunked` take the JAX package's arguments: a wide BVH
(build/bvh.py) over a triangle soup, rays, masks and a filter. They
compute what kernel B2 computes, a closest or any hit over a BVH4/8 of
triangles, so they pack the tree into B2's compact form
(traverse/packet_kernel.py::compact_scene) and launch B2 on CUDA
tensors; on CPU tensors B2's plain version answers. What differs from
the JAX package's shared-stack lock-step walk:

  * `packet_size` and `stack_depth` are the TPU schedule (one stack a
    packet of rays): they are accepted and select nothing. Each ray
    walks on its own, so `intersect_chunked` equals `intersect_packet`
    and a result does not depend on how rays are grouped.
  * Caps: the JAX walk drops pushes past its shared stack of
    `stack_depth` and tests at most `max_leaf` triangles of a leaf. Here
    every push fits (a tree deeper than B2's compiled stack is refused)
    and every triangle of a leaf is tested; a tree with a leaf of more
    than B2's 8 triangles is refused. So `max_leaf` selects nothing.
  * `filter_fn` is called once a round over the whole batch by
    `filter_restart`, not per candidate inside the walk: with the
    finalized hits (u and v after the quad flip, per-ray geom and prim
    ids). The answer is the closest accepted hit as in the JAX walk,
    but for ties: after a rejection at distance t the restart skips
    other triangles at exactly t.
  * Masks act, as in the JAX walk, only when both `prim_mask` and
    `ray_mask` are given. A ray with tfar = -inf is not occluded, as in
    the JAX walk (B2's any-hit answer, t == -inf, would say it is;
    `scene_occluded` keeps that answer, as the JAX package's kernel
    paths do).

The tree is packed on the host at every call; a caller that walks one
tree many times packs it once with `packed_bvh` and calls
`walk_closest`, as the primitive-sharded ring does.
"""
from __future__ import annotations

import math

import torch

from ..core.rayhit import Hits, INVALID_ID, Rays, miss_hits
from ..scene.prims import TrianglePrims
from .moeller import intersect_triangle

FILTER_MAX_ROUNDS = 1 << 16


def _finalize_hits(tris: TrianglePrims, rays: Rays, t, prim) -> Hits:
    """Recompute u/v/Ng from the winning prim of each ray."""
    valid = prim >= 0
    p = prim.clamp_min(0).long()
    v0, v1, v2 = tris.v0[p], tris.v1[p], tris.v2[p]
    # the winning triangle is re-tested with tfar just past the kernel's t
    _valid, _t, u, v, ng = intersect_triangle(
        rays.org, rays.dir, rays.tnear, t * (1.0 + 1e-6) + 1e-30, v0, v1, v2)
    # quad second-triangle uv remap (kernels/geometry/quadv.h convention);
    # Ng needs no flip: the second triangle is stored with consistent winding
    flip = tris.uv_flip[p] == 1
    u = torch.where(flip, 1.0 - u, u)
    v = torch.where(flip, 1.0 - v, v)
    zero = torch.zeros_like(u)
    invalid = torch.full_like(prim, INVALID_ID, dtype=torch.int32)
    return Hits(
        t=torch.where(valid, t, rays.tfar),
        u=torch.where(valid, u, zero),
        v=torch.where(valid, v, zero),
        ng=torch.where(valid[..., None], ng, torch.zeros_like(ng)),
        prim_id=torch.where(valid, tris.prim_id[p], invalid),
        geom_id=torch.where(valid, tris.geom_id[p], invalid),
        gprim=torch.where(valid, p.to(torch.int32), invalid),
        inst_id=invalid.clone(),
    )


def filter_restart(closest, flat: Rays, filter_fn, refusals=()) -> Hits:
    """Intersection filters as a restart wavefront (the JAX package's
    scene-level formulation): `closest(rays)` gives the unfiltered
    closest hit of a flat batch, the filter is applied to the whole batch
    as tensor ops, and the rejected rays are traversed again with tnear
    advanced just past the rejected hit. Rays that accept or miss are
    retired with tfar = -inf, which costs the kernels one node visit, so
    late rounds pay only for the undecided rays. One `.tolist()` per
    round is the only host sync.

    Hits reach the filter in increasing t per ray. After a rejected hit
    at distance t, other primitives at exactly the same t are skipped; a
    forward-progress guard refuses the same primitive at a t that did
    not grow, so the loop always ends (and is capped at
    FILTER_MAX_ROUNDS). `refusals` is a sequence of (predicate(hits,
    rejected) -> bool tensor, exception): a round in which a predicate
    holds for any ray raises its exception."""
    org, d, tnear_cur, tf = flat
    R = tf.shape[0]
    dev = tf.device
    best = miss_hits((R,), tf, device=dev)
    done = torch.zeros(R, dtype=torch.bool, device=dev)
    prev_prim = torch.full((R,), -2, dtype=torch.int32, device=dev)
    prev_t = torch.full((R,), -math.inf, dtype=torch.float32, device=dev)
    inf = torch.tensor(math.inf, dtype=torch.float32, device=dev)
    for _ in range(FILTER_MAX_ROUNDS if R else 0):
        h = closest(Rays(org, d, tnear_cur, torch.where(done, -inf, tf)))
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
        flags = torch.stack([(~done).any()] + [pred(h, rej).any()
                                               for pred, _ in refusals])
        open_, *stuck = flags.tolist()
        for (_, exc), s in zip(refusals, stuck):
            if s:
                raise exc
        if not open_:
            break
    return best


def packed_bvh(bvh, tris: TrianglePrims, prim_mask=None):
    """B2's compact form (traverse/packet_kernel.py::CompactScene) of a
    wide BVH over `tris`, packed on the host and put on the device of
    `tris`. `prim_mask` (T,) i32, in the order of `tris`, is stored for
    masked walks. Refuses a tree with a leaf of more triangles than B2
    tests (packet_kernel.MAX_LEAF)."""
    from .packet_kernel import MAX_LEAF, compact_scene, pack_scene
    from ..build.bvh import BVHArraysNP

    host = BVHArraysNP(*(torch.as_tensor(a).cpu().numpy() for a in bvh))
    largest = int(host.count.max()) if host.count.size else 0
    if largest > MAX_LEAF:
        raise ValueError(f"a leaf of {largest} triangles: kernel B2 tests at "
                         f"most {MAX_LEAF} a leaf")
    verts = tuple(v.detach().cpu().numpy() for v in tris[:3])
    pm = (None if prim_mask is None
          else torch.as_tensor(prim_mask).cpu().numpy())
    return compact_scene(pack_scene(host, verts, "cpu", pm),
                         tris.v0.device)


def _flat(rays: Rays) -> Rays:
    return Rays(rays.org.reshape(-1, 3).contiguous(),
                rays.dir.reshape(-1, 3).contiguous(),
                rays.tnear.reshape(-1).contiguous(),
                rays.tfar.reshape(-1).contiguous())


def _flat_mask(ps, ray_mask, n):
    """The ray mask as B2 takes it, or None where the scene has no
    prim mask (the JAX walk masks only when it has both)."""
    if ray_mask is None or ps.prim_mask is None:
        return None
    m = torch.as_tensor(ray_mask, device=ps.nodes.device).to(torch.int32)
    return m.broadcast_to((n,)).reshape(-1).contiguous()


def walk_closest(ps, tris: TrianglePrims, rays: Rays, filter_fn=None,
                 ray_mask=None, backface_cull: bool = False) -> Hits:
    """Closest hit of `rays` (any batch shape) over the packed tree `ps`
    (`packed_bvh`) through B2, finalized against `tris`; with
    `filter_fn`, through `filter_restart`."""
    from .packet_kernel import intersect_packet_kernel_raw

    shape = rays.batch_shape
    flat = _flat(rays)
    rm = _flat_mask(ps, ray_mask, flat.tnear.shape[0])

    def closest(r: Rays) -> Hits:
        t, prim = intersect_packet_kernel_raw(ps, r, cull=backface_cull,
                                              ray_mask=rm)
        return _finalize_hits(tris, r, t, prim)

    h = (closest(flat) if filter_fn is None
         else filter_restart(closest, flat, filter_fn))
    return Hits(*(x.reshape(shape + x.shape[1:]) for x in h))


def _masked(prim_mask, ray_mask):
    both = prim_mask is not None and ray_mask is not None
    return (prim_mask, ray_mask) if both else (None, None)


def intersect_packet(bvh, tris: TrianglePrims, rays: Rays,
                     stack_depth: int = 96, max_leaf: int = 8,
                     filter_fn=None, prim_mask=None, ray_mask=None,
                     backface_cull: bool = False) -> Hits:
    """Closest hit of every ray (the module docstring says what differs
    from the JAX walk). Returns Hits of the rays' batch shape."""
    pm, rm = _masked(prim_mask, ray_mask)
    return walk_closest(packed_bvh(bvh, tris, pm), tris, rays, filter_fn,
                        rm, backface_cull)


def intersect_chunked(bvh, tris: TrianglePrims, rays: Rays,
                      packet_size: int = 1024, stack_depth: int = 96,
                      max_leaf: int = 8, filter_fn=None, prim_mask=None,
                      ray_mask=None, backface_cull: bool = False) -> Hits:
    """`intersect_packet`: the answer does not depend on the packets."""
    return intersect_packet(bvh, tris, rays, stack_depth, max_leaf,
                            filter_fn, prim_mask, ray_mask, backface_cull)


def occluded_packet(bvh, tris: TrianglePrims, rays: Rays,
                    stack_depth: int = 96, max_leaf: int = 8,
                    prim_mask=None, ray_mask=None,
                    backface_cull: bool = False) -> torch.Tensor:
    """Any hit of every ray: bool of the rays' batch shape."""
    from .packet_kernel import occluded_packet_kernel

    pm, rm = _masked(prim_mask, ray_mask)
    ps = packed_bvh(bvh, tris, pm)
    flat = _flat(rays)
    occ = occluded_packet_kernel(
        ps, flat, cull=backface_cull,
        ray_mask=_flat_mask(ps, rm, flat.tnear.shape[0]))
    return (occ & (flat.tfar != -math.inf)).reshape(rays.batch_shape)


def occluded_chunked(bvh, tris: TrianglePrims, rays: Rays,
                     packet_size: int = 1024, stack_depth: int = 96,
                     max_leaf: int = 8, prim_mask=None, ray_mask=None,
                     backface_cull: bool = False) -> torch.Tensor:
    """`occluded_packet`: the answer does not depend on the packets."""
    return occluded_packet(bvh, tris, rays, stack_depth, max_leaf,
                           prim_mask, ray_mask, backface_cull)
