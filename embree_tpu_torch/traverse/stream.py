"""Ray-stream reordering (octant + origin-morton sort).

Counterpart of embree_tpu/traverse/stream.py, the analog of the
reference's stream traversal front end
(kernels/bvh/bvh_intersector_stream.{h,cpp} + stream filters): a large
ray batch is sorted into coherent groups — direction octant first (the
stream traverser's octant partition, bvh_intersector_stream.h:44-113),
then the 30-bit morton code of the quantized origin — so that the rays
of a warp walk neighbouring parts of the tree.

Keys and permutation are those of the JAX package (a stable sort on the
same keys); the reorder itself is one `torch.sort(stable=True)` plus
gathers, and the inverse is a scatter through the permutation.
"""
from __future__ import annotations

import torch

from ..build.morton import morton3d
from ..core.rayhit import Rays


def stream_sort_keys(rays: Rays, world_lower, world_upper) -> torch.Tensor:
    """(R,) int64 sort keys: octant(dir) above the 30-bit origin morton
    code, kept to 32 bits as the JAX package's uint32 keys are — so the
    sign of dir.z (bit 32) does not reach the key, there as here."""
    d = rays.dir.reshape(-1, 3)
    org = rays.org.reshape(-1, 3)
    neg = (d < 0).to(torch.int64)
    octant = neg[:, 0] | (neg[:, 1] << 1) | (neg[:, 2] << 2)
    ext = (world_upper - world_lower).clamp_min(1e-20)
    q = ((org - world_lower) / ext * 1023.0).clamp(0.0, 1023.0)
    q = q.to(torch.int64)
    code = morton3d(q[:, 0], q[:, 1], q[:, 2])
    return ((octant << 30) | code) & 0xFFFFFFFF


def _sort_with_rays(keys: torch.Tensor, rays: Rays):
    """Stable sort by key. Returns (sorted_rays, perm): sorted ray i is
    original ray perm[i]."""
    perm = torch.sort(keys, stable=True).indices
    return Rays(rays.org.reshape(-1, 3)[perm], rays.dir.reshape(-1, 3)[perm],
                rays.tnear.reshape(-1)[perm], rays.tfar.reshape(-1)[perm]), perm


def sort_rays(rays: Rays, world_lower, world_upper):
    """Returns (sorted_rays, inverse_permutation)."""
    srays, _perm, inv = sort_rays_perm(rays, world_lower, world_upper)
    return srays, inv


def sort_rays_perm(rays: Rays, world_lower, world_upper):
    """Returns (sorted_rays, perm, inv); `perm` lets callers co-sort
    per-ray payloads, `inv` restores the original order by a gather
    (x_sorted[inv])."""
    srays, perm = sort_rays_stream(rays, world_lower, world_upper)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device)
    return srays, perm, inv


def sort_rays_stream(rays: Rays, world_lower, world_upper):
    """Stream-order variant: returns (sorted_rays, perm) without the
    inverse permutation — for consumers that stay in stream order or
    unsort with `unsort_by_perm`."""
    keys = stream_sort_keys(rays, world_lower, world_upper)
    return _sort_with_rays(keys, rays)


def unsort_by_perm(perm: torch.Tensor, *arrays: torch.Tensor):
    """Restore original ray order for per-ray result tensors given in
    stream order: out[perm[i]] = a[i]. Returns one tensor or a tuple,
    matching the arity."""
    out = []
    for a in arrays:
        o = torch.empty_like(a)
        o[perm] = a
        out.append(o)
    return out[0] if len(out) == 1 else tuple(out)


def unsort_one(perm: torch.Tensor, x: torch.Tensor):
    return unsort_by_perm(perm, x)


def unsort(x, inv):
    return x[inv]
