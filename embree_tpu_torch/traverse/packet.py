"""Hit finalization shared by the traversal paths.

Counterpart of embree_tpu/traverse/packet.py::_finalize_hits: the
traversal kernels return only (t, prim); u, v, Ng and the ids are
recomputed here from the winning primitive. The packet traversal itself
is not ported yet.
"""
from __future__ import annotations

import torch

from ..core.rayhit import Hits, INVALID_ID, Rays
from ..scene.prims import TrianglePrims
from .moeller import intersect_triangle


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
