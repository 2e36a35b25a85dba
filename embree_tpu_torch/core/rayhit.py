"""Ray / hit containers (struct-of-arrays NamedTuples of torch tensors).

Counterpart of embree_tpu/core/rayhit.py. Rays and hits carry an
arbitrary batch shape; INVALID_ID == -1 stands in for
RTC_INVALID_GEOMETRY_ID (0xFFFFFFFF). Every constructor takes an
explicit `device`: the package never relies on a default device.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

INVALID_ID = -1


class Rays(NamedTuple):
    org: torch.Tensor    # (..., 3) f32
    dir: torch.Tensor    # (..., 3) f32
    tnear: torch.Tensor  # (...,)  f32
    tfar: torch.Tensor   # (...,)  f32

    @property
    def batch_shape(self):
        return tuple(self.tnear.shape)


def make_rays(org, dir, tnear=0.0, tfar=math.inf, *, device) -> Rays:
    device = torch.device(device)
    org = torch.as_tensor(org, dtype=torch.float32, device=device)
    dir = torch.as_tensor(dir, dtype=torch.float32, device=device)
    shape = org.shape[:-1]
    # broadcast scalars are materialized: the kernels take dense tensors
    tnear = torch.as_tensor(tnear, dtype=torch.float32,
                            device=device).broadcast_to(shape).contiguous()
    tfar = torch.as_tensor(tfar, dtype=torch.float32,
                           device=device).broadcast_to(shape).contiguous()
    return Rays(org, dir, tnear, tfar)


class Hits(NamedTuple):
    """Per-ray closest hit; miss <=> geom_id == INVALID_ID (ray.h RayHit).

    `gprim` is the internal *global* flattened-triangle index (the leaf
    slot) from which the hit can be recomputed analytically.
    """

    t: torch.Tensor        # (...,) f32 hit distance (tfar after a miss)
    u: torch.Tensor        # (...,) f32 barycentric u
    v: torch.Tensor        # (...,) f32
    ng: torch.Tensor       # (..., 3) f32 unnormalized geometric normal
    prim_id: torch.Tensor  # (...,) i32 prim index within its geometry
    geom_id: torch.Tensor  # (...,) i32
    gprim: torch.Tensor    # (...,) i32 global flattened prim index
    inst_id: torch.Tensor  # (...,) i32 instance id (-1 = top level)

    @property
    def valid(self):
        return self.geom_id != INVALID_ID


def miss_hits(shape, tfar, *, device) -> Hits:
    device = torch.device(device)
    shape = tuple(shape)

    def ids():
        return torch.full(shape, INVALID_ID, dtype=torch.int32,
                          device=device)

    return Hits(
        t=torch.as_tensor(tfar, dtype=torch.float32,
                          device=device).broadcast_to(shape),
        u=torch.zeros(shape, dtype=torch.float32, device=device),
        v=torch.zeros(shape, dtype=torch.float32, device=device),
        ng=torch.zeros(shape + (3,), dtype=torch.float32, device=device),
        prim_id=ids(), geom_id=ids(), gprim=ids(), inst_id=ids(),
    )
