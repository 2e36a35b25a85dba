"""Light table + next-event-estimation sampling.

Counterpart of embree_tpu/render/lights.py: the reference's light
vtable set (tutorials/common/lights: point, spot, quad/area,
directional, ambient, each with sample/eval) as one SoA table;
sampling is vectorized over the wavefront for one light at a time
(small light counts, like the tutorial scenes). `sample_light` draws
nothing: a quad light reads its two uniforms from `uv`.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.math import cross, dot, length

LIGHT_POINT = 0
LIGHT_SPOT = 1
LIGHT_QUAD = 2
LIGHT_DIRECTIONAL = 3
# ambient is handled as environment radiance on miss


class LightTable:
    """SoA light table; `type` is a tuple of python ints (the light kinds
    select code paths, like the reference's per-light vtables), the rest
    tensors on one device."""

    def __init__(self, type, pos, e1, e2, radiance, angles, ambient):
        self.type = tuple(int(t) for t in np.asarray(type))
        self.pos = pos            # (L, 3) position / quad corner
        self.e1 = e1              # (L, 3) quad edge 1 / spot direction
        self.e2 = e2              # (L, 3) quad edge 2
        self.radiance = radiance  # (L, 3)
        self.angles = angles      # (L, 2) spot cos angles
        self.ambient = ambient    # (3,) environment radiance


def make_light_table(lights: list[dict], ambient=(0.0, 0.0, 0.0), *,
                     device) -> LightTable:
    n = max(len(lights), 1)
    t = np.zeros(n, np.int32)
    pos = np.zeros((n, 3), np.float32)
    e1 = np.zeros((n, 3), np.float32)
    e2 = np.zeros((n, 3), np.float32)
    rad = np.zeros((n, 3), np.float32)
    ang = np.ones((n, 2), np.float32)
    for i, l in enumerate(lights):
        t[i] = l["type"]
        pos[i] = l.get("pos", (0, 0, 0))
        e1[i] = l.get("e1", l.get("dir", (0, -1, 0)))
        e2[i] = l.get("e2", (0, 0, 0))
        rad[i] = l.get("radiance", (1, 1, 1))
        ang[i] = l.get("cos_angles", (1.0, 0.9))
    return LightTable(t, *(torch.from_numpy(a).to(device) for a in (
        pos, e1, e2, rad, ang, np.asarray(ambient, np.float32))))


def sample_light(lt: LightTable, li: int, p, uv=None):
    """Sample light `li` (a python index) from points p (R, 3); `uv`
    (R, 2) holds a quad light's two uniforms (u along e1, v along e2)
    and is not read for the other kinds.

    Returns (wi, dist, radiance_over_pdf) — the common/lights sample()
    contract."""
    ltype = lt.type[li]
    if ltype in (LIGHT_POINT, LIGHT_SPOT):
        d = lt.pos[li] - p
        dist2 = dot(d, d).clamp_min(1e-12)
        dist = torch.sqrt(dist2)
        wi = d / dist[..., None]
        if ltype == LIGHT_POINT:
            return wi, dist, lt.radiance[li] / dist2[..., None]
        cos = dot(-wi, lt.e1[li])
        c0, c1 = lt.angles[li, 0], lt.angles[li, 1]
        fall = ((cos - c1) / (c0 - c1).clamp_min(1e-6)).clamp(0.0, 1.0)
        return wi, dist, lt.radiance[li] * (fall / dist2)[..., None]
    if ltype == LIGHT_DIRECTIONAL:
        wi = -lt.e1[li] / length(lt.e1[li])
        dist = torch.full(p.shape[:-1], 1e30, dtype=torch.float32,
                          device=p.device)
        return wi.expand(p.shape), dist, lt.radiance[li].expand(p.shape)
    # quad/area light: uniform point on the parallelogram
    u, v = uv[..., 0], uv[..., 1]
    q = lt.pos[li] + u[..., None] * lt.e1[li] + v[..., None] * lt.e2[li]
    ng = cross(lt.e1[li], lt.e2[li])
    area = length(ng)
    ngn = ng / area.clamp_min(1e-12)
    d = q - p
    dist2 = dot(d, d).clamp_min(1e-12)
    dist = torch.sqrt(dist2)
    wi = d / dist[..., None]
    cos_l = dot(-wi, ngn).clamp_min(0.0)
    # Le * cos_l * area / dist^2  (pdf = 1/area)
    w = lt.radiance[li] * (cos_l * area / dist2)[..., None]
    return wi, dist, w


def num_lights(lt: LightTable) -> int:
    return len(lt.type)
