"""Plain reference of the `obj_subdiv` scene's closest hits: the exact
limit surface that the compressed accel approximates, and the readings
that compare the program's compressed hits with it.

`prepare` works the surface out again from the cage the harness read:
uniform Catmull-Clark subdivision to the configuration's level and every
vertex pushed to its limit position (`rtbench/reference/catmull_clark.py`,
written from the published rules), each face's (2^L + 1)^2 grid of limit
vertices split into two triangles a cell, as the accel's grid leaves
split them (compressed.h:591-610). `answer` runs every kept ray against
all of them (`rtbench/reference/triangles.py`) and reports the base face
as `prim_id` and the hit's patch uv, u from the face's corner 0 to its
corner 1.

The accel's `leaf` mode answers with a bilinear slab around each cell
quantized to 4 bits (the paper's pizza box), so its hits lie near the
exact surface, not on it; a ray that grazes an edge may hit the slab and
miss the surface, or the reverse. The readings are therefore shares and
tails, and the limits in the configuration come from measured runs:

  valid_mismatch  share of rays whose hit/miss differs
  t_gap           99th percentile of |t - t_ref| / t_ref where both hit
  uv_gap          99th percentile, where both hit, of max(|du|, |dv|) of
                  the patch uv, or 1 where the base faces differ (uv of
                  two faces do not compare)
  far_share       share of the rays hit on both sides whose t lies more
                  than FAR_T off (relative) or whose base face differs:
                  what a fault on a few rays moves, which the tails miss

Ng is not compared: the accel answers its hits with a placeholder
normal, as Embree's compressed leaves do; a renderer asks
`Scene.interpolate_normal` for the surface's.
"""
from __future__ import annotations

import torch

from . import catmull_clark, triangles

FAR_T = 1e-3


def prepare(inp: dict, device) -> dict:
    lim, grids = catmull_clark.limit_grids(
        inp["vertices"], inp["face_counts"], inp["face_indices"],
        inp["levels"][0], device)
    g = grids.shape[1] - 1
    c00, c10 = grids[:, :-1, :-1], grids[:, 1:, :-1]
    c01, c11 = grids[:, :-1, 1:], grids[:, 1:, 1:]
    # triangle 0 (c00, c10, c01), triangle 1 (c11, c01, c10); index
    # ((face * g + i) * g + j) * 2 + k
    v = lim.float()
    return {"v0": v[torch.stack([c00, c11], -1).reshape(-1)],
            "v1": v[torch.stack([c10, c01], -1).reshape(-1)],
            "v2": v[torch.stack([c01, c10], -1).reshape(-1)], "g": g}


def answer(state: dict, kept: dict, dtype=torch.float32) -> dict:
    """The closest hits of the kept rays, computed in `dtype`."""
    h = triangles.closest(state["v0"], state["v1"], state["v2"],
                          kept["org"], kept["dir"], dtype)
    g = state["g"]
    tri = h.pop("tri").clamp_min(0)
    k = tri % 2
    cell = tri // 2
    j = cell % g
    i = (cell // g) % g
    face = cell // (g * g)
    # cell-local (s along i, r along j) of the hit point
    s = torch.where(k == 0, h["u"], 1.0 - h["u"])
    r = torch.where(k == 0, h["v"], 1.0 - h["v"])
    valid = h["valid"]
    zero = torch.zeros_like(s)
    h["u"] = torch.where(valid, (i + s) / g, zero)
    h["v"] = torch.where(valid, (j + r) / g, zero)
    h["prim_id"] = torch.where(valid, face, -1)
    h["geom_id"] = torch.where(valid, 0, -1)
    return h


def _p99(x) -> float:
    return float(torch.quantile(x.double(), 0.99)) if x.numel() else 0.0


def compare(prog: dict, ref: dict) -> dict:
    vp, vr = prog["valid"], ref["valid"]
    both = vp & vr
    same = ((prog["prim_id"] == ref["prim_id"])
            & (prog["geom_id"] == ref["geom_id"]))[both]
    tr = ref["t"][both]
    dt = (prog["t"][both] - tr).abs() / tr.abs()
    duv = torch.maximum((prog["u"][both] - ref["u"][both]).abs(),
                        (prog["v"][both] - ref["v"][both]).abs())
    far = (dt > FAR_T) | ~same
    return {
        "valid_mismatch": float((vp != vr).float().mean()),
        "t_gap": _p99(dt),
        "uv_gap": _p99(torch.where(same, duv, 1.0)),
        "far_share": float(far.sum()) / max(int(both.sum()), 1),
    }
