"""Plain reference of the `triangle_sphere` scene's closest hits: the
closest hit of each sampled ray against every triangle of the mesh the
harness made (`rtbench/reference/triangles.py`), and the readings that
compare the program's hit records with it.

The mesh is one geometry (id 0) whose triangles keep their index as
`prim_id`. Readings, over the sampled rays:

  valid_mismatch  share of rays whose hit/miss differs
  id_mismatch     share of rays hit on both sides whose (geom, prim)
                  differs (a ray through a shared edge may pick either)
  t_gap           largest |t - t_ref| / t_ref where both hit
  uv_gap          largest |u - u_ref| or |v - v_ref| where the ids agree
  ng_gap          largest |Ng - Ng_ref| / max |Ng_ref| where the ids agree
"""
from __future__ import annotations

import torch

from . import triangles


def prepare(inp: dict, device) -> dict:
    tri = torch.as_tensor(inp["triangles"], dtype=torch.int64, device=device)
    v = torch.as_tensor(inp["vertices"], dtype=torch.float32, device=device)
    return {"v0": v[tri[:, 0]], "v1": v[tri[:, 1]], "v2": v[tri[:, 2]]}


def answer(state: dict, kept: dict, dtype=torch.float32) -> dict:
    """The closest hits of the kept rays, computed in `dtype`."""
    h = triangles.closest(state["v0"], state["v1"], state["v2"],
                          kept["org"], kept["dir"], dtype)
    h["prim_id"] = h.pop("tri")
    h["geom_id"] = torch.where(h["valid"], 0, -1)
    return h


def _max(x) -> float:
    return float(x.max()) if x.numel() else 0.0


def compare(prog: dict, ref: dict) -> dict:
    """Readings of the program's hits `prog` against `ref`, both dicts of
    (R,) / (R, 3) tensors with the keys of `closest`."""
    vp, vr = prog["valid"], ref["valid"]
    both = vp & vr
    same = (both & (prog["prim_id"] == ref["prim_id"])
            & (prog["geom_id"] == ref["geom_id"]))
    tr = ref["t"][both]
    ng_scale = ref["ng"][same].abs().amax(dim=1).clamp_min(1e-30)
    return {
        "valid_mismatch": float((vp != vr).float().mean()),
        "id_mismatch": (float((both & ~same).sum()) / max(int(both.sum()), 1)),
        "t_gap": _max((prog["t"][both] - tr).abs() / tr.abs()),
        "uv_gap": _max(torch.maximum(
            (prog["u"][same] - ref["u"][same]).abs(),
            (prog["v"][same] - ref["v"][same]).abs())),
        "ng_gap": _max((prog["ng"][same] - ref["ng"][same]).abs()
                       .amax(dim=1) / ng_scale),
    }
