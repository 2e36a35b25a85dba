"""Scene `obj_subdiv`: the faces of an OBJ file as one Catmull-Clark
`SubdivMesh`, committed at the configuration's subdivision and
compression levels under its `subdiv_accel` (the fork's viewer with
`--compress.*`, obj_loader.cpp:528).

`inputs` reads the raw file (positions and faces only; the demo's OBJ has
no materials, creases or holes) and refuses it unless its SHA-256 is the
configuration's `obj_sha256`, so that a change to the file cannot move
the yardstick unseen; the program and the reference
(`rtbench/reference/obj_subdiv.closest.py`) both take these arrays.
"""
from __future__ import annotations

import hashlib
import os

import numpy as np

GRID_VERTEX_BYTES = 12  # one float32 limit-surface vertex


def inputs(params: dict, root: str) -> dict:
    """{"vertices" (V, 3) f32, "face_counts" (F,) i32, "face_indices"
    (sum counts,) i32, "levels" (subdivision, compression)} of the OBJ
    named by `params["obj"]` (a path relative to the checkout's root)."""
    with open(os.path.join(root, params["obj"]), "rb") as f:
        raw = f.read()
    digest = hashlib.sha256(raw).hexdigest()
    if digest != params["obj_sha256"]:
        raise ValueError(f"{params['obj']} has SHA-256 {digest}, not the "
                         f"configuration's {params['obj_sha256']}")
    verts, counts, flat = [], [], []
    for line in raw.decode().splitlines():
        tok = line.split()
        if not tok:
            continue
        if tok[0] == "v":
            verts.append(tuple(map(float, tok[1:4])))
        elif tok[0] == "f":
            idx = [int(p.split("/")[0]) for p in tok[1:]]
            idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
            counts.append(len(idx))
            flat.extend(idx)
    return {"vertices": np.asarray(verts, np.float32),
            "face_counts": np.asarray(counts, np.int32),
            "face_indices": np.asarray(flat, np.int32),
            "levels": (int(params["subdivision_level"]),
                       int(params["compression_level"]))}


def bounds(inp: dict):
    """The cage's box, which holds the limit surface (the convex hull
    property of the Catmull-Clark limit)."""
    v = inp["vertices"]
    return v.min(0), v.max(0)


def geometry_bytes(inp: dict) -> int:
    """Bytes of the limit grid the configuration defines, read once: a
    quad face's (2^L + 1)^2 vertices of float32 at subdivision level L."""
    if not np.all(inp["face_counts"] == 4):
        raise ValueError("geometry_bytes counts quad faces only")
    g = (1 << inp["levels"][0]) + 1
    return int(inp["face_counts"].shape[0]) * g * g * GRID_VERTEX_BYTES


def commit(inp: dict, cfg: dict, device: str):
    import embree_tpu_torch as ett
    dev = ett.Device(cfg["device_config"], device=device)
    scene = ett.Scene(dev)
    scene.attach(ett.SubdivMesh(inp["vertices"], inp["face_counts"],
                                inp["face_indices"]))
    scene.set_levels(*inp["levels"])
    scene.commit()
    return scene
