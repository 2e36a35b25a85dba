"""Scene `triangle_sphere`: the lat-long triangle sphere of Embree's verify
benchmarks (createTriangleSphere, tutorials/common/scenegraph/
geometry_creation.cpp), committed as one `TriangleMesh`.

`inputs` makes the mesh in numpy from the configuration's parameters; the
program and the reference (`rtbench/reference/triangle_sphere.py`) both
take these arrays. `commit` hands them to the program.
"""
from __future__ import annotations

import numpy as np

TRIANGLE_BYTES = 36  # three float32 vertices: what a triangle is, once


def inputs(params: dict, root: str) -> dict:
    """{"vertices" (V, 3) f32, "triangles" (T, 3) i32} of
    triangle_sphere(center, radius, n): 2 n (n - 1) triangles, the rows
    of the poles as single triangles, in createTriangleSphere's order."""
    n = int(params["n"])
    center = np.asarray(params["center"], np.float32)
    theta = np.linspace(0.0, np.pi, n + 1)
    phi = np.linspace(0.0, 2.0 * np.pi, n + 1)[:-1]
    tt, pp = np.meshgrid(theta, phi, indexing="ij")
    xyz = np.stack([np.sin(tt) * np.cos(pp), np.cos(tt),
                    np.sin(tt) * np.sin(pp)], -1)
    verts = (xyz.reshape(-1, 3) * float(params["radius"])
             + center).astype(np.float32)
    idx = np.arange((n + 1) * n).reshape(n + 1, n)
    nxt = np.roll(idx, -1, axis=1)
    a, b = idx[:-1], nxt[:-1]
    c, d = idx[1:], nxt[1:]
    upper = np.stack([a, c, b], -1)      # rows 1 .. n-1
    lower = np.stack([b, c, d], -1)      # rows 0 .. n-2
    tris = np.empty((n, n, 2, 3), np.int64)
    tris[:, :, 0] = upper
    tris[:, :, 1] = lower
    keep = np.ones((n, n, 2), bool)
    keep[0, :, 0] = False
    keep[n - 1, :, 1] = False
    return {"vertices": verts,
            "triangles": tris[keep].astype(np.int32)}


def bounds(inp: dict):
    v = inp["vertices"]
    return v.min(0), v.max(0)


def geometry_bytes(inp: dict) -> int:
    """Bytes of the geometry the configuration defines, read once."""
    return int(inp["triangles"].shape[0]) * TRIANGLE_BYTES


def commit(inp: dict, cfg: dict, device: str):
    """The program's committed scene of the mesh on `device`."""
    import embree_tpu_torch as ett
    dev = ett.Device(cfg["device_config"], device=device)
    scene = ett.Scene(dev)
    scene.attach(ett.TriangleMesh(inp["vertices"], inp["triangles"]))
    scene.commit()
    return scene
