"""interpolation tutorial: vertex-attribute interpolation at hit points.

Counterpart of embree_tpu/render/tutorials/interpolation.py, the
re-creation of tutorials/interpolation/interpolation_device.cpp: a
triangle cube, a quad cube and a subdivision cube each carry per-vertex
colors (cube_vertex_colors :50-61) bound as vertex-attribute buffers; at
every hit rtcInterpolate (`Scene.interpolate(..., slot=0)`) fetches the
interpolated color, which is used directly as the diffuse albedo
(renderPixelStandard :330-390). For the subdiv cube the color is
smoothed through the same Catmull-Clark stencils as the limit surface.

    python -m embree_tpu_torch.render.tutorials.interpolation \\
        --size 512 512 -o interp.ppm --benchmark 1 3
    ... -rtcore device=cpu                               # on the CPU

A frame is one coherent batch: the triangle and quad cubes through the
packet kernel, the subdivision cube through the compressed kernel
(`bvh4.compressed.grid`, levels (3, 2)).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...core.device import Device
from ...core.math import dot, normalize
from ...core.rayhit import Rays
from ...scene.geometry import QuadMesh, SubdivMesh, TriangleMesh
from ...scene.scene import Scene, scene_intersect
from ..camera import Camera, pixel_coords
from ..tutorial_app import TutorialApplication

CUBE_V = np.asarray([
    [-1, -1, -1], [1, -1, -1], [1, -1, 1], [-1, -1, 1],
    [-1, 1, -1], [1, 1, -1], [1, 1, 1], [-1, 1, 1]], np.float32)
CUBE_COLORS = np.asarray([
    [0, 0, 0], [1, 0, 0], [1, 0, 1], [0, 0, 1],
    [0, 1, 0], [1, 1, 0], [1, 1, 1], [0, 1, 1]], np.float32)
CUBE_T = np.asarray([
    [1, 4, 5], [0, 4, 1], [2, 5, 6], [1, 5, 2], [3, 6, 7], [2, 6, 3],
    [4, 3, 7], [0, 3, 4], [5, 7, 6], [4, 7, 5], [3, 1, 2], [0, 1, 3]],
    np.int32)
CUBE_Q = np.asarray([
    [0, 4, 5, 1], [1, 5, 6, 2], [2, 6, 7, 3],
    [0, 3, 7, 4], [4, 7, 6, 5], [0, 1, 2, 3]], np.int32)


def build_scene(rtcore: str = ""):
    """The three cubes, committed; `rtcore` is appended to the Device
    config string (`device=cpu` runs on the CPU)."""
    # compressed-grid subdiv accel: hits carry patch-space uv, which the
    # attribute interpolation needs
    cfg = "ignore_config_files=1,subdiv_accel=bvh4.compressed.grid"
    if rtcore:
        cfg += f",{rtcore}"
    scene = Scene(Device(cfg))
    scene.set_levels(3, 2)
    offs = {"tri": (-4.5, 0, 0), "quad": (0, 0, 0), "subdiv": (4.5, 0, 0)}
    tri = TriangleMesh(CUBE_V + offs["tri"], CUBE_T)
    tri.vertex_attributes.append(CUBE_COLORS)
    gid_tri = scene.attach(tri)
    quad = QuadMesh(CUBE_V + offs["quad"], CUBE_Q)
    quad.vertex_attributes.append(CUBE_COLORS)
    gid_quad = scene.attach(quad)
    sub = SubdivMesh(CUBE_V + offs["subdiv"],
                     np.full(6, 4, np.int32), CUBE_Q.reshape(-1))
    sub.vertex_attributes.append(CUBE_COLORS)
    gid_sub = scene.attach(sub)
    cs = scene.commit()
    # refine the subdiv cube's colors now rather than in the first frame
    scene.interpolate(gid_sub, np.zeros(1, np.int64), np.zeros(1),
                      np.zeros(1), slot=0)
    return dict(cscene=cs, scene=scene, gids=(gid_tri, gid_quad, gid_sub))


def _interp_colors(scene, gids, hits):
    """Per-geometry rtcInterpolate of the color attribute, selected by
    the hit geom_id (the reference's per-hit rtcInterpolate call)."""
    prim = hits.prim_id.reshape(-1).clamp_min(0)
    u, v = hits.u.reshape(-1), hits.v.reshape(-1)
    gidv = hits.geom_id.reshape(-1)
    col = torch.ones((prim.shape[0], 3), dtype=torch.float32,
                     device=prim.device)
    for gid in gids:
        # a hit on another geometry may carry a prim id past this one's
        # (its value is not selected)
        p = prim.clamp_max(scene.geometries[gid].num_prims - 1)
        c = scene.interpolate(gid, p, u, v, slot=0)
        col = torch.where((gidv == gid)[:, None], c, col)
    return col.reshape(hits.prim_id.shape + (3,))


def render_frame(state, camera: Camera, size):
    w, h = size
    cs, scene, gids = state["cscene"], state["scene"], state["gids"]
    dev = cs.device
    vx, vy, vz, p = camera.ispc_camera(w, h, device=dev)
    x, y = pixel_coords(w, h, device=dev)
    d = normalize(x[..., None] * vx + y[..., None] * vy + vz).reshape(
        h, w, 3)
    org = p.broadcast_to(d.shape).contiguous()
    rays = Rays(org, d, torch.zeros((h, w), dtype=torch.float32, device=dev),
                torch.full((h, w), math.inf, dtype=torch.float32,
                           device=dev))
    hits = scene_intersect(cs, rays, coherent=True)
    col = _interp_colors(scene, gids, hits)
    ns = normalize(hits.ng)
    ns = torch.where((dot(d, ns) < 0)[..., None], ns, -ns)
    shade = 0.3 + 0.7 * dot(-d, ns).clamp(0.0, 1.0)
    img = torch.where(hits.valid[..., None], col * shade[..., None],
                      torch.zeros_like(col))
    return img, w * h


def make_app() -> TutorialApplication:
    app = TutorialApplication(
        "interpolation", lambda app: build_scene(rtcore=app.args.rtcore),
        render_frame)
    app.camera = Camera(from_=(0, 3, -6.5), to=(0, 0, 0))
    return app


if __name__ == "__main__":
    raise SystemExit(make_app().run())
