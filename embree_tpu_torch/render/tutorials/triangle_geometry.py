"""triangle_geometry tutorial: cube + ground plane, primary + shadow rays.

Counterpart of embree_tpu/render/tutorials/triangle_geometry.py, the
re-creation of tutorials/triangle_geometry/triangle_geometry_device.cpp:
the 12-triangle unit cube with per-face colors (:28-85), the 2-triangle
y=-2 ground plane (:88-108), and renderPixelStandard (:137-168):

    color  = 0.5 * diffuse                                if hit
    shadow = occluded(org + tfar*dir, -lightDir, 0.001, inf)
    color += diffuse * clamp(-dot(lightDir, normalize(Ng)), 0, 1)  if !shadow

with lightDir = normalize((-1,-1,-1)). A frame is two coherent batches
(primary rays, shadow rays) through the packet kernel plus tensor ops;
the reference's tile parallel_for (:213-226) maps to the pixel-morton
order the rays are traced in.

    python -m embree_tpu_torch.render.tutorials.triangle_geometry \\
        --size 320 240 -o tri.ppm --benchmark 1 3       # on the CUDA device
    ... -rtcore device=cpu                               # on the CPU
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...core.device import Device
from ...core.math import dot, normalize
from ...core.rayhit import Rays
from ...scene.geometry import TriangleMesh
from ...scene.scene import CommittedScene, Scene, scene_intersect, scene_occluded
from ..camera import Camera, pixel_coords, pixel_morton_order_device
from ..tutorial_app import TutorialApplication

CUBE_VERTICES = np.array([
    [-1, -1, -1], [-1, -1, +1], [-1, +1, -1], [-1, +1, +1],
    [+1, -1, -1], [+1, -1, +1], [+1, +1, -1], [+1, +1, +1]], np.float32)

CUBE_INDICES = np.array([
    [0, 1, 2], [1, 3, 2],      # left
    [4, 6, 5], [5, 6, 7],      # right
    [0, 4, 1], [1, 4, 5],      # bottom
    [2, 3, 6], [3, 7, 6],      # top
    [0, 2, 4], [2, 6, 4],      # front
    [1, 5, 3], [3, 5, 7]], np.int32)  # back

CUBE_FACE_COLORS = np.array([
    [1, 0, 0], [1, 0, 0], [0, 1, 0], [0, 1, 0],
    [0.5, 0.5, 0.5], [0.5, 0.5, 0.5], [1, 1, 1], [1, 1, 1],
    [0, 0, 1], [0, 0, 1], [1, 1, 0], [1, 1, 0]], np.float32)

PLANE_VERTICES = np.array([
    [-10, -2, -10], [-10, -2, +10], [+10, -2, -10], [+10, -2, +10]], np.float32)
PLANE_INDICES = np.array([[0, 1, 2], [1, 3, 2]], np.int32)


def build_scene(device=None):
    """`device` is a Device; None means the CUDA device."""
    dev = device or Device()
    scene = Scene(dev)
    cube_id = scene.attach(TriangleMesh(CUBE_VERTICES, CUBE_INDICES))
    plane_id = scene.attach(TriangleMesh(PLANE_VERTICES, PLANE_INDICES))
    cs = scene.commit()
    # reference-exact: renderPixelStandard shades EVERY hit with
    # face_colors[ray.primID] (triangle_geometry_device.cpp:152) — the
    # ground plane's primIDs are 0/1, so the floor picks up the cube's
    # left-face red. Gated against the reference's own render, so the
    # quirk is load-bearing.
    face_colors = torch.from_numpy(CUBE_FACE_COLORS).to(dev.device)
    prim_offset = torch.zeros(2, dtype=torch.int64, device=dev.device)
    return dict(cscene=cs, face_colors=face_colors, prim_offset=prim_offset,
                cube_id=cube_id, plane_id=plane_id)


def render(cscene: CommittedScene, face_colors, prim_offset,
           cam_vx, cam_vy, cam_vz, cam_p, perm=None, inv=None,
           *, width: int, height: int):
    """Returns the (H, W, 3) f32 framebuffer on the scene's device.

    When (perm, inv) from `pixel_morton_order_device` are given, rays
    trace in pixel-morton order so that neighbouring rays cover an
    ~square screen tile (the reference's TILE_SIZE render tiles,
    tutorial_device.cpp) and the framebuffer is un-permuted at the end
    with one gather."""
    dev = cscene.device
    x, y = pixel_coords(width, height, perm, device=dev)
    d = normalize(x[..., None] * cam_vx + y[..., None] * cam_vy + cam_vz)
    org = cam_p.broadcast_to(d.shape).contiguous()
    n = d.shape[:-1]
    rays = Rays(org, d, torch.zeros(n, dtype=torch.float32, device=dev),
                torch.full(n, math.inf, dtype=torch.float32, device=dev))

    hits = scene_intersect(cscene, rays, coherent=True)
    valid = hits.valid

    fidx = prim_offset[hits.geom_id.clamp_min(0).long()] + hits.prim_id
    diffuse = face_colors[fidx.clamp(0, face_colors.shape[0] - 1)]
    zero = torch.zeros_like(diffuse)
    color = torch.where(valid[..., None], 0.5 * diffuse, zero)

    light_dir = normalize(torch.tensor([-1.0, -1.0, -1.0], device=dev))
    hit_p = org + hits.t[..., None] * d
    shadow = Rays(hit_p, (-light_dir).broadcast_to(d.shape).contiguous(),
                  torch.full(n, 1e-3, dtype=torch.float32, device=dev),
                  torch.full(n, math.inf, dtype=torch.float32, device=dev))
    occ = scene_occluded(cscene, shadow, coherent=True)

    ndotl = (-dot(light_dir.broadcast_to(d.shape),
                  normalize(hits.ng))).clamp(0.0, 1.0)
    color = color + torch.where((valid & ~occ)[..., None],
                                diffuse * ndotl[..., None], zero)
    if inv is not None:
        color = color[inv]
    return color.reshape(height, width, 3)


def render_frame(state, camera: Camera, size):
    w, h = size
    cs = state["cscene"]
    vx, vy, vz, p = camera.ispc_camera(w, h, device=cs.device)
    perm, inv = pixel_morton_order_device(w, h, cs.device)
    img = render(cs, state["face_colors"], state["prim_offset"],
                 vx, vy, vz, p, perm, inv, width=w, height=h)
    # RayStats: 1 primary per pixel + 1 shadow per hit pixel. Counted
    # analytically (tutorial_device.h:151-173 increments per traced ray).
    nrays = 2 * w * h  # upper bound; refined by caller if needed
    return img, nrays


def make_app() -> TutorialApplication:
    def _build(app):
        return build_scene(Device(app.args.rtcore))

    app = TutorialApplication("triangle_geometry", _build, render_frame)
    app.camera = Camera(from_=(1.5, 1.5, -1.5), to=(0, 0, 0))
    return app


if __name__ == "__main__":
    raise SystemExit(make_app().run())
