"""user_geometry tutorial: analytic spheres via user callbacks.

Counterpart of embree_tpu/render/tutorials/user_geometry.py, the
re-creation of tutorials/user_geometry/user_geometry_device.cpp:
analytic spheres registered through the user-geometry callback pair
(sphereBoundsFunc :288-299 on the host, sphereIntersectFunc :301-360 in
torch ops — quadratic ray/sphere solve taking the nearer root in
(tnear, tfar)), plus a triangle ground plane, eyelight shading with
per-sphere colors and point-light shadows via occluded()
(renderPixelStandard :820-860). A frame is two coherent batches
(primary and shadow rays): the plane through the packet kernel, the
spheres through the user-geometry walk (traverse/user.py).

    python -m embree_tpu_torch.render.tutorials.user_geometry \\
        --size 512 512 -o user.ppm --benchmark 1 3     # on the CUDA device
    ... -rtcore device=cpu                               # on the CPU
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...core.device import Device
from ...core.math import dot, normalize
from ...core.rayhit import Rays
from ...scene.geometry import TriangleMesh, UserGeometry
from ...scene.scene import (CommittedScene, Scene, scene_intersect,
                            scene_occluded)
from ..camera import Camera, pixel_coords
from ..tutorial_app import TutorialApplication

SPHERES = np.asarray([
    [0.0, 0.0, 0.0, 1.0],
    [2.2, 0.0, 0.0, 0.6],
    [-2.2, 0.0, 0.0, 0.6],
    [0.0, 0.0, 2.2, 0.6],
], np.float32)   # (x, y, z, r)
COLORS = np.asarray([[1.0, 0.2, 0.2], [0.2, 1.0, 0.2], [0.2, 0.2, 1.0],
                     [1.0, 1.0, 0.2], [0.8, 0.8, 0.8]], np.float32)
LIGHT = (4.0, 6.0, -3.0)


def sphere_bounds(prim_ids):
    c = SPHERES[prim_ids, :3]
    r = SPHERES[prim_ids, 3:4]
    return c - r, c + r


def make_sphere_intersect(spheres: torch.Tensor):
    """The intersect callback over `spheres` (N, 4) on the rays' device."""

    def sphere_intersect(prim_id, rays: Rays, tfar):
        s = spheres[prim_id]
        c, r = s[:3], s[3]
        o = rays.org - c
        a = dot(rays.dir, rays.dir)
        b = 2.0 * dot(o, rays.dir)
        cc = dot(o, o) - r * r
        disc = b * b - 4 * a * cc
        ok = disc >= 0
        sq = disc.clamp_min(0.0).sqrt()
        den = torch.where(a != 0, 2 * a, 1.0)
        t0 = (-b - sq) / den
        t1 = (-b + sq) / den
        # nearer root inside (tnear, tfar) — :330-340
        t = torch.where((t0 > rays.tnear) & (t0 < tfar), t0,
                        torch.where((t1 > rays.tnear) & (t1 < tfar), t1,
                                    math.inf))
        valid = ok & torch.isfinite(t)
        ng = rays.org + t[..., None] * rays.dir - c
        z = torch.zeros_like(t)
        return valid, torch.where(valid, t, tfar), z, z, \
            torch.where(valid[..., None], ng, 0.0)

    return sphere_intersect


def sphere_intersect(prim_id, rays: Rays, tfar):
    """The tutorial's intersect callback over SPHERES, on the rays'
    device."""
    spheres = torch.from_numpy(SPHERES).to(rays.org.device)
    return make_sphere_intersect(spheres)(prim_id, rays, tfar)


def build_scene(device=None):
    """`device` is a Device; None means the CUDA device."""
    dev = device or Device()
    scene = Scene(dev)
    spheres = torch.from_numpy(SPHERES).to(dev.device)
    scene.attach(UserGeometry(SPHERES.shape[0], sphere_bounds,
                              make_sphere_intersect(spheres)))
    gv = np.asarray([[-10, -2, -10], [10, -2, -10], [10, -2, 10],
                     [-10, -2, 10]], np.float32)
    scene.attach(TriangleMesh(gv, np.asarray([[0, 1, 2], [0, 2, 3]],
                                             np.int32)))
    cs = scene.commit()
    return dict(cscene=cs, scene=scene,
                colors=torch.from_numpy(COLORS).to(cs.device))


def render(cscene: CommittedScene, colors, cam_vx, cam_vy, cam_vz, cam_p,
           *, width: int, height: int):
    """One frame, (H, W, 3) f32 on the scene's device."""
    dev = cscene.device
    x, y = pixel_coords(width, height, device=dev)
    d = normalize(x[..., None] * cam_vx + y[..., None] * cam_vy + cam_vz)
    org = cam_p.broadcast_to(d.shape).contiguous()
    n = d.shape[:-1]
    rays = Rays(org, d, torch.zeros(n, dtype=torch.float32, device=dev),
                torch.full(n, math.inf, dtype=torch.float32, device=dev))
    hits = scene_intersect(cscene, rays, coherent=True)

    # sphere prims -> color by prim id; ground -> last color
    cidx = torch.where(hits.geom_id == 0, hits.prim_id.clamp(0, 3), 4)
    col = colors[cidx.long()]
    ns = normalize(hits.ng)
    ns = torch.where((dot(d, ns) < 0)[..., None], ns, -ns)

    # point light + shadow rays (user_geometry_device.cpp:840-855)
    light = torch.tensor(LIGHT, dtype=torch.float32, device=dev)
    pt = org + hits.t[..., None] * d
    ld = light - pt
    dist = dot(ld, ld).sqrt()
    ldn = ld / dist[..., None]
    sorg = pt + 1e-3 * ns * torch.sign(dot(ns, ldn))[..., None]
    srays = Rays(sorg.contiguous(), ldn.contiguous(),
                 torch.zeros_like(hits.t), dist.contiguous())
    shadowed = scene_occluded(cscene, srays, coherent=True)

    diff = dot(ldn, ns).clamp(0.0, 1.0)
    lit = torch.where(shadowed | ~hits.valid, 0.0, diff)
    shade = 0.15 + 0.85 * lit
    img = torch.where(hits.valid[..., None], col * shade[..., None], 0.0)
    return img.reshape(height, width, 3)


def render_frame(state, camera: Camera, size):
    w, h = size
    cs = state["cscene"]
    vx, vy, vz, p = camera.ispc_camera(w, h, device=cs.device)
    img = render(cs, state["colors"], vx, vy, vz, p, width=w, height=h)
    return img, 2 * w * h  # primary + shadow


def make_app() -> TutorialApplication:
    def _build(app):
        return build_scene(Device(app.args.rtcore))

    app = TutorialApplication("user_geometry", _build, render_frame)
    app.camera = Camera(from_=(2, 3, -6), to=(0, 0, 0))
    return app


if __name__ == "__main__":
    raise SystemExit(make_app().run())
