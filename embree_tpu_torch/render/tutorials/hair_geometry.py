"""hair_geometry tutorial: a fur patch of Bezier hair strands on a plane.

Counterpart of embree_tpu/render/tutorials/hair_geometry.py, the analog
of tutorials/hair_geometry: random strands rooted on a ground patch
(`make_fur`), rendered with diffuse + shadow
shading:

    color  = 0.4 * diffuse                                    if hit
    shadow = occluded(org + t*dir, -lightDir, 0.001, inf)
    color += diffuse * clamp(-dot(lightDir, Ng'), 0, 1)       if !shadow

with lightDir = normalize((-1, -2, -1)) and Ng' the unit normal turned to
face the ray. A frame is one coherent batch of camera rays and one batch
of shadow rays: the plane through kernel B2, the fur through kernel B3
(one launch a hair cluster, closest hit and any hit).

    python -m embree_tpu_torch.render.tutorials.hair_geometry \\
        --size 256 256 -o hair.ppm --benchmark 1 3       # on the CUDA device
    ... -rtcore device=cpu                               # on the CPU
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...core.device import Device
from ...core.math import dot, normalize
from ...core.rayhit import Rays
from ...scene.curves import BezierCurves
from ...scene.geometry import TriangleMesh
from ...scene.scene import (CommittedScene, Scene, scene_intersect,
                            scene_occluded)
from ..camera import Camera, pixel_coords
from ..tutorial_app import TutorialApplication

PLANE_V = np.array([[-2, 0, -2], [-2, 0, 2], [2, 0, -2], [2, 0, 2]],
                   np.float32)
PLANE_T = np.array([[0, 1, 2], [1, 3, 2]], np.int32)
HAIR_DIFFUSE = (0.65, 0.45, 0.2)
GROUND_DIFFUSE = (0.3, 0.5, 0.3)


def make_fur(n_strands: int = 120, seed: int = 7):
    """The hair_geometry tutorial's fur: n_strands Bezier strands rooted
    uniformly on the [-1, 1]^2 patch of the y = 0 plane, 1 tall, swaying
    by N(0, 0.15), tapering from radius 0.02 to 0.003. The JAX package's
    generator vectorised (the same draws in the same order, the same
    bytes). Returns ((4 n, 4) xyzr vertices, (n,) indices)."""
    rng = np.random.default_rng(seed)
    roots = rng.uniform(-1, 1, (n_strands, 2)).astype(np.float32)
    sway = rng.normal(0, 0.15, (n_strands, 2))
    x, z = roots[:, 0:1], roots[:, 1:2]
    r0 = 0.02
    cps = np.stack([
        np.concatenate([x, np.zeros_like(x), z, np.full_like(x, r0)], 1),
        np.concatenate([x + sway[:, 0:1] * 0.3, np.full_like(x, 0.35),
                        z + sway[:, 1:2] * 0.3, np.full_like(x, r0 * 0.7)],
                       1),
        np.concatenate([x + sway[:, 0:1] * 0.8, np.full_like(x, 0.7),
                        z + sway[:, 1:2] * 0.8, np.full_like(x, r0 * 0.4)],
                       1),
        np.concatenate([x + sway[:, 0:1], np.ones_like(x),
                        z + sway[:, 1:2], np.full_like(x, r0 * 0.15)], 1),
    ], axis=1).reshape(-1, 4)
    return (np.asarray(cps, np.float32),
            np.arange(0, 4 * n_strands, 4, dtype=np.int32))


def build_scene(device=None, n_strands: int = 120):
    """`device` is a Device; None means the CUDA device. Geometry 0 is
    the ground, 1 the fur (tessellation rate 6)."""
    scene = Scene(device or Device())
    scene.attach(TriangleMesh(PLANE_V, PLANE_T))
    cps, idx = make_fur(n_strands)
    scene.attach(BezierCurves(cps, idx, tessellation_rate=6))
    cs = scene.commit()
    return dict(cscene=cs, scene=scene)


def render(cscene: CommittedScene, cam_vx, cam_vy, cam_vz, cam_p, *,
           width: int, height: int):
    """One frame, (H, W, 3) f32 on the scene's device."""
    dev = cscene.device
    x, y = pixel_coords(width, height, device=dev)
    d = normalize(x[..., None] * cam_vx + y[..., None] * cam_vy + cam_vz)
    org = cam_p.broadcast_to(d.shape).contiguous()
    n = d.shape[:-1]
    rays = Rays(org, d, torch.zeros(n, dtype=torch.float32, device=dev),
                torch.full(n, math.inf, dtype=torch.float32, device=dev))
    hits = scene_intersect(cscene, rays, coherent=True)
    valid = hits.valid
    hair = torch.tensor(HAIR_DIFFUSE, device=dev)
    ground = torch.tensor(GROUND_DIFFUSE, device=dev)
    diffuse = torch.where((hits.geom_id == 1)[..., None], hair, ground)
    color = torch.where(valid[..., None], 0.4 * diffuse, 0.0)
    light_dir = normalize(torch.tensor([-1.0, -2.0, -1.0], device=dev))
    hit_p = org + hits.t[..., None] * d
    occ = scene_occluded(cscene, Rays(
        hit_p, (-light_dir).broadcast_to(d.shape).contiguous(),
        torch.full(n, 1e-3, dtype=torch.float32, device=dev),
        torch.full(n, math.inf, dtype=torch.float32, device=dev)))
    ng = normalize(hits.ng)
    ng = torch.where((dot(d, ng) < 0)[..., None], ng, -ng)
    ndotl = (-dot(light_dir.broadcast_to(d.shape), ng)).clamp(0.0, 1.0)
    color = color + torch.where((valid & ~occ)[..., None],
                                diffuse * ndotl[..., None], 0.0)
    return color.reshape(height, width, 3)


def render_frame(state, camera: Camera, size):
    w, h = size
    cs = state["cscene"]
    vx, vy, vz, p = camera.ispc_camera(w, h, device=cs.device)
    return render(cs, vx, vy, vz, p, width=w, height=h), 2 * w * h


def make_app() -> TutorialApplication:
    def _build(app):
        return build_scene(Device(app.args.rtcore))

    app = TutorialApplication("hair_geometry", _build, render_frame,
                              default_size=(256, 256))
    app.camera = Camera(from_=(2.5, 2.0, 2.5), to=(0, 0.4, 0), fov=50)
    return app


if __name__ == "__main__":
    raise SystemExit(make_app().run())
