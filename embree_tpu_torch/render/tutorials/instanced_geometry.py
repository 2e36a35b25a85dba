"""instanced_geometry tutorial: one sphere scene instanced 4x.

Counterpart of embree_tpu/render/tutorials/instanced_geometry.py, the
re-creation of tutorials/instanced_geometry/instanced_geometry_device.cpp:
a child scene with a triangulated sphere, four RTC_GEOMETRY_TYPE_INSTANCE
placements orbiting the origin (instance_xfm updates, :195-215), a
ground plane in the top scene, instance-id-based coloring
(g_instance_colors, :230-260) with eyelight shading. A frame is one
coherent batch: the ground plane through the packet kernel, then each
instance's rays through the child's packet kernel.

    python -m embree_tpu_torch.render.tutorials.instanced_geometry \\
        --size 512 512 -o inst.ppm --benchmark 1 3     # on the CUDA device
    ... -rtcore device=cpu                               # on the CPU
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...core.device import Device
from ...core.math import dot, normalize
from ...core.rayhit import Rays
from ...scene.geometry import Instance, TriangleMesh
from ...scene.scene import CommittedScene, Scene, scene_intersect
from ..camera import Camera, pixel_coords
from ..tutorial_app import TutorialApplication
from .dynamic_scene import _sphere

COLORS = np.asarray([[0.85, 0.0, 0.0], [0.0, 0.85, 0.0], [0.0, 0.0, 0.85],
                     [0.85, 0.85, 0.0], [0.7, 0.7, 0.7]], np.float32)


def _orbit_xfm(k: int, time: float) -> np.ndarray:
    a = time + k * np.pi / 2
    t = np.zeros((3, 4), np.float32)
    t[:, :3] = np.eye(3)
    t[:, 3] = (2.5 * np.cos(a), 0.0, 2.5 * np.sin(a))
    return t


def build_scene(device=None, time: float = 0.0):
    """`device` is a Device; None means the CUDA device."""
    dev = device or Device()
    child = Scene(dev)
    v, tris = _sphere((0.0, 0.0, 0.0), 1.0, 0.0, 0.0)
    child.attach(TriangleMesh(v, tris))
    child.commit()

    scene = Scene(dev)
    for k in range(4):
        scene.attach(Instance(child, _orbit_xfm(k, time)))
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
    # color by instance id (instanced_geometry_device.cpp:246); the
    # ground hits carry inst_id == -1 -> last color
    cidx = torch.where(hits.inst_id >= 0, hits.inst_id.clamp(0, 3), 4)
    col = colors[cidx.long()]
    ns = normalize(hits.ng)
    ns = torch.where((dot(d, ns) < 0)[..., None], ns, -ns)
    shade = dot(-d, ns).clamp(0.0, 1.0)
    img = torch.where(hits.valid[..., None], col * shade[..., None], 0.0)
    return img.reshape(height, width, 3)


def render_frame(state, camera: Camera, size):
    w, h = size
    cs = state["cscene"]
    vx, vy, vz, p = camera.ispc_camera(w, h, device=cs.device)
    return render(cs, state["colors"], vx, vy, vz, p, width=w,
                  height=h), w * h


def make_app() -> TutorialApplication:
    def _build(app):
        return build_scene(Device(app.args.rtcore))

    app = TutorialApplication("instanced_geometry", _build, render_frame)
    app.camera = Camera(from_=(0, 5, -8), to=(0, 0, 0))
    return app


if __name__ == "__main__":
    raise SystemExit(make_app().run())
