"""intersection_filter tutorial: procedural transparency via filters.

Counterpart of embree_tpu/render/tutorials/intersection_filter.py, the
re-creation of tutorials/intersection_filter/intersection_filter_device.cpp:
a cube whose hits are accepted or rejected by an intersection filter
implementing 3D procedural transparency (transparencyFunction :60-66 —
T = clamp(sin(4x)*cos(4y)*sin(4z) scaled), reject when T >= 0.5 so the
ray continues through), over a ground plane; the accepted hit is shaded
by its residual opacity. The filter is a torch function on the whole
batch; the scene answers it with the restart wavefront
(scene/scene.py::_intersect_filter_restart): every round one packet
kernel launch for the undecided rays.

    python -m embree_tpu_torch.render.tutorials.intersection_filter \\
        --size 512 512 -o filter.ppm --benchmark 1 3   # on the CUDA device
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
from ...scene.scene import CommittedScene, Scene, scene_intersect
from ..camera import Camera, pixel_coords
from ..tutorial_app import TutorialApplication

CUBE_V = np.asarray([
    [-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
    [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]], np.float32)
CUBE_T = np.asarray([
    [0, 1, 2], [0, 2, 3], [5, 4, 7], [5, 7, 6],
    [4, 0, 3], [4, 3, 7], [1, 5, 6], [1, 6, 2],
    [3, 2, 6], [3, 6, 7], [4, 5, 1], [4, 1, 0]], np.int32)
COLORS = np.asarray([[0.9, 0.2, 0.2], [0.6, 0.6, 0.6]], np.float32)


def transparency(p):
    """3D procedural transparency (intersection_filter_device.cpp:60-66)."""
    v = torch.sin(4.0 * p[..., 0]) * torch.cos(4.0 * p[..., 1]) \
        * torch.sin(4.0 * p[..., 2])
    return (0.5 * (v + 1.0)).clamp(0.0, 1.0)


def make_filter():
    def filter_fn(org, direction, t, u, v, ng, geom_id, prim_id):
        # the cube is geometry 0; the ground (geometry 1) is opaque
        p = org + t[..., None] * direction
        # accept only sufficiently opaque hits; transparent lanes keep
        # traversing — the reference's RTC_FILTER_* reject path
        return (geom_id != 0) | (transparency(p) < 0.5)
    return filter_fn


def build_scene(device=None):
    """`device` is a Device; None means the CUDA device."""
    scene = Scene(device or Device())
    scene.attach(TriangleMesh(CUBE_V, CUBE_T))
    gv = np.asarray([[-10, -2, -10], [10, -2, -10], [10, -2, 10],
                     [-10, -2, 10]], np.float32)
    scene.attach(TriangleMesh(gv, np.asarray([[0, 1, 2], [0, 2, 3]],
                                             np.int32)))
    scene.set_intersection_filter(make_filter())
    cs = scene.commit()
    return dict(cscene=cs, scene=scene, filter_fn=scene.intersection_filter,
                colors=torch.from_numpy(COLORS).to(cs.device))


def render(cscene: CommittedScene, colors, cam_vx, cam_vy, cam_vz, cam_p,
           *, filter_fn, width: int, height: int):
    """One frame, (H, W, 3) f32 on the scene's device."""
    dev = cscene.device
    x, y = pixel_coords(width, height, device=dev)
    d = normalize(x[..., None] * cam_vx + y[..., None] * cam_vy + cam_vz)
    org = cam_p.broadcast_to(d.shape).contiguous()
    n = d.shape[:-1]
    rays = Rays(org, d, torch.zeros(n, dtype=torch.float32, device=dev),
                torch.full(n, math.inf, dtype=torch.float32, device=dev))
    hits = scene_intersect(cscene, rays, filter_fn=filter_fn)
    col = colors[hits.geom_id.clamp(0, 1).long()]
    ns = normalize(hits.ng)
    ns = torch.where((dot(d, ns) < 0)[..., None], ns, -ns)
    # the surviving (accepted) hit shaded by its residual opacity
    pt = org + hits.t[..., None] * d
    opacity = torch.where(hits.geom_id == 0, 1.0 - transparency(pt), 1.0)
    shade = dot(-d, ns).clamp(0.0, 1.0) * opacity
    img = torch.where(hits.valid[..., None], col * shade[..., None], 0.0)
    return img.reshape(height, width, 3)


def render_frame(state, camera: Camera, size):
    w, h = size
    cs = state["cscene"]
    vx, vy, vz, p = camera.ispc_camera(w, h, device=cs.device)
    img = render(cs, state["colors"], vx, vy, vz, p,
                 filter_fn=state["filter_fn"], width=w, height=h)
    return img, w * h


def make_app() -> TutorialApplication:
    def _build(app):
        return build_scene(Device(app.args.rtcore))

    app = TutorialApplication("intersection_filter", _build, render_frame)
    app.camera = Camera(from_=(2, 2, -4), to=(0, 0, 0))
    return app


if __name__ == "__main__":
    raise SystemExit(make_app().run())
