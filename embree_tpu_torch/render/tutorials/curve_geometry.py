"""curve_geometry tutorial: a round B-spline hair loop over a ground plane.

Counterpart of embree_tpu/render/tutorials/curve_geometry.py, the
re-creation of tutorials/curve_geometry/curve_geometry_device.cpp: one
closed loop of 6 cubic B-spline curves sharing a 9-point control polygon
with varying radius (hair_vertices :31-45), per-control-point colors
(hair_vertex_colors :47-59) interpolated along the curve with the curve's
own basis, eyelight-shaded (0.2 + 0.8 * |n.d|) above a triangulated
ground plane (:78-101). A frame is one coherent batch of camera rays: the
plane through kernel B2, the loop (tessellation rate 16) through kernel
B3's cone leaves.

    python -m embree_tpu_torch.render.tutorials.curve_geometry \\
        --size 512 512 -o curve.ppm --benchmark 1 3      # on the CUDA device
    ... -rtcore device=cpu                               # on the CPU
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...core.device import Device
from ...core.math import dot, normalize
from ...core.rayhit import Rays
from ...scene.curves import BSplineCurves
from ...scene.geometry import TriangleMesh
from ...scene.scene import CommittedScene, Scene, scene_intersect
from ..camera import Camera, pixel_coords
from ..tutorial_app import TutorialApplication

W = 2.0
HAIR_VERTICES = np.asarray([
    [-1, 0, -W, 0.2],
    [0, -1, 0, 0.2], [1, 0, W, 0.2], [-1, 0, W, 0.2],
    [0, 1, 0, 0.6], [1, 0, -W, 0.2], [-1, 0, -W, 0.2],
    [0, -1, 0, 0.2], [1, 0, W, 0.2]], np.float32)
HAIR_COLORS = np.asarray([
    [1, 1, 0],
    [1, 0, 0], [1, 1, 0], [0, 0, 1],
    [1, 1, 1], [1, 0, 0], [1, 1, 0],
    [1, 0, 0], [1, 1, 0]], np.float32)
HAIR_INDICES = np.arange(6, dtype=np.int32)


def build_scene(device=None):
    """`device` is a Device; None means the CUDA device."""
    scene = Scene(device or Device())
    gv = np.asarray([[-10, -2, -10], [-10, -2, 10], [10, -2, -10],
                     [10, -2, 10]], np.float32)
    gt = np.asarray([[0, 1, 2], [1, 3, 2]], np.int32)
    gid_plane = scene.attach(TriangleMesh(gv, gt))
    gid_curve = scene.attach(BSplineCurves(HAIR_VERTICES, HAIR_INDICES,
                                           tessellation_rate=16))
    cs = scene.commit()
    return dict(cscene=cs, gid_curve=gid_curve, gid_plane=gid_plane,
                colors=torch.from_numpy(HAIR_COLORS).to(cs.device))


def _curve_color(colors, u, prim):
    """Control-point colors interpolated with the curve's own uniform
    B-spline basis (the demo's vertex-attribute interpolation)."""
    t = u.clamp(0.0, 1.0)
    i = prim.clamp(0, 5).long()
    t2, t3 = t * t, t * t * t
    n0 = (1 - 3 * t + 3 * t2 - t3) / 6.0
    n1 = (4 - 6 * t2 + 3 * t3) / 6.0
    n2 = (1 + 3 * t + 3 * t2 - 3 * t3) / 6.0
    n3 = t3 / 6.0
    return (n0[..., None] * colors[i] + n1[..., None] * colors[i + 1]
            + n2[..., None] * colors[i + 2] + n3[..., None] * colors[i + 3])


def render(cscene: CommittedScene, colors, cam_vx, cam_vy, cam_vz, cam_p, *,
           width: int, height: int, gid_curve: int):
    """One frame, (H, W, 3) f32 on the scene's device."""
    dev = cscene.device
    x, y = pixel_coords(width, height, device=dev)
    d = normalize(x[..., None] * cam_vx + y[..., None] * cam_vy + cam_vz)
    org = cam_p.broadcast_to(d.shape).contiguous()
    n = d.shape[:-1]
    rays = Rays(org, d, torch.zeros(n, dtype=torch.float32, device=dev),
                torch.full(n, math.inf, dtype=torch.float32, device=dev))
    hits = scene_intersect(cscene, rays, coherent=True)
    col = torch.where((hits.geom_id == gid_curve)[..., None],
                      _curve_color(colors, hits.u, hits.prim_id),
                      torch.tensor([0.7, 0.7, 0.7], device=dev))
    ns = normalize(hits.ng)
    ns = torch.where((dot(d, ns) < 0)[..., None], ns, -ns)
    shade = 0.2 + 0.8 * dot(-d, ns).clamp(0.0, 1.0)
    img = torch.where(hits.valid[..., None], col * shade[..., None], 0.0)
    return img.reshape(height, width, 3)


def render_frame(state, camera: Camera, size):
    w, h = size
    cs = state["cscene"]
    vx, vy, vz, p = camera.ispc_camera(w, h, device=cs.device)
    img = render(cs, state["colors"], vx, vy, vz, p, width=w, height=h,
                 gid_curve=state["gid_curve"])
    return img, w * h


def make_app() -> TutorialApplication:
    def _build(app):
        return build_scene(Device(app.args.rtcore))

    app = TutorialApplication("curve_geometry", _build, render_frame)
    app.camera = Camera(from_=(2, 2.5, -6), to=(0, 0, 0))
    return app


if __name__ == "__main__":
    raise SystemExit(make_app().run())
