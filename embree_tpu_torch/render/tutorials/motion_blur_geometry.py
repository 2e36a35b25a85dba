"""motion_blur_geometry tutorial: moving cubes and a sphere, one random
time a pixel, averaged over frames.

Counterpart of embree_tpu/render/tutorials/motion_blur_geometry.py, the
re-creation of tutorials/motion_blur_geometry/
motion_blur_geometry_device.cpp: a triangle cube and a quad cube (as
triangles) each turning a quarter around y between two timesteps
(addTriangleCube :98-135, addQuadCube), a sphere translating by (0, 2, 0)
(the reference's moving instances), a static ground plane, one random
ray time a pixel a frame (renderPixelStandard :520-560), and frames
averaged into an accumulation buffer (g_accu :590-620). Shading: the
geometry's color times 0.2 + 0.8 * |n.l| with the light at the eye.

A frame is one batch of camera rays: the plane through the packet
kernel, the moving meshes through the motion-blur kernel at each ray's
time. The times come from a `torch.Generator` seeded with the number of
frames accumulated so far; `render` takes them as a tensor, so a caller
can give it any times.

    python -m embree_tpu_torch.render.tutorials.motion_blur_geometry \\
        --size 512 512 -o mb.ppm --benchmark 1 3        # on the CUDA device
    ... -rtcore device=cpu                               # on the CPU
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...core.device import Device
from ...core.math import dot, normalize
from ...core.rayhit import Rays
from ...scene.geometry import TriangleMesh, TriangleMeshMB
from ...scene.scene import CommittedScene, Scene, scene_intersect
from ..camera import Camera, pixel_coords
from ..tutorial_app import TutorialApplication

CUBE_V = np.asarray([
    [-1, -1, -1], [1, -1, -1], [1, -1, 1], [-1, -1, 1],
    [-1, 1, -1], [1, 1, -1], [1, 1, 1], [-1, 1, 1]], np.float32)
CUBE_T = np.asarray([
    [1, 4, 5], [0, 4, 1], [2, 5, 6], [1, 5, 2], [3, 6, 7], [2, 6, 3],
    [4, 3, 7], [0, 3, 4], [5, 7, 6], [4, 7, 5], [3, 1, 2], [0, 1, 3]],
    np.int32)
CUBE_Q = np.asarray([
    [0, 4, 5, 1], [1, 5, 6, 2], [2, 6, 7, 3],
    [0, 3, 7, 4], [4, 7, 6, 5], [0, 1, 2, 3]], np.int32)
COLORS = np.asarray([[1.0, 0.3, 0.3], [0.3, 1.0, 0.3], [0.3, 0.3, 1.0],
                     [0.8, 0.8, 0.8]], np.float32)


def _rot_y(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.asarray([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def _cube_verts(pos, angle):
    scale = np.diag([2.0, 1.0, 1.0]).astype(np.float32)
    return CUBE_V @ ((_rot_y(angle) @ scale).T) + np.asarray(pos, np.float32)


def _quads_to_tris(q):
    return np.concatenate([q[:, [0, 1, 3]], q[:, [1, 2, 3]]]).astype(np.int32)


def _sphere(pos, r, n=16):
    phi = np.linspace(0, np.pi, n + 1)
    theta = np.linspace(0, 2 * np.pi, 2 * n, endpoint=False)
    P, T = np.meshgrid(phi, theta, indexing="ij")
    v = np.stack([pos[0] + r * np.sin(P) * np.sin(T),
                  pos[1] + r * np.cos(P),
                  pos[2] + r * np.sin(P) * np.cos(T)], -1)
    v = v.reshape(-1, 3).astype(np.float32)
    tris = []
    for i in range(n):
        for j in range(2 * n):
            jn = (j + 1) % (2 * n)
            a, b = i * 2 * n + j, i * 2 * n + jn
            c, d = (i + 1) * 2 * n + j, (i + 1) * 2 * n + jn
            if i > 0:
                tris.append((a, b, c))
            if i < n - 1:
                tris.append((b, d, c))
    return v, np.asarray(tris, np.int32)


def build_scene(device=None):
    """`device` is a Device; None means the CUDA device."""
    dev = device or Device()
    scene = Scene(dev)
    # turning triangle cube (the timestep pair spans a quarter turn)
    scene.attach(TriangleMeshMB(_cube_verts((-5, 1, 0), 0.0),
                                _cube_verts((-5, 1, 0), 0.5 * np.pi),
                                CUBE_T))
    # turning quad cube, split into triangles
    scene.attach(TriangleMeshMB(_cube_verts((0, 1, 0), 0.0),
                                _cube_verts((0, 1, 0), 0.5 * np.pi),
                                _quads_to_tris(CUBE_Q)))
    # linearly translating sphere
    sv, st = _sphere((5, 1, 0), 1.0)
    scene.attach(TriangleMeshMB(sv, sv + np.asarray([0, 2, 0], np.float32),
                                st))
    # static ground plane
    gv = np.asarray([[-15, 0, -15], [15, 0, -15], [15, 0, 15],
                     [-15, 0, 15]], np.float32)
    scene.attach(TriangleMesh(gv, np.asarray([[0, 1, 2], [0, 2, 3]],
                                             np.int32)))
    cs = scene.commit()
    return dict(cscene=cs, accu=None, frame=0,
                colors=torch.from_numpy(COLORS).to(cs.device))


def render(cscene: CommittedScene, colors, times, cam_vx, cam_vy, cam_vz,
           cam_p, *, width: int, height: int):
    """One frame, (H, W, 3) f32 on the scene's device; `times` holds one
    time in [0, 1] a pixel, H * W values in image-row order."""
    dev = cscene.device
    x, y = pixel_coords(width, height, device=dev)
    d = normalize(x[..., None] * cam_vx + y[..., None] * cam_vy + cam_vz)
    org = cam_p.broadcast_to(d.shape).contiguous()
    n = d.shape[:-1]
    rays = Rays(org, d, torch.zeros(n, dtype=torch.float32, device=dev),
                torch.full(n, math.inf, dtype=torch.float32, device=dev))
    hits = scene_intersect(cscene, rays, time=times, coherent=True)
    ns = normalize(hits.ng)
    ns = torch.where((dot(d, ns) < 0)[..., None], ns, -ns)
    shade = 0.2 + 0.8 * dot(-d, ns).clamp(0.0, 1.0)
    col = colors[hits.geom_id.clamp(0, 3).long()]
    img = torch.where(hits.valid[..., None], col * shade[..., None], 0.0)
    return img.reshape(height, width, 3)


def frame_times(frame: int, width: int, height: int, device):
    """One uniform time a pixel from a generator seeded with `frame`."""
    g = torch.Generator(device=device)
    g.manual_seed(frame)
    return torch.rand(width * height, generator=g, device=device)


def render_frame(state, camera: Camera, size):
    w, h = size
    cs = state["cscene"]
    vx, vy, vz, p = camera.ispc_camera(w, h, device=cs.device)
    times = frame_times(state["frame"], w, h, cs.device)
    img = render(cs, state["colors"], times, vx, vy, vz, p, width=w,
                 height=h)
    # accumulation buffer (g_accu)
    if state["accu"] is None or state["accu"].shape != img.shape:
        state["accu"] = img
        state["frame"] = 1
    else:
        k = state["frame"]
        state["accu"] = (state["accu"] * k + img) / (k + 1)
        state["frame"] = k + 1
    return state["accu"], w * h


def make_app() -> TutorialApplication:
    def _build(app):
        return build_scene(Device(app.args.rtcore))

    app = TutorialApplication("motion_blur_geometry", _build, render_frame)
    app.camera = Camera(from_=(0, 8, -14), to=(0, 1, 0))
    return app


if __name__ == "__main__":
    raise SystemExit(make_app().run())
