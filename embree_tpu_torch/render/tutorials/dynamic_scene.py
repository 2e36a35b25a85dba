"""dynamic_scene tutorial: animated spheres, a re-commit every frame.

Counterpart of embree_tpu/render/tutorials/dynamic_scene.py, the
re-creation of tutorials/dynamic_scene/dynamic_scene_device.cpp: N
triangulated spheres whose vertices are re-generated each frame
(animateSphere, :165-215 — y displaced by a per-sphere phase), committed
again every frame (the reference alternates the build quality per
sphere at :320-330: REFIT for even ids, a rebuild for odd ones; the
scene keeps the last, and every quality commits the binned SAH), then
eyelight-shaded with per-sphere colors (:219-249). A frame is one
coherent batch of camera rays in image-row order through the packet
kernel B2. The frame counter lives in the state.

    python -m embree_tpu_torch.render.tutorials.dynamic_scene \\
        --size 512 512 -o dyn.ppm --benchmark 1 3       # on the CUDA device
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
from ...scene.scene import BuildQuality, Scene, scene_intersect
from ..camera import Camera
from ..tutorial_app import TutorialApplication

NUM_SPHERES = 8
NUM_PHI = 8
NUM_THETA = 16


def _sphere(pos, r, phase, time):
    """Triangulated sphere with the animated y-wobble (animateSphere,
    dynamic_scene_device.cpp:165-215): (vertices (V, 3) f32, triangles
    (T, 3) i32), the JAX package's arrays byte for byte."""
    phi = np.linspace(0, np.pi, NUM_PHI + 1)
    theta = np.linspace(0, 2 * np.pi, NUM_THETA, endpoint=False)
    P, T = np.meshgrid(phi, theta, indexing="ij")
    x = pos[0] + r * np.sin(P) * np.sin(T)
    y = pos[1] + r * np.cos(P) + 0.5 * r * np.sin(phase + time)
    z = pos[2] + r * np.sin(P) * np.cos(T)
    verts = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
    tris = []
    for i in range(NUM_PHI):
        for j in range(NUM_THETA):
            jn = (j + 1) % NUM_THETA
            a = i * NUM_THETA + j
            b = i * NUM_THETA + jn
            c = (i + 1) * NUM_THETA + j
            d = (i + 1) * NUM_THETA + jn
            if i > 0:
                tris.append((a, b, c))
            if i < NUM_PHI - 1:
                tris.append((b, d, c))
    return verts, np.asarray(tris, np.int32)


def build_scene(time: float = 0.0, device: Device = None):
    """The spheres and the ground plane at `time`, committed; `device`
    is a Device, None means the CUDA device."""
    rng = np.random.default_rng(42)
    dev = device or Device("ignore_config_files=1")
    scene = Scene(dev)
    colors = [np.array([1, 1, 1], np.float32)]
    pos = rng.uniform(-2, 2, (NUM_SPHERES, 3)).astype(np.float32)
    phase = rng.uniform(0, 2 * np.pi, NUM_SPHERES).astype(np.float32)
    for i in range(NUM_SPHERES):
        v, t = _sphere(pos[i], 0.5, phase[i], time)
        scene.attach(TriangleMesh(v, t))
        colors.append(rng.uniform(0.2, 1.0, 3).astype(np.float32))
    # ground plane
    gv = np.asarray([[-10, -3, -10], [10, -3, -10], [10, -3, 10],
                     [-10, -3, 10]], np.float32)
    gt = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    scene.attach(TriangleMesh(gv, gt))
    cs = scene.commit()
    return dict(cscene=cs, scene=scene, pos=pos, phase=phase, frame=0,
                colors=torch.from_numpy(
                    np.stack(colors[1:] + [colors[0]])).to(dev.device))


def animate(state, time: float):
    """Per-frame vertex update + recommit (the reference's per-frame
    rtcCommitScene; even spheres refit-quality, odd rebuild)."""
    scene = state["scene"]
    for i in range(NUM_SPHERES):
        v, _t = _sphere(state["pos"][i], 0.5, state["phase"][i], time)
        scene.geometries[i].vertices = v
        scene.quality = (BuildQuality.REFIT if i % 2 == 0
                         else BuildQuality.MEDIUM)
    state["cscene"] = scene.commit()
    return state


def render(cscene, colors, cam_vx, cam_vy, cam_vz, cam_p,
           *, width: int, height: int):
    """The (height, width, 3) f32 frame: eyelight shading in the
    color of the geometry hit, black where nothing is."""
    dev = cscene.device
    xs = torch.arange(width, dtype=torch.float32, device=dev)
    ys = torch.arange(height, dtype=torch.float32, device=dev)
    y, x = torch.meshgrid(ys, xs, indexing="ij")
    d = normalize(x[..., None] * cam_vx + y[..., None] * cam_vy + cam_vz)
    org = cam_p.broadcast_to(d.shape).contiguous()
    n = d.shape[:-1]
    rays = Rays(org, d.contiguous(),
                torch.zeros(n, dtype=torch.float32, device=dev),
                torch.full(n, math.inf, dtype=torch.float32, device=dev))
    hits = scene_intersect(cscene, rays, coherent=True)
    col = colors[hits.geom_id.clamp(0, colors.shape[0] - 1).long()]
    ns = normalize(hits.ng)
    ns = torch.where((dot(d, ns) < 0)[..., None], ns, -ns)
    shade = dot(-d, ns).clamp(0.0, 1.0)
    img = col * shade[..., None]
    return torch.where(hits.valid[..., None], img, torch.zeros_like(img))


def render_frame(state, camera: Camera, size):
    """Frame k (from 0) renders at time 0.2 k; every frame after the
    first animates and re-commits first."""
    w, h = size
    t = 0.2 * state["frame"]
    state["frame"] += 1
    if state["frame"] > 1:
        state = animate(state, t)
    cs = state["cscene"]
    vx, vy, vz, p = camera.ispc_camera(w, h, device=cs.device)
    img = render(cs, state["colors"], vx, vy, vz, p, width=w, height=h)
    return img, w * h


def make_app() -> TutorialApplication:
    def _build(app):
        return build_scene(device=Device(app.args.rtcore))

    app = TutorialApplication("dynamic_scene", _build, render_frame)
    app.camera = Camera(from_=(0, 4, -7), to=(0, -1, 0))
    return app


if __name__ == "__main__":
    raise SystemExit(make_app().run())
