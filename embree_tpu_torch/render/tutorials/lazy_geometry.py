"""lazy_geometry tutorial: geometry built lazily on first ray contact.

Counterpart of embree_tpu/render/tutorials/lazy_geometry.py, the
re-creation of tutorials/lazy_geometry/lazy_geometry_device.cpp: a grid
of spheres is registered only as bounds (instanceBoundsFunc :49-61); a
sphere's triangle mesh is created and committed the first time a ray
enters its bounds (lazyCreate :120-160, state machine LAZY_INVALID ->
LAZY_CREATE -> LAZY_COMMIT -> LAZY_VALID :29-35).

As in the JAX package, the laziness works a frame at a time, not a ray
at a time: each frame first traces against a user-geometry proxy of the
pending spheres' bounds (an analytic sphere test in torch ops), then
builds on the host the meshes of the spheres any ray touched, recommits
and traces again. Rays never see a proxy in the final image, and
untouched spheres are never tessellated; `state["built"]` counts the
spheres built.

    python -m embree_tpu_torch.render.tutorials.lazy_geometry \\
        --size 512 512 -o lazy.ppm --benchmark 1 3     # on the CUDA device
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
from ...scene.scene import Scene, scene_intersect
from ..camera import Camera, pixel_coords
from ..tutorial_app import TutorialApplication

NUM_SPHERES_X = 5
NUM_SPHERES_Z = 5
RADIUS = 0.8

LAZY_INVALID = 0
LAZY_VALID = 3


def _sphere_mesh(p, r, n_phi=16, n_theta=32):
    phi = np.linspace(0, np.pi, n_phi + 1)
    theta = np.linspace(0, 2 * np.pi, n_theta, endpoint=False)
    P, T = np.meshgrid(phi, theta, indexing="ij")
    v = np.stack([p[0] + r * np.sin(P) * np.sin(T),
                  p[1] + r * np.cos(P),
                  p[2] + r * np.sin(P) * np.cos(T)], -1)
    v = v.reshape(-1, 3).astype(np.float32)
    tris = []
    for i in range(n_phi):
        for j in range(n_theta):
            jn = (j + 1) % n_theta
            a, b = i * n_theta + j, i * n_theta + jn
            c, d = (i + 1) * n_theta + j, (i + 1) * n_theta + jn
            if i > 0:
                tris.append((a, b, c))
            if i < n_phi - 1:
                tris.append((b, d, c))
    return v, np.asarray(tris, np.int32)


def _make_bounds_proxy(centers: np.ndarray, device):
    """UserGeometry callbacks over the pending spheres' bounds: intersect
    is the analytic sphere, a cheap stand-in used only to detect that a
    ray entered a sphere."""
    c_dev = torch.from_numpy(centers).to(device)

    def bounds_fn(ids):
        c = centers[np.asarray(ids)]
        return (c - RADIUS).astype(np.float32), (c + RADIUS).astype(np.float32)

    def intersect_fn(pid, rays, tfar):
        c = c_dev[pid]
        oc = rays.org - c
        b = dot(oc, rays.dir)
        dd = dot(rays.dir, rays.dir)
        disc = b * b - dd * (dot(oc, oc) - RADIUS * RADIUS)
        ok = disc >= 0
        sq = disc.clamp_min(0.0).sqrt()
        t0 = (-b - sq) / dd.clamp_min(1e-20)
        t1 = (-b + sq) / dd.clamp_min(1e-20)
        t = torch.where(t0 > rays.tnear, t0, t1)
        ok = ok & (t > rays.tnear) & (t < tfar)
        pt = rays.org + t[..., None] * rays.dir
        return ok, torch.where(ok, t, tfar), torch.zeros_like(t), \
            torch.zeros_like(t), pt - c

    return bounds_fn, intersect_fn


def build_scene(device=None):
    """`device` is a Device; None means the CUDA device."""
    xs = np.arange(NUM_SPHERES_X) - (NUM_SPHERES_X - 1) / 2.0
    zs = np.arange(NUM_SPHERES_Z) - (NUM_SPHERES_Z - 1) / 2.0
    X, Z = np.meshgrid(xs, zs, indexing="ij")
    centers = np.stack([2.5 * X, np.zeros_like(X), 2.5 * Z],
                       -1).reshape(-1, 3).astype(np.float32)
    state = dict(device=device or Device(), centers=centers,
                 lazy_state=[LAZY_INVALID] * centers.shape[0], built=0)
    _recommit(state)
    return state


def _recommit(state):
    """Rebuild the scene: real meshes for LAZY_VALID spheres, the bounds
    proxy for the rest, plus the ground plane."""
    dev = state["device"]
    scene = Scene(dev)
    centers = state["centers"]
    pending = [i for i, s in enumerate(state["lazy_state"])
               if s != LAZY_VALID]
    for i, s in enumerate(state["lazy_state"]):
        if s == LAZY_VALID:
            v, t = _sphere_mesh(centers[i], RADIUS)
            scene.attach(TriangleMesh(v, t))
    if pending:
        bounds_fn, intersect_fn = _make_bounds_proxy(
            centers[np.asarray(pending)], dev.device)
        proxy_gid = scene.attach(UserGeometry(len(pending), bounds_fn,
                                              intersect_fn))
    else:
        proxy_gid = -1
    gv = np.asarray([[-16, -2, -16], [-16, -2, 16], [16, -2, -16],
                     [16, -2, 16]], np.float32)
    gt = np.asarray([[0, 1, 2], [1, 3, 2]], np.int32)
    scene.attach(TriangleMesh(gv, gt))
    state["cscene"] = scene.commit()
    state["proxy_gid"] = proxy_gid
    state["pending"] = pending
    return state


def _trace(cscene, cam_vx, cam_vy, cam_vz, cam_p, *, width, height):
    dev = cscene.device
    x, y = pixel_coords(width, height, device=dev)
    d = normalize(x[..., None] * cam_vx + y[..., None] * cam_vy + cam_vz)
    org = cam_p.broadcast_to(d.shape).contiguous()
    n = d.shape[:-1]
    rays = Rays(org, d, torch.zeros(n, dtype=torch.float32, device=dev),
                torch.full(n, math.inf, dtype=torch.float32, device=dev))
    return d, scene_intersect(cscene, rays, coherent=True)


def render_frame(state, camera: Camera, size):
    w, h = size
    vx, vy, vz, p = camera.ispc_camera(w, h, device=state["cscene"].device)
    d, hits = _trace(state["cscene"], vx, vy, vz, p, width=w, height=h)

    # lazyCreate: any proxy hit promotes that sphere to LAZY_VALID (one
    # host sync a frame while spheres are pending)
    if state["proxy_gid"] >= 0:
        proxy_hits = hits.geom_id == state["proxy_gid"]
        touched = torch.unique(hits.prim_id[proxy_hits]).tolist()
        if touched:
            for k in touched:
                state["lazy_state"][state["pending"][int(k)]] = LAZY_VALID
                state["built"] += 1
            _recommit(state)
            d, hits = _trace(state["cscene"], vx, vy, vz, p, width=w,
                             height=h)

    ns = normalize(hits.ng)
    ns = torch.where((dot(d, ns) < 0)[..., None], ns, -ns)
    shade = 0.2 + 0.8 * dot(-d, ns).clamp(0.0, 1.0)
    col = torch.tensor([0.8, 0.8, 0.9], dtype=torch.float32, device=d.device)
    img = torch.where(hits.valid[..., None], col * shade[..., None], 0.0)
    return img.reshape(h, w, 3), w * h


def make_app() -> TutorialApplication:
    def _build(app):
        return build_scene(Device(app.args.rtcore))

    app = TutorialApplication("lazy_geometry", _build, render_frame)
    app.camera = Camera(from_=(6, 6, -10), to=(0, 0, 0))
    return app


if __name__ == "__main__":
    raise SystemExit(make_app().run())
