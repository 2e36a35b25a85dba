"""displacement_geometry tutorial: displaced subdiv cube + ground plane.

Counterpart of embree_tpu/render/tutorials/displacement_geometry.py, the
re-creation of tutorials/displacement_geometry/
displacement_geometry_device.cpp: ground plane (geom 0, diffuse
(0.8,0,0)) + 6-quad subdiv cube (geom 1, diffuse (0.9,0.6,0.5)) with
procedural fBm noise displacement along the geometric normal (:88-125),
SUBDIVISION_LEVEL=6 / COMPRESSED_LEVELS=4 via rtcSetSceneLevels (:144,
`Scene.set_levels`), shading identical to the triangle tutorial
(0.5*diffuse ambient + n.l with shadow ray). The compressed accel mode
is selected by the --compress.* CLI flags (the `subdiv_accel` config);
without one the cube is tessellated eagerly into triangles.

    python -m embree_tpu_torch.render.tutorials.displacement_geometry \\
        --compress.leaf --size 512 512 -o displ.ppm --benchmark 1 3
    ... -rtcore device=cpu                               # on the CPU

A frame is two coherent batches (primary rays, shadow rays): the plane
goes through the packet kernel, the cube through the compressed-tile
kernels, and the shading is tensor ops.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...core.device import Device
from ...core.math import dot, normalize
from ...core.rayhit import Rays
from ...scene.geometry import SubdivMesh, TriangleMesh
from ...scene.scene import CommittedScene, Scene, scene_intersect, scene_occluded
from ..camera import Camera, pixel_coords, pixel_morton_order_device
from ..noise import fbm_displacement
from ..tutorial_app import TutorialApplication

SUBDIVISION_LEVEL = 6
COMPRESSED_LEVELS = 4

CUBE_VERTICES = np.array([
    [-1, -1, -1], [1, -1, -1], [1, -1, 1], [-1, -1, 1],
    [-1, 1, -1], [1, 1, -1], [1, 1, 1], [-1, 1, 1]], np.float32)
CUBE_INDICES = np.array([
    0, 4, 5, 1,
    1, 5, 6, 2,
    2, 6, 7, 3,
    0, 3, 7, 4,
    4, 7, 6, 5,
    0, 1, 2, 3], np.int32)
CUBE_FACES = np.full(6, 4, np.int32)

PLANE_VERTICES = np.array([
    [-10, -2, -10], [-10, -2, 10], [10, -2, -10], [10, -2, 10]], np.float32)
PLANE_INDICES = np.array([[0, 1, 2], [1, 3, 2]], np.int32)


def displacement(p, ng, u, v):
    """displacementFunction (:111-125): P += displacement(P) * Ng."""
    dn = fbm_displacement(np.asarray(p, np.float32))
    return np.asarray(p) + dn[..., None] * np.asarray(ng)


def build_scene(subdiv_mode=None, subdiv_level=SUBDIVISION_LEVEL,
                comp_level=COMPRESSED_LEVELS, rtcore: str = ""):
    """`subdiv_mode` is a `subdiv_accel` value such as
    "bvh4.compressed.leaf" or None (eager tessellation); `rtcore` is
    appended to the Device config string (`device=cpu` runs on the CPU)."""
    cfg = "ignore_config_files=1"
    if subdiv_mode:
        cfg += f",subdiv_accel={subdiv_mode}"
    if rtcore:
        cfg += f",{rtcore}"
    dev = Device(cfg)
    scene = Scene(dev)
    scene.attach(TriangleMesh(PLANE_VERTICES, PLANE_INDICES))  # geom 0
    scene.attach(SubdivMesh(CUBE_VERTICES, CUBE_FACES, CUBE_INDICES,
                            displacement=displacement))        # geom 1
    scene.set_levels(subdiv_level, comp_level)
    cs = scene.commit()
    return dict(cscene=cs, scene=scene)


def trace(cscene: CommittedScene, cam_vx, cam_vy, cam_vz, cam_p,
          perm=None, inv=None, *, width: int, height: int):
    """Primary + shadow trace; returns flat image-row-ordered hit fields
    (valid, occluded, geom_id, prim_id, u, v, ng, ray direction)."""
    dev = cscene.device
    x, y = pixel_coords(width, height, perm, device=dev)
    d = normalize(x[..., None] * cam_vx + y[..., None] * cam_vy + cam_vz)
    org = cam_p.broadcast_to(d.shape).contiguous()
    n = d.shape[:-1]
    rays = Rays(org, d, torch.zeros(n, dtype=torch.float32, device=dev),
                torch.full(n, math.inf, dtype=torch.float32, device=dev))
    hits = scene_intersect(cscene, rays, coherent=True)

    light_dir = normalize(torch.tensor([-1.0, -1.0, -1.0], device=dev))
    # a primary ray that missed sends a retired shadow ray (from the
    # camera, tfar -inf) in place of one from an infinite origin, whose
    # NaN slab tests would enter every node; its answer is not read
    t = torch.where(hits.valid, hits.t, 0.0)
    hit_p = org + t[..., None] * d
    shadow = Rays(hit_p, (-light_dir).broadcast_to(d.shape).contiguous(),
                  torch.full(n, 1e-3, dtype=torch.float32, device=dev),
                  torch.where(hits.valid, math.inf, -math.inf))
    occ = scene_occluded(cscene, shadow, coherent=True)
    out = (hits.valid, occ, hits.geom_id, hits.prim_id, hits.u, hits.v,
           hits.ng, d)
    if inv is not None:
        out = tuple(a[inv] for a in out)
    return out


def _shade(valid, occ, geom_id, ng, d, width, height):
    """0.5*diffuse ambient + shadowed n.l (:226-240); `ng` arrives
    normalized."""
    dev = d.device
    diffuse = torch.where((geom_id != 0)[..., None],
                          torch.tensor([0.9, 0.6, 0.5], device=dev),
                          torch.tensor([0.8, 0.0, 0.0], device=dev))
    zero = torch.zeros_like(diffuse)
    color = torch.where(valid[..., None], 0.5 * diffuse, zero)
    light_dir = normalize(torch.tensor([-1.0, -1.0, -1.0], device=dev))
    ndotl = (-dot(light_dir.broadcast_to(d.shape), ng)).clamp(0.0, 1.0)
    color = color + torch.where((valid & ~occ)[..., None],
                                diffuse * ndotl[..., None], zero)
    return color.reshape(height, width, 3)


def render(cscene: CommittedScene, cam_vx, cam_vy, cam_vz, cam_p,
           perm=None, inv=None, *, width: int, height: int):
    """The (H, W, 3) f32 framebuffer on the scene's device."""
    valid, occ, geom_id, _prim, _u, _v, ng, d = trace(
        cscene, cam_vx, cam_vy, cam_vz, cam_p, perm, inv,
        width=width, height=height)
    # compressed hits carry the dummy Ng (1,0,0): face the ray there (the
    # tutorial uses raw Ng; grid/eager modes have true normals)
    ngn = normalize(ng)
    dummy = (ng[..., 0] == 1.0) & (ng[..., 1] == 0.0) & (ng[..., 2] == 0.0)
    ngn = torch.where(dummy[..., None], -d, ngn)
    return _shade(valid, occ, geom_id, ngn, d, width, height)


def render_frame(state, camera: Camera, size):
    w, h = size
    cs = state["cscene"]
    vx, vy, vz, p = camera.ispc_camera(w, h, device=cs.device)
    perm, inv = pixel_morton_order_device(w, h, cs.device)
    img = render(cs, vx, vy, vz, p, perm, inv, width=w, height=h)
    return img, 2 * w * h


def make_app() -> TutorialApplication:
    def _build(app):
        # the device hardcodes SUBDIVISION_LEVEL/COMPRESSED_LEVELS via
        # rtcSetSceneLevels (:144); only the accel mode comes from the CLI
        return build_scene(app.args.subdiv_mode, rtcore=app.args.rtcore)

    app = TutorialApplication("displacement_geometry", _build, render_frame)
    app.camera = Camera(from_=(2.5, 2.5, 2.5), to=(0, 0, 0))
    return app


if __name__ == "__main__":
    raise SystemExit(make_app().run())
