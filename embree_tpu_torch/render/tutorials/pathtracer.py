"""pathtracer tutorial: wavefront Monte Carlo path tracer.

Counterpart of embree_tpu/render/tutorials/pathtracer.py, the
re-design of tutorials/pathtracer/pathtracer_device.cpp
(renderPixelFunction :1442-1546) as a wavefront integrator: every pixel
of a sample advances through the bounce loop together, each bounce is
one batched closest-hit request plus one batched shadow (any-hit)
request a light. Semantics kept:

  * path length <= MAX_PATH_LENGTH = 8            (:41, :1457)
  * environment/ambient gathered on miss          (:1476-1484)
  * per-light sample + occluded shadow ray        (:1520-1533)
  * per-ray Medium tracking of solid dielectrics  (:57-81) and the
    segment attenuation by the medium crossed     (:1503-1506)
  * throughput update Lw *= c/pdf and the Lw < 0.01 cutoff (:1459-1536)
  * face-forwarded geometric-normal shading, the camera bounce flagged
    coherent (:1467), pixels in Morton order.

The wavefront is eager torch ops on the scene's device. A lane that is
retired (missed, or cut off) leaves the wavefront: each request carries
only the live rays, gathered with one `nonzero` a step, and each shadow
request only the rays that face their light. So the requests of a large
scene go to the treelet kernel B1 while at least ROWTRACE_MIN_RAYS rays
are live, to the packet kernel B2 otherwise (the camera bounce always).
The JAX package keeps every lane and masks retired ones; the answers on
live lanes are the same, and the gather also keeps the NaN of a missed
lane's t out of autograd (the JAX package's `t_safe` / `ng_raw`).

Randomness comes from a sampler (`TorchSampler` by default: a
`torch.Generator` seeded with `seed` on the render device) with three
methods that return uniforms in [0, 1) for all n = width * height lanes
of a sample, in the traced (Morton) pixel order: `pixel(s)` (n, 2),
`light(s, bounce, li)` (n, 2) (read for quad lights only) and
`bsdf(s, bounce)` (n, 3). Two renders with the same sampler trace the
same paths.

With no scene on the command line the reference loads an empty scene;
the tutorial renders the classic procedural Cornell box instead:

    python -m embree_tpu_torch.render.tutorials.pathtracer \\
        --size 256 256 -o pt.ppm --benchmark 1 3        # on the CUDA device
    ... -rtcore device=cpu                               # on the CPU
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...core.device import Device
from ...core.math import dot, length, normalize
from ...core.rayhit import Rays
from ...scene.geometry import QuadMesh
from ...scene.scene import Scene, scene_intersect, scene_occluded
from ..camera import Camera, pixel_coords, pixel_morton_order_device
from ..lights import LIGHT_QUAD, LightTable, make_light_table, sample_light
from ..materials import (MAT_MATTE, MAT_MIRROR, MaterialTable,
                         eval_brdf, make_material_table, sample_bsdf_medium,
                         table_rows)
from ..tutorial_app import TutorialApplication
from ..xmlloader import light_table_from_xml

MAX_PATH_LENGTH = 8


class TorchSampler:
    """The default sampler: uniforms from a `torch.Generator` seeded with
    `seed` on `device`, drawn in the order the renderer asks for them."""

    def __init__(self, seed: int, n: int, device):
        self.n = n
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))

    def _draw(self, k: int):
        return torch.rand((self.n, k), generator=self.gen,
                          device=self.device)

    def pixel(self, s: int):
        return self._draw(2)

    def light(self, s: int, bounce: int, li: int):
        return self._draw(2)

    def bsdf(self, s: int, bounce: int):
        return self._draw(3)


def _quad(p0, du, dv):
    p0 = np.asarray(p0, np.float32)
    du = np.asarray(du, np.float32)
    dv = np.asarray(dv, np.float32)
    verts = np.stack([p0, p0 + du, p0 + du + dv, p0 + dv])
    return verts, np.array([[0, 1, 2, 3]], np.int32)


def _state(dev: Device, scene: Scene, geom_mat, mats, lights):
    d = dev.device
    return dict(cscene=scene.commit(), scene=scene,
                materials=make_material_table(mats, device=d),
                lights=lights,
                geom_mat=torch.from_numpy(
                    np.asarray(geom_mat, np.int32)).to(d))


def build_cornell_scene(device: Device = None):
    """The Cornell box (17 quads in 7 geometries: five walls, a matte
    short box and a mirror tall box) under one quad light. `device` is a
    Device; None means the CUDA device."""
    dev = device or Device("ignore_config_files=1")
    scene = Scene(dev)
    mats = []
    geom_mat = []

    def add(v, q, mat):
        gid = scene.attach(QuadMesh(v, q))
        while len(geom_mat) <= gid:
            geom_mat.append(0)
        geom_mat[gid] = len(mats)
        mats.append(mat)

    white = {"type": MAT_MATTE, "kd": (0.75, 0.75, 0.75)}
    red = {"type": MAT_MATTE, "kd": (0.63, 0.065, 0.05)}
    green = {"type": MAT_MATTE, "kd": (0.14, 0.45, 0.091)}
    mirror = {"type": MAT_MIRROR, "ks": (0.9, 0.9, 0.9)}

    # box [0,1]^3, open towards +z camera
    add(*_quad((0, 0, 0), (1, 0, 0), (0, 0, 1)), dict(white))    # floor
    add(*_quad((0, 1, 0), (0, 0, 1), (1, 0, 0)), dict(white))    # ceiling
    add(*_quad((0, 0, 0), (0, 1, 0), (1, 0, 0)), dict(white))    # back
    add(*_quad((0, 0, 0), (0, 0, 1), (0, 1, 0)), dict(red))      # left
    add(*_quad((1, 0, 0), (0, 1, 0), (0, 0, 1)), dict(green))    # right

    # short box (matte) and tall box (mirror)
    def box(lo, hi):
        lo = np.asarray(lo, np.float32)
        hi = np.asarray(hi, np.float32)
        v = np.array([
            [lo[0], lo[1], lo[2]], [hi[0], lo[1], lo[2]],
            [hi[0], lo[1], hi[2]], [lo[0], lo[1], hi[2]],
            [lo[0], hi[1], lo[2]], [hi[0], hi[1], lo[2]],
            [hi[0], hi[1], hi[2]], [lo[0], hi[1], hi[2]]], np.float32)
        q = np.array([[3, 2, 1, 0], [4, 5, 6, 7], [0, 1, 5, 4],
                      [1, 2, 6, 5], [2, 3, 7, 6], [3, 0, 4, 7]], np.int32)
        return v, q

    add(*box((0.55, 0.0, 0.55), (0.85, 0.3, 0.85)), dict(white))
    add(*box((0.15, 0.0, 0.15), (0.45, 0.6, 0.45)), dict(mirror))

    lights = make_light_table([
        {"type": LIGHT_QUAD, "pos": (0.35, 0.999, 0.35),
         "e1": (0.3, 0.0, 0.0), "e2": (0.0, 0.0, 0.3),
         "radiance": (18.0, 14.0, 8.0)},
    ], ambient=(0.0, 0.0, 0.0), device=dev.device)
    return _state(dev, scene, geom_mat, mats, lights)


def build_xml_scene(xs, device: Device = None):
    """The pathtracer's state for a loaded scene (`xmlloader.XMLScene`,
    as `load_xml` or `load_corona` return it): its geometries with their
    materials, and its lights (`light_table_from_xml`)."""
    from ..xmlloader import light_table_from_xml
    dev = device or Device("ignore_config_files=1")
    scene = Scene(dev)
    geom_mat = []
    for g, m in xs.geometries:
        gid = scene.attach(g)
        while len(geom_mat) <= gid:
            geom_mat.append(0)
        geom_mat[gid] = m
    return _state(dev, scene, geom_mat, xs.materials,
                  light_table_from_xml(xs, device=dev.device))


def _take(idx, *arrays):
    return tuple(a[idx] for a in arrays)


def _one_sample(cscene, materials: MaterialTable, lights: LightTable,
                geom_mat, px, py, cam, sampler, s: int, n_lights: int,
                max_path: int, counts):
    """The radiance (n, 3) of sample `s` of every lane."""
    dev = px.device
    cam_vx, cam_vy, cam_vz, cam_p = cam
    n = px.shape[0]
    uxy = sampler.pixel(s)
    x = px + uxy[:, 0]
    y = py + uxy[:, 1]
    d = normalize(x[..., None] * cam_vx + y[..., None] * cam_vy + cam_vz)
    L = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    # the live lanes: pixel index, throughput, ray, per-ray Medium
    # (pathtracer_device.cpp:57-81: starts vacuum; DIELECTRIC_SOLID
    # refraction events push/pop it)
    pix = torch.arange(n, device=dev)
    Lw = torch.ones((n, 3), dtype=torch.float32, device=dev)
    ro = cam_p.expand(d.shape)
    rd = d
    med_eta = torch.ones(n, dtype=torch.float32, device=dev)
    med_trans = torch.ones((n, 3), dtype=torch.float32, device=dev)
    ambient = lights.ambient if bool(lights.ambient.any()) else None
    emits = bool(materials.le.any())
    last_gm = geom_mat.shape[0] - 1
    for bounce in range(max_path):
        m = pix.shape[0]
        if m == 0:
            break
        rays = Rays(ro.contiguous(), rd.contiguous(),
                    torch.full((m,), 1e-4, dtype=torch.float32, device=dev),
                    torch.full((m,), math.inf, dtype=torch.float32,
                               device=dev))
        # coherent flag on the camera bounce only (the reference sets
        # RTC_INTERSECT_CONTEXT_FLAG_COHERENT at :1467)
        hits = scene_intersect(cscene, rays, coherent=(bounce == 0))
        counts["rays"] += m
        counts["intersect"] += 1
        if ambient is not None:
            # environment on miss (:1476-1484)
            L.index_add_(0, pix, torch.where(
                hits.valid[:, None], 0.0, Lw * ambient))
        hit = hits.valid.nonzero().squeeze(1)
        pix, Lw, ro, rd, med_eta, med_trans, t, ng_raw, gid = _take(
            hit, pix, Lw, ro, rd, med_eta, med_trans, hits.t, hits.ng,
            hits.geom_id)
        mid = geom_mat[gid.clamp(0, last_gm).long()].long()
        if emits:
            L.index_add_(0, pix, Lw * table_rows(materials.le, mid))

        p_hit = ro + t[..., None] * rd
        ng = ng_raw / length(ng_raw)[..., None].clamp_min(1e-20)
        # face forward
        ng = torch.where((dot(rd, ng) < 0)[..., None], ng, -ng)
        wo = -rd

        # next event estimation over every light (:1520-1533); a shadow
        # ray goes only where the light is in front of the surface
        for li in range(n_lights):
            uv = (sampler.light(s, bounce, li)[pix]
                  if lights.type[li] == LIGHT_QUAD else None)
            wi, dist, le_w = sample_light(lights, li, p_hit, uv)
            cos_s = dot(wi, ng)
            f = eval_brdf(materials, mid, wo, ng, wi)
            front = (cos_s > 0).nonzero().squeeze(1)
            k = front.shape[0]
            if k == 0:
                continue
            shadow = Rays(p_hit[front].contiguous(), wi[front].contiguous(),
                          torch.full((k,), 1e-3, dtype=torch.float32,
                                     device=dev),
                          (dist[front] * (1.0 - 1e-3)).contiguous())
            occ = scene_occluded(cscene, shadow)
            counts["rays"] += k
            counts["occluded"] += 1
            vis = front[~occ]
            L.index_add_(0, pix[vis], (Lw[vis] * f[vis]) * le_w[vis])

        # simple volumetric effect (:1503-1506): the medium the segment
        # just crossed attenuates the continuation weight
        seg_att = med_trans ** t[..., None]
        # sample continuation (:1459-1536) with Medium tracking
        u = sampler.bsdf(s, bounce)[pix]
        wi, w, _delta, med_eta, med_trans = sample_bsdf_medium(
            materials, mid, wo, ng, u, med_eta, med_trans)
        Lw = Lw * (w * seg_att)
        ro = p_hit + 1e-4 * wi
        rd = wi
        live = (Lw.amax(-1) >= 0.01).nonzero().squeeze(1)   # cutoff (:1459)
        pix, Lw, ro, rd, med_eta, med_trans = _take(
            live, pix, Lw, ro, rd, med_eta, med_trans)
    return L


def render_pt(cscene, materials: MaterialTable, lights: LightTable,
              geom_mat, cam_vx, cam_vy, cam_vz, cam_p, seed=0,
              perm=None, inv=None, *, width: int, height: int, spp: int = 4,
              n_lights: int = 1, max_path: int = MAX_PATH_LENGTH,
              sampler=None, counts=None):
    """The (height, width, 3) f32 image: the mean of `spp` samples, each
    traced in the order of `perm` (image-row order without it) and
    unsorted by `inv`. `sampler` defaults to `TorchSampler(seed, ...)` on
    the scene's device. When `counts` is a dict, the rays traced and the
    requests made are added to its "rays", "intersect" and "occluded"."""
    dev = cscene.device
    px, py = pixel_coords(width, height, perm, device=dev)
    n = px.shape[0]
    if sampler is None:
        sampler = TorchSampler(seed, n, dev)
    tally = {"rays": 0, "intersect": 0, "occluded": 0}
    cam = tuple(a.to(dev) for a in (cam_vx, cam_vy, cam_vz, cam_p))
    L = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    for s in range(spp):
        L = L + _one_sample(cscene, materials, lights, geom_mat, px, py,
                            cam, sampler, s, n_lights, max_path, tally)
    L = L / spp
    if inv is not None:
        L = L[inv]
    if counts is not None:
        for k, v in tally.items():
            counts[k] = counts.get(k, 0) + v
    return L.reshape(height, width, 3)


def render_frame(state, camera: Camera, size, spp=4, seed=0, sampler=None,
                 counts=None):
    """One frame in Morton pixel order. Returns (image, rays traced):
    the live rays of every request, which the JAX package bounds from
    above by spp * w * h * 2 * MAX_PATH_LENGTH. `sampler` and `counts`
    are `render_pt`'s."""
    w, h = size
    cs = state["cscene"]
    vx, vy, vz, p = camera.ispc_camera(w, h, device=cs.device)
    perm, inv = pixel_morton_order_device(w, h, cs.device)
    counts = {} if counts is None else counts
    before = counts.get("rays", 0)
    img = render_pt(cs, state["materials"], state["lights"],
                    state["geom_mat"], vx, vy, vz, p, seed, perm, inv,
                    width=w, height=h, spp=spp,
                    n_lights=len(state["lights"].type), sampler=sampler,
                    counts=counts)
    return img, counts["rays"] - before


def make_app() -> TutorialApplication:
    def _build(app):
        return build_cornell_scene(Device(app.args.rtcore))

    app = TutorialApplication("pathtracer", _build, render_frame,
                              default_size=(256, 256))
    app.camera = Camera(from_=(0.5, 0.5, 2.4), to=(0.5, 0.5, 0.0), fov=40)
    return app


if __name__ == "__main__":
    raise SystemExit(make_app().run())
