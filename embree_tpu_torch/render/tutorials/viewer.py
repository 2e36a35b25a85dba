"""viewer tutorial: OBJ scene renderer (eyelight shading).

Counterpart of embree_tpu/render/tutorials/viewer.py, the re-creation of
tutorials/viewer/viewer_device.cpp renderPixelStandard (:249-305):
primary rays, OBJ material Kd (times the map_Kd texture), color = Kd *
dot(-dir, Ns), black background. With a `--compress.*` flag the OBJ
faces become Catmull-Clark subdivision surfaces in the fork's compressed
accel (obj_loader.cpp:528, tutorial.cpp:1104) at `--subdLvl` /
`--compLvl`, shaded with smooth limit-surface normals. The paper's demo
(build/bomberman.ecs):

    python -m embree_tpu_torch.render.tutorials.viewer \\
        -i tests/golden/bomberman.obj --compress.leaf --subdLvl 6 \\
        --compLvl 3 --size 1280 768 -o bomberman.ppm --benchmark 1 3
    ... -rtcore device=cpu                               # on the CPU

A frame is one coherent batch traced in Morton pixel order (the
compressed kernel for the subdivision surfaces, the packet kernel for
triangles), the smooth-normal pass, the shading, and one unsort of the
RGB image; `render` is the geometric-normal frame without the smooth
pass. `-i` takes `.obj`, `.xml` (render/xmlloader.py), `.scn`
(render/coronaloader.py) and `.ply` (render/plyloader.py) scenes; only
an OBJ's faces become subdivision surfaces under `--compress.*`.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...core.device import Device
from ...core.math import dot, normalize
from ...core.rayhit import Rays
from ...scene.geometry import SubdivMesh
from ...scene.scene import Scene, scene_intersect
from ..camera import Camera, pixel_coords, pixel_morton_order_device
from ..coronaloader import load_corona
from ..materials import MAT_OBJ, make_material_table
from ..objloader import load_obj
from ..plyloader import load_ply
from ..texture import make_texture_set, sample_texture
from ..tutorial_app import TutorialApplication
from ..xmlloader import load_xml


def build_scene(obj_path: str, subdiv_mode=None, subdiv_level=5,
                comp_level=2, rtcore: str = ""):
    """Load `obj_path` (.obj, .xml, .scn or .ply) and commit it.
    `subdiv_mode` is a `subdiv_accel` value such as "bvh4.compressed.leaf"
    (an OBJ's faces become a SubdivMesh) or None (triangles); `rtcore` is
    appended to the Device config string (`device=cpu` runs on the CPU)."""
    cfg = "ignore_config_files=1"
    if subdiv_mode:
        cfg += f",subdiv_accel={subdiv_mode}"
    if rtcore:
        cfg += f",{rtcore}"
    dev = Device(cfg)
    scene = Scene(dev)
    low = obj_path.lower()
    if low.endswith(".xml"):
        xs = load_xml(obj_path)
        geometries, mats = xs.geometries, xs.materials
    elif low.endswith(".scn"):
        xs = load_corona(obj_path)
        geometries, mats = xs.geometries, xs.materials
    elif low.endswith(".ply"):
        geometries = [(load_ply(obj_path), 0)]
        mats = [{"type": MAT_OBJ, "kd": (0.5, 0.5, 0.5)}]
    else:
        geometries, mats = load_obj(obj_path,
                                    subdiv_mode=subdiv_mode is not None)
    geom_mat = []
    prim_base = {}
    uv_all = []
    for geom, m in geometries:
        gid = scene.attach(geom)
        while len(geom_mat) <= gid:
            geom_mat.append(0)
        geom_mat[gid] = m
        tc = getattr(geom, "texcoords", None)
        prim_base[gid] = len(uv_all)
        if tc is not None:
            uv_all.extend(tc)
        elif hasattr(geom, "indices"):
            uv_all.extend(np.zeros((geom.num_prims, 3, 2), np.float32))
    scene.set_levels(subdiv_level, comp_level)
    cs = scene.commit()

    # material textures (map_Kd)
    images = []
    kd_tex = np.full(len(mats), -1, np.int32)
    for i, m in enumerate(mats):
        if "map_kd" in m:
            kd_tex[i] = len(images)
            images.append(m["map_kd"])
    base_arr = np.zeros(max(len(geom_mat), 1), np.int32)
    for gid, b in prim_base.items():
        base_arr[gid] = b
    d = dev.device

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(d)

    return dict(cscene=cs, scene=scene,
                materials=make_material_table(mats, device=d),
                geom_mat=up(np.asarray(geom_mat, np.int32)),
                textures=make_texture_set(images, device=d),
                kd_tex=up(kd_tex),
                tri_uv=up(np.asarray(uv_all, np.float32) if uv_all
                          else np.zeros((1, 3, 2), np.float32)),
                prim_base=up(base_arr))


def _trace(cscene, materials, geom_mat, textures, kd_tex, tri_uv, prim_base,
           cam_vx, cam_vy, cam_vz, cam_p, perm=None, *, width: int,
           height: int):
    """Trace + material part; returns flat kd/valid/d/geom/prim/u/v/ng
    in the order of `perm` (image-row order without it) so the
    smooth-normal pass can run on top."""
    dev = cscene.device
    x, y = pixel_coords(width, height, perm, device=dev)
    d = normalize(x[..., None] * cam_vx + y[..., None] * cam_vy + cam_vz)
    org = cam_p.broadcast_to(d.shape).contiguous()
    n = d.shape[:-1]
    rays = Rays(org, d, torch.zeros(n, dtype=torch.float32, device=dev),
                torch.full(n, math.inf, dtype=torch.float32, device=dev))
    hits = scene_intersect(cscene, rays, coherent=True)
    valid = hits.valid

    gidc = hits.geom_id.clamp(0, geom_mat.shape[0] - 1).long()
    mid = geom_mat[gidc].long()
    kd = materials.kd[mid]
    # map_Kd texture lookup with barycentric-interpolated texcoords
    tid = kd_tex[mid]
    gp = (prim_base[hits.geom_id.clamp(0, prim_base.shape[0] - 1).long()]
          + hits.prim_id).clamp(0, tri_uv.shape[0] - 1).long()
    uv3 = tri_uv[gp]  # (..., 3, 2)
    w0 = (1.0 - hits.u - hits.v)[..., None]
    uv = uv3[..., 0, :] * w0 + uv3[..., 1, :] * hits.u[..., None] \
        + uv3[..., 2, :] * hits.v[..., None]
    tex = sample_texture(textures, tid.clamp_min(0), uv[..., 0], uv[..., 1])
    kd = torch.where((tid >= 0)[..., None], kd * tex, kd)
    return kd, valid, d, hits.geom_id, hits.prim_id, hits.u, hits.v, hits.ng


def render(cscene, materials, geom_mat, textures, kd_tex, tri_uv, prim_base,
           cam_vx, cam_vy, cam_vz, cam_p, perm=None, inv=None,
           *, width: int, height: int):
    """One-shot geometric-normal frame (no smooth-normal pass), (H, W, 3)
    f32 on the scene's device — the fast path used by viewer_anim's
    per-frame loop. The rays are traced in the order of `perm` (image-row
    order without it); given `inv` as well, the shaded image is unsorted
    with it."""
    kd, valid, d, _gid, _prim, _u, _v, ng = _trace(
        cscene, materials, geom_mat, textures, kd_tex, tri_uv, prim_base,
        cam_vx, cam_vy, cam_vz, cam_p, perm, width=width, height=height)
    img = _shade(kd, valid, d, ng)
    if perm is not None and inv is not None:
        img = img[inv]
    return img.reshape(height, width, 3)


def _shade(kd, valid, d, ns):
    """color = Kd * dot(-dir, face_forward(normalize(Ns))) —
    viewer_device.cpp:241-244,304. Returns flat (R, 3)."""
    ns = normalize(ns)
    ns = torch.where((dot(d, ns) < 0)[..., None], ns, -ns)
    shade = dot(-d, ns).clamp(0.0, 1.0)
    return torch.where(valid[..., None], kd * shade[..., None],
                       torch.zeros_like(kd))


def shade_normals(scene, valid, gid, prim, u, v, ng):
    """Ng replaced by the smooth limit-surface normal at the hits of
    every SubdivMesh (Scene.interpolate_normal); triangle hits keep Ng
    (their dPdu x dPdv is +-Ng already)."""
    for g_id, g in scene.geometries.items():
        if not isinstance(g, SubdivMesh):
            continue
        m = valid & (gid == g_id)
        nrm = scene.interpolate_normal(
            g_id, prim.clamp(0, g.num_prims - 1), u, v)
        ng = torch.where(m[..., None], nrm, ng)
    return ng


def render_frame(state, camera: Camera, size, smooth_normals: bool = True):
    """Reference viewer shading: g_use_smooth_normals defaults TRUE in
    the fork (viewer_device.cpp:132) — Ns from rtcInterpolate at every
    hit (:284-295), which for subdiv geometry is the limit-surface normal
    (essential for compressed leaves, whose raw Ng is the dummy (1,0,0)).
    `smooth_normals=False` shades with the geometric normal, as `render`.

    The whole frame runs in Morton ray order; only the final RGB image is
    unsorted."""
    w, h = size
    cs = state["cscene"]
    vx, vy, vz, p = camera.ispc_camera(w, h, device=cs.device)
    perm, inv = pixel_morton_order_device(w, h, cs.device)
    kd, valid, d, gid, prim, u, v, ng = _trace(
        cs, state["materials"], state["geom_mat"], state["textures"],
        state["kd_tex"], state["tri_uv"], state["prim_base"], vx, vy, vz, p,
        perm, width=w, height=h)
    if smooth_normals:
        ng = shade_normals(state["scene"], valid, gid, prim, u, v, ng)
    img = _shade(kd, valid, d, ng)[inv].reshape(h, w, 3)
    return img, w * h


def make_app() -> TutorialApplication:
    def _build(app):
        obj = app.args.input
        if obj is None:
            raise SystemExit("viewer: -i <scene.obj> required")
        return build_scene(obj, app.args.subdiv_mode, app.args.subdLvl,
                           app.args.compLvl, rtcore=app.args.rtcore)

    app = TutorialApplication("viewer", _build, render_frame)
    parser_make = app.make_parser

    def make_parser():
        p = parser_make()
        p.add_argument("-i", "--input", type=str, default=None)
        return p

    app.make_parser = make_parser
    return app


if __name__ == "__main__":
    raise SystemExit(make_app().run())
