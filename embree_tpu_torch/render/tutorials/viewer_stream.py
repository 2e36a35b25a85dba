"""viewer_stream tutorial: OBJ viewer through the ray-stream API.

Counterpart of embree_tpu/render/tutorials/viewer_stream.py, the
re-creation of tutorials/viewer_stream/viewer_stream_device.cpp: the
same scene and shading as `viewer` (geometric normals), but the rays go
through the large ray-stream entry (`rtcIntersect1M`, :200-260
renderTileStandardStream) instead of per-pixel rtcIntersect1. Here the
whole frame is one flat stream in image-row order, traced as one batch
(`scene_intersect` on the committed scene, as `rtcore.rtcIntersect1M`
does; no coherent hint: B2, or B1 for a stream of at least
ROWTRACE_MIN_RAYS rays on a scene with a treelet scene).

    python -m embree_tpu_torch.render.tutorials.viewer_stream \\
        -i scene.obj --size 512 512 -o vs.ppm --benchmark 1 3
    ... -rtcore device=cpu                               # on the CPU
"""
from __future__ import annotations

import math

import torch

from ...core.math import dot, normalize
from ...core.rayhit import Rays
from ...scene.scene import scene_intersect
from ..camera import Camera, pixel_coords
from ..texture import sample_texture
from ..tutorial_app import TutorialApplication
from .viewer import build_scene


def render(cscene, materials, geom_mat, textures, kd_tex, tri_uv, prim_base,
           cam_vx, cam_vy, cam_vz, cam_p, *, width: int, height: int):
    """The (height, width, 3) f32 image of `cscene` (a CommittedScene)."""
    dev = cam_vx.device
    x, y = pixel_coords(width, height, device=dev)
    d = normalize(x[..., None] * cam_vx + y[..., None] * cam_vy + cam_vz)
    org = cam_p.expand(d.shape).contiguous()
    n = width * height
    # one flat ray stream for the frame (the 1M entry point)
    hits = scene_intersect(cscene, Rays(
        org, d, torch.zeros(n, dtype=torch.float32, device=dev),
        torch.full((n,), math.inf, dtype=torch.float32, device=dev)))

    gidc = hits.geom_id.clamp(0, geom_mat.shape[0] - 1).long()
    mid = geom_mat[gidc].long()
    kd = materials.kd[mid]
    tid = kd_tex[mid]
    gp = (prim_base[hits.geom_id.clamp(0, prim_base.shape[0] - 1).long()]
          + hits.prim_id).clamp(0, tri_uv.shape[0] - 1).long()
    uv3 = tri_uv[gp]
    w0 = (1.0 - hits.u - hits.v)[..., None]
    uv = uv3[..., 0, :] * w0 + uv3[..., 1, :] * hits.u[..., None] \
        + uv3[..., 2, :] * hits.v[..., None]
    tex = sample_texture(textures, tid.clamp_min(0), uv[..., 0], uv[..., 1])
    kd = torch.where((tid >= 0)[..., None], kd * tex, kd)
    ns = normalize(hits.ng)
    ns = torch.where((dot(d, ns) < 0)[..., None], ns, -ns)
    shade = dot(-d, ns).clamp(0.0, 1.0)
    img = torch.where(hits.valid[..., None], kd * shade[..., None],
                      torch.zeros_like(kd))
    return img.reshape(height, width, 3)


def render_frame(state, camera: Camera, size):
    w, h = size
    dev = state["cscene"].device
    vx, vy, vz, p = camera.ispc_camera(w, h, device=dev)
    img = render(state["cscene"], state["materials"], state["geom_mat"],
                 state["textures"], state["kd_tex"], state["tri_uv"],
                 state["prim_base"], vx, vy, vz, p, width=w, height=h)
    return img, w * h


def make_app() -> TutorialApplication:
    def _build(app):
        obj = app.args.input
        if obj is None:
            raise SystemExit("viewer_stream: -i <scene.obj> required")
        return build_scene(obj, app.args.subdiv_mode, app.args.subdLvl,
                           app.args.compLvl, rtcore=app.args.rtcore)

    app = TutorialApplication("viewer_stream", _build, render_frame)
    parser_make = app.make_parser

    def make_parser():
        p = parser_make()
        p.add_argument("-i", "--input", type=str, default=None)
        return p

    app.make_parser = make_parser
    return app


if __name__ == "__main__":
    raise SystemExit(make_app().run())
