"""viewer_anim tutorial: keyframed OBJ playback with per-frame recommit.

Counterpart of embree_tpu/render/tutorials/viewer_anim.py, the
re-creation of tutorials/viewer_anim/viewer_anim_device.cpp: mesh
vertices are linearly interpolated between two keyframes each frame
(interpolateVertices :151-178, updateVertexData :187-221), geometry is
re-committed at RTC_BUILD_QUALITY_LOW (:48, :121; it commits the binned
SAH, as in the JAX package), and the frame rendered with the viewer's
geometric-normal shading (viewer.py's `render`: one coherent batch in
image-row order through the packet kernel B2).
Keyframes are given as repeated `-i` OBJ files; with a single input a
second keyframe is synthesized by a sinusoidal deformation so the demo
is self-contained. The frame counter lives in the state.

    python -m embree_tpu_torch.render.tutorials.viewer_anim \\
        -i model.obj --size 512 512 -o anim.ppm --benchmark 1 3
    ... -rtcore device=cpu                               # on the CPU
"""
from __future__ import annotations

import numpy as np
import torch

from ...core.device import Device
from ...scene.geometry import TriangleMesh
from ...scene.scene import BuildQuality, Scene
from ..camera import Camera
from ..materials import make_material_table
from ..objloader import load_obj
from ..texture import make_texture_set
from ..tutorial_app import TutorialApplication
from .viewer import render


def _load_keyframes(paths):
    """Each path -> list of (vertices, indices, mat); topology must match
    across keyframes (the reference asserts equal numVertices)."""
    frames = []
    mats0 = None
    for p in paths:
        geoms, mats = load_obj(p)
        frames.append([(np.asarray(g.vertices, np.float32), g.indices, m)
                       for g, m in geoms if isinstance(g, TriangleMesh)])
        if mats0 is None:
            mats0 = mats
    if len(frames) == 1:
        # synthesize keyframe 2: sinusoidal bulge along the normal axis
        f2 = []
        for v, idx, m in frames[0]:
            c = v.mean(0)
            r = v - c
            f2.append((v + 0.4 * np.sin(2.0 * v[:, 1:2]) * r, idx, m))
        frames.append(f2)
    return frames, mats0


def build_scene(app=None, paths=None, device: Device = None):
    """The first keyframe committed at BuildQuality.LOW; `device` is a
    Device, None means the CUDA device."""
    frames, mats = _load_keyframes(paths)
    dev = device or Device("ignore_config_files=1")
    scene = Scene(dev, quality=BuildQuality.LOW)
    geoms = []
    geom_mat = []
    for v, idx, m in frames[0]:
        g = TriangleMesh(v, idx)
        gid = scene.attach(g)
        geoms.append(g)
        while len(geom_mat) <= gid:
            geom_mat.append(0)
        geom_mat[gid] = m
    cs = scene.commit()
    d = dev.device

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(d)

    return dict(cscene=cs, scene=scene, geoms=geoms, frames=frames,
                frame=0,
                materials=make_material_table(mats, device=d),
                geom_mat=up(np.asarray(geom_mat, np.int32)),
                textures=make_texture_set([], device=d),
                kd_tex=up(np.full(len(mats), -1, np.int32)),
                tri_uv=up(np.zeros((1, 3, 2), np.float32)),
                prim_base=up(np.zeros(max(len(geom_mat), 1), np.int32)))


def animate(state, t: float):
    """updateVertexData: lerp keyframe pair, recommit at LOW quality."""
    frames = state["frames"]
    K = len(frames)
    pos = (t % K)
    k0 = int(pos)
    k1 = (k0 + 1) % K
    tt = pos - k0
    for g, (v0, _, _), (v1, _, _) in zip(state["geoms"], frames[k0],
                                         frames[k1]):
        g.vertices = (1.0 - tt) * v0 + tt * v1
    state["cscene"] = state["scene"].commit()
    return state


def render_frame(state, camera: Camera, size):
    """Frame k (from 0) shows time 0.1 k; every frame after the first
    animates and re-commits first."""
    w, h = size
    t = 0.1 * state["frame"]
    state["frame"] += 1
    if state["frame"] > 1:
        state = animate(state, t)
    cs = state["cscene"]
    vx, vy, vz, p = camera.ispc_camera(w, h, device=cs.device)
    img = render(cs, state["materials"], state["geom_mat"],
                 state["textures"], state["kd_tex"], state["tri_uv"],
                 state["prim_base"], vx, vy, vz, p, width=w, height=h)
    return img, w * h


def make_app() -> TutorialApplication:
    def _build(app):
        paths = getattr(app.args, "input", None)
        if not paths:
            raise SystemExit("viewer_anim: -i <keyframe.obj> "
                             "[-i keyframe2.obj ...] required")
        return build_scene(app, paths=paths, device=Device(app.args.rtcore))

    app = TutorialApplication("viewer_anim", _build, render_frame)
    parser_make = app.make_parser

    def make_parser():
        p = parser_make()
        p.add_argument("-i", "--input", type=str, action="append",
                       default=None)
        return p

    app.make_parser = make_parser
    return app


if __name__ == "__main__":
    raise SystemExit(make_app().run())
