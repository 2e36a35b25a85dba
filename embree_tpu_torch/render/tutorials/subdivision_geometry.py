"""subdivision_geometry tutorial: Catmull-Clark cube + plane.

Counterpart of embree_tpu/render/tutorials/subdivision_geometry.py, the
re-creation of tutorials/subdivision_geometry/
subdivision_geometry_device.cpp: ground plane (geom 0, diffuse
(0.8,0,0)) + 6-quad subdiv cube (geom 1, diffuse (0.9,0.6,0.5)) with
edge/vertex crease arrays (the reference binds them with itemCount 0, so
by default no crease is active; `crease_weight` turns them on). The cube
shades with the smooth limit-surface normal dPdu x dPdv of
`Scene.interpolate(..., derivatives=True)`; otherwise the shading is
displacement_geometry's.

    python -m embree_tpu_torch.render.tutorials.subdivision_geometry \\
        --subdLvl 6 --size 512 512 -o subdiv.ppm --benchmark 1 3
    ... -rtcore device=cpu                               # on the CPU

Without a `--compress.*` flag the cube is tessellated eagerly to level
`--subdLvl` and a frame's two coherent batches (primary and shadow rays)
go through the packet kernel.
"""
from __future__ import annotations

import numpy as np

from ...core.device import Device
from ...core.math import cross, normalize
from ...scene.geometry import SubdivMesh, TriangleMesh
from ...scene.scene import Scene
from ..camera import Camera, pixel_morton_order_device
from ..tutorial_app import TutorialApplication
from . import displacement_geometry as dg

EDGE_CREASE_INDICES = np.array([
    [0, 1], [1, 2], [2, 3], [3, 0],
    [4, 5], [5, 6], [6, 7], [7, 4],
    [0, 4], [1, 5], [2, 6], [3, 7]], np.int32)


def build_scene(subdiv_mode=None, subdiv_level=4, comp_level=2,
                crease_weight=None, rtcore: str = ""):
    """crease_weight=None is reference-exact: the tutorial binds its
    edge/vertex crease arrays with itemCount ZERO
    (subdivision_geometry_device.cpp:130-134), so NO creases are active
    and the cube subdivides to the smooth rounded limit surface. Pass a
    weight to get the creased variant. `rtcore` is appended to the Device
    config string (`device=cpu` runs on the CPU)."""
    cfg = "ignore_config_files=1"
    if subdiv_mode:
        cfg += f",subdiv_accel={subdiv_mode}"
    if rtcore:
        cfg += f",{rtcore}"
    scene = Scene(Device(cfg))
    scene.attach(TriangleMesh(dg.PLANE_VERTICES, dg.PLANE_INDICES))  # geom 0
    if crease_weight is None:
        scene.attach(SubdivMesh(dg.CUBE_VERTICES, dg.CUBE_FACES,
                                dg.CUBE_INDICES))
    else:
        w = min(crease_weight, 1e9)
        scene.attach(SubdivMesh(
            dg.CUBE_VERTICES, dg.CUBE_FACES, dg.CUBE_INDICES,
            edge_creases=EDGE_CREASE_INDICES,
            edge_crease_weights=np.full(12, w, np.float32),
            vertex_creases=np.arange(8, dtype=np.int32),
            vertex_crease_weights=np.full(8, w, np.float32)))  # geom 1
    scene.set_levels(subdiv_level, comp_level)
    cs = scene.commit()
    return dict(cscene=cs, scene=scene)


def render_frame(state, camera: Camera, size, smooth_normals: bool = True):
    """Reference-exact shading: the subdiv cube (geomID > 0) shades with
    the SMOOTH limit-surface normal Ng = cross(dPdu, dPdv) from
    rtcInterpolate (subdivision_geometry_device.cpp:219-226); the plane
    keeps its raw triangle normal. `smooth_normals=False` returns
    displacement_geometry's frame of the scene (raw normals)."""
    if not smooth_normals:
        return dg.render_frame(state, camera, size)
    w, h = size
    cs = state["cscene"]
    vx, vy, vz, p = camera.ispc_camera(w, h, device=cs.device)
    perm, inv = pixel_morton_order_device(w, h, cs.device)
    valid, occ, gid, prim, u, v, ng, d = dg.trace(
        cs, vx, vy, vz, p, perm, inv, width=w, height=h)
    scene = state["scene"]
    ns = normalize(ng)
    for g_id, g in scene.geometries.items():
        if not isinstance(g, SubdivMesh):
            continue
        m = ((gid == g_id) & valid).nonzero().squeeze(1)
        if m.numel() == 0:
            continue
        dv = scene.interpolate(g_id, prim[m], u[m], v[m], derivatives=True)
        ns[m] = normalize(cross(dv["dPdu"], dv["dPdv"]))
    return dg._shade(valid, occ, gid, ns, d, w, h), 2 * w * h


def make_app() -> TutorialApplication:
    def _build(app):
        a = app.args
        return build_scene(a.subdiv_mode, a.subdLvl, a.compLvl,
                           rtcore=a.rtcore)

    app = TutorialApplication("subdivision_geometry", _build, render_frame)
    app.camera = Camera(from_=(2.5, 2.5, 2.5), to=(0, 0, 0))
    return app


if __name__ == "__main__":
    raise SystemExit(make_app().run())
