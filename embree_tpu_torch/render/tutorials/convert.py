"""convert tool: offline scene transformation (OBJ/PLY/XML -> XML).

Counterpart of embree_tpu/render/tutorials/convert.py (host code,
copied: the same flags, and byte-equal written files).

Recreates tutorials/convert/convert.cpp's core pipeline: `-i` loads scene
files into a flat scene graph (:150-162), transform flags rewrite it, and
`-o` stores it as embree XML (:280-283, SceneGraph::store).  Supported
flags map 1:1 where our scene graph has the node kinds:

  -i <file>                     load obj/ply/xml (accumulates, :150)
  -convert-triangles-to-quads   pair coplanar tris into quads (:177)
  -convert-to-subdivs           triangle/quad meshes -> SubdivMesh (:182)
  -centerScaleTranslate s tx ty tz  recenter to origin, scale s,
                                translate (tx,ty,tz) (:272-277)
  -o <file.xml>                 write the current graph (:280)

(The terrain/plant-distribution special modes :218-252 are tied to the
barbarian dataset and are out of scope.)
"""
from __future__ import annotations

import sys

import numpy as np

from ...scene.geometry import QuadMesh, SubdivMesh, TriangleMesh
from ..coronaloader import load_corona
from ..objloader import load_obj
from ..plyloader import load_ply
from ..xmlloader import XMLScene, load_xml, write_xml


def load_input(path: str, scene: XMLScene) -> None:
    low = path.lower()
    if low.endswith(".xml"):
        sub = load_xml(path)
        base = len(scene.materials)
        scene.materials.extend(sub.materials)
        scene.geometries.extend((g, mi + base) for g, mi in sub.geometries)
        scene.lights.extend(sub.lights)
        if sub.camera is not None:
            scene.camera = sub.camera
    elif low.endswith(".obj"):
        geoms, mats = load_obj(path)
        base = len(scene.materials)
        scene.materials.extend(mats)
        scene.geometries.extend((g, mi + base) for g, mi in geoms)
    elif low.endswith(".ply"):
        scene.geometries.append((load_ply(path), 0))
    elif low.endswith(".scn"):
        sub = load_corona(path)
        base = len(scene.materials)
        scene.materials.extend(sub.materials)
        scene.geometries.extend((g, mi + base) for g, mi in sub.geometries)
    else:
        raise ValueError(f"unsupported input: {path}")


def triangles_to_quads(scene: XMLScene) -> None:
    """Merge coplanar triangle pairs sharing an edge into quads
    (SceneGraph convert_triangles_to_quads semantics: consecutive tri
    pairs (v0,v1,v3)+(v2,v3,v1) -> quad v0,v1,v2,v3)."""
    out = []
    for g, mi in scene.geometries:
        if not isinstance(g, TriangleMesh):
            out.append((g, mi))
            continue
        idx = np.asarray(g.indices)
        quads, tris = [], []
        i = 0
        while i < idx.shape[0]:
            if i + 1 < idx.shape[0]:
                a, b = idx[i], idx[i + 1]
                # pair pattern from quad flattening: (0,1,3) + (2,3,1)
                if a[1] == b[2] and a[2] == b[1]:
                    quads.append((a[0], a[1], b[0], a[2]))
                    i += 2
                    continue
                # fan triangulation: (0,1,2) + (0,2,3)
                if a[0] == b[0] and a[2] == b[1]:
                    quads.append((a[0], a[1], a[2], b[2]))
                    i += 2
                    continue
            tris.append(tuple(a for a in idx[i]))
            i += 1
        if quads:
            out.append((QuadMesh(g.vertices,
                                 np.asarray(quads, np.int32)), mi))
        if tris:
            out.append((TriangleMesh(g.vertices,
                                     np.asarray(tris, np.int32)), mi))
        if not quads and not tris:
            out.append((g, mi))
    scene.geometries = out


def to_subdivs(scene: XMLScene) -> None:
    out = []
    for g, mi in scene.geometries:
        if isinstance(g, TriangleMesh):
            idx = np.asarray(g.indices)
            out.append((SubdivMesh(g.vertices,
                                   np.full(idx.shape[0], 3, np.int32),
                                   idx.reshape(-1)), mi))
        elif isinstance(g, QuadMesh):
            idx = np.asarray(g.indices)
            out.append((SubdivMesh(g.vertices,
                                   np.full(idx.shape[0], 4, np.int32),
                                   idx.reshape(-1)), mi))
        else:
            out.append((g, mi))
    scene.geometries = out


def center_scale_translate(scene: XMLScene, s: float, t) -> None:
    vs = [np.asarray(g.vertices, np.float32)
          for g, _ in scene.geometries if hasattr(g, "vertices")]
    if not vs:
        return
    lo = np.min([v.min(0) for v in vs], 0)
    hi = np.max([v.max(0) for v in vs], 0)
    center = 0.5 * (lo + hi)
    for g, _ in scene.geometries:
        if hasattr(g, "vertices"):
            g.vertices = ((np.asarray(g.vertices, np.float32) - center) * s
                          + np.asarray(t, np.float32))


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    scene = XMLScene()
    scene.geometries = []
    i = 0
    wrote = False
    while i < len(args):
        tag = args[i]
        if tag == "-i":
            load_input(args[i + 1], scene)
            i += 2
        elif tag == "-convert-triangles-to-quads":
            triangles_to_quads(scene)
            i += 1
        elif tag == "-convert-to-subdivs":
            to_subdivs(scene)
            i += 1
        elif tag == "-centerScaleTranslate":
            s = float(args[i + 1])
            t = tuple(map(float, args[i + 2:i + 5]))
            center_scale_translate(scene, s, t)
            i += 5
        elif tag == "-o":
            write_xml(args[i + 1], scene)
            print(f"wrote {args[i + 1]} "
                  f"({len(scene.geometries)} geometries)")
            wrote = True
            i += 2
        else:
            print(f"unknown command line parameter: {tag}",
                  file=sys.stderr)
            i += 1
    if not wrote:
        print("usage: convert -i in.{obj,ply,xml} [transforms] -o out.xml",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
