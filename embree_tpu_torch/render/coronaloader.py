"""Corona scene loader (.scn).

Analog of tutorials/common/scenegraph/corona_loader.cpp: a corona scene
is XML with a `<scene>` root holding `geometryGroup` nodes; each group's
first child is an `<instance>` carrying a `<material>` plus one or more
`<transform>` (12-float affine rows, corona_loader.cpp:83-90), and the
remaining children are `<object class="file">mesh.obj</object>`
references (:215-223).  `mtllib` material libraries define Native
materials (diffuse -> Kd, reflect -> mirror, :92-140) referenced by name.
Cameras/environment/renderElement nodes are skipped exactly like the
reference (:272-280).

Counterpart of embree_tpu/render/coronaloader.py (host code, copied).
Produces the same XMLScene container as the XML loader so the viewer and
convert tool consume it unchanged; instance transforms are baked into
vertices (the flattened form of the reference's TransformNodes).
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

from ..scene.geometry import TriangleMesh
from .materials import MAT_MIRROR, MAT_OBJ
from .objloader import load_obj
from .plyloader import load_ply
from .xmlloader import XMLScene


def _floats(text):
    return np.asarray([float(t) for t in text.split()], np.float32)


def _load_material(e, material_map):
    """<material class="Native"> diffuse/reflect, or class="Reference"."""
    cls = e.get("class", "")
    if cls == "Reference":
        name = (e.text or "").strip()
        return material_map.get(name, {"type": MAT_OBJ,
                                       "kd": (0.5, 0.5, 0.5)})
    mat = {"type": MAT_OBJ, "kd": (0.5, 0.5, 0.5)}
    for c in e:
        if c.tag == "diffuse" and c.text and c.text.strip():
            kd = _floats(c.text)[:3]
            mat["kd"] = tuple(kd.tolist())
        elif c.tag == "reflect":
            color = c.find("color")
            if color is not None and color.text:
                ks = _floats(color.text)[:3]
                if float(ks.max()) > 0.5:
                    mat["type"] = MAT_MIRROR
                mat["ks"] = tuple(ks.tolist())
    return mat


def _load_mtllib(path, material_map):
    root = ET.parse(path).getroot()
    if root.tag != "mtlLib":
        raise ValueError(f"{path}: invalid material library")
    for child in root:
        if child.tag == "materialDefinition":
            name = child.get("name", "")
            mat_e = child.find("material")
            if mat_e is not None:
                material_map[name] = _load_material(mat_e, material_map)


def _affine_from_12(vals):
    """12-float row-major 3x4 (corona_loader.cpp:83-90)."""
    m = np.asarray(vals, np.float32).reshape(3, 4)
    return m


def _xfm(m, p):
    return p @ m[:, :3].T + m[:, 3]


def load_corona(path: str) -> XMLScene:
    base = os.path.dirname(path)
    root = ET.parse(path).getroot()
    if root.tag != "scene":
        raise ValueError(f"{path}: invalid scene tag")

    scene = XMLScene()
    scene.geometries = []
    material_map = {}

    for node in root:
        if node.tag == "mtllib":
            _load_mtllib(os.path.join(base, (node.text or "").strip()),
                         material_map)
        elif node.tag in ("conffile", "camera", "environment",
                          "renderElement"):
            continue  # skipped, like loadNode (:272-280)
        elif node.tag == "geometryGroup":
            children = list(node)
            if not children or children[0].tag != "instance":
                raise ValueError("invalid group node")
            inst = children[0]
            mat = {"type": MAT_OBJ, "kd": (0.5, 0.5, 0.5)}
            xfms = []
            for c in inst:
                if c.tag == "material":
                    mat = _load_material(c, material_map)
                elif c.tag == "transform":
                    xfms.append(_affine_from_12(_floats(c.text)))
                else:
                    raise ValueError(f"unknown node: {c.tag}")
            mi = len(scene.materials)
            scene.materials.append(mat)
            # load referenced objects
            geoms = []
            for obj in children[1:]:
                if obj.tag != "object" or obj.get("class") != "file":
                    raise ValueError("invalid object node")
                fn = os.path.join(base, (obj.text or "").strip())
                if fn.lower().endswith(".obj"):
                    sub_geoms, _sub_mats = load_obj(fn)
                    geoms.extend(g for g, _ in sub_geoms)
                elif fn.lower().endswith(".ply"):
                    geoms.append(load_ply(fn))
                else:
                    raise ValueError(f"unsupported object file: {fn}")
            if not xfms:
                xfms = [np.concatenate([np.eye(3, dtype=np.float32),
                                        np.zeros((3, 1), np.float32)], 1)]
            for m in xfms:
                for g in geoms:
                    v = _xfm(m, np.asarray(g.vertices, np.float32))
                    scene.geometries.append(
                        (TriangleMesh(v, np.asarray(g.indices)), mi))
        else:
            raise ValueError(f"unknown tag: {node.tag}")
    return scene
