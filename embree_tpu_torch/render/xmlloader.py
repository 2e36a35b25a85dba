"""Embree .xml scene format loader + writer.

Counterpart of embree_tpu/render/xmlloader.py (host code, copied: the
same geometries, materials, lights and camera, and byte-equal written
files); `light_table_from_xml` makes the port's light table on a device.

Analog of tutorials/common/scenegraph/xml_loader.cpp (1478 LoC) and
xml_writer.cpp: the element vocabulary is the reference's —
TriangleMesh/QuadMesh/SubdivisionMesh with <positions>/<triangles>/
<indices>/<faces> whitespace arrays (xml_loader.cpp:885-1014), material
nodes as <material><code>T</code><parameters>… (xml_loader.cpp:766-782),
Transform nodes whose AffineSpace child carries translate/scale/
rotate_*/12-float parms (xml_loader.cpp:373-400), lights
(Point/Directional/Ambient/Quad/Triangle, xml_loader.cpp:630-691),
PerspectiveCamera from/to/up/fov parms (xml_loader.cpp:724-731),
<Group>, <ref id=…>/<assign>, and <obj src=…> externs. Binary .bin
side-files and animation nodes are not supported (text arrays only).

Transforms are baked into vertices at load time (one flat geometry list
instead of the reference's TransformNode graph — instancing is available
separately through scene.Instance when needed).
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

from ..scene.geometry import QuadMesh, SubdivMesh, TriangleMesh
from .lights import (LIGHT_DIRECTIONAL, LIGHT_POINT, LIGHT_QUAD,
                     make_light_table)
from .materials import (MAT_DIELECTRIC, MAT_DIELECTRIC_SOLID, MAT_EMITTER,
                        MAT_HAIR, MAT_MATTE, MAT_METAL, MAT_METALLIC_PAINT,
                        MAT_MIRROR, MAT_OBJ, MAT_REFLECTIVE_METAL,
                        MAT_VELVET)
from .objloader import load_obj


def _floats(e) -> np.ndarray:
    if e is None or e.text is None:
        return np.zeros((0,), np.float32)
    return np.asarray([float(x) for x in e.text.split()], np.float32)


def _ints(e) -> np.ndarray:
    if e is None or e.text is None:
        return np.zeros((0,), np.int32)
    return np.asarray([int(float(x)) for x in e.text.split()], np.int32)


def _vec3_array(e) -> np.ndarray:
    return _floats(e).reshape(-1, 3)


def _parm_vec3(e, name, default=(0.0, 0.0, 0.0)):
    s = e.get(name)
    if s is None:
        return np.asarray(default, np.float32)
    return np.asarray([float(x) for x in s.replace(",", " ").split()],
                      np.float32)


def _rot(axis: np.ndarray, deg: float) -> np.ndarray:
    a = np.radians(deg)
    x, y, z = axis / np.linalg.norm(axis)
    c, s = np.cos(a), np.sin(a)
    C = 1 - c
    return np.asarray([
        [x * x * C + c, x * y * C - z * s, x * z * C + y * s],
        [y * x * C + z * s, y * y * C + c, y * z * C - x * s],
        [z * x * C - y * s, z * y * C + x * s, z * z * C + c]], np.float32)


def load_affine(e) -> np.ndarray:
    """AffineSpace element -> (3, 4) matrix (xml_loader.cpp:373-400)."""
    m = np.zeros((3, 4), np.float32)
    m[:, :3] = np.eye(3)
    if e is None:
        return m
    if e.get("translate"):
        m[:, 3] = _parm_vec3(e, "translate")
    elif e.get("scale"):
        m[:, :3] = np.diag(_parm_vec3(e, "scale"))
    elif e.get("rotate_x"):
        m[:, :3] = _rot(np.asarray([1., 0, 0]), float(e.get("rotate_x")))
    elif e.get("rotate_y"):
        m[:, :3] = _rot(np.asarray([0., 1, 0]), float(e.get("rotate_y")))
    elif e.get("rotate_z"):
        m[:, :3] = _rot(np.asarray([0., 0, 1]), float(e.get("rotate_z")))
    elif e.text and len((e.text or "").split()) == 12:
        # full row-major 3x4 body (xml_loader.cpp:399-404)
        b = np.asarray([float(x) for x in e.text.split()],
                       np.float32).reshape(3, 4)
        m[:, :] = b
    elif e.get("rotate"):
        # "axis_x axis_y axis_z degrees" is not in the grammar; the
        # reference uses rotate around axis via separate parms — fall
        # through to column text
        pass
    else:
        v = _floats(e)
        if v.size == 12:  # column-major LinearSpace + translation
            m[:, 0] = v[0:3]
            m[:, 1] = v[3:6]
            m[:, 2] = v[6:9]
            m[:, 3] = v[9:12]
        elif v.size == 16:
            m[:] = v.reshape(4, 4)[:3]
    return m


def _xfm_points(m: np.ndarray, p: np.ndarray) -> np.ndarray:
    return p @ m[:, :3].T + m[:, 3]


def _compose(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    out = np.zeros((3, 4), np.float32)
    out[:, :3] = a[:, :3] @ b[:, :3]
    out[:, 3] = a[:, :3] @ b[:, 3] + a[:, 3]
    return out


_MAT_CODES = {"Matte": MAT_MATTE, "Mirror": MAT_MIRROR, "OBJ": MAT_OBJ,
              "OBJMaterial": MAT_OBJ,
              "Dielectric": MAT_DIELECTRIC_SOLID,
              "ThinDielectric": MAT_DIELECTRIC, "ThinGlass": MAT_DIELECTRIC,
              "Metal": MAT_METAL, "ReflectiveMetal": MAT_REFLECTIVE_METAL,
              "Velvet": MAT_VELVET, "MetallicPaint": MAT_METALLIC_PAINT,
              "Hair": MAT_HAIR}


class XMLScene:
    """Parsed scene: flat geometry/material/light lists + camera."""

    def __init__(self):
        self.geometries = []   # [(TriangleMesh|QuadMesh|SubdivMesh, mat)]
        self.materials = [{"type": MAT_OBJ, "kd": (0.5, 0.5, 0.5)}]
        self.lights = []       # [dict(type=..., ...)]
        self.camera = None     # dict(from_, to, up, fov) | None


def _load_parms(e) -> dict:
    out = {}
    if e is None:
        return out
    for c in e:
        name = c.get("name", "")
        tag = c.tag if c.tag != "param" else c.get("type", "")
        if tag in ("float", "int"):
            out[name] = float(c.text)
        elif tag in ("float2", "float3", "float4", "int2", "int3", "int4"):
            out[name] = tuple(_floats(c).tolist())
    return out


class _Loader:
    def __init__(self, path: str):
        self.path = path
        self.base = os.path.dirname(path)
        self.scene = XMLScene()
        self.id_mat = {}    # xml id -> material index
        self.id_node = {}   # xml id -> node element (for <ref>)

    def material(self, e) -> int:
        if e is None:
            return 0
        mid = e.get("id", "")
        if mid and mid in self.id_mat:
            return self.id_mat[mid]
        code_e = e.find("code")
        code = (code_e.text or "").strip().strip('"') \
            if code_e is not None else "OBJ"
        parms = _load_parms(e.find("parameters"))
        mtype = _MAT_CODES.get(code, MAT_OBJ)
        m = {"type": mtype}
        for src, dst in (("Kd", "kd"), ("reflectance", "kd"), ("Ks", "ks"),
                         ("Ns", "ns"), ("d", "d"), ("Le", "le"),
                         ("eta", "eta"), ("etaOutside", "eta"),
                         ("k", "k"), ("roughness", "roughness")):
            if src in parms:
                m[dst] = parms[src]
        if mtype in (MAT_METAL, MAT_REFLECTIVE_METAL) and \
                "reflectance" in parms:
            # metal reflectance scales the specular lobe (MetalMaterial,
            # xml_loader.cpp:838-845)
            m["ks"] = parms["reflectance"]
            m.pop("kd", None)
        if mtype == MAT_DIELECTRIC_SOLID:
            # DielectricMaterial params (xml_loader.cpp:855-861):
            # interior/exterior ior + transmission, Medium-tracked
            m["eta"] = parms.get("etaInside", 1.4)
            m["eta_outside"] = parms.get("etaOutside", 1.0)
            m["transmission"] = parms.get("transmission", (1.0, 1.0, 1.0))
            m["transmission_outside"] = parms.get(
                "transmissionOutside", (1.0, 1.0, 1.0))
        if mtype == MAT_HAIR:
            # HairMaterial (xml_loader.cpp:871-877): AnisotropicBlinn
            # Kr/Kt lobes with (nx, ny) exponents
            m["ks"] = parms.get("Kr", (1.0, 1.0, 1.0))
            m["kd"] = parms.get("Kt", (0.0, 0.0, 0.0))
            m["ns"] = parms.get("nx", 20.0)
            m["roughness"] = parms.get("ny", 2.0)
        if mtype == MAT_VELVET:
            # VelvetMaterial params (xml_loader.cpp:849-852):
            # Minneart(reflectance, backScattering) +
            # Velvety(horizonScatteringColor, horizonScatteringFallOff)
            m["ks"] = parms.get("reflectance", (1.0, 1.0, 1.0))
            m["kd"] = parms.get("horizonScatteringColor", (1.0, 1.0, 1.0))
            m["ns"] = parms.get("horizonScatteringFallOff", 0.0)
            m["roughness"] = parms.get("backScattering", 0.0)
        idx = len(self.scene.materials)
        self.scene.materials.append(m)
        if mid:
            self.id_mat[mid] = idx
        return idx

    def node(self, e, xfm: np.ndarray):
        tag = e.tag
        if tag in ("scene", "Group", "group"):
            for c in e:
                self.node(c, xfm)
        elif tag in ("Transform", "Transform2", "MultiTransform"):
            kids = list(e)
            space = _compose(xfm, load_affine(kids[0]))
            for c in kids[1:]:
                self.node(c, space)
        elif tag == "TriangleMesh":
            mat = self.material(e.find("material"))
            pos = _xfm_points(xfm, _vec3_array(e.find("positions")))
            tris = _ints(e.find("triangles")).reshape(-1, 3)
            self.scene.geometries.append((TriangleMesh(pos, tris), mat))
        elif tag == "QuadMesh":
            mat = self.material(e.find("material"))
            pos = _xfm_points(xfm, _vec3_array(e.find("positions")))
            quads = _ints(e.find("indices")).reshape(-1, 4)
            self.scene.geometries.append((QuadMesh(pos, quads), mat))
        elif tag == "SubdivisionMesh":
            mat = self.material(e.find("material"))
            pos = _xfm_points(xfm, _vec3_array(e.find("positions")))
            faces = _ints(e.find("faces"))
            idx = _ints(e.find("position_indices"))
            ec = _ints(e.find("edge_creases")).reshape(-1, 2)
            ecw = _floats(e.find("edge_crease_weights"))
            vc = _ints(e.find("vertex_creases"))
            vcw = _floats(e.find("vertex_crease_weights"))
            self.scene.geometries.append((SubdivMesh(
                pos, faces, idx,
                edge_creases=ec if ec.size else None,
                edge_crease_weights=ecw if ecw.size else None,
                vertex_creases=vc if vc.size else None,
                vertex_crease_weights=vcw if vcw.size else None), mat))
        elif tag == "PointLight":
            space = _compose(xfm, load_affine(e.find("AffineSpace")))
            self.scene.lights.append(dict(
                type="point", position=tuple(space[:, 3].tolist()),
                intensity=tuple(_floats(e.find("I")).tolist())))
        elif tag == "DirectionalLight":
            space = _compose(xfm, load_affine(e.find("AffineSpace")))
            d = space[:, :3] @ np.asarray([0, 0, 1], np.float32)
            self.scene.lights.append(dict(
                type="directional", direction=tuple(d.tolist()),
                radiance=tuple(_floats(e.find("E")).tolist())))
        elif tag == "AmbientLight":
            self.scene.lights.append(dict(
                type="ambient", radiance=tuple(_floats(e.find("L")).tolist())))
        elif tag == "QuadLight":
            space = _compose(xfm, load_affine(e.find("AffineSpace")))
            corners = [_xfm_points(space, np.asarray([[x, y, 0.]],
                                                     np.float32))[0]
                       for x, y in ((0, 0), (0, 1), (1, 1), (1, 0))]
            self.scene.lights.append(dict(
                type="quad", corners=[tuple(c.tolist()) for c in corners],
                radiance=tuple(_floats(e.find("L")).tolist())))
        elif tag == "TriangleLight":
            space = _compose(xfm, load_affine(e.find("AffineSpace")))
            corners = [_xfm_points(space, np.asarray([[x, y, 0.]],
                                                     np.float32))[0]
                       for x, y in ((0, 0), (0, 1), (1, 0))]
            self.scene.lights.append(dict(
                type="triangle", corners=[tuple(c.tolist()) for c in corners],
                radiance=tuple(_floats(e.find("L")).tolist())))
        elif tag == "PerspectiveCamera":
            self.scene.camera = dict(
                from_=tuple(_parm_vec3(e, "from").tolist()),
                to=tuple(_parm_vec3(e, "to").tolist()),
                up=tuple(_parm_vec3(e, "up", (0, 1, 0)).tolist()),
                fov=float(e.get("fov", "90")))
        elif tag == "obj":
            sub, mats = load_obj(os.path.join(self.base, e.get("src", "")),
                                 subdiv_mode=e.get("subdiv") == "1")
            off = len(self.scene.materials)
            self.scene.materials.extend(mats)
            for g, m in sub:
                if not np.allclose(xfm[:, :3], np.eye(3)) or xfm[:, 3].any():
                    g.vertices = _xfm_points(xfm, np.asarray(g.vertices))
                self.scene.geometries.append((g, off + m))
        elif tag == "assign":
            if e.get("type") == "material":
                self.material(list(e)[0] if len(e) else None)
        elif tag == "ref":
            ref = self.id_node.get(e.get("id", ""))
            if ref is not None:
                self.node(ref, xfm)
        # remember ids for <ref>
        if e.get("id") and tag not in ("assign", "ref"):
            self.id_node[e.get("id")] = e


def light_table_from_xml(scene: XMLScene, *, device):
    """XMLScene light dicts -> render/lights.LightTable on `device` (the
    ISPCScene::convertLight analog, scene_device.cpp:75-125)."""
    ambient = (0.0, 0.0, 0.0)
    out = []
    for l in scene.lights:
        if l["type"] == "ambient":
            ambient = l["radiance"]
        elif l["type"] == "point":
            out.append({"type": LIGHT_POINT, "pos": l["position"],
                        "radiance": l["intensity"]})
        elif l["type"] == "directional":
            out.append({"type": LIGHT_DIRECTIONAL, "dir": l["direction"],
                        "radiance": l["radiance"]})
        elif l["type"] == "quad":
            c = [np.asarray(x, np.float32) for x in l["corners"]]
            out.append({"type": LIGHT_QUAD, "pos": tuple(c[0].tolist()),
                        "e1": tuple((c[1] - c[0]).tolist()),
                        "e2": tuple((c[3] - c[0]).tolist()),
                        "radiance": l["radiance"]})
    return make_light_table(out, ambient=ambient, device=device)


def load_xml(path: str) -> XMLScene:
    root = ET.parse(path).getroot()
    ld = _Loader(path)
    ident = np.zeros((3, 4), np.float32)
    ident[:, :3] = np.eye(3)
    ld.node(root, ident)
    return ld.scene


# ---------------------------------------------------------------------
# writer (xml_writer.cpp analog; text arrays only)

def _fmt(a: np.ndarray) -> str:
    return " ".join(f"{float(x):g}" if isinstance(x, (float, np.floating))
                    else str(int(x)) for x in np.asarray(a).ravel())


_MAT_NAMES = {MAT_MATTE: "Matte", MAT_MIRROR: "Mirror", MAT_OBJ: "OBJ",
              MAT_DIELECTRIC: "ThinDielectric",
              MAT_DIELECTRIC_SOLID: "Dielectric", MAT_EMITTER: "Matte",
              MAT_METAL: "Metal", MAT_REFLECTIVE_METAL: "ReflectiveMetal",
              MAT_VELVET: "Velvet", MAT_METALLIC_PAINT: "MetallicPaint",
              MAT_HAIR: "Hair"}


def write_xml(path: str, scene: XMLScene) -> None:
    root = ET.Element("scene")
    for geom, mi in scene.geometries:
        m = scene.materials[mi]
        if isinstance(geom, TriangleMesh):
            e = ET.SubElement(root, "TriangleMesh")
            arr, tag = geom.indices, "triangles"
        elif isinstance(geom, QuadMesh):
            e = ET.SubElement(root, "QuadMesh")
            arr, tag = geom.indices, "indices"
        elif isinstance(geom, SubdivMesh):
            e = ET.SubElement(root, "SubdivisionMesh")
            arr, tag = None, None
        else:
            continue
        me = ET.SubElement(e, "material")
        ET.SubElement(me, "code").text = f'"{_MAT_NAMES.get(m.get("type", MAT_OBJ), "OBJ")}"'
        pe = ET.SubElement(me, "parameters")
        if "kd" in m:
            f3 = ET.SubElement(pe, "float3", name="Kd")
            f3.text = _fmt(np.asarray(m["kd"], np.float32))
        ET.SubElement(e, "positions").text = _fmt(
            np.asarray(geom.vertices, np.float32))
        if arr is not None:
            ET.SubElement(e, tag).text = _fmt(np.asarray(arr, np.int32))
        else:
            ET.SubElement(e, "faces").text = _fmt(
                np.asarray(geom.face_counts, np.int32))
            ET.SubElement(e, "position_indices").text = _fmt(
                np.asarray(geom.face_indices, np.int32))
            if geom.edge_creases is not None:
                ET.SubElement(e, "edge_creases").text = _fmt(
                    np.asarray(geom.edge_creases, np.int32))
                ET.SubElement(e, "edge_crease_weights").text = _fmt(
                    np.asarray(geom.edge_crease_weights, np.float32))
            if geom.vertex_creases is not None:
                ET.SubElement(e, "vertex_creases").text = _fmt(
                    np.asarray(geom.vertex_creases, np.int32))
                ET.SubElement(e, "vertex_crease_weights").text = _fmt(
                    np.asarray(geom.vertex_crease_weights, np.float32))
    ET.indent(ET.ElementTree(root))
    ET.ElementTree(root).write(path)
