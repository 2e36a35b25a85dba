"""Wavefront OBJ/MTL loader (tutorials/common/scenegraph/obj_loader.cpp
analog; 618 LoC of C++ -> vectorized numpy parsing).

Host (numpy) copy of embree_tpu/render/objloader.py: the same
geometries, arrays and material dicts for the same file.

Supports v/vn/vt, f (triangulated by fanning), usemtl/mtllib, and the MTL
keys the reference maps onto OBJ materials (Kd/Ks/Ns/d/map ignored).
`subdiv_mode` loads faces as a SubdivMesh instead (obj_loader.cpp:528 —
the fork's viewer converts OBJ to subdivision surfaces when subdiv mode
is on, tutorial.cpp:1104)."""
from __future__ import annotations

import os

import numpy as np

from ..scene.geometry import SubdivMesh, TriangleMesh
from .materials import MAT_OBJ


def _load_image(path: str):
    from .image import load_image
    return load_image(path)


def load_mtl(path: str) -> dict:
    mats = {}
    cur = None
    base = os.path.dirname(path)
    if not os.path.exists(path):
        return mats
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok or tok[0].startswith("#"):
                continue
            if tok[0] == "newmtl":
                cur = tok[1]
                mats[cur] = {"type": MAT_OBJ, "kd": (1.0, 1.0, 1.0)}
            elif cur is None:
                continue
            elif tok[0] == "map_Kd":
                img = _load_image(os.path.join(base, tok[-1]))
                if img is not None:
                    mats[cur]["map_kd"] = img
            elif tok[0] in ("map_d", "d_map"):
                # opacity texture (obj_loader.cpp:409-411)
                img = _load_image(os.path.join(base, tok[-1]))
                if img is not None:
                    mats[cur]["map_d"] = img
            elif tok[0] in ("map_Displ", "Displ_map", "bumpMap", "map_bump",
                            "disp"):
                # displacement texture (obj_loader.cpp:423-425,450)
                img = _load_image(os.path.join(base, tok[-1]))
                if img is not None:
                    mats[cur]["map_displ"] = img
            elif tok[0] == "Kd":
                mats[cur]["kd"] = tuple(map(float, tok[1:4]))
            elif tok[0] == "Ks":
                mats[cur]["ks"] = tuple(map(float, tok[1:4]))
            elif tok[0] == "Ns":
                mats[cur]["ns"] = float(tok[1])
            elif tok[0] == "d":
                mats[cur]["d"] = float(tok[1])
            elif tok[0] == "Ni":
                mats[cur]["eta"] = float(tok[1])
            elif tok[0] == "Ke":
                mats[cur]["le"] = tuple(map(float, tok[1:4]))
    return mats


def load_obj(path: str, subdiv_mode: bool = False):
    """Returns (geometries, materials): geometries is a list of
    (TriangleMesh|SubdivMesh, material_index); materials a list of dicts
    for make_material_table."""
    verts = []
    texcoords = []
    faces = []          # list of (index list, texcoord index list, mat id)
    mats = [{"type": MAT_OBJ, "kd": (1.0, 1.0, 1.0)}]  # OBJMaterial() default Kd=1 (materials.h:117)
    mat_index = {None: 0}
    cur_mat = 0

    base = os.path.dirname(path)
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok or tok[0].startswith("#"):
                continue
            if tok[0] == "v":
                verts.append(tuple(map(float, tok[1:4])))
            elif tok[0] == "vt":
                texcoords.append(tuple(map(float, tok[1:3])))
            elif tok[0] == "mtllib":
                loaded = load_mtl(os.path.join(base, tok[1]))
                for name, m in loaded.items():
                    if name not in mat_index:
                        mat_index[name] = len(mats)
                        mats.append(m)
            elif tok[0] == "usemtl":
                cur_mat = mat_index.get(tok[1], 0)
            elif tok[0] == "f":
                parts = [t.split("/") for t in tok[1:]]
                idx = [int(p[0]) for p in parts]
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                ti = [int(p[1]) - 1 if len(p) > 1 and p[1] else -1
                      for p in parts]
                faces.append((idx, ti, cur_mat))

    verts = np.asarray(verts, np.float32)
    texcoords = np.asarray(texcoords, np.float32) if texcoords \
        else np.zeros((0, 2), np.float32)
    geometries = []

    # group faces by material -> one geometry per material (the reference
    # scene graph's per-material meshes)
    by_mat = {}
    for idx, ti, m in faces:
        by_mat.setdefault(m, []).append((idx, ti))

    for m, fl in sorted(by_mat.items()):
        if subdiv_mode:
            counts = np.asarray([len(x[0]) for x in fl], np.int32)
            flat = np.asarray([i for x in fl for i in x[0]], np.int32)
            geometries.append((SubdivMesh(verts, counts, flat), m))
        else:
            tris = []
            tri_uv = []
            for idx, ti in fl:
                for k in range(1, len(idx) - 1):  # fan triangulation
                    tris.append((idx[0], idx[k], idx[k + 1]))
                    uv3 = []
                    for j in (0, k, k + 1):
                        if 0 <= ti[j] < len(texcoords):
                            uv3.append(texcoords[ti[j]])
                        else:
                            uv3.append((0.0, 0.0))
                    tri_uv.append(uv3)
            mesh = TriangleMesh(verts, np.asarray(tris, np.int32))
            mesh.texcoords = np.asarray(tri_uv, np.float32)  # (T, 3, 2)
            geometries.append((mesh, m))

    return geometries, mats
