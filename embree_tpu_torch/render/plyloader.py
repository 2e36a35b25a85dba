"""Stanford PLY mesh loader
(tutorials/common/scenegraph/ply_loader.cpp analog).

Counterpart of embree_tpu/render/plyloader.py (host numpy, copied; the
arrays are byte-equal to the JAX package's).

Supports ascii and binary_little/big_endian formats, the standard
vertex properties (x/y/z, optional nx/ny/nz, u/v or s/t, colors are
skipped), and `face` elements with a `vertex_indices`/`vertex_index`
list property (fan-triangulated like the reference's convertTriangle
path). Parsed with numpy (vectorized binary decode via a structured
dtype when every vertex property is fixed-width).
"""
from __future__ import annotations

import numpy as np

from ..scene.geometry import TriangleMesh

_TYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def load_ply(path: str) -> TriangleMesh:
    with open(path, "rb") as f:
        line = f.readline().strip()
        if line != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # [(name, count, [(prop_name, dtype) | ("list", ...)])]
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            tok = line.decode("ascii", "replace").split()
            if not tok or tok[0] == "comment":
                continue
            if tok[0] == "format":
                fmt = tok[1]
            elif tok[0] == "element":
                elements.append((tok[1], int(tok[2]), []))
            elif tok[0] == "property":
                if tok[1] == "list":
                    elements[-1][2].append(
                        ("list", _TYPES[tok[2]], _TYPES[tok[3]], tok[4]))
                else:
                    elements[-1][2].append((tok[2], _TYPES[tok[1]]))
            elif tok[0] == "end_header":
                break

        endian = {"ascii": None, "binary_little_endian": "<",
                  "binary_big_endian": ">"}[fmt]

        verts = None
        faces = []
        for name, count, props in elements:
            fixed = all(p[0] != "list" for p in props)
            if fixed:
                if endian is None:
                    data = np.loadtxt(
                        (f.readline() for _ in range(count)),
                        dtype=np.float64, ndmin=2)
                else:
                    dt = np.dtype([(p[0], endian + p[1]) for p in props])
                    raw = np.frombuffer(f.read(dt.itemsize * count), dt)
                    data = np.stack(
                        [raw[p[0]].astype(np.float64) for p in props], 1)
                if name == "vertex":
                    cols = {p[0]: i for i, p in enumerate(props)}
                    verts = np.stack([data[:, cols["x"]], data[:, cols["y"]],
                                      data[:, cols["z"]]], 1)
            else:
                # list element (faces): per-row variable length
                if endian is None:
                    for _ in range(count):
                        nums = f.readline().split()
                        k = int(nums[0])
                        faces.append([int(x) for x in nums[1:1 + k]])
                else:
                    cdt = np.dtype(endian + props[0][1])
                    idt = np.dtype(endian + props[0][2])
                    for _ in range(count):
                        k = int(np.frombuffer(f.read(cdt.itemsize), cdt)[0])
                        faces.append(np.frombuffer(
                            f.read(idt.itemsize * k), idt).tolist())

    if verts is None:
        raise ValueError(f"{path}: no vertex element")
    tris = []
    for fc in faces:
        for k in range(1, len(fc) - 1):  # fan triangulation
            tris.append((fc[0], fc[k], fc[k + 1]))
    return TriangleMesh(np.asarray(verts, np.float32),
                        np.asarray(tris, np.int32).reshape(-1, 3))
