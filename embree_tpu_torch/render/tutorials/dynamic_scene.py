"""dynamic_scene tutorial: the animated sphere mesh.

Counterpart of embree_tpu/render/tutorials/dynamic_scene.py
(tutorials/dynamic_scene/dynamic_scene_device.cpp). So far only the
sphere generator, which `instanced_geometry` shares: the tutorial's app
recommits every frame at build qualities REFIT and MEDIUM in turn, and
REFIT (with the LBVH of quality LOW) is not ported yet.
"""
from __future__ import annotations

import numpy as np

NUM_PHI = 8
NUM_THETA = 16


def _sphere(pos, r, phase, time):
    """Triangulated sphere with the animated y-wobble (animateSphere,
    dynamic_scene_device.cpp:165-215): (vertices (V, 3) f32, triangles
    (T, 3) i32), the JAX package's arrays byte for byte."""
    phi = np.linspace(0, np.pi, NUM_PHI + 1)
    theta = np.linspace(0, 2 * np.pi, NUM_THETA, endpoint=False)
    P, T = np.meshgrid(phi, theta, indexing="ij")
    x = pos[0] + r * np.sin(P) * np.sin(T)
    y = pos[1] + r * np.cos(P) + 0.5 * r * np.sin(phase + time)
    z = pos[2] + r * np.sin(P) * np.cos(T)
    verts = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
    tris = []
    for i in range(NUM_PHI):
        for j in range(NUM_THETA):
            jn = (j + 1) % NUM_THETA
            a = i * NUM_THETA + j
            b = i * NUM_THETA + jn
            c = (i + 1) * NUM_THETA + j
            d = (i + 1) * NUM_THETA + jn
            if i > 0:
                tris.append((a, b, c))
            if i < NUM_PHI - 1:
                tris.append((b, d, c))
    return verts, np.asarray(tris, np.int32)
