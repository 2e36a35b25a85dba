"""Procedural 3D gradient noise matching the reference tutorials.

Host (numpy) copy of embree_tpu/render/noise.py: a vectorized
re-implementation of the tutorial noise
(tutorials/common/tutorial/noise.cpp). The permutation/gradient tables
come from data extracted out of the reference (noise_tables.npz, this
package's own copy beside this file, read once at import into `P_TABLE`
and `G3`) so the displacement_geometry tutorial produces the same
displaced surface.
"""
from __future__ import annotations

import functools
import os

import numpy as np

TABLES_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "noise_tables.npz")


@functools.cache
def noise_tables():
    """(P_TABLE (513,) i64, G3 (128, 3) f32), read once."""
    with np.load(TABLES_PATH) as tables:
        return (tables["p"].astype(np.int64), tables["g3"].astype(np.float32))


P_TABLE, G3 = noise_tables()    # (513,) i64, (128, 3) f32


def _fade(t):
    return (t * t * t) * (t * (t * 6 - 15) + 10)


def noise3(pos: np.ndarray) -> np.ndarray:
    """noise(Vec3fa) (noise.cpp:125-160), vectorized over (..., 3)."""
    pos = np.asarray(pos, np.float32)
    x, y, z = pos[..., 0], pos[..., 1], pos[..., 2]
    fx, fy, fz = np.floor(x), np.floor(y), np.floor(z)
    X = fx.astype(np.int64) & 255
    Y = fy.astype(np.int64) & 255
    Z = fz.astype(np.int64) & 255
    x = x - fx
    y = y - fy
    z = z - fz
    u, v, w = _fade(x), _fade(y), _fade(z)

    # index chain exactly as noise.cpp:146-156
    p, g3 = P_TABLE, G3
    p00 = p[X] + Y
    p000 = p[p00] + Z
    p010 = p[p00 + 1] + Z
    p001 = p000 + 1
    p011 = p010 + 1
    p10 = p[X + 1] + Y
    p100 = p[p10] + Z
    p110 = p[p10 + 1] + Z
    p101 = p100 + 1
    p111 = p110 + 1

    def grad(h, gx, gy, gz):
        g = g3[p[h] & 127]
        return gx * g[..., 0] + gy * g[..., 1] + gz * g[..., 2]

    g000 = grad(p000, x, y, z)
    g100 = grad(p100, x - 1, y, z)
    g010 = grad(p010, x, y - 1, z)
    g110 = grad(p110, x - 1, y - 1, z)
    g001 = grad(p001, x, y, z - 1)
    g101 = grad(p101, x - 1, y, z - 1)
    g011 = grad(p011, x, y - 1, z - 1)
    g111 = grad(p111, x - 1, y - 1, z - 1)

    def lerp(t, a, b):
        return a + t * (b - a)

    return lerp(w,
                lerp(v, lerp(u, g000, g100), lerp(u, g010, g110)),
                lerp(v, lerp(u, g001, g101), lerp(u, g011, g111)))


def fbm_displacement(p: np.ndarray) -> np.ndarray:
    """displacement() from displacement_geometry_device.cpp:88-95:
    dN = sum over freq in 1,2,4,...,32 of 1.4*|noise(freq*P)|^2/freq."""
    dn = np.zeros(p.shape[:-1], np.float32)
    freq = 1.0
    while freq < 40.0:
        n = np.abs(noise3(freq * p))
        dn += 1.4 * n * n / freq
        freq *= 2.0
    return dn
