"""Watertightness of the port's triangle kernels: the triangle and
motion-blur triangle cases of tests/test_watertight_matrix.py (the
reference's WatertightTest, verify.cpp:2635-2712) through the plain
versions of B2 (packet), B1 (rowtrace2) and the redesigned B6 (motion
blur: lerped node boxes, nearest child first). Rays start at the centre
of a closed sphere in random directions; a ray that slips between two
triangles sharing an edge misses. The reference allows 0.002 % over
100,000 rays; here 10,000 rays each, and none may miss."""
import numpy as np
import pytest
import torch

import embree_tpu_torch as ett
from embree_tpu_torch.traverse.rowtrace2 import intersect_rowtrace2
from embree_tpu_torch.verify.fixtures import triangle_sphere

CFG = "ignore_config_files=1"
N_RAYS = 10_000


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inside_rays(n):
    rng = np.random.default_rng(0x3A7)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return ett.make_rays(np.zeros((n, 3), np.float32), d, device="cpu"), rng


@pytest.mark.parametrize("kernel", ["packet", "rowtrace2"])
def test_watertight_triangles(kernel):
    verts, idx = triangle_sphere((0, 0, 0), 2.0, 60)
    sc = ett.Scene(ett.Device(CFG + ",tri_accel=bvh4.triangle4.rowtrace",
                              device="cpu"))
    sc.attach(ett.TriangleMesh(verts, idx))
    cs = sc.commit()
    rays, _ = _inside_rays(N_RAYS)
    if kernel == "packet":
        valid = sc.intersect(rays).valid
    else:
        valid = intersect_rowtrace2(cs.rowtrace, rays)[1] >= 0
    assert int((~valid).sum()) == 0


def test_watertight_motion_blur():
    verts, idx = triangle_sphere((0, 0, 0), 2.0, 40)
    sc = ett.Scene(ett.Device(CFG, device="cpu"))
    sc.attach(ett.TriangleMeshMB(verts, verts + np.float32([0.3, 0, 0]),
                                 idx))
    sc.commit()
    rays, rng = _inside_rays(N_RAYS)
    time = torch.from_numpy(rng.uniform(0, 1, N_RAYS).astype(np.float32))
    h = sc.intersect(rays, time=time)
    assert int((~h.valid).sum()) == 0
