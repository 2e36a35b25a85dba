"""Watertightness of the port's quad and subdivision paths: the quad,
subdivision (eager and every compressed mode) and motion-blur
subdivision cases of tests/test_watertight_matrix.py (the reference's
WatertightTest, verify.cpp:2635-2712) through the plain versions of the
packet kernel (B2, quads and eager tessellations), the compressed
kernels (B4 for 'grid', 'box' and 'leaf'; the torch-op walk for 'full')
and the motion-blur kernel (B6). Rays start inside a closed surface in
random directions; a ray that slips through a seam misses. The
reference allows 0.002 % of 100,000 rays; here 100,000 rays a case and
none may miss (the triangle cases are tests/test_torch_watertight.py's)."""
import numpy as np
import pytest
import torch

import embree_tpu_torch as ett
from embree_tpu_torch.verify.fixtures import quad_sphere, subdiv_cube

CFG = "ignore_config_files=1"
N_RAYS = 100_000


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


def test_watertight_quads():
    verts, quads = quad_sphere((0, 0, 0), 2.0, 50)
    s = ett.Scene(ett.Device(CFG, device="cpu"))
    s.attach(ett.QuadMesh(verts, quads))
    s.commit()
    rays, _ = _inside_rays(N_RAYS)
    assert int((~s.intersect(rays).valid).sum()) == 0


def _subdiv_misses(accel):
    cfg = CFG + (f",subdiv_accel={accel}" if accel else "")
    s = ett.Scene(ett.Device(cfg, device="cpu"))
    s.attach(ett.SubdivMesh(*subdiv_cube()))
    s.set_levels(4, 2)
    cs = s.commit()
    assert (cs.compressed_kernel is not None) == (
        accel is not None and not accel.endswith("full"))
    rays, _ = _inside_rays(N_RAYS)
    return int((~s.intersect(rays).valid).sum())


def test_watertight_subdiv():
    """The eager tessellation (the packet kernel's plain version)."""
    assert _subdiv_misses(None) == 0


def test_watertight_subdiv_compressed():
    """Every compressed mode: B4's plain version for grid, box and leaf,
    the torch-op walk for full."""
    misses = {mode: _subdiv_misses(f"bvh4.compressed.{mode}")
              for mode in ("grid", "box", "leaf", "full")}
    assert misses == {"grid": 0, "box": 0, "leaf": 0, "full": 0}


def test_watertight_subdiv_motion_blur():
    v, counts, fidx = subdiv_cube()
    s = ett.Scene(ett.Device(CFG, device="cpu"))
    s.attach(ett.SubdivMeshMB(v, np.asarray(v) * 1.15, counts, fidx))
    s.set_levels(3, 2)
    s.commit()
    rays, rng = _inside_rays(N_RAYS)
    time = torch.from_numpy(rng.uniform(0, 1, N_RAYS).astype(np.float32))
    assert int((~s.intersect(rays, time=time).valid).sum()) == 0
