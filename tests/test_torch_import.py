"""The PyTorch port stands alone: embree_tpu_torch and chip_smoke.py
import neither jax nor the JAX package, the Device refuses to run on a
card that is not there, and the kernel wrapper takes its plain version
for CPU tensors only."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import embree_tpu_torch as ett
from embree_tpu_torch.build.treelets import build_treelet_scene
from embree_tpu_torch.traverse import rowtrace2 as rt2
from embree_tpu_torch.verify.fixtures import triangle_sphere

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "embree_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "embree_tpu")


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _dirs, files in os.walk(PKG):
        out += [os.path.join(base, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    """Top-level package of every absolute import in the file."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_sources_import_no_jax():
    files = _port_sources()
    assert len(files) > 30
    for path in files:
        bad = _imported_roots(path) & set(FORBIDDEN)
        assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_import_and_tiny_scene_pull_in_no_jax():
    """In a fresh interpreter: import the port, commit and query a tiny
    CPU scene; neither jax nor embree_tpu may have been imported."""
    code = (
        "import sys, numpy as np\n"
        "import embree_tpu_torch as ett\n"
        "from embree_tpu_torch.verify.fixtures import triangle_sphere\n"
        "dev = ett.Device('ignore_config_files=1', device='cpu')\n"
        "sc = ett.Scene(dev)\n"
        "sc.attach(ett.TriangleMesh(*triangle_sphere((0, 0, 0), 1.0, 8)))\n"
        "sc.commit()\n"
        "rays = ett.make_rays(np.array([[0., 0., -3.], [5., 5., -3.]]),\n"
        "                     np.array([[0., 0., 1.], [0., 0., 1.]]),\n"
        "                     device='cpu')\n"
        "h = sc.intersect(rays)\n"
        "assert h.valid.tolist() == [True, False], h.valid\n"
        "assert abs(float(h.t[0]) - 2.0) < 0.05, h.t\n"
        "assert sc.occluded(rays).tolist() == [True, False]\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'embree_tpu')]\n"
        "assert not bad, bad\n"
        "print('PORT_OK')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "PORT_OK" in out.stdout


def test_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(ett.RaytracerError) as e:
        ett.Device("ignore_config_files=1")
    assert e.value.code == ett.Error.INVALID_OPERATION
    with pytest.raises(ett.RaytracerError):
        ett.Device("ignore_config_files=1", device="cuda")


def test_device_cpu_and_config_string():
    dev = ett.Device("ignore_config_files=1,verbose=0,backface_culling=1,"
                     "frobnicate=3", device="cpu")
    assert dev.device == torch.device("cpu")
    assert dev.state.backface_culling is True
    assert dev.state.unknown == {"frobnicate": "3"}
    with pytest.raises(ett.RaytracerError):
        dev.raise_error(ett.Error.INVALID_ARGUMENT, "x")
    assert dev.get_error() == ett.Error.INVALID_ARGUMENT
    assert dev.get_error() == ett.Error.NONE


def test_cpu_tensors_take_plain_version_without_a_launch(monkeypatch):
    """On CPU tensors the wrapper runs rowtrace2_plain and neither builds
    nor launches the kernel."""
    verts, idx = triangle_sphere((0, 0, 0), 1.0, 8)
    v = verts[idx]
    ts = build_treelet_scene(v[:, 0], v[:, 1], v[:, 2], np.arange(len(idx)),
                             fan=4).to_device("cpu")
    rays = ett.make_rays(np.array([[0., 0., -3.]]), np.array([[0., 0., 1.]]),
                         device="cpu")

    def no_kernel(*a, **k):
        raise AssertionError("the kernel path was taken for a CPU tensor")

    monkeypatch.setattr(rt2, "_load_kernel", no_kernel)
    monkeypatch.setattr(rt2, "_launch", no_kernel)
    before = rt2.launches
    t, prim = rt2.intersect_rowtrace2(ts, rays)
    assert rt2.launches == before
    assert prim.item() >= 0 and abs(t.item() - 2.0) < 0.05
    with pytest.raises(ValueError):
        rt2.rowtrace2_stats(ts, rays)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    verts, idx = triangle_sphere((0, 0, 0), 1.0, 8)
    v = verts[idx]
    ts = build_treelet_scene(v[:, 0], v[:, 1], v[:, 2], np.arange(len(idx)),
                             fan=4).to_device("cpu")
    org = torch.zeros((4, 3))
    d = torch.ones((4, 3))
    tn = torch.zeros(4)
    tf = torch.full((4,), float("inf"))
    rt2.intersect_rowtrace2(ts, ett.Rays(org, d, tn, tf))
    with pytest.raises(ValueError, match="dtype"):
        rt2.intersect_rowtrace2(ts, ett.Rays(org.double(), d, tn, tf))
    with pytest.raises(ValueError, match="contiguous"):
        rt2.intersect_rowtrace2(ts, ett.Rays(org, d, tn,
                                             tf[:1].expand(4)))
    with pytest.raises(ValueError, match="shape"):
        rt2.intersect_rowtrace2(ts, ett.Rays(org, d[:2], tn, tf))
    with pytest.raises(ValueError, match="fan"):
        rt2.intersect_rowtrace2(ts._replace(fan=200),
                                ett.Rays(org, d, tn, tf))


def test_no_try_around_the_launch():
    """A CUDA tensor launches the kernel or raises: the traversal module
    and the scene contain no `try` at all that could give way to another
    path."""
    for rel in ("traverse/rowtrace2.py", "traverse/packet_kernel.py",
                "core/nvcc.py", "scene/scene.py", "traverse/packet.py",
                "traverse/stream.py", "diff/hit.py", "convert.py"):
        with open(os.path.join(PKG, rel)) as f:
            tree = ast.parse(f.read())
        tries = [n for n in ast.walk(tree) if isinstance(n, ast.Try)]
        assert not tries, f"{rel} has a try statement"
    for rel in ("rowtrace2.py", "packet_kernel.py"):
        with open(os.path.join(PKG, "traverse", rel)) as f:
            assert "torch.compile" not in f.read()
