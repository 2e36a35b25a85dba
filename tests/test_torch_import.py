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
from embree_tpu_torch.traverse import cbvh_kernel as ck
from embree_tpu_torch.traverse import rowtrace2 as rt2
from embree_tpu_torch.verify.fixtures import subdiv_cube, triangle_sphere

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
        "import embree_tpu_torch.rtcore as rtc\n"
        "from embree_tpu_torch.render.tutorials import (\n"
        "    instanced_geometry, user_geometry, lazy_geometry,\n"
        "    intersection_filter, bvh_builder, bvh_access)\n"
        "top = ett.Scene(dev)\n"
        "top.attach(ett.Instance(sc, np.eye(3, 4) * 2))\n"
        "top.commit()\n"
        "assert top.intersect(rays).inst_id.tolist() == [0, -1]\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'embree_tpu')]\n"
        "assert not bad, bad\n"
        "print('PORT_OK')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "PORT_OK" in out.stdout


def test_subdiv_scene_and_tutorial_pull_in_no_jax():
    """In a fresh interpreter: commit a compressed subdivision scene on
    the CPU, query it, and render the displacement tutorial's scene."""
    code = (
        "import sys, numpy as np\n"
        "import embree_tpu_torch as ett\n"
        "from embree_tpu_torch.verify.fixtures import subdiv_cube\n"
        "from embree_tpu_torch.render.camera import Camera\n"
        "from embree_tpu_torch.render.tutorials import (\n"
        "    displacement_geometry as dg)\n"
        "dev = ett.Device('ignore_config_files=1,'\n"
        "                 'subdiv_accel=bvh4.compressed.leaf', device='cpu')\n"
        "sc = ett.Scene(dev)\n"
        "sc.attach(ett.SubdivMesh(*subdiv_cube()))\n"
        "sc.set_levels(3, 2)\n"
        "sc.commit()\n"
        "rays = ett.make_rays(np.array([[0., 0., -3.], [5., 5., -3.]]),\n"
        "                     np.array([[0., 0., 1.], [0., 0., 1.]]),\n"
        "                     device='cpu')\n"
        "h = sc.intersect(rays)\n"
        "assert h.valid.tolist() == [True, False], h.valid\n"
        "assert 1.5 < float(h.t[0]) < 2.6, h.t\n"
        "assert sc.occluded(rays).tolist() == [True, False]\n"
        "st = dg.build_scene('bvh4.compressed.box', 2, 2,\n"
        "                    rtcore='device=cpu')\n"
        "img, _ = dg.render_frame(st, Camera(from_=(2.5, 2.5, 2.5),\n"
        "                                    to=(0, 0, 0)), (16, 12))\n"
        "assert img.shape == (12, 16, 3) and float(img.max()) > 0\n"
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


def test_compressed_wrappers_take_plain_versions_without_a_launch(
        monkeypatch):
    """On CPU tensors the compressed wrappers run their plain versions
    and neither build nor launch a kernel; the scene's entry points go
    through the wrappers."""
    s = ett.Scene(ett.Device(
        "ignore_config_files=1,subdiv_accel=bvh4.compressed.grid",
        device="cpu"))
    s.attach(ett.SubdivMesh(*subdiv_cube()))
    s.set_levels(2, 2)
    s.commit()
    pc = s.committed.compressed_kernel
    rays = ett.make_rays(np.array([[0., 0., -3.]]), np.array([[0., 0., 1.]]),
                         device="cpu")

    def no_kernel(*a, **k):
        raise AssertionError("the kernel path was taken for a CPU tensor")

    monkeypatch.setattr(ck, "_load_kernel", no_kernel)
    before = dict(ck.launches)
    t, _u, _v, tile, stats = ck.cbvh_trace(pc, rays)
    occ, _ = ck.cbvh_occluded_trace(pc, rays)
    assert tile.item() >= 0 and 1.5 < t.item() < 2.6 and stats is None
    assert occ.item() and s.intersect(rays).valid.item()
    assert s.occluded(rays).item()
    assert ck.launches == before == {"closest": 0, "occluded": 0}


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
                "traverse/stream.py", "diff/hit.py", "convert.py",
                "traverse/cbvh.py", "traverse/cbvh_kernel.py",
                "scene/subdiv_accel.py",
                "render/tutorials/displacement_geometry.py",
                "traverse/mb.py", "traverse/mb_kernel.py", "build/refit.py",
                "render/tutorials/motion_blur_geometry.py",
                "traverse/hair_kernel.py", "traverse/hair.py",
                "traverse/user.py", "scene/curves.py", "build/hair.py",
                "render/tutorials/hair_geometry.py",
                "render/tutorials/curve_geometry.py",
                "build/twolevel.py", "build/user_builder.py", "rtcore.py",
                "render/tutorials/instanced_geometry.py",
                "render/tutorials/user_geometry.py",
                "render/tutorials/lazy_geometry.py",
                "render/tutorials/intersection_filter.py",
                "render/materials.py", "render/lights.py",
                "render/xmlloader.py", "render/plyloader.py",
                "render/coronaloader.py", "render/tutorials/pathtracer.py",
                "render/tutorials/convert.py", "render/tutorials/viewer.py",
                "render/tutorials/viewer_stream.py"):
        with open(os.path.join(PKG, rel)) as f:
            tree = ast.parse(f.read())
        tries = [n for n in ast.walk(tree) if isinstance(n, ast.Try)]
        assert not tries, f"{rel} has a try statement"
    for rel in ("rowtrace2.py", "packet_kernel.py", "cbvh.py",
                "cbvh_kernel.py", "mb.py", "mb_kernel.py", "hair_kernel.py",
                "hair.py", "user.py"):
        with open(os.path.join(PKG, "traverse", rel)) as f:
            assert "torch.compile" not in f.read()


def test_hair_wrapper_launches_or_raises_and_takes_plain_on_cpu(monkeypatch):
    """Kernel B3's wrapper: CPU tensors run hair_plain without building or
    launching anything; tensors on another device go to the kernel (here
    a stand-in that raises), never quietly to the plain version."""
    from embree_tpu_torch.traverse import hair_kernel as hk
    cps = np.array([[[0, 0, 0], [0, 0.3, 0], [0, 0.6, 0], [0, 1, 0]]],
                   np.float32)
    rad = np.full((1, 4), 0.1, np.float32)
    ph = hk.pack_hair_cluster(cps, rad, 4, False, "cpu")
    rays = ett.make_rays(np.array([[0., 0.5, 3.]]), np.array([[0., 0., -1.]]),
                         device="cpu")

    class Refused(Exception):
        pass

    def no_kernel(*a, **k):
        raise Refused

    monkeypatch.setattr(hk, "_load_kernel", no_kernel)
    before = dict(hk.launches)
    t, slot, _ = hk.hair_trace(ph, rays)
    assert slot.item() >= 0 and abs(t.item() - 2.9) < 1e-3
    assert hk.occluded_hair_kernel(ph, rays.org, rays.dir, rays.tnear,
                                   rays.tfar).item()
    assert hk.launches == before
    meta = hk.PackedHair(*(a.to("meta") if isinstance(a, torch.Tensor)
                           else a for a in ph))
    mrays = ett.Rays(*(a.to("meta") for a in rays))
    for occluded in (False, True):
        with pytest.raises(Refused):
            hk.hair_trace(meta, mrays, occluded)


def test_hair_scene_and_tutorials_pull_in_no_jax():
    """In a fresh interpreter: commit and query hair, line segments and
    motion-blur curves on the CPU and render both curve tutorials."""
    code = (
        "import sys, numpy as np\n"
        "import embree_tpu_torch as ett\n"
        "from embree_tpu_torch.render.camera import Camera\n"
        "from embree_tpu_torch.render.tutorials import hair_geometry as hg\n"
        "from embree_tpu_torch.render.tutorials import curve_geometry as cg\n"
        "dev = ett.Device('ignore_config_files=1', device='cpu')\n"
        "cp = np.array([[0, -1, 0, .2], [0, -.3, 0, .2], [0, .3, 0, .2],\n"
        "               [0, 1, 0, .2]], np.float32)\n"
        "rays = ett.make_rays(np.array([[0., 0., 3.], [5., 5., 3.]]),\n"
        "                     np.array([[0., 0., -1.], [0., 0., -1.]]),\n"
        "                     device='cpu')\n"
        "for g in (ett.BezierCurves(cp, [0]), ett.BezierCurves(cp, [0],\n"
        "          flat=True), ett.BSplineCurves(cp, [0]),\n"
        "          ett.LineSegments(cp, [1])):\n"
        "    sc = ett.Scene(dev)\n"
        "    sc.attach(g)\n"
        "    sc.commit()\n"
        "    h = sc.intersect(rays)\n"
        "    assert h.valid.tolist() == [True, False], (g, h.valid)\n"
        "    assert sc.occluded(rays).tolist() == [True, False]\n"
        "sc = ett.Scene(dev)\n"
        "sc.attach(ett.BezierCurvesMB(cp, cp + np.float32([2, 0, 0, 0]),\n"
        "                             indices=[0]))\n"
        "sc.commit()\n"
        "assert sc.intersect(rays, time=0.0).valid.tolist() == [True, False]\n"
        "assert not sc.intersect(rays, time=1.0).valid.any()\n"
        "for mod in (hg, cg):\n"
        "    st = mod.build_scene(dev)\n"
        "    img, _ = mod.render_frame(st, mod.make_app().camera, (16, 12))\n"
        "    assert img.shape == (12, 16, 3) and float(img.max()) > 0\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'embree_tpu')]\n"
        "assert not bad, bad\n"
        "print('PORT_OK')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "PORT_OK" in out.stdout


def test_pathtracer_loaders_and_tools_pull_in_no_jax():
    """In a fresh interpreter: import every module of the pathtracer
    slice, load an XML scene, render it and the Cornell box through the
    pathtracer on the CPU, open it in the viewer and viewer_stream, and
    write it back through the convert tool."""
    code = (
        "import sys, os, tempfile\n"
        "import embree_tpu_torch as ett\n"
        "from embree_tpu_torch.render import (materials, lights, xmlloader,\n"
        "    plyloader, coronaloader)\n"
        "from embree_tpu_torch import convert\n"
        "from embree_tpu_torch.render.camera import Camera\n"
        "from embree_tpu_torch.render.tutorials import (pathtracer as pt,\n"
        "    viewer, viewer_stream, convert as tool)\n"
        "xml = os.path.join('tests', 'golden', 'glass_sphere.xml')\n"
        "dev = ett.Device('ignore_config_files=1', device='cpu')\n"
        "for st in (pt.build_cornell_scene(dev),\n"
        "           pt.build_xml_scene(xmlloader.load_xml(xml), dev)):\n"
        "    img, rays = pt.render_frame(st, Camera(from_=(0.5, 1, 2.4),\n"
        "                                to=(0.5, 0.5, 0)), (8, 6), spp=1)\n"
        "    assert img.shape == (6, 8, 3) and rays > 0\n"
        "st = viewer.build_scene(xml, rtcore='device=cpu')\n"
        "a, _ = viewer.render_frame(st, Camera(from_=(0, 1.2, 2.6),\n"
        "                           to=(0, 0.6, 0)), (8, 6))\n"
        "b, _ = viewer_stream.render_frame(st, Camera(from_=(0, 1.2, 2.6),\n"
        "                                  to=(0, 0.6, 0)), (8, 6))\n"
        "assert float(a.max()) > 0 and float(b.max()) > 0\n"
        "out = os.path.join(tempfile.mkdtemp(), 'o.xml')\n"
        "assert tool.main(['-i', xml, '-o', out]) == 0\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'embree_tpu')]\n"
        "assert not bad, bad\n"
        "print('PORT_OK')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "PORT_OK" in out.stdout
