"""The port's render layer (camera, image I/O, tutorial application,
`triangle_geometry`) against the JAX package's and against the reference
renderer's own image.

Tolerances: camera vectors and ray directions 1e-6 absolute; the frame
1e-5 absolute except on silhouette pixels, where a primary or shadow ray
grazes an edge and the two packages' float32 roundings pick different
sides (counted, at most 1 % of the frame); against the reference
renderer's 128x128 image the budget of the JAX package's own golden
test (0.5 % of the pixels beyond 1.5/255)."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import embree_tpu_torch as ett
from embree_tpu.render import camera as ref_camera
from embree_tpu.render import image as ref_image
from embree_tpu.render.tutorials import triangle_geometry as ref_tg
from embree_tpu_torch.render import camera as port_camera
from embree_tpu_torch.render import image as port_image
from embree_tpu_torch.render.tutorial_app import TutorialApplication
from embree_tpu_torch.render.tutorials import triangle_geometry as port_tg
from embree_tpu_torch.traverse import packet_kernel as pk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden",
                      "ref_triangle_geometry_128.pfm")
VIEW = dict(from_=(1.5, 1.5, -1.5), to=(0, 0, 0))


@pytest.fixture(scope="module")
def port_state():
    return port_tg.build_scene(ett.Device("ignore_config_files=1",
                                          device="cpu"))


@pytest.mark.parametrize("right_handed", [True, False])
def test_camera_matches_reference(right_handed):
    kw = dict(from_=(1.5, 1.2, -1.5), to=(0.1, 0, 0.2), up=(0, 1, 0),
              fov=70.0, right_handed=right_handed)
    ref = ref_camera.Camera(**kw)
    cam = port_camera.Camera(**kw)
    for a, b in zip(cam.ispc_camera(96, 64, device="cpu"),
                    ref.ispc_camera(96, 64)):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=1e-6)
    rr = ref_camera.primary_rays(ref, 96, 64, tnear=0.1, tfar=50.0)
    pr = port_camera.primary_rays(cam, 96, 64, tnear=0.1, tfar=50.0,
                                  device="cpu")
    assert pr.batch_shape == (64, 96)
    np.testing.assert_allclose(pr.dir.numpy(), np.asarray(rr.dir), atol=1e-6)
    np.testing.assert_array_equal(pr.org.numpy(), np.asarray(rr.org))
    np.testing.assert_array_equal(pr.tnear.numpy(), np.asarray(rr.tnear))
    np.testing.assert_array_equal(pr.tfar.numpy(), np.asarray(rr.tfar))


def test_pixel_orders_match_reference():
    for w, h in ((7, 5), (64, 48)):
        perm, inv = port_camera.pixel_morton_order(w, h)
        rperm, rinv = ref_camera.pixel_morton_order(w, h)
        np.testing.assert_array_equal(perm, rperm)
        np.testing.assert_array_equal(inv, rinv)
        tperm, tinv = port_camera.pixel_morton_order_device(w, h, "cpu")
        assert torch.equal(tperm[tinv], torch.arange(w * h))
        x, y = port_camera.pixel_coords(w, h, tperm, device="cpu")
        rx, ry = ref_camera.pixel_coords(w, h, np.asarray(rperm))
        np.testing.assert_array_equal(x.numpy(), np.asarray(rx))
        np.testing.assert_array_equal(y.numpy(), np.asarray(ry))
        x, y = port_camera.pixel_coords(w, h, device="cpu")
        rx, ry = ref_camera.pixel_coords(w, h)
        np.testing.assert_array_equal(x.numpy(), np.asarray(rx))
        np.testing.assert_array_equal(y.numpy(), np.asarray(ry))


def test_frame_matches_reference_package(port_state):
    ref_state = ref_tg.build_scene()
    ref_img, ref_n = ref_tg.render_frame(
        ref_state, ref_camera.Camera(**VIEW), (64, 64))
    ref_img = np.asarray(ref_img)
    before = pk.launches
    img, n = port_tg.render_frame(port_state, port_camera.Camera(**VIEW),
                                  (64, 64))
    assert pk.launches == before               # CPU tensors: no launch
    assert isinstance(img, torch.Tensor) and img.dtype == torch.float32
    img = img.numpy()
    assert img.shape == ref_img.shape == (64, 64, 3) and n == ref_n
    assert np.isfinite(img).all() and img.max() <= 1.5 and img.min() >= 0.0
    diff = np.abs(img - ref_img).max(-1)
    silhouette = int((diff > 1e-5).sum())
    assert silhouette <= 0.01 * 64 * 64, silhouette
    # the cube's faces, the shadowed and the lit floor are all there
    colors = {tuple(np.round(c, 3)) for c in img.reshape(-1, 3)}
    assert (0.0, 0.0, 0.0) in colors and (0.5, 0.0, 0.0) in colors
    assert len(colors) >= 5


def test_frame_matches_reference_renderer(port_state):
    """The gate of the JAX package's own golden test
    (tests/test_ref_golden.py) on the port's frame."""
    img, _ = port_tg.render_frame(port_state, port_camera.Camera(**VIEW),
                                  (128, 128))
    ref = port_image.read_pfm(GOLDEN)
    quant = np.floor(255.0 * np.clip(img.numpy(), 0.0, 1.0)) / 255.0
    diff = np.abs(quant - ref).max(-1)
    frac = float((diff > 1.5 / 255).mean())
    assert frac <= 0.005, f"{frac:.4%} of the pixels differ"


def test_image_io_byte_equal(tmp_path, rng):
    img = rng.uniform(-0.2, 1.2, (13, 17, 3)).astype(np.float32)
    np.testing.assert_array_equal(port_image.to_u8(img), ref_image.to_u8(img))
    for name in ("write_ppm", "write_pfm"):
        a, b = tmp_path / f"port_{name}", tmp_path / f"ref_{name}"
        getattr(port_image, name)(str(a), img)
        getattr(ref_image, name)(str(b), img)
        assert a.read_bytes() == b.read_bytes()
    ppm = str(tmp_path / "port_write_ppm")
    np.testing.assert_array_equal(port_image.read_ppm(ppm),
                                  ref_image.read_ppm(ppm))
    np.testing.assert_array_equal(port_image.read_ppm(ppm),
                                  port_image.to_u8(img))
    pfm = str(tmp_path / "port_write_pfm")
    np.testing.assert_array_equal(port_image.read_pfm(pfm),
                                  ref_image.read_pfm(pfm))
    np.testing.assert_array_equal(port_image.read_pfm(GOLDEN),
                                  ref_image.read_pfm(GOLDEN))


def test_application_options_and_benchmark(tmp_path, capsys):
    app = port_tg.make_app()
    out = tmp_path / "tri.ppm"
    rc = app.run(["--size", "48", "32", "-o", str(out), "--benchmark", "1",
                  "2", "-rtcore", "device=cpu,ignore_config_files=1",
                  "--compress.grid", "--subdLvl", "1", "--compLvl", "9"])
    assert rc == 0
    text = capsys.readouterr().out
    keys = [ln.split()[0] for ln in text.splitlines()
            if ln.startswith("BENCHMARK_RENDER_")]
    assert keys == ["BENCHMARK_RENDER_MIN", "BENCHMARK_RENDER_AVG",
                    "BENCHMARK_RENDER_MAX", "BENCHMARK_RENDER_SIGMA",
                    "BENCHMARK_RENDER_AVG_SIGMA",
                    "BENCHMARK_RENDER_MRAYPS_MIN",
                    "BENCHMARK_RENDER_MRAYPS_AVG",
                    "BENCHMARK_RENDER_MRAYPS_MAX",
                    "BENCHMARK_RENDER_MRAYPS_SIGMA"]
    for ln in text.splitlines():
        if ln.startswith("BENCHMARK_RENDER_"):
            assert float(ln.split()[1]) >= 0.0
    # the fork's flags parse, are clamped as the reference clamps them,
    # and select nothing
    assert app.args.subdiv_mode == "bvh4.compressed.grid"
    assert (app.args.subdLvl, app.args.compLvl) == (2, 2)
    img = port_image.read_ppm(str(out))
    assert img.shape == (32, 48, 3) and img.dtype == np.uint8
    assert out.read_bytes().startswith(b"P6\n48 32\n255\n")
    assert len(np.unique(img.reshape(-1, 3), axis=0)) >= 4
    # camera options reach the camera
    app2 = TutorialApplication("t", lambda a: None, lambda *a: None)
    app2.parse(["-vp", "1", "2", "3", "-vd", "0", "0", "1", "-fov", "60",
                "-lefthanded"])
    assert app2.camera.from_ == (1.0, 2.0, 3.0)
    assert app2.camera.to == (1.0, 2.0, 4.0)
    assert app2.camera.fov == 60.0 and app2.camera.right_handed is False


def test_cli_prints_benchmark_keys_and_writes_ppm(tmp_path):
    out = tmp_path / "cli.ppm"
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m",
         "embree_tpu_torch.render.tutorials.triangle_geometry",
         "--size", "40", "30", "-o", str(out), "--benchmark", "1", "2",
         "-rtcore", "device=cpu,ignore_config_files=1"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "BENCHMARK_RENDER_AVG " in proc.stdout
    assert "BENCHMARK_RENDER_MRAYPS_AVG " in proc.stdout
    assert f"wrote {out}" in proc.stdout
    assert port_image.read_ppm(str(out)).shape == (30, 40, 3)


def test_cli_without_a_card_raises_instead_of_running_on_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(ett.RaytracerError, match="no CUDA device"):
        port_tg.make_app().run(["--size", "8", "8", "-rtcore",
                                "ignore_config_files=1"])
