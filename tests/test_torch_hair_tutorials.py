"""The hair_geometry and curve_geometry tutorials of the port against the
JAX package's 64x48 frames, and their command lines."""
import numpy as np
import pytest

import embree_tpu_torch as ett

from test_torch_hair import (  # noqa: F401
    CFG, one_torch_thread)


def _tutorial_images(name, size=(64, 48)):
    from embree_tpu.render.camera import Camera as RefCamera
    import importlib
    ref_mod = importlib.import_module(
        f"embree_tpu.render.tutorials.{name}")
    port_mod = importlib.import_module(
        f"embree_tpu_torch.render.tutorials.{name}")
    app = port_mod.make_app()
    c = app.camera
    ref_img, _ = ref_mod.render_frame(
        ref_mod.build_scene(),
        RefCamera(from_=c.from_, to=c.to, up=c.up, fov=c.fov), size)
    port_img, _ = port_mod.render_frame(
        port_mod.build_scene(ett.Device(CFG, device="cpu")), c, size)
    return np.asarray(ref_img), port_img.numpy()


@pytest.mark.parametrize("name,budget", [("curve_geometry", 0.0),
                                         ("hair_geometry", 0.02)])
def test_tutorial_matches_reference(name, budget):
    ref, port = _tutorial_images(name)
    assert port.shape == ref.shape == (48, 64, 3)
    diff = np.abs(ref - port).max(-1)
    assert np.isfinite(port).all()
    assert (diff > 1.5 / 255).mean() <= budget, (diff > 1.5 / 255).mean()
    assert (port.max(-1) > 0).mean() > 0.3


@pytest.mark.parametrize("name", ["hair_geometry", "curve_geometry"])
def test_tutorial_cli(name, tmp_path, capsys):
    import importlib
    from embree_tpu_torch.render.image import read_ppm
    mod = importlib.import_module(
        f"embree_tpu_torch.render.tutorials.{name}")
    out = tmp_path / f"{name}.ppm"
    rc = mod.make_app().run(["--size", "32", "24", "-o", str(out),
                             "--benchmark", "0", "1",
                             "-rtcore", "device=cpu"])
    assert rc == 0
    text = capsys.readouterr().out
    for key in ("BENCHMARK_RENDER_AVG", "BENCHMARK_RENDER_MRAYPS_AVG"):
        assert key in text
    img = read_ppm(str(out))
    assert img.shape == (24, 32, 3) and img.max() > 0
