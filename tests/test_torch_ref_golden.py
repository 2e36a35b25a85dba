"""The port's form of tests/test_ref_golden.py::test_ref_displacement: the
`displacement_geometry` tutorial of the port, rendered on the CPU (the
compressed kernels' plain versions) at 64x64, against the reference
binaries' own renders `tests/golden/ref_displacement_{mode}_64.pfm`
(tools/make_ref_goldens.sh), with that test's comparison and budgets:
the framebuffer is quantized as the reference's RGBA8 output is, and a
pixel differs when a channel is more than 1.5/255 off. `grid` and `box`
may differ on no pixel, `leaf` (the pizza-box z refit) on 0.5 %."""
import os

import numpy as np
import pytest

from embree_tpu_torch.render.camera import Camera
from embree_tpu_torch.render.image import read_pfm
from embree_tpu_torch.render.tutorials import displacement_geometry as dg

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _quant(img):
    """The reference's float -> RGBA8 -> float pipeline."""
    return np.floor(255.0 * np.clip(np.asarray(img), 0.0, 1.0)) / 255.0


@pytest.mark.parametrize("mode,budget", [
    ("leaf", 0.005), ("grid", 0.0), ("box", 0.0)])
def test_ref_displacement(mode, budget):
    """Displaced subdivision cube through the compressed accel at the
    tutorial's levels (6, 4), one leaf approximation a case."""
    state = dg.build_scene(f"bvh4.compressed.{mode}", rtcore="device=cpu")
    img, _ = dg.render_frame(state, Camera(from_=(2.5, 2.5, 2.5),
                                           to=(0, 0, 0)), (64, 64))
    ref = read_pfm(os.path.join(GOLDEN, f"ref_displacement_{mode}_64.pfm"))
    assert img.shape == ref.shape == (64, 64, 3)
    diff = np.abs(_quant(img.numpy()) - ref).max(-1)
    frac = float((diff > 1.5 / 255).mean())
    assert frac <= budget, (
        f"{mode}: {frac:.4%} of the pixels differ from the reference render "
        f"(budget {budget:.2%}, max diff {diff.max():.3f})")
    # the cube covers a good part of the frame
    assert (ref.max(-1) > 0).mean() > 0.3
