"""The six tutorials of instances, user geometry and the rtcore facade in
the port (embree_tpu_torch/render/tutorials/) against the JAX package's:
`instanced_geometry`, `user_geometry`, `intersection_filter` and
`lazy_geometry` render one 64x48 frame each in both packages, the same
camera, and the port's frame may differ from the JAX package's in at
most 3 of its 3,072 pixels (a pixel differs when a channel is more than
1.5/255 apart; 0 differ on this CPU, the budget leaves room for an
equal-t tie; `lazy_geometry` must also build as many spheres);
`bvh_builder` and `bvh_access` print the same lines (the build times
aside). The port runs on the CPU, the JAX package its XLA path."""
import contextlib
import io
import re

import numpy as np

import embree_tpu_torch as ett
from embree_tpu.render.tutorials import bvh_access as ref_ba
from embree_tpu.render.tutorials import bvh_builder as ref_bb
from embree_tpu.render.tutorials import instanced_geometry as ref_ig
from embree_tpu.render.tutorials import intersection_filter as ref_if
from embree_tpu.render.tutorials import lazy_geometry as ref_lg
from embree_tpu.render.tutorials import user_geometry as ref_ug
from embree_tpu_torch.render.camera import primary_rays
from embree_tpu_torch.render.tutorials import bvh_access as ba
from embree_tpu_torch.render.tutorials import bvh_builder as bb
from embree_tpu_torch.render.tutorials import instanced_geometry as ig
from embree_tpu_torch.render.tutorials import intersection_filter as itf
from embree_tpu_torch.render.tutorials import lazy_geometry as lg
from embree_tpu_torch.render.tutorials import user_geometry as ug
from test_torch_build import reference_native  # noqa: F401,E402

SIZE = (64, 48)
BUDGET = 3 / (64 * 48)


def frames(mod, ref_mod):
    """(port frame, JAX frame, port state, JAX state) at SIZE through
    each package's own app camera."""
    dev = ett.Device("ignore_config_files=1", device="cpu")
    st = mod.build_scene(dev)
    img, n = mod.render_frame(st, mod.make_app().camera, SIZE)
    assert n >= SIZE[0] * SIZE[1]
    ref_app = ref_mod.make_app()
    ref_st = ref_mod.build_scene()
    ref_img, _ = ref_mod.render_frame(ref_st, ref_app.camera, SIZE)
    return img.numpy(), np.asarray(ref_img), st, ref_st


def off_fraction(a, b):
    assert a.shape == b.shape == (SIZE[1], SIZE[0], 3)
    return float((np.abs(a - b).max(-1) > 1.5 / 255).mean())


def test_instanced_and_user_geometry_frames():
    for mod, ref_mod in ((ig, ref_ig), (ug, ref_ug)):
        img, ref, st, _ = frames(mod, ref_mod)
        assert ref.max() > 0.2 and (ref.max(-1) > 0).mean() > 0.3
        assert off_fraction(img, ref) <= BUDGET, mod.__name__
    # the user_geometry frame's state is last; the instanced one's rays
    # see all four instances and the ground
    st = ig.build_scene(ett.Device("ignore_config_files=1", device="cpu"))
    h = ett.scene_intersect(st["cscene"], primary_rays(
        ig.make_app().camera, *SIZE, device="cpu"), coherent=True)
    assert set(h.inst_id.flatten().tolist()) == {-1, 0, 1, 2, 3}


def test_intersection_filter_and_lazy_geometry_frames():
    img, ref, _, _ = frames(itf, ref_if)
    assert ref.max() > 0.2
    assert off_fraction(img, ref) <= BUDGET
    img, ref, st, ref_st = frames(lg, ref_lg)
    assert ref.max() > 0.2
    assert off_fraction(img, ref) <= BUDGET
    assert st["built"] == ref_st["built"] > 0
    assert st["lazy_state"] == ref_st["lazy_state"]
    # the next frame builds nothing more: every touched sphere is real
    built = st["built"]
    lg.render_frame(st, lg.make_app().camera, SIZE)
    assert st["built"] == built


def test_bvh_builder_and_bvh_access_print_the_same():
    out = {}
    for name, run in (("port", lambda: bb.main(
            ["-rtcore", "ignore_config_files=1,device=cpu"], n=2000)),
            ("jax", lambda: ref_bb.main(2000))):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert run() == 0
        out[name] = [re.sub(r" build=.*", "", line)
                     for line in buf.getvalue().splitlines()]
    assert len(out["port"]) == 3 and out["port"] == out["jax"]
    lines, ref_lines = [], []
    _, cs = ba.build_scene(ett.Device("ignore_config_files=1",
                                      device="cpu"))
    stats = ba.print_bvh4(cs, out=lines.append)
    _, ref_cs = ref_ba.build_scene()
    assert stats == ref_ba.print_bvh4(ref_cs, out=ref_lines.append)
    assert lines == ref_lines and stats["prims"] == 14
    assert any("Triangle geomID=1" in ln for ln in lines)
