"""The port's dynamic-scene builders and tutorials against the JAX
package's (`build_morton` node for node is in
tests/test_torch_dynamic.py): the morton tree walked by the packet
kernel's plain version against the SAH scene, `rotate_bvh` byte-equal
(and the rotated tree answering as the original), scenes committed at
BuildQuality.LOW and REFIT equal to the JAX package's trees, and the
`dynamic_scene` (32x32) and `viewer_anim` (64x48) frames, a re-commit
between them, against the JAX package's (at most 3 pixels a frame more
than 1.5/255 apart) with the motion visible. The port runs on the
CPU."""
import textwrap

import numpy as np
import torch

import embree_tpu as et
import embree_tpu_torch as ett
from embree_tpu.build import rotate as jrotate
from embree_tpu.build import sah as jsah
from embree_tpu.build import user_builder as juser
from embree_tpu.render.camera import Camera as JCamera
from embree_tpu.render.tutorials import dynamic_scene as jds
from embree_tpu.render.tutorials import viewer_anim as jva
from embree_tpu_torch.build import sah as tsah
from embree_tpu_torch.build import user_builder as tuser
from embree_tpu_torch.build.bvh import sah_cost
from embree_tpu_torch.build.morton import build_morton
from embree_tpu_torch.build.rotate import rotate_bvh
from embree_tpu_torch.render.camera import Camera
from embree_tpu_torch.render.tutorials import dynamic_scene as ds
from embree_tpu_torch.render.tutorials import viewer_anim as va
from embree_tpu_torch.scene.prims import TrianglePrims
from embree_tpu_torch.traverse.packet_kernel import (compact_scene,
                                                     intersect_packet_kernel,
                                                     pack_scene)
from embree_tpu_torch.verify.fixtures import random_triangles, triangle_sphere
from test_torch_build import reference_native  # noqa: F401,E402
from test_torch_dynamic import _bounds, _equal_trees, _host

CPU = dict(device="cpu")
BUDGET = 3   # pixels a frame more than 1.5/255 apart (an equal-t tie)
CUBE_OBJ = textwrap.dedent("""\
    v -1 -1 -1
    v 1 -1 -1
    v 1 1 -1
    v -1 1 -1
    v -1 -1 1
    v 1 -1 1
    v 1 1 1
    v -1 1 1
    f 1 2 3 4
    f 5 8 7 6
    f 1 5 6 2
    f 2 6 7 3
    f 3 7 8 4
    f 5 1 4 8
    """)


def _walk(bvh, verts, idx, rays):
    """Closest hits of `rays` through the packet kernel's plain version
    over `bvh` (packed as a committed scene's tree is)."""
    v = (verts[idx[:, 0]], verts[idx[:, 1]], verts[idx[:, 2]])
    ps = compact_scene(pack_scene(_host(bvh), v, "cpu"), "cpu")
    n = idx.shape[0]
    tris = TrianglePrims(*(torch.from_numpy(a) for a in v),
                         torch.zeros(n, dtype=torch.int32),
                         torch.arange(n, dtype=torch.int32),
                         torch.zeros(n, dtype=torch.int32))
    return intersect_packet_kernel(ps, tris, rays)


def test_morton_walk_and_rotation(rng):
    """The morton tree through the packet kernel's plain version answers
    as the SAH scene (valid equal, t at 1e-5: tests/test_dynamic.py's
    gate); `rotate_bvh` is byte-equal to the JAX package's on its
    median tree, lowers the SAH cost, and the rotated SAH tree answers
    as the original (prim equal, t at 1e-6: tests/test_rotate.py)."""
    verts, idx = random_triangles(rng, 400, extent=5.0, size=1.0)
    lo, hi = _bounds(verts, idx)
    org = rng.uniform(-8, 8, (256, 3)).astype(np.float32)
    d = rng.normal(size=(256, 3)).astype(np.float32)
    rays = ett.make_rays(org, d, **CPU)
    h_m = _walk(build_morton(torch.from_numpy(lo), torch.from_numpy(hi)),
                verts, idx, rays)
    scene = ett.Scene(ett.Device("ignore_config_files=1", **CPU))
    scene.attach(ett.TriangleMesh(verts, idx))
    scene.commit()
    h_s = scene.intersect(rays)
    assert torch.equal(h_m.valid, h_s.valid) and h_s.valid.sum() > 20
    np.testing.assert_allclose(h_m.t[h_s.valid].numpy(),
                               h_s.t[h_s.valid].numpy(), rtol=1e-5)

    # tests/test_rotate.py's deliberately poor tree, in both packages
    brng = np.random.default_rng(3)
    blo = brng.uniform(-10, 10, (600, 3)).astype(np.float32)
    bhi = blo + brng.uniform(0.1, 1.0, (600, 3)).astype(np.float32)
    trees = []
    for user, sah in ((tuser, tsah), (juser, jsah)):
        child2, nlo2, nhi2, order, root, mult = user._morton_bvh2(blo, bhi,
                                                                  4)
        trees.append(sah.collapse_to_wide(
            child2, nlo2, nhi2, order, leaf_mult=mult, root_ref=root,
            width=4, prim_lower=blo, prim_upper=bhi))
    _equal_trees(*trees)
    rot = rotate_bvh(trees[0], rounds=2)
    _equal_trees(rot, jrotate.rotate_bvh(trees[1], rounds=2))
    assert sah_cost(rot) < sah_cost(trees[0]) * 0.999

    sv, si = triangle_sphere((0, 0, 0), 1.5, 12)
    sph = ett.Scene(ett.Device("ignore_config_files=1", **CPU))
    sph.attach(ett.TriangleMesh(sv, si))
    sph.commit()
    host = sph._bvh_host
    rot = rotate_bvh(host, rounds=1)
    _equal_trees(rot, jrotate.rotate_bvh(host, rounds=1))
    rng2 = np.random.default_rng(0)
    o2 = rng2.uniform(-3, 3, (256, 3)).astype(np.float32)
    d2 = rng2.normal(size=(256, 3)).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    r2 = ett.make_rays(o2, d2, **CPU)
    h0, h1 = _walk(host, sv, si, r2), _walk(rot, sv, si, r2)
    np.testing.assert_allclose(h1.t.numpy(), h0.t.numpy(), rtol=1e-6)
    assert torch.equal(h0.prim_id, h1.prim_id)


def _off(a, b):
    return int((np.abs(a - b).max(-1) > 1.5 / 255).sum())


def test_dynamic_scene_frames_match_jax():
    """dynamic_scene's first two frames (the second re-committed after
    the animation, at REFIT for the even spheres and MEDIUM for the odd
    ones) against the JAX package's at 32x32; the committed trees of
    both frames equal the JAX package's; the motion is visible
    (tests/test_tutorials.py's gate)."""
    st = ds.build_scene(device=ett.Device("ignore_config_files=1", **CPU))
    cam = ds.make_app().camera
    jst = jds.build_scene()
    jcam = JCamera(from_=(0, 4, -7), to=(0, -1, 0))
    jds._frame[0] = 0
    imgs = []
    for _ in range(2):
        img, n = ds.render_frame(st, cam, (32, 32))
        ref, _ = jds.render_frame(jst, jcam, (32, 32))
        a, b = img.numpy(), np.asarray(ref)
        assert n == 32 * 32 and np.isfinite(a).all()
        assert _off(a, b) <= BUDGET
        _equal_trees(st["cscene"].bvh, jst["cscene"].bvh)
        imgs.append(a)
    assert st["frame"] == 2
    assert np.abs(imgs[1] - imgs[0]).max() > 0.01  # motion visible
    assert imgs[0].max() > 0.2 and (imgs[0].max(-1) > 0).mean() > 0.3


def test_low_and_refit_commit_the_jax_tree(tmp_path):
    """viewer_anim: its two frames (the second after an animation and a
    re-commit at BuildQuality.LOW) against the JAX package's at 64x48,
    the deformation visible (tests/test_convert_viewers.py's gate); a
    scene committed at LOW, at REFIT and at MEDIUM: the same tree, the
    JAX package's."""
    obj = tmp_path / "cube.obj"
    obj.write_text(CUBE_OBJ)
    st = va.build_scene(paths=[str(obj)],
                        device=ett.Device("ignore_config_files=1", **CPU))
    jst = jva.build_scene(paths=[str(obj)])
    assert st["scene"].quality == ett.BuildQuality.LOW
    cam = Camera(from_=(3, 3, -5), to=(0, 0, 0))
    jcam = JCamera(from_=(3, 3, -5), to=(0, 0, 0))
    jva._frame[0] = 0
    imgs = []
    for k in range(2):
        img, _ = va.render_frame(st, cam, (64, 48))
        ref, _ = jva.render_frame(jst, jcam, (64, 48))
        a, b = img.numpy(), np.asarray(ref)
        assert np.isfinite(a).all() and _off(a, b) <= BUDGET
        _equal_trees(st["cscene"].bvh, jst["cscene"].bvh)
        imgs.append(a)
        if k == 0:  # halfway between keyframes
            st = va.animate(st, 0.5)
            jst = jva.animate(jst, 0.5)
    assert np.abs(imgs[0] - imgs[1]).max() > 0.01   # deformation visible

    verts, idx = triangle_sphere((0, 0, 0), 1.0, 8)
    trees = {}
    for q in ("LOW", "REFIT", "MEDIUM"):
        sc = ett.Scene(ett.Device("ignore_config_files=1", **CPU),
                       quality=ett.BuildQuality[q])
        sc.attach(ett.TriangleMesh(verts, idx))
        trees[q] = sc.commit().bvh
        js = et.Scene(et.Device("ignore_config_files=1"),
                      quality=et.BuildQuality[q])
        js.attach(et.TriangleMesh(verts, idx))
        _equal_trees(trees[q], js.commit().bvh)
    _equal_trees(trees["LOW"], trees["MEDIUM"])
    _equal_trees(trees["REFIT"], trees["MEDIUM"])
