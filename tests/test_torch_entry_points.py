"""The port's counterparts of the JAX package's last public entry points,
against the JAX functions on the same seeded inputs, on the CPU:
`viewer.render` and `viewer.render_frame(smooth_normals=False)` (the
geometric-normal frame), `subdivision_geometry.render_frame(...,
smooth_normals=False)`, `verify/fixtures.py::triangle_plane`, the stream
sort's `sort_rays` / `unsort` / `unsort_one`, `AffineSpace.xfm_point` /
`xfm_vector`, `TreeletScene.hbm_bytes`, the noise tables `P_TABLE` / `G3`
and the `user_geometry` tutorial's `sphere_intersect`."""
import numpy as np
import torch

import jax.numpy as jnp
from embree_tpu.build import treelets as jtreelets
from embree_tpu.core import math as jmath
from embree_tpu.core.rayhit import Rays as JRays
from embree_tpu.render import noise as jnoise
from embree_tpu.render.camera import Camera as JCamera
from embree_tpu.render.camera import pixel_morton_order_device as jmorton
from embree_tpu.render.tutorials import subdivision_geometry as jsg
from embree_tpu.render.tutorials import user_geometry as jug
from embree_tpu.render.tutorials import viewer as jviewer
from embree_tpu.traverse import stream as jstream
from embree_tpu.verify import fixtures as jfix
from embree_tpu_torch.build import treelets as ttreelets
from embree_tpu_torch.core import math as tmath
from embree_tpu_torch.core.rayhit import Rays
from embree_tpu_torch.render import noise as tnoise
from embree_tpu_torch.render.camera import Camera, pixel_morton_order_device
from embree_tpu_torch.render.tutorials import subdivision_geometry as tsg
from embree_tpu_torch.render.tutorials import user_geometry as tug
from embree_tpu_torch.render.tutorials import viewer as tviewer
from embree_tpu_torch.traverse import stream as tstream
from embree_tpu_torch.verify import fixtures as tfix

from test_torch_build import reference_native  # noqa: F401

BOMBERMAN = "tests/golden/bomberman.obj"
DEMO_CAMERA = dict(from_=(18.21240425, 20.05745888, 15.46878433),
                   to=(0, 0, 0), fov=90)
CPU = torch.device("cpu")


def _state_args(st):
    return (st["cscene"], st["materials"], st["geom_mat"], st["textures"],
            st["kd_tex"], st["tri_uv"], st["prim_base"])


def test_viewer_geometric_normal_frame_matches_jax(request):
    """bomberman.obj in leaf mode at levels (2, 1), the demo camera at
    64x48: `render` in Morton order with its unsort equals
    `render_frame(smooth_normals=False)` bit for bit, each package's
    alike, and the port's frame is the JAX package's within 1e-5 on
    every pixel; the smooth frame differs from it (a leaf hit's raw Ng
    is the dummy (1, 0, 0))."""
    path = str(request.config.rootpath / BOMBERMAN)
    w, h = 64, 48
    st = tviewer.build_scene(path, "bvh4.compressed.leaf", 2, 1,
                             rtcore="device=cpu")
    cam = Camera(**DEMO_CAMERA)
    flat, n = tviewer.render_frame(st, cam, (w, h), smooth_normals=False)
    perm, inv = pixel_morton_order_device(w, h, CPU)
    img = tviewer.render(*_state_args(st),
                         *cam.ispc_camera(w, h, device=CPU), perm, inv,
                         width=w, height=h)
    assert n == w * h and img.shape == (h, w, 3)
    assert torch.equal(img, flat)
    rowwise = tviewer.render(*_state_args(st),
                             *cam.ispc_camera(w, h, device=CPU),
                             width=w, height=h)
    assert torch.equal(rowwise, flat)
    smooth, _ = tviewer.render_frame(st, cam, (w, h))
    assert not torch.equal(smooth, flat)

    js = jviewer.build_scene(path, "bvh4.compressed.leaf", 2, 1)
    jcam = JCamera(**DEMO_CAMERA)
    jflat, _ = jviewer.render_frame(js, jcam, (w, h), smooth_normals=False)
    jperm, jinv = jmorton(w, h)
    jimg = jviewer.render(*_state_args(js), *jcam.ispc_camera(w, h),
                          jperm, jinv, width=w, height=h)
    jflat, jimg = np.asarray(jflat), np.asarray(jimg)
    np.testing.assert_array_equal(jimg, jflat)
    np.testing.assert_allclose(flat.numpy(), jflat, rtol=0, atol=1e-5)
    assert (jflat.max(-1) > 0).mean() > 0.5


def test_subdivision_geometry_raw_frame_matches_jax():
    """`render_frame(..., smooth_normals=False)` is displacement_geometry's
    frame of the tutorial's scene (the cube tessellated at level 3, its
    raw triangle normals), in both packages; the port's is the JAX
    package's within 1e-5 on every pixel, and the smooth frame differs."""
    cam = dict(from_=(2.5, 2.5, 2.5), to=(0, 0, 0))
    st = tsg.build_scene(None, 3, rtcore="device=cpu")
    img, n = tsg.render_frame(st, Camera(**cam), (64, 48),
                              smooth_normals=False)
    smooth, _ = tsg.render_frame(st, Camera(**cam), (64, 48))
    assert n == 2 * 64 * 48 and img.shape == (48, 64, 3)
    assert not torch.equal(img, smooth)
    ref, _ = jsg.render_frame(jsg.build_scene(None, 3), JCamera(**cam),
                              (64, 48), smooth_normals=False)
    np.testing.assert_allclose(img.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)
    assert (np.asarray(ref).max(-1) > 0).mean() > 0.3


def test_stream_sort_helpers_match_jax(rng):
    """`sort_rays` gives the JAX package's sorted rays and inverse
    permutation; `unsort` with it and `unsort_one` with the stream's
    permutation restore the original order, as the JAX package's do."""
    n = 3000
    org = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tn = rng.uniform(0, 0.1, n).astype(np.float32)
    tf = rng.uniform(5, 50, n).astype(np.float32)
    lo, hi = np.float32([-4, -4, -4]), np.float32([4, 4, 4])
    t = torch.from_numpy
    rays = Rays(t(org), t(d), t(tn), t(tf))
    jrays = JRays(*(jnp.asarray(a) for a in (org, d, tn, tf)))
    srays, inv = tstream.sort_rays(rays, t(lo), t(hi))
    jsrays, jinv = jstream.sort_rays(jrays, jnp.asarray(lo), jnp.asarray(hi))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(jinv))
    for a, b in zip(srays, jsrays):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(srays, rays):
        assert torch.equal(tstream.unsort(a, inv), b)
        np.testing.assert_array_equal(
            tstream.unsort(a, inv).numpy(),
            np.asarray(jstream.unsort(jnp.asarray(a.numpy()), jinv)))
    s2, perm = tstream.sort_rays_stream(rays, t(lo), t(hi))
    _, jperm = jstream.sort_rays_stream(jrays, jnp.asarray(lo),
                                        jnp.asarray(hi))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    back = tstream.unsort_one(perm, s2.tfar)
    assert torch.equal(back, rays.tfar)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jstream.unsort_one(
            jperm, jnp.asarray(s2.tfar.numpy()))))


def test_host_helpers_match_jax(rng):
    """`triangle_plane` byte-equal, the noise tables equal,
    `TreeletScene.hbm_bytes` the JAX package's for the same treelets,
    `AffineSpace.xfm_point` / `xfm_vector` within 1e-6 of the JAX
    package's (XLA:CPU contracts products into FMAs), and the tutorial's
    `sphere_intersect` on every sphere: valid equal, t and Ng within
    1e-5 relative."""
    for p0, dx, dy, n in (((0, 0, 0), (1, 0, 0), (0, 0, 1), 1),
                          ((-1, 0.5, 2), (3, 0, 0.5), (0, 2, 0), 7),
                          ((0, -2, 0), (10, 0, 0), (0, 0, 10), 40)):
        a = tfix.triangle_plane(p0, dx, dy, n)
        b = jfix.triangle_plane(p0, dx, dy, n)
        assert a[1].shape == (2 * n * n, 3)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert x.tobytes() == y.tobytes()
    for x, y in ((tnoise.P_TABLE, jnoise.P_TABLE), (tnoise.G3, jnoise.G3)):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    verts, idx = tfix.triangle_sphere((0, 0, 0), 1.0, 40)
    v = verts[idx]
    ids = np.arange(len(idx))
    ours = ttreelets.build_treelet_scene(v[:, 0], v[:, 1], v[:, 2], ids,
                                         fan=4).to_device("cpu")
    theirs = jtreelets.build_treelet_scene(v[:, 0], v[:, 1], v[:, 2], ids,
                                           fan=4).to_device()
    assert ours.hbm_bytes == theirs.hbm_bytes > ours.device_bytes // 2
    t = torch.from_numpy
    cols = rng.normal(size=(4, 3)).astype(np.float32)
    q = rng.normal(size=(5, 7, 3)).astype(np.float32)
    xfm = tmath.AffineSpace(*(t(c) for c in cols))
    jxfm = jmath.AffineSpace(*(jnp.asarray(c) for c in cols))
    for name in ("xfm_point", "xfm_vector"):
        got = getattr(xfm, name)(t(q))
        want = np.asarray(getattr(jxfm, name)(jnp.asarray(q)))
        assert got.shape == want.shape == q.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    n = 512
    org = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    tgt = tug.SPHERES[rng.integers(0, 4, n), :3]
    d = (tgt - org + rng.normal(scale=0.4, size=(n, 3))).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tn = np.zeros(n, np.float32)
    tf = np.full(n, 100.0, np.float32)
    rays = Rays(t(org), t(d), t(tn), t(tf))
    jrays = JRays(*(jnp.asarray(a) for a in (org, d, tn, tf)))
    hits = 0
    for prim in range(len(tug.SPHERES)):
        ok, tt, u, v, ng = tug.sphere_intersect(prim, rays, t(tf))
        jok, jt, _, _, jng = (np.asarray(a) for a in jug.sphere_intersect(
            prim, jrays, jnp.asarray(tf)))
        np.testing.assert_array_equal(ok.numpy(), jok)
        np.testing.assert_allclose(tt.numpy(), jt, rtol=1e-5)
        np.testing.assert_allclose(ng.numpy(), jng, rtol=1e-5, atol=1e-5)
        assert not u.any() and not v.any()
        hits += int(jok.sum())
    assert hits > n // 4
