"""The rtcore API facade (embree_tpu_torch/rtcore.py), the user-space BVH
builder (build/user_builder.py, rtcBuildBVH) and the Pluecker triangle
test (traverse/moeller.py) against the JAX package: the port's forms of
tests/test_rtcore.py, tests/test_api.py, tests/test_user_builder.py and
tests/test_pluecker.py. The box helpers and the barycentric hit point
are in test_torch_rtcore_helpers.py.

The port runs on the CPU (`device=cpu`), its kernels' plain versions
answering; the JAX package its XLA path. Tolerances: ids and valid
equal, t at 5e-5 relative (ROADMAP.md C.3); the user builder's trees
equal node for node, bounds bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import embree_tpu as et
import embree_tpu.rtcore as ref_rtc
import embree_tpu_torch as ett
import embree_tpu_torch.rtcore as rtc
from embree_tpu.render.tutorials import bvh_builder as ref_bb
from embree_tpu.traverse import moeller as ref_moeller
from embree_tpu_torch.build.user_builder import (BuildArguments,
                                                 BuildCancelled,
                                                 BuildQualityEnum,
                                                 build_user_bvh)
from embree_tpu_torch.render.tutorials import bvh_builder as bb
from embree_tpu_torch.traverse.moeller import (intersect_triangle,
                                               intersect_triangle_pluecker)
from embree_tpu_torch.verify.fixtures import random_triangles, subdiv_cube
from test_torch_build import reference_native  # noqa: F401,E402

CPU = "ignore_config_files=1,device=cpu"
CUBE_V = np.array([[-1, -1, -1], [1, -1, -1], [1, -1, 1], [-1, -1, 1],
                   [-1, 1, -1], [1, 1, -1], [1, 1, 1], [-1, 1, 1]],
                  np.float32)


def _ray():
    return ett.make_rays(np.array([[0, 0, 5]], np.float32),
                         np.array([[0, 0, -1]], np.float32), device="cpu")


def _tri_at_origin():
    verts = np.array([[-1, -1, 0], [1, -1, 0], [0, 1, 0]], np.float32)
    return ett.TriangleMesh(verts, np.array([[0, 1, 2]], np.int32))


def _user_fns(pkg):
    """Two analytic spheres as rtcore user callbacks."""
    centers = np.array([[0, 0, 0], [2.5, 0, 0]], np.float32)
    radii = np.array([1.0, 0.6], np.float32)

    def bounds_fn(ids):
        return centers[ids] - radii[ids][:, None], \
            centers[ids] + radii[ids][:, None]

    xp = jnp if pkg is ref_rtc else torch
    c = jnp.asarray(centers) if pkg is ref_rtc else torch.from_numpy(centers)
    r = jnp.asarray(radii) if pkg is ref_rtc else torch.from_numpy(radii)

    def intersect_fn(p, rays, tfar):
        oc = rays.org - c[p]
        b = (oc * rays.dir).sum(-1)
        cc = (oc * oc).sum(-1) - r[p] ** 2
        disc = b * b - cc
        th = -b - xp.sqrt(xp.maximum(disc, xp.zeros_like(disc)))
        ok = (disc >= 0) & (th > rays.tnear) & (th < tfar)
        return ok, th, th * 0, th * 0, rays.org + th[..., None] * rays.dir \
            - c[p]

    return bounds_fn, intersect_fn


def _geometry(r, dev, kind, child=None):
    """One committed rtcore geometry of `kind` through package `r`."""
    g = r.rtcNewGeometry(dev, getattr(r, f"RTC_GEOMETRY_TYPE_{kind}"))
    buf = r.rtcSetSharedGeometryBuffer
    if kind == "TRIANGLE":
        buf(g, r.RTC_BUFFER_TYPE_VERTEX, 0, CUBE_V)
        buf(g, r.RTC_BUFFER_TYPE_INDEX, 0, np.array(
            [[0, 1, 2], [0, 2, 3], [4, 6, 5], [4, 7, 6]], np.uint32))
    elif kind == "QUAD":
        r.rtcSetNewGeometryBuffer(g, r.RTC_BUFFER_TYPE_VERTEX, 0, CUBE_V)
        buf(g, r.RTC_BUFFER_TYPE_INDEX, 0, np.array(
            [[0, 4, 5, 1], [1, 5, 6, 2], [2, 6, 7, 3], [0, 3, 7, 4]],
            np.uint32))
    elif kind == "SUBDIVISION":
        v, counts, idx = subdiv_cube()
        buf(g, r.RTC_BUFFER_TYPE_VERTEX, 0, v)
        buf(g, r.RTC_BUFFER_TYPE_INDEX, 0, np.asarray(idx, np.uint32))
        buf(g, r.RTC_BUFFER_TYPE_FACE, 0, np.asarray(counts, np.uint32))
    elif kind in ("FLAT_LINEAR_CURVE", "ROUND_BEZIER_CURVE"):
        cp = np.array([[-1, -1, 0, 0.2], [-0.3, 0.5, 0, 0.2],
                       [0.3, -0.5, 0, 0.25], [1, 1, 0, 0.2]], np.float32)
        buf(g, r.RTC_BUFFER_TYPE_VERTEX, 0, cp)
        buf(g, r.RTC_BUFFER_TYPE_INDEX, 0, np.array(
            [0, 1, 2] if kind == "FLAT_LINEAR_CURVE" else [0], np.uint32))
        r.rtcSetGeometryTessellationRate(g, 6.0)
    elif kind == "USER":
        r.rtcSetGeometryUserPrimitiveCount(g, 2)
        b, i = _user_fns(r)
        r.rtcSetGeometryBoundsFunction(g, b)
        r.rtcSetGeometryIntersectFunction(g, i)
    elif kind == "INSTANCE":
        r.rtcSetGeometryInstancedScene(g, child)
        r.rtcSetGeometryTransform(g, 0, "float3x4", np.array(
            [[0, -1.5, 0, 0.5], [1.5, 0, 0, 0], [0, 0, 1.5, 0.2]],
            np.float32))
    r.rtcSetGeometryUserData(g, kind)
    r.rtcCommitGeometry(g)
    return g


KINDS = ("TRIANGLE", "QUAD", "SUBDIVISION", "FLAT_LINEAR_CURVE",
         "ROUND_BEZIER_CURVE", "USER", "INSTANCE")


def test_rtcore_every_function_and_geometry_type_against_jax(rng):
    """Every public function of embree_tpu/rtcore.py has a counterpart;
    each of the seven geometry types of rtcCommitGeometry, committed
    through the facade into a scene of its own, answers 600 rays as the
    JAX package's facade does; test_rtcore.py's two round trips."""
    names = {n for n in dir(ref_rtc) if n.startswith(("rtc", "RTC_"))}
    assert names and names <= set(dir(rtc)), names - set(dir(rtc))

    org = rng.uniform(-4, 4, (600, 3)).astype(np.float32)
    org /= np.linalg.norm(org, axis=1, keepdims=True) / 4.0
    d = rng.uniform(-1, 1, (600, 3)).astype(np.float32) - org
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = {ref_rtc: et.make_rays(org, d),
            rtc: ett.make_rays(org, d, device="cpu")}
    for kind in KINDS:
        out = {}
        for r in (ref_rtc, rtc):
            dev = r.rtcNewDevice(CPU)
            child = None
            if kind == "INSTANCE":
                child = r.rtcNewScene(dev)
                r.rtcAttachGeometry(child, _geometry(r, dev, "TRIANGLE"))
                r.rtcCommitScene(child)
            scene = r.rtcNewScene(dev)
            g = _geometry(r, dev, kind, child)
            gid = r.rtcAttachGeometry(scene, g)
            r.rtcReleaseGeometry(g)
            r.rtcJoinCommitScene(scene)
            out[r] = (gid, r.rtcIntersect1M(scene, rays[r]),
                      r.rtcOccluded1M(scene, rays[r]))
        (gj, hj, oj), (gp, hp, op) = out[ref_rtc], out[rtc]
        v = np.asarray(hj.valid)
        assert gj == gp and v.sum() > 30, (kind, v.sum())
        np.testing.assert_array_equal(hp.valid.numpy(), v, kind)
        np.testing.assert_array_equal(op.numpy(), np.asarray(oj), kind)
        for k in ("prim_id", "geom_id", "inst_id"):
            np.testing.assert_array_equal(getattr(hp, k).numpy()[v],
                                          np.asarray(getattr(hj, k))[v], k)
        # the compressed modes are not this type's default: subdivision
        # meshes tessellate eagerly, as in the JAX package
        np.testing.assert_allclose(hp.t.numpy()[v], np.asarray(hj.t)[v],
                                   rtol=5e-5, err_msg=kind)

    # test_rtcore.py: the triangle round trip and the compressed subdivision
    device = rtc.rtcNewDevice(CPU)
    calls = []
    rtc.rtcSetDeviceErrorFunction(device, lambda c, m: calls.append(c))
    rtc.rtcSetDeviceMemoryMonitorFunction(device, lambda n, post: True)
    scene = rtc.rtcNewScene(device)
    rtc.rtcSetSceneBuildQuality(scene, rtc.RTC_BUILD_QUALITY_HIGH)
    geom = rtc.rtcNewGeometry(device, rtc.RTC_GEOMETRY_TYPE_TRIANGLE)
    rtc.rtcSetSharedGeometryBuffer(geom, rtc.RTC_BUFFER_TYPE_VERTEX, 0,
                                   np.array([[-1, -1, 0], [1, -1, 0],
                                             [0, 1, 0]], np.float32))
    rtc.rtcSetSharedGeometryBuffer(geom, rtc.RTC_BUFFER_TYPE_INDEX, 0,
                                   np.array([[0, 1, 2]], np.uint32))
    rtc.rtcSetGeometryMask(geom, 0xFFFFFFFF)
    rtc.rtcCommitGeometry(geom)
    rtc.rtcAttachGeometryByID(scene, geom, 3)
    rtc.rtcCommitScene(scene)
    h = rtc.rtcIntersect1(scene, _ray())
    assert h.valid.item() and h.geom_id.item() == 3
    for fn in (rtc.rtcIntersect4, rtc.rtcIntersect8, rtc.rtcIntersect16):
        assert torch.equal(fn(scene, _ray()).t, h.t)
    for fn in (rtc.rtcOccluded1, rtc.rtcOccluded4, rtc.rtcOccluded8,
               rtc.rtcOccluded16):
        assert fn(scene, _ray()).item()
    lo, hi = rtc.rtcGetSceneBounds(scene)
    assert (lo <= -1 + 1e-6).any() and (hi >= 1 - 1e-6).any()
    P, N = rtc.rtcInterpolate1(scene, 3, h.prim_id, h.u, h.v)
    assert torch.allclose(P, torch.zeros(1, 3), atol=1e-5)
    rtc.rtcDetachGeometry(scene, 3)
    with pytest.raises(ett.RaytracerError):
        rtc.rtcDetachGeometry(scene, 3)
    assert calls == [ett.Error.INVALID_ARGUMENT]
    assert rtc.rtcGetDeviceError(device) == ett.Error.INVALID_ARGUMENT
    rtc.rtcReleaseScene(scene)
    rtc.rtcReleaseDevice(device)

    device = rtc.rtcNewDevice(CPU + ",subdiv_accel=bvh4.compressed.leaf")
    scene = rtc.rtcNewScene(device)
    geom = _geometry(rtc, device, "SUBDIVISION")
    rtc.rtcSetGeometryDisplacementFunction(geom, None)
    rtc.rtcCommitGeometry(geom)
    rtc.rtcAttachGeometry(scene, geom)
    rtc.rtcSetSceneLevels(scene, 3, 2)
    rtc.rtcCommitScene(scene)
    assert scene.committed.compressed is not None
    h = rtc.rtcIntersect1(scene, ett.make_rays(
        np.array([[3, 0.1, 0.1]], np.float32),
        np.array([[-1, 0, 0]], np.float32), device="cpu"))
    assert h.valid.item()
    P, N = rtc.rtcInterpolate1(scene, 0, h.prim_id, h.u, h.v)
    assert torch.isfinite(P).all() and torch.isfinite(N).all()
    # rtcNewDevice binds the CUDA device unless the string says otherwise
    if not torch.cuda.is_available():
        with pytest.raises(ett.RaytracerError):
            rtc.rtcNewDevice("ignore_config_files=1")


def test_api_behaviour(rng, tmp_path, monkeypatch, capsys):
    """The port's forms of tests/test_api.py: config parsing, the error
    model, empty scenes, enable/disable, attach/detach churn, geometry
    ids, dynamic updates, progress-monitor cancellation, garbage
    geometry, statistics and the config-file layer."""
    dev = ett.Device("ignore_config_files=1,verbose=0,threads=4,isa=xla,"
                     "tessellation_cache_size=64M", device="cpu")
    assert dev.state.threads == 4 and dev.state.isa == "xla"
    assert dev.state.tessellation_cache_size == 64 * 1024 * 1024
    assert ett.Device(CPU + ",bogus_key=3").state.unknown == {
        "bogus_key": "3"}

    dev = ett.Device(CPU)
    calls = []
    dev.set_error_function(lambda code, msg: calls.append((code, msg)))
    s = ett.Scene(dev)
    with pytest.raises(ett.RaytracerError):
        s.intersect(_ray())
    assert dev.get_error() == ett.Error.INVALID_OPERATION
    assert dev.get_error() == ett.Error.NONE
    assert calls and calls[0][0] == ett.Error.INVALID_OPERATION

    s = ett.Scene(dev)
    s.commit()
    assert not s.intersect(_ray()).valid.item()
    assert not s.occluded(_ray()).item()

    s = ett.Scene(dev)
    g = _tri_at_origin()
    s.attach(g)
    for on in (True, False, True):
        g.enable() if on else g.disable()
        s.commit()
        assert s.intersect(_ray()).valid.item() == on

    s = ett.Scene(dev)
    ids = [s.attach(ett.TriangleMesh(*random_triangles(rng, 10)))
           for _ in range(5)]
    assert ids == list(range(5))
    s.detach(2)
    s.detach(4)
    with pytest.raises(ett.RaytracerError):
        s.detach(4)
    assert s.attach(_tri_at_origin()) == 5
    s.commit()
    assert s.intersect(_ray()).geom_id.item() in (0, 1, 3, 5)

    s = ett.Scene(dev)
    s.attach_by_id(_tri_at_origin(), 7)
    with pytest.raises(ett.RaytracerError):
        s.attach_by_id(_tri_at_origin(), 7)
    s.commit()
    assert s.intersect(_ray()).geom_id.item() == 7

    s = ett.Scene(dev)
    g = _tri_at_origin()
    s.attach(g)
    s.commit()
    t0 = s.intersect(_ray()).t.item()
    g.vertices = g.vertices - np.array([0, 0, 2], np.float32)
    s.commit()
    assert abs(t0 - 5.0) < 1e-5 and abs(s.intersect(_ray()).t.item()
                                        - 7.0) < 1e-5

    s = ett.Scene(dev)
    s.attach(_tri_at_origin())
    s.progress_monitor = lambda f: f < 0.5
    with pytest.raises(ett.RaytracerError) as e:
        s.commit()
    assert e.value.code == ett.Error.CANCELLED and s.committed is None

    verts, idx = random_triangles(rng, 50)
    verts[::7] = np.nan
    verts[1::9] = np.inf
    s = ett.Scene(ett.Device(CPU + ",builder=python"))
    s.attach(ett.TriangleMesh(verts, idx))
    s.commit()
    assert s.intersect(_ray()).t.shape == (1,)

    capsys.readouterr()
    s = ett.Scene(ett.Device(CPU + ",verbose=2"))
    s.attach(_tri_at_origin())
    s.commit()
    out = capsys.readouterr().out
    assert "BVH" in out and "triangles" in out

    (tmp_path / ".embree_tpu").write_text("verbose=0\nthreads=9\n")
    monkeypatch.chdir(tmp_path)
    assert ett.Device(device="cpu").state.threads == 9
    assert ett.Device("threads=3", device="cpu").state.threads == 3


def _tree(node, leaf_type):
    """A user tree as nested tuples: inner nodes with their children's
    bounds as bytes, leaves with their prims."""
    if isinstance(node, leaf_type):
        return ("leaf", tuple((np.asarray(p.lower, np.float32).tobytes(),
                               np.asarray(p.upper, np.float32).tobytes(),
                               p.geom_id, p.prim_id) for p in node.prims))
    return ("inner",
            tuple((np.asarray(lo, np.float32).tobytes(),
                   np.asarray(hi, np.float32).tobytes())
                  for lo, hi in node.bounds),
            tuple(_tree(c, leaf_type) for c in node.children))


def _collect_prims(root):
    out, stack = [], [root]
    while stack:
        n = stack.pop()
        if isinstance(n, bb.LeafNode):
            out.extend(p.prim_id for p in n.prims)
        else:
            stack.extend(n.children)
    return sorted(out)


def test_user_builder_trees_equal_jax_and_bvh_access():
    """rtcBuildBVH at every quality and branching factors 2 and 4 hands
    the user's callbacks the JAX package's tree, node for node; then the
    port's forms of tests/test_user_builder.py and of the bvh_access
    walk."""
    lower, upper = bb.make_random_prims(500)
    for q in (BuildQualityEnum.LOW, BuildQualityEnum.MEDIUM,
              BuildQualityEnum.HIGH):
        for branching in (2, 4):
            # at HIGH quality both write the split boxes into the
            # caller's bounds arrays (ROADMAP.md C.2): each gets a copy
            ours = lower.copy(), upper.copy()
            theirs = lower.copy(), upper.copy()
            mine, _ = bb.build(q, *ours, branching, rtcore=CPU)
            ref, _ = ref_bb.build(q, *theirs, branching)
            assert _tree(mine, bb.LeafNode) == _tree(ref, ref_bb.LeafNode), \
                (q, branching)
            for a, b in zip(ours, theirs):
                assert a.tobytes() == b.tobytes()
            assert (ours[1].tobytes() != upper.tobytes()) == (
                q == BuildQualityEnum.HIGH)
            assert mine.sah() == ref.sah()
            prims = _collect_prims(mine)
            if q == BuildQualityEnum.HIGH:
                assert len(prims) > 500 and set(prims) == set(range(500))
            else:
                assert prims == list(range(500))
    root, _ = bb.build(BuildQualityEnum.MEDIUM, lower, upper, 4, rtcore=CPU)
    stack, widest = [root], 0
    while stack:
        n = stack.pop()
        if isinstance(n, bb.InnerNode):
            assert len(n.children) <= 4
            widest = max(widest, len(n.children))
            stack.extend(n.children)
    assert widest > 2
    lo2, hi2 = bb.make_random_prims(2000)
    assert (bb.build(BuildQualityEnum.MEDIUM, lo2, hi2, rtcore=CPU)[0].sah()
            < bb.build(BuildQualityEnum.LOW, lo2, hi2, rtcore=CPU)[0].sah())
    args = BuildArguments(
        create_node=lambda n: bb.InnerNode(),
        set_node_children=lambda node, ch: node.children.extend(ch),
        set_node_bounds=lambda node, bs: node.bounds.extend(bs),
        create_leaf=lambda prims: bb.LeafNode(prims),
        progress=lambda f: f < 0.25)
    with pytest.raises(BuildCancelled):
        build_user_bvh(args, *bb.make_random_prims(100))
    dev = rtc.rtcNewDevice(CPU)
    bvh = rtc.rtcNewBVH(dev)
    args = rtc.rtcDefaultBuildArguments()
    args.create_node = lambda n: bb.InnerNode()
    args.set_node_children = lambda node, ch: node.children.extend(ch)
    args.set_node_bounds = lambda node, bs: node.bounds.extend(bs)
    args.create_leaf = lambda prims: bb.LeafNode(prims)
    assert rtc.rtcThreadLocalAlloc(None, 64) is None
    root = rtc.rtcBuildBVH(bvh, args, *bb.make_random_prims(64))
    assert _collect_prims(root) == list(range(64)) and bvh.root is root
    rtc.rtcReleaseBVH(bvh)


def test_pluecker_against_moeller_and_jax(rng):
    """tests/test_pluecker.py in the port: the Pluecker test agrees with
    Moeller inside the triangle and is watertight on a shared edge; and
    it equals the JAX package's on the same rays (valid equal, t at 5e-5
    relative, u and v at 1e-4), backface culling included."""
    v0 = torch.tensor([0.0, 0.0, 0.0])
    v1 = torch.tensor([1.0, 0.0, 0.0])
    v2 = torch.tensor([0.0, 1.0, 0.0])
    v3 = torch.tensor([1.0, 1.0, 0.0])
    n = 5000
    org = torch.from_numpy(np.concatenate(
        [rng.uniform(0.01, 0.45, (n, 2)), np.full((n, 1), 3.0)],
        1).astype(np.float32))
    d = torch.tensor([0, 0, -1.0]).expand(n, 3)
    tn, tf = torch.zeros(n), torch.full((n,), np.inf)
    okm, tm, um, _vm, ngm = intersect_triangle(org, d, tn, tf, v0, v1, v2)
    okp, tp, up, _vp, ngp = intersect_triangle_pluecker(org, d, tn, tf,
                                                        v0, v1, v2)
    assert torch.equal(okm, okp) and okm.all()
    np.testing.assert_allclose(tp[okm].numpy(), tm[okm].numpy(), rtol=1e-5)
    np.testing.assert_allclose(up[okm].numpy(), um[okm].numpy(), atol=1e-5)
    assert float((ngm * ngp).sum()) > 0

    s = torch.from_numpy(rng.uniform(0, 1, 20000).astype(np.float32))
    pts = v1[None] * s[:, None] + v2[None] * (1 - s[:, None])
    eorg = torch.cat([pts[:, :2], torch.full((20000, 1), 5.0)], 1)
    ed = torch.tensor([0, 0, -1.0]).expand(20000, 3)
    etn, etf = torch.zeros(20000), torch.full((20000,), np.inf)
    hA = intersect_triangle_pluecker(eorg, ed, etn, etf, v0, v1, v2)[0]
    hB = intersect_triangle_pluecker(eorg, ed, etn, etf, v3, v2, v1)[0]
    assert (hA.int() + hB.int() > 0).all(), "edge miss: not watertight"

    tri = [rng.uniform(-1, 1, 3).astype(np.float32) for _ in range(3)]
    ro = rng.uniform(-2, 2, (2000, 3)).astype(np.float32)
    w = rng.uniform(0, 0.8, (2000, 2)).astype(np.float32)
    rd = (tri[0] + w[:, :1] * (tri[1] - tri[0]) + w[:, 1:] * (tri[2] - tri[0])
          - ro).astype(np.float32)
    for cull in (False, True):
        a = intersect_triangle_pluecker(
            torch.from_numpy(ro), torch.from_numpy(rd), torch.zeros(2000),
            torch.full((2000,), np.inf), *(torch.from_numpy(x) for x in tri),
            backface_cull=cull)
        b = ref_moeller.intersect_triangle_pluecker(
            jnp.asarray(ro), jnp.asarray(rd), jnp.zeros(2000),
            jnp.full(2000, jnp.inf), *(jnp.asarray(x) for x in tri),
            backface_cull=cull)
        ok = np.asarray(b[0])
        np.testing.assert_array_equal(a[0].numpy(), ok)
        assert ok.sum() > 30
        np.testing.assert_allclose(a[1].numpy()[ok], np.asarray(b[1])[ok],
                                   rtol=5e-5)
        # u, v are quotients of edge volumes, each a difference of
        # products that XLA:CPU contracts into FMAs
        for x, y in zip(a[2:4], b[2:4]):
            np.testing.assert_allclose(x.numpy()[ok], np.asarray(y)[ok],
                                       atol=1e-4)
