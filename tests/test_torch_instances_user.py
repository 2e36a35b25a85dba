"""Instances and user geometry through the port's scene
(embree_tpu_torch/scene/scene.py) against the JAX package: the port's
forms of tests/test_instances_user.py and of the instance and user cases
of tests/test_mixed_fastpath.py, the open-merge entry boxes and the
world-to-local transforms byte for byte, instanced scenes carried across
with `instance_entries_from_reference`, and a filter that rejects hits
inside instances against the JAX package's restart wavefront.

The port runs the plain versions of its kernels here (CPU tensors); the
JAX package its XLA path. Tolerances: valid, prim_id, geom_id and
inst_id equal; t at 5e-5 relative (ROADMAP.md C.3: XLA:CPU contracts
FMAs, the port does not); Ng at 1e-5 of its length; occlusion equal.
The rays each instance gathers and the transform check are in
test_torch_instances_user_reaching.py, which uses the helpers below."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import embree_tpu as et
import embree_tpu_torch as ett
from embree_tpu.build import twolevel as ref_twolevel
from embree_tpu.scene import scene as ref_scene
from embree_tpu_torch.build import twolevel as port_twolevel
from embree_tpu_torch.build.bvh import sah_cost
from embree_tpu_torch.build.sah import BuildSettings, build_sah
from embree_tpu_torch.convert import (committed_scene_from_reference,
                                      instance_entries_from_reference)
from embree_tpu_torch.scene import scene as port_scene
from embree_tpu_torch.scene.prims import prim_bounds_np
from embree_tpu_torch.traverse import rowtrace2 as rt2
from embree_tpu_torch.verify.fixtures import subdiv_cube, triangle_sphere
from test_torch_build import reference_native  # noqa: F401,E402
from test_torch_scene_paths import reference_arrays  # noqa: E402

CFG = "ignore_config_files=1"
PKGS = (et, ett)


def device(pkg, cfg=CFG):
    return pkg.Device(cfg) if pkg is et else pkg.Device(cfg, device="cpu")


def rays_np(rng, n, lo, hi):
    org = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org, d


def aimed_rays_np(rng, n, radius, spread):
    """Rays from a sphere of `radius` aimed at points uniform in
    [-spread, spread]^3."""
    org = rng.normal(size=(n, 3)).astype(np.float32)
    org *= radius / np.linalg.norm(org, axis=1, keepdims=True)
    d = rng.uniform(-spread, spread, (n, 3)).astype(np.float32) - org
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org, d


def make_rays(pkg, org, d):
    if pkg is et:
        return et.make_rays(org, d)
    return ett.make_rays(org, d, device="cpu")


def sphere_fns(pkg, centers, radii):
    """The analytic-sphere user callbacks of tests/test_instances_user.py
    in either package's ops: bounds on the host, intersect on the rays'
    arrays."""
    def bounds_fn(ids):
        return (centers[ids] - radii[ids][:, None],
                centers[ids] + radii[ids][:, None])

    if pkg is et:
        cj, rj, xp = jnp.asarray(centers), jnp.asarray(radii), jnp
    else:
        cj, rj, xp = torch.from_numpy(centers), torch.from_numpy(radii), torch

    def intersect_fn(p, rays, tfar):
        oc = rays.org - cj[p]
        b = (oc * rays.dir).sum(-1)
        cc = (oc * oc).sum(-1) - rj[p] ** 2
        a = (rays.dir * rays.dir).sum(-1)
        disc = b * b - a * cc
        ok = disc >= 0
        sq = xp.sqrt(xp.maximum(disc, xp.zeros_like(disc)))
        den = xp.maximum(a, xp.full_like(a, 1e-20))
        t0 = (-b - sq) / den
        t1 = (-b + sq) / den
        th = xp.where(t0 > rays.tnear, t0, t1)
        ok = ok & (th > rays.tnear) & (th < tfar)
        ng = rays.org + th[..., None] * rays.dir - cj[p]
        return ok, th, th * 0, th * 0, ng

    return bounds_fn, intersect_fn


def compare(label, ref, port, rays_ref, rays_port, occ=True):
    """The port's answers equal the JAX package's at the module's
    tolerances; returns the number of hits."""
    hj = ref.intersect(rays_ref)
    hp = port.intersect(rays_port)
    v = np.asarray(hj.valid)
    np.testing.assert_array_equal(hp.valid.numpy(), v, err_msg=label)
    for k in ("prim_id", "geom_id", "inst_id"):
        np.testing.assert_array_equal(getattr(hp, k).numpy()[v],
                                      np.asarray(getattr(hj, k))[v],
                                      err_msg=f"{label}: {k}")
    np.testing.assert_allclose(hp.t.numpy()[v], np.asarray(hj.t)[v],
                               rtol=5e-5, err_msg=f"{label}: t")
    # a user sphere's Ng is its hit point minus its center, so it moves
    # with t: by |dt| for these unit directions
    ng_j = np.asarray(hj.ng)[v]
    err = np.linalg.norm(hp.ng.numpy()[v] - ng_j, axis=1)
    tol = 1e-5 * np.linalg.norm(ng_j, axis=1)
    tol += np.where(np.asarray(hj.gprim)[v] < 0,
                    np.abs(hp.t.numpy()[v] - np.asarray(hj.t)[v]), 0)
    assert (err <= tol).all(), (label, float((err - tol).max()))
    if occ:
        np.testing.assert_array_equal(port.occluded(rays_port).numpy(),
                                      np.asarray(ref.occluded(rays_ref)),
                                      err_msg=f"{label}: occluded")
    return int(v.sum())


def xfm(rot_deg, scale, offset, axis=(0.3, 1.0, 0.2)):
    """(3, 4) f32 local -> world: a rotation about `axis`, a uniform
    scale and an offset."""
    a = np.asarray(axis, np.float64)
    a /= np.linalg.norm(a)
    th = np.deg2rad(rot_deg)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    R = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K
    return np.concatenate([scale * R, np.asarray(offset)[:, None]],
                          1).astype(np.float32)


def test_open_merge_entries_and_transforms_byte_equal(rng):
    """open_merge_entries on the long rotated bars of
    test_open_merge_top_level_sah equals the JAX package's byte for byte
    and passes that test's SAH gates; a committed instanced scene has
    the JAX package's world2local, local2world and entry boxes byte for
    byte, and carried across with `instance_entries_from_reference` it
    answers as the port's own commit does."""
    nseg = 60
    v0 = np.stack([np.linspace(0, 10, nseg), np.zeros(nseg),
                   np.zeros(nseg)], 1).astype(np.float32)
    e1 = np.array([0.1, 0.12, 0], np.float32)
    e2 = np.array([0.1, 0, 0.12], np.float32)
    lo, hi = prim_bounds_np(v0, v0 + e1, v0 + e2)
    bar = build_sah(lo, hi, BuildSettings())
    insts, all_lo, all_hi = [], [], []
    for k in range(24):
        a = 2 * np.pi * k / 24
        R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                      [0, 0, 1]], np.float32)
        insts.append((np.concatenate([R, np.zeros((3, 1), np.float32)], 1),
                      bar.lower, bar.upper, bar.child, bar.count))
        all_lo.append(np.minimum(lo @ R.T, hi @ R.T))
        all_hi.append(np.maximum(lo @ R.T, hi @ R.T))
    for factor in (24.0, 8.0, 1.0):
        a = port_twolevel.open_merge_entries(insts, budget_factor=factor)
        b = ref_twolevel.open_merge_entries(insts, budget_factor=factor)
        for k in ("lower", "upper", "inst"):
            x, y = getattr(a, k), getattr(b, k)
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), k
    c_flat = sah_cost(build_sah(np.concatenate(all_lo),
                                np.concatenate(all_hi), BuildSettings()))
    ent = port_twolevel.open_merge_entries(insts, budget_factor=24.0)
    c_open = sah_cost(build_sah(ent.lower, ent.upper, BuildSettings()))
    roots = port_twolevel.open_merge_entries(insts, budget_factor=1.0)
    assert roots.lower.shape[0] <= 26
    c_roots = sah_cost(build_sah(roots.lower, roots.upper, BuildSettings()))
    assert c_open <= 1.2 * c_flat and c_roots > 1.4 * c_flat
    assert c_open < 0.85 * c_roots

    verts, idx = triangle_sphere((0, 0, 0), 1.0, 12)
    xfms = [xfm(37, 1.3, (3, 0, 0)), xfm(-81, 0.6, (-2, 1, 0.5)),
            xfm(150, 2.1, (0, -3, 1), axis=(1, 0, 0))]
    scenes = []
    for pkg in PKGS:
        dev = device(pkg)
        child = pkg.Scene(dev)
        child.attach(pkg.TriangleMesh(verts, idx))
        child.commit()
        top = pkg.Scene(dev)
        top.attach(pkg.TriangleMesh(*triangle_sphere((0, 4, 0), 0.5, 6)))
        for x in xfms:
            top.attach(pkg.Instance(child, x))
        top.commit()
        scenes.append((child, top))
    (rchild, rtop), (pchild, ptop) = scenes
    rinst, pinst = rtop.committed.instances, ptop.committed.instances
    assert len(rinst) == len(pinst) == 3
    for ri, pi in zip(rinst, pinst):
        assert int(ri.inst_id) == pi.inst_id
        for k in ("local2world", "world2local", "cull_lower", "cull_upper"):
            x, y = np.asarray(getattr(pi, k)), np.asarray(getattr(ri, k))
            assert x.dtype == y.dtype == np.float32, k
            assert x.shape == y.shape and x.tobytes() == y.tobytes(), k
        assert pi.child is pchild.committed     # shared, not copied
    # the JAX package's committed state carried across
    child_cs = committed_scene_from_reference(
        reference_arrays(rchild.committed), "cpu")
    entries = instance_entries_from_reference(
        [dict(inst_id=int(ri.inst_id), child=child_cs,
              local2world=np.asarray(ri.local2world),
              world2local=np.asarray(ri.world2local),
              cull_lower=np.asarray(ri.cull_lower),
              cull_upper=np.asarray(ri.cull_upper)) for ri in rinst], "cpu")
    top_cs = committed_scene_from_reference(
        reference_arrays(rtop.committed), "cpu")._replace(instances=entries)
    org, d = rays_np(rng, 800, -4, 5)
    rays = make_rays(ett, org, d)
    a = ett.scene_intersect(top_cs, rays)
    b = ett.scene_intersect(ptop.committed, rays)
    for k in a._fields:
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert torch.equal(ett.scene_occluded(top_cs, rays),
                       ett.scene_occluded(ptop.committed, rays))
    assert int((a.inst_id >= 0).sum()) > 50
    # world bounds leave the instances out, as in the JAX package
    for x, y in zip(ptop.bounds, rtop.bounds):
        assert np.asarray(x).tobytes() == np.asarray(y).tobytes()


def test_instances_two_and_nested_against_jax(rng):
    """test_instances_transform_and_ids and test_nested_instances in the
    port, then 1,000 random rays through a scene of two rotated, scaled
    instances and through a nested one (an instance of a scene that holds
    an instance and triangles of its own) against the JAX package."""
    verts, idx = triangle_sphere((0, 0, 0), 1.0, 16)
    dev = device(ett)
    child = ett.Scene(dev)
    child.attach(ett.TriangleMesh(verts, idx))
    child.commit()
    top = ett.Scene(dev)
    i1 = top.attach(ett.Instance(child, np.array(
        [[1, 0, 0, 3], [0, 1, 0, 0], [0, 0, 1, 0]], np.float32)))
    i2 = top.attach(ett.Instance(child, np.array(
        [[2, 0, 0, -4], [0, 2, 0, 0], [0, 0, 2, 0]], np.float32)))
    top.commit()
    org = np.array([[3, 0, 5], [-4, 0, 9], [0, 5, 0]], np.float32)
    d = np.array([[0, 0, -1], [0, 0, -1], [0, -1, 0]], np.float32)
    h = top.intersect(make_rays(ett, org, d))
    assert h.valid.tolist() == [True, True, False]
    np.testing.assert_allclose(h.t[:2].numpy(), [4.0, 7.0], atol=1e-3)
    assert h.inst_id[:2].tolist() == [i1, i2]
    assert top.occluded(make_rays(ett, org, d)).tolist() == [True, True,
                                                             False]
    mid = ett.Scene(dev)
    mid.attach_by_id(ett.Instance(child, np.array(
        [[1, 0, 0, 0], [0, 1, 0, 2], [0, 0, 1, 0]], np.float32)), 7)
    mid.commit()
    nest = ett.Scene(dev)
    nest.attach(ett.Instance(mid, np.array(
        [[1, 0, 0, 5], [0, 1, 0, 0], [0, 0, 1, 0]], np.float32)))
    nest.commit()
    h = nest.intersect(make_rays(ett, np.array([[5, 2, 4]], np.float32),
                                 np.array([[0, 0, -1]], np.float32)))
    assert h.valid.item() and abs(h.t.item() - 3.0) < 1e-3
    # the hit reports the outermost instance (0), not the inner one (7),
    # as the JAX package does (ROADMAP.md C.2)
    assert h.inst_id.item() == 0
    # a child on another device than its parent is refused at commit
    other = ett.Scene(ett.Device(CFG, device="meta"))
    other.attach(ett.Instance(child, np.eye(3, 4, dtype=np.float32)))
    with pytest.raises(ett.RaytracerError, match="child scene is on cpu"):
        other.commit()

    verts, idx = triangle_sphere((0, 0, 0), 1.0, 10)
    pair = {}
    for pkg in PKGS:
        dev = device(pkg)
        child = pkg.Scene(dev)
        child.attach(pkg.TriangleMesh(verts, idx))
        child.commit()
        two = pkg.Scene(dev)
        two.attach(pkg.Instance(child, xfm(30, 1.4, (1.5, 0, 0))))
        two.attach(pkg.Instance(child, xfm(-60, 0.7, (-1.5, 0.5, 0))))
        two.commit()
        mid = pkg.Scene(dev)
        mid.attach(pkg.TriangleMesh(*triangle_sphere((0, -2, 0), 0.6, 6)))
        mid.attach(pkg.Instance(child, xfm(45, 0.8, (0, 1, 0))))
        mid.commit()
        nest = pkg.Scene(dev)
        nest.attach(pkg.Instance(mid, xfm(20, 1.2, (1, 0, 0))))
        nest.attach(pkg.Instance(mid, xfm(200, 1.0, (-2, 0, 1),
                                          axis=(0, 0, 1))))
        nest.attach(pkg.TriangleMesh(*triangle_sphere((0, 0, 3), 0.5, 6)))
        nest.commit()
        pair[pkg] = (two, nest)
    org, d = aimed_rays_np(rng, 1000, 6.0, 2.5)
    rr, rp = make_rays(et, org, d), make_rays(ett, org, d)
    for k, (label, least) in enumerate((("two instances", 300),
                                        ("nested", 60))):
        n = compare(label, pair[et][k], pair[ett][k], rr, rp)
        assert n > least, (label, n)


def test_user_geometry_and_mixed_scene_against_jax(rng):
    """test_user_geometry_spheres and
    test_user_geometry_mixed_with_triangles in the port, then 1,000
    random rays through a scene of triangles, analytic-sphere user
    geometry and an instance of a compressed subdivision child (grid
    mode) against the JAX package."""
    centers = np.array([[0, 0, 0], [3, 0, 0], [0, 3, 0]], np.float32)
    radii = np.array([1.0, 0.5, 0.25], np.float32)
    s = ett.Scene(device(ett))
    gid = s.attach(ett.UserGeometry(3, *sphere_fns(ett, centers, radii)))
    s.commit()
    org = np.array([[0, 0, 5], [3, 0, 5], [0, 3, 5], [5, 5, 5]], np.float32)
    d = np.array([[0, 0, -1]] * 4, np.float32)
    h = s.intersect(make_rays(ett, org, d))
    assert h.valid.tolist() == [True, True, True, False]
    np.testing.assert_allclose(h.t[:3].numpy(), [4.0, 4.5, 4.75], atol=1e-4)
    assert (h.geom_id[h.valid] == gid).all()
    assert h.prim_id[:3].tolist() == [0, 1, 2]
    assert s.occluded(make_rays(ett, org, d)).tolist() == h.valid.tolist()

    s = ett.Scene(device(ett))
    s.attach(ett.TriangleMesh(
        np.array([[-2, -2, 0], [2, -2, 0], [0, 2, 0]], np.float32),
        np.array([[0, 1, 2]], np.int32)))
    s.attach(ett.UserGeometry(1, *sphere_fns(
        ett, np.array([[0, 0, 2]], np.float32), np.array([0.5], np.float32))))
    s.commit()
    h = s.intersect(make_rays(ett, np.array([[0, 0, 5]], np.float32),
                              np.array([[0, 0, -1]], np.float32)))
    assert abs(h.t.item() - 2.5) < 1e-4

    uc = rng.uniform(-2.5, 2.5, (12, 3)).astype(np.float32)
    ur = rng.uniform(0.2, 0.5, 12).astype(np.float32)
    scenes = {}
    for pkg in PKGS:
        sub = pkg.Scene(device(pkg,
                               CFG + ",subdiv_accel=bvh4.compressed.grid"))
        sub.attach(pkg.SubdivMesh(*subdiv_cube()))
        sub.set_levels(3, 2)
        sub.commit()
        top = pkg.Scene(device(pkg))
        top.attach(pkg.TriangleMesh(*triangle_sphere((1.5, 0, 0), 1.0, 10)))
        top.attach(pkg.UserGeometry(12, *sphere_fns(pkg, uc, ur)))
        top.attach(pkg.Instance(sub, xfm(25, 0.9, (-1.5, 0.3, 0))))
        top.commit()
        scenes[pkg] = top
    assert scenes[ett].committed.instances[0].child.compressed is not None
    org, d = aimed_rays_np(rng, 1000, 6.0, 2.5)
    n = compare("triangles + user + compressed child", scenes[et],
                scenes[ett], make_rays(et, org, d), make_rays(ett, org, d))
    assert n > 300
    h = scenes[ett].intersect(make_rays(ett, org, d))
    assert {0, 1} <= set(h.geom_id[h.valid].tolist())
    inside = h.inst_id == 2
    assert inside.sum() > 20 and (h.gprim[inside] == -1).all()


def test_cull_and_mixed_fast_paths(rng, monkeypatch):
    """test_instance_cull_preserves_hits in the port (six instances
    against a flattened copy) and the instance and user cases of
    test_mixed_fastpath.py: triangles through the treelet path (B1's plain
    version, ROWTRACE_MIN_RAYS monkeypatched to 256 as there) with an
    instance or user geometry folded on top, against the JAX package."""
    verts, idx = triangle_sphere((0, 0, 0), 1.0, 12)
    dev = device(ett)
    child = ett.Scene(dev)
    child.attach(ett.TriangleMesh(verts, idx))
    child.commit()
    top, flat = ett.Scene(dev), ett.Scene(dev)
    fv, fi = [], []
    for k in range(6):
        top.attach(ett.Instance(child, np.array(
            [[1, 0, 0, 3.0 * k], [0, 1, 0, 0], [0, 0, 1, 0]], np.float32)))
        fv.append(verts + np.array([3.0 * k, 0, 0], np.float32))
        fi.append(idx + k * verts.shape[0])
    cs = top.commit()
    flat.attach(ett.TriangleMesh(np.concatenate(fv), np.concatenate(fi)))
    fcs = flat.commit()
    assert cs.instances and cs.instances[0].cull_lower is not None
    org = rng.uniform(-2, 18, (500, 3)).astype(np.float32)
    org[:, 1:] = rng.uniform(-4, 4, (500, 2))
    d = rng.uniform([0, -1, -1], [15, 1, 1], (500, 3)).astype(np.float32)
    d -= org
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = make_rays(ett, org, d)
    h, hf = ett.scene_intersect(cs, rays), ett.scene_intersect(fcs, rays)
    assert torch.equal(h.valid, hf.valid) and int(h.valid.sum()) > 50
    np.testing.assert_allclose(h.t[h.valid].numpy(), hf.t[hf.valid].numpy(),
                               rtol=1e-5)
    # the cull retires rays: fewer enter the children than without it
    reach = port_scene._entry_cull(cs.instances[0].cull_lower,
                                   cs.instances[0].cull_upper, rays,
                                   rays.tfar)
    assert 0 < int(reach.sum()) < 250
    # the entry boxes come from the child's triangle BVH alone, in both
    # packages (ROADMAP.md C.2): the child's user sphere outside them is
    # culled away through the instance, and hit in the child itself
    org = np.array([[5, 0, 5], [0, 0, 5]], np.float32)
    d = np.array([[0, 0, -1], [0, 0, -1]], np.float32)
    for pkg in PKGS:
        kid = pkg.Scene(device(pkg))
        kid.attach(pkg.TriangleMesh(*triangle_sphere((0, 0, 0), 1.0, 6)))
        kid.attach(pkg.UserGeometry(1, *sphere_fns(
            pkg, np.array([[5, 0, 0]], np.float32),
            np.array([0.5], np.float32))))
        kid.commit()
        above = pkg.Scene(device(pkg))
        above.attach(pkg.Instance(kid, np.eye(3, 4, dtype=np.float32)))
        above.commit()
        r = make_rays(pkg, org, d)
        assert np.asarray(kid.intersect(r).valid).tolist() == [True, True]
        assert np.asarray(above.intersect(r).valid).tolist() == [False, True]

    monkeypatch.setattr(port_scene, "ROWTRACE_MIN_RAYS", 256)
    calls = {"rowtrace2": 0}
    plain = rt2.rowtrace2_plain

    def count(*a, **k):
        calls["rowtrace2"] += 1
        return plain(*a, **k)

    monkeypatch.setattr(rt2, "rowtrace2_plain", count)
    cfg = CFG + ",tri_accel=bvh4.rowtrace"
    verts, idx = triangle_sphere((0, 0, 0), 1.0, 12)
    centers = rng.uniform(-1.5, 1.5, (8, 3)).astype(np.float32)
    radii = np.full(8, 0.4, np.float32)
    for case in ("instance", "user"):
        scenes = {}
        for pkg in PKGS:
            dev = device(pkg, cfg)
            s = pkg.Scene(dev)
            if case == "instance":
                inner = pkg.Scene(dev)
                inner.attach(pkg.TriangleMesh(verts, idx))
                inner.commit()
                s.attach(pkg.TriangleMesh(verts, idx))
                s.attach(pkg.Instance(inner, np.array(
                    [[1, 0, 0, 2.0], [0, 1, 0, 0], [0, 0, 1, 0]],
                    np.float32)))
            else:
                s.attach(pkg.TriangleMesh(*triangle_sphere((0, 0, 0), 1.4,
                                                           12)))
                s.attach(pkg.UserGeometry(8, *sphere_fns(pkg, centers,
                                                         radii)))
            s.commit()
            scenes[pkg] = s
        assert scenes[ett].committed.rowtrace is not None
        org, d = aimed_rays_np(rng, 1024, 4.0, 1.5)
        before = calls["rowtrace2"]
        n = compare(f"tris + {case} on the treelet path", scenes[et],
                    scenes[ett], make_rays(et, org, d),
                    make_rays(ett, org, d))
        assert n > 200
        # closest and occluded at the top, and (instance) in the child
        assert calls["rowtrace2"] - before == (4 if case == "instance"
                                               else 2)


def test_filter_rejecting_instance_hits_matches_jax_restart(rng):
    """A filter that rejects every hit of an odd prim (inside the
    instanced spheres too) through the port's restart wavefront equals
    the JAX package's `_intersect_filter_restart` on the same scene:
    rays entering an instanced sphere meet several rejected hits before
    one is accepted."""
    verts, idx = triangle_sphere((0, 0, 0), 1.0, 10)
    scenes = {}
    for pkg in PKGS:
        dev = device(pkg)
        child = pkg.Scene(dev)
        child.attach(pkg.TriangleMesh(verts, idx))
        child.commit()
        top = pkg.Scene(dev)
        top.attach(pkg.TriangleMesh(*triangle_sphere((0, 0, 0), 0.6, 8)))
        top.attach(pkg.Instance(child, xfm(40, 1.2, (1.6, 0, 0))))
        top.attach(pkg.Instance(child, xfm(-20, 0.9, (-1.6, 0.4, 0))))
        top.commit()
        scenes[pkg] = top

    def filt(org, d, t, u, v, ng, geom, prim):
        return (prim % 2) == 0

    org, d = aimed_rays_np(rng, 600, 5.0, 2.0)
    rr = make_rays(et, org, d)
    hj = ref_scene._intersect_filter_restart(scenes[et].committed, rr, "xla",
                                             filt, None, False, None)
    scenes[ett].set_intersection_filter(filt)
    hp = scenes[ett].intersect(make_rays(ett, org, d))
    v = np.asarray(hj.valid)
    np.testing.assert_array_equal(hp.valid.numpy(), v)
    assert v.sum() > 150
    for k in ("prim_id", "geom_id", "inst_id"):
        np.testing.assert_array_equal(getattr(hp, k).numpy()[v],
                                      np.asarray(getattr(hj, k))[v], k)
    assert (hp.prim_id[hp.valid] % 2 == 0).all()
    assert (hp.inst_id[hp.valid] >= 0).sum() > 100
    np.testing.assert_allclose(hp.t.numpy()[v], np.asarray(hj.t)[v],
                               rtol=5e-5)
    # the unfiltered answer differs: the filter rejected something
    un = ett.scene_intersect(scenes[ett].committed, make_rays(ett, org, d))
    assert (un.prim_id[un.valid] % 2 == 1).any()
    # a rejected hit of an instanced compressed child in a slab mode raises,
    # as one of the scene's own does (the restart would crawl a float a
    # round, ROADMAP.md C.2)
    sub = ett.Scene(device(ett, CFG + ",subdiv_accel=bvh4.compressed.box"))
    sub.attach(ett.SubdivMesh(*subdiv_cube()))
    sub.set_levels(3, 2)
    sub.commit()
    top = ett.Scene(device(ett))
    top.attach(ett.Instance(sub, xfm(10, 1.0, (0, 0, 0))))
    top.commit()
    top.set_intersection_filter(lambda org, d, t, *a: t > 1e9)
    with pytest.raises(ett.RaytracerError,
                       match="not ported yet: .*bvh4.compressed.box"):
        top.intersect(make_rays(ett, org, d))
