"""The PyTorch port as a whole: Scene / commit / intersect / occluded in
both packages on the same meshes and rays, the reference through its XLA
path (`isa="xla"`), the port on the CPU through the plain version of
each of its two kernels: the packet kernel, which serves these small
scenes by the dispatch rule, and the treelet kernel, reached by asking
for a treelet scene (`tri_accel=....rowtrace`) and lowering
ROWTRACE_MIN_RAYS.

Tolerances: ids equal except on equal-t ties; t 1e-5 relative; u, v 1e-5
absolute; Ng 1e-5 relative to its length. The two sides walk their trees
in another order (and the treelet kernel another tree) and XLA:CPU
contracts FMAs, so nothing here is bit-exact."""
import numpy as np
import pytest
import torch

import embree_tpu as et
import embree_tpu_torch as ett
from embree_tpu_torch.convert import committed_scene_from_reference
from embree_tpu_torch.scene import scene as port_scene
from embree_tpu_torch.verify.fixtures import random_triangles, triangle_sphere


def quad_sphere(center, radius, n):
    center = np.asarray(center, np.float32)
    theta = np.linspace(0.0, np.pi, n + 1)
    phi = np.linspace(0.0, 2.0 * np.pi, n + 1)[:-1]
    tt, pp = np.meshgrid(theta, phi, indexing="ij")
    verts = np.stack([np.sin(tt) * np.cos(pp), np.cos(tt),
                      np.sin(tt) * np.sin(pp)], -1).reshape(-1, 3)
    idx = np.arange((n + 1) * n).reshape(n + 1, n)
    quads = [[idx[i, j], idx[i + 1, j], idx[i + 1, (j + 1) % n],
              idx[i, (j + 1) % n]] for i in range(n) for j in range(n)]
    return ((verts * radius + center).astype(np.float32),
            np.asarray(quads, np.int32))


def make_rays_np(rng, n, extent):
    org = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org, d


def commit_both(geoms, cfg="ignore_config_files=1"):
    """Attach the same geometries to a scene of each package and commit.
    `geoms` is a list of ("tri" | "quad", vertices, indices)."""
    scenes = []
    for pkg, dev in ((et, et.Device(cfg)),
                     (ett, ett.Device(cfg, device="cpu"))):
        sc = pkg.Scene(dev)
        for kind, v, i in geoms:
            mesh = pkg.TriangleMesh if kind == "tri" else pkg.QuadMesh
            sc.attach(mesh(v, i))
        sc.commit()
        scenes.append(sc)
    return scenes


def assert_hits_match(ref, port, min_hits):
    rv = np.asarray(ref.valid)
    assert rv.sum() >= min_hits
    np.testing.assert_array_equal(port.valid.numpy(), rv)
    rt, pt = np.asarray(ref.t), port.t.numpy()
    np.testing.assert_allclose(pt[rv], rt[rv], rtol=1e-5)
    np.testing.assert_array_equal(pt[~rv], rt[~rv])      # tfar on a miss
    same = np.ones_like(rv)
    for name in ("prim_id", "geom_id", "gprim", "inst_id"):
        a, b = np.asarray(getattr(ref, name)), getattr(port, name).numpy()
        assert b.dtype == np.int32
        np.testing.assert_array_equal(b[~rv], a[~rv])
        same &= a == b
    # ids differ only where two prims tie on t, and rarely
    assert (~same).mean() <= 0.005
    np.testing.assert_allclose(pt[~same], rt[~same], rtol=1e-6)
    m = rv & same
    np.testing.assert_allclose(port.u.numpy()[m], np.asarray(ref.u)[m],
                               atol=1e-5)
    np.testing.assert_allclose(port.v.numpy()[m], np.asarray(ref.v)[m],
                               atol=1e-5)
    rng_, png = np.asarray(ref.ng)[m], port.ng.numpy()[m]
    scale = np.linalg.norm(rng_, axis=1, keepdims=True)
    assert (np.abs(png - rng_) <= 1e-5 * scale).all()
    for name in ("u", "v", "ng"):
        assert not getattr(port, name).numpy()[~rv].any()


GEOMS = {
    "triangle_mesh": lambda rng: [("tri", *triangle_sphere((0, 0, 0), 2.0, 20))],
    "two_geometries": lambda rng: [
        ("tri", *triangle_sphere((-1.5, 0, 0), 1.2, 12)),
        ("tri", *random_triangles(rng, 600, extent=3.0, size=0.8))],
    "quad_mesh": lambda rng: [("quad", *quad_sphere((0, 0.2, 0), 1.8, 14))],
    "quads_and_triangles": lambda rng: [
        ("quad", *quad_sphere((1.0, 0, 0), 1.0, 8)),
        ("tri", *triangle_sphere((-1.0, 0, 0), 1.0, 8))],
}


ROWTRACE_CFG = "ignore_config_files=1,tri_accel=bvh4.triangle4.rowtrace"


@pytest.fixture
def kernel_path(request, monkeypatch):
    """The Device config that makes small scenes and batches reach the
    named kernel of the port: "packet" is what the dispatch rule gives
    them; "rowtrace2" asks for a treelet scene and lowers the ray
    threshold."""
    if request.param == "rowtrace2":
        monkeypatch.setattr(port_scene, "ROWTRACE_MIN_RAYS", 1)
        return ROWTRACE_CFG
    return "ignore_config_files=1"


@pytest.mark.parametrize("kernel_path", ["packet", "rowtrace2"],
                         indirect=True)
@pytest.mark.parametrize("case", sorted(GEOMS))
def test_scene_matches_reference(rng, case, kernel_path):
    geoms = GEOMS[case](rng)
    ref_sc, port_sc = commit_both(geoms, kernel_path)
    assert (port_sc.committed.rowtrace is not None) == (
        kernel_path == ROWTRACE_CFG)
    org, d = make_rays_np(rng, 600, 3.0)
    ref = et.scene_intersect(ref_sc.committed, et.make_rays(org, d),
                             isa="xla")
    rays = ett.make_rays(org, d, device="cpu")
    port = port_sc.intersect(rays)
    assert_hits_match(ref, port, 60)
    if len(geoms) > 1:
        assert set(port.geom_id.numpy()[port.valid.numpy()]) == {0, 1}
    if case == "quad_mesh":
        # second triangles of quads report flipped uv: without the flip
        # u + v of half the hits would not exceed 1
        uv = (port.u + port.v)[port.valid]
        assert (uv > 1.0).any() and (uv < 1.0).any()
    ref_occ = et.scene_occluded(ref_sc.committed, et.make_rays(org, d),
                                isa="xla")
    occ = port_sc.occluded(rays)
    assert occ.dtype == torch.bool
    np.testing.assert_array_equal(occ.numpy(), np.asarray(ref_occ))
    for a, b in zip(port_sc.bounds, ref_sc.bounds):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kernel_path", ["packet", "rowtrace2"],
                         indirect=True)
def test_batch_shape_tnear_tfar_and_cull(rng, kernel_path):
    """Rays keep their batch shape; tnear / tfar clip; the
    backface_culling config key reaches the traversal."""
    geoms = [("tri", *triangle_sphere((0, 0, 0), 2.0, 16))]
    cfg = kernel_path + ",backface_culling=1"
    ref_sc, port_sc = commit_both(geoms, cfg)
    assert port_sc.committed.backface_cull is True
    org, d = make_rays_np(rng, 6 * 50, 3.0)
    org, d = org.reshape(6, 50, 3), d.reshape(6, 50, 3)
    tnear = rng.uniform(0, 1, (6, 50)).astype(np.float32)
    tfar = rng.uniform(2, 6, (6, 50)).astype(np.float32)
    ref = et.scene_intersect(ref_sc.committed,
                             et.make_rays(org, d, tnear, tfar), isa="xla")
    port = port_sc.intersect(ett.make_rays(org, d, tnear, tfar,
                                           device="cpu"))
    assert port.t.shape == (6, 50) and port.ng.shape == (6, 50, 3)
    flat_ref = type(ref)(*(np.asarray(x).reshape((300,) + x.shape[2:])
                           for x in ref))
    flat_port = ett.Hits(*(x.reshape((300,) + x.shape[2:]) for x in port))
    assert_hits_match(flat_ref, flat_port, 20)


def reference_arrays(cs) -> dict:
    """The JAX package's committed state as numpy arrays."""
    a = {f"tris.{k}": np.asarray(getattr(cs.tris, k))
         for k in ("v0", "v1", "v2", "geom_id", "prim_id", "uv_flip")}
    a.update({f"bvh.{k}": np.asarray(getattr(cs.bvh, k))
              for k in ("lower", "upper", "child", "count", "prim_order")})
    ps = cs.pallas
    a.update({"packet.nodes": np.asarray(ps.nodes),
              "packet.tdata": np.asarray(ps.tdata),
              "packet.bvh_to_orig": np.asarray(ps.bvh_to_orig),
              "packet.num_nodes": ps.num_nodes,
              "packet.num_prims": ps.num_prims, "packet.width": ps.width})
    rt = cs.rowtrace
    a.update({"rowtrace.blocks": np.asarray(rt.blocks),
              "rowtrace.mid_boxes": np.asarray(rt.mid_boxes),
              "rowtrace.tre_boxes": np.asarray(rt.tre_boxes),
              "rowtrace.fan": rt.fan, "rowtrace.num_mids": rt.num_mids,
              "rowtrace.num_treelets": rt.num_treelets,
              "rowtrace.num_prims": rt.num_prims,
              "prim_mask": np.asarray(cs.prim_mask),
              "world_lower": np.asarray(cs.world_lower),
              "world_upper": np.asarray(cs.world_upper),
              "backface_cull": cs.backface_cull})
    return a


def test_committed_scene_from_reference(rng, monkeypatch):
    """The JAX commit's arrays, carried across, answer exactly as the
    port's own commit of the same meshes does, through either kernel."""
    geoms = [("quad", *quad_sphere((1.0, 0, 0), 1.0, 10)),
             ("tri", *random_triangles(rng, 900, extent=3.0, size=0.8))]
    # both packages build the treelet scene for small meshes only when
    # the accel string asks for it
    ref_sc, port_sc = commit_both(geoms, ROWTRACE_CFG)
    assert ref_sc.committed.rowtrace is not None
    arrays = reference_arrays(ref_sc.committed)
    cs = committed_scene_from_reference(arrays, "cpu")
    own = port_sc.committed
    for a, b in zip(cs.tris, own.tris):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert (cs.rowtrace.fan, cs.rowtrace.num_mids, cs.rowtrace.num_treelets,
            cs.rowtrace.num_prims) == (own.rowtrace.fan,
                                       own.rowtrace.num_mids,
                                       own.rowtrace.num_treelets,
                                       own.rowtrace.num_prims)
    assert torch.equal(cs.rowtrace.blocks.view(torch.int32),
                       own.rowtrace.blocks.view(torch.int32))
    assert torch.equal(cs.rowtrace.mid_boxes, own.rowtrace.mid_boxes)
    assert torch.equal(cs.rowtrace.tre_boxes, own.rowtrace.tre_boxes)
    assert torch.equal(cs.prim_mask, own.prim_mask)
    assert torch.equal(cs.packet.nodes, own.packet.nodes)
    assert torch.equal(cs.packet.tdata, own.packet.tdata)
    assert cs.backface_cull is False
    org, d = make_rays_np(rng, 500, 3.0)
    rays = ett.make_rays(org, d, device="cpu")
    for min_rays in (port_scene.ROWTRACE_MIN_RAYS, 1):   # packet, rowtrace2
        monkeypatch.setattr(port_scene, "ROWTRACE_MIN_RAYS", min_rays)
        h_ref = ett.scene_intersect(cs, rays)
        h_own = port_sc.intersect(rays)
        assert h_own.valid.sum() >= 50
        for a, b in zip(h_ref, h_own):
            assert torch.equal(a, b)
        assert torch.equal(ett.scene_occluded(cs, rays),
                           port_sc.occluded(rays))
    with pytest.raises(ValueError):
        committed_scene_from_reference(
            {**arrays, "rowtrace.num_treelets": 1}, "cpu")
    # the treelet scene may be absent, the packed scene may not
    no_rt = committed_scene_from_reference(
        {k: v for k, v in arrays.items() if not k.startswith("rowtrace")},
        "cpu")
    assert no_rt.rowtrace is None and no_rt.packet is not None
    with pytest.raises(ValueError):
        committed_scene_from_reference(
            {k: v for k, v in arrays.items() if not k.startswith("packet")},
            "cpu")


def test_empty_scene_and_disabled_geometry(rng):
    dev = ett.Device("ignore_config_files=1", device="cpu")
    sc = ett.Scene(dev)
    with pytest.raises(ett.RaytracerError):
        sc.intersect(ett.make_rays(np.zeros((1, 3)), np.ones((1, 3)),
                                   device="cpu"))
    mesh = ett.TriangleMesh(*triangle_sphere((0, 0, 0), 1.0, 8))
    gid = sc.attach(mesh)
    mesh.disable()
    cs = sc.commit()
    assert cs.rowtrace is None and cs.tris.num_prims == 0
    org, d = make_rays_np(rng, 10, 0.5)
    rays = ett.make_rays(org, d, 0.0, 7.0, device="cpu")
    h = sc.intersect(rays)
    assert not h.valid.any() and (h.t == 7.0).all()
    assert not sc.occluded(rays).any()
    mesh.enable()
    sc.commit()
    assert sc.intersect(rays).valid.all()      # origins inside the sphere
    assert dev.bytes_used > 0
    sc.detach(gid)
    with pytest.raises(ett.RaytracerError):
        sc.detach(gid)
    sc.attach_by_id(mesh, 5)
    with pytest.raises(ett.RaytracerError):
        sc.attach_by_id(mesh, 5)
    sc.commit()
    assert set(sc.intersect(rays).geom_id.tolist()) == {5}


def test_unported_arguments_raise(rng):
    dev = ett.Device("ignore_config_files=1", device="cpu")
    sc = ett.Scene(dev)
    sc.attach(ett.TriangleMesh(*triangle_sphere((0, 0, 0), 1.0, 8)))
    sc.commit()
    org, d = make_rays_np(rng, 4, 0.5)
    rays = ett.make_rays(org, d, device="cpu")

    def raises_not_ported(fn):
        with pytest.raises(ett.RaytracerError, match="not ported yet") as e:
            fn()
        assert e.value.code == ett.Error.INVALID_OPERATION

    raises_not_ported(lambda: sc.intersect(rays, time=0.5))
    raises_not_ported(lambda: ett.scene_intersect(
        sc.committed, rays, time=torch.zeros(4)))
    # ray masks and intersection filters are ported: they answer
    plain = sc.intersect(rays)
    assert plain.valid.all()                   # origins inside the sphere
    assert torch.equal(sc.intersect(rays, mask=torch.ones(4)).valid,
                       plain.valid)
    assert not sc.occluded(rays, mask=torch.zeros(4)).any()
    kept = ett.scene_intersect(sc.committed, rays, filter_fn=lambda *a: True)
    assert torch.equal(kept.gprim, plain.gprim)
    sc.set_intersection_filter(lambda *a: False)
    assert not sc.intersect(rays).valid.any()
    sc.set_intersection_filter(None)
    for q in (ett.BuildQuality.LOW, ett.BuildQuality.REFIT):
        low = ett.Scene(dev, quality=q)
        low.attach(ett.TriangleMesh(*triangle_sphere((0, 0, 0), 1.0, 8)))
        raises_not_ported(low.commit)

    class Blob(ett.Geometry):
        num_prims = 1

    other = ett.Scene(dev)
    other.attach(Blob())
    raises_not_ported(other.commit)
    # rays on another device than the scene are refused, not moved
    with pytest.raises(ett.RaytracerError):
        ett.scene_intersect(sc.committed, ett.Rays(
            *(x.to("meta") for x in rays)))
