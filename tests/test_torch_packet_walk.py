"""The packet walks' public entries (embree_tpu_torch/traverse/packet.py:
`intersect_packet`, `intersect_chunked`, `occluded_packet`,
`occluded_chunked`) against the JAX package's shared-stack walks
(embree_tpu/traverse/packet.py, its XLA path) on one small scene and the
same numpy inputs: batches below and above `packet_size`, ray and prim
masks, backface culling and an intersection filter.

Tolerances, as in tests/test_torch_packet.py: valid masks equal; t 5e-5
relative on every hit (XLA:CPU contracts products into FMAs, the port's
kernel rounds every product); prim equal except where two winners tie
on t (the JAX walk orders children by the nearest ray of a whole packet,
the port by the ray's own distance), and those rays are counted. Every
ninth ray is retired with tfar = -inf. The JAX package answers such a
ray two ways (ROADMAP.md C.2): its XLA walks say it is not occluded,
and the port's walks follow them; its kernel paths (B1, B2: the any-hit
answer is t == -inf, and t starts at tfar) say it is, and the port's
`scene_occluded`, which runs the kernels, follows those."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from embree_tpu.build.sah import BuildSettings as RefSettings
from embree_tpu.build.sah import build_sah as ref_build_sah
from embree_tpu.core.rayhit import Rays as RefRays
from embree_tpu.scene.prims import TrianglePrims as RefPrims
from embree_tpu.traverse import packet as ref_packet
import embree_tpu_torch as ett
from embree_tpu_torch.build.sah import BuildSettings, build_sah
from embree_tpu_torch.scene.prims import TrianglePrims, prim_bounds_np
from embree_tpu_torch.traverse import packet
from embree_tpu_torch.verify.fixtures import random_triangles
from test_torch_build import reference_native  # noqa: F401,E402

PACKET = 256
SMALL, LARGE = 200, 600     # rays below and above PACKET


def reject_thirds(org, d, t, u, v, ng, geom_id, prim_id):
    """Rejects every third primitive: per candidate in the JAX walk
    (scalar ids), per ray in the port's restart (id tensors)."""
    return prim_id % 3 != 0


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(0x9A1C)
    verts, idx = random_triangles(rng, 400, extent=4.0, size=1.0)
    v = np.asarray(verts, np.float32)[idx]
    v0, v1, v2 = (np.ascontiguousarray(v[:, k]) for k in range(3))
    T = len(idx)
    geom = np.zeros(T, np.int32)
    prim = np.arange(T, dtype=np.int32)
    flip = np.zeros(T, np.int32)
    mask = (1 + np.arange(T) % 2).astype(np.int32)
    lo, hi = prim_bounds_np(v0, v1, v2)
    ref_bvh = ref_build_sah(lo, hi, RefSettings()).to_device()
    ref_tris = RefPrims(*map(jnp.asarray, (v0, v1, v2, geom, prim, flip)))
    bvh = build_sah(lo, hi, BuildSettings()).to_device("cpu")
    tris = TrianglePrims(*(torch.tensor(a) for a in
                           (v0, v1, v2, geom, prim, flip)))
    org = rng.uniform(-5, 5, (LARGE, 3)).astype(np.float32)
    cen = (v0 + v1 + v2) / 3
    tgt = cen[rng.integers(0, T, LARGE)]
    d = tgt - org
    d[1::2] = rng.normal(size=(LARGE // 2, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tf = np.full(LARGE, np.inf, np.float32)
    tf[::9] = -np.inf                       # retired rays
    ray_mask = rng.integers(0, 4, LARGE).astype(np.int32)
    return dict(bvh=bvh, tris=tris, ref_bvh=ref_bvh, ref_tris=ref_tris,
                org=org, d=d, tf=tf, mask=mask, ray_mask=ray_mask)


def rays(s, n):
    return ett.make_rays(s["org"][:n], s["d"][:n], 0.0, s["tf"][:n],
                         device="cpu")


def ref_rays(s, n):
    return RefRays(jnp.asarray(s["org"][:n]), jnp.asarray(s["d"][:n]),
                   jnp.zeros(n), jnp.asarray(s["tf"][:n]))


def assert_hits_match(ref, port):
    """Returns the number of rays whose prim differs on a tie."""
    rv = np.asarray(ref.valid)
    np.testing.assert_array_equal(port.valid.numpy(), rv)
    rt, pt = np.asarray(ref.t), port.t.numpy()
    np.testing.assert_allclose(pt[rv], rt[rv], rtol=5e-5)
    np.testing.assert_array_equal(pt[~rv], rt[~rv])
    same = np.asarray(ref.gprim) == port.gprim.numpy()
    np.testing.assert_allclose(pt[~same], rt[~same], rtol=5e-5)
    np.testing.assert_array_equal(port.prim_id.numpy()[same],
                                  np.asarray(ref.prim_id)[same])
    return int((~same).sum())


def assert_occluded_match(ref, port, tf):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    assert not port.numpy()[tf == -np.inf].any()


def test_walks_below_and_above_packet_size(scene):
    s = scene
    args = (s["bvh"], s["tris"])
    ref_args = (s["ref_bvh"], s["ref_tris"])
    ties = 0
    for n in (SMALL, LARGE):
        hj = ref_packet.intersect_chunked(*ref_args, ref_rays(s, n),
                                          packet_size=PACKET)
        h = packet.intersect_chunked(*args, rays(s, n), packet_size=PACKET)
        ties += assert_hits_match(hj, h)
        oj = ref_packet.occluded_chunked(*ref_args, ref_rays(s, n),
                                         packet_size=PACKET)
        o = packet.occluded_chunked(*args, rays(s, n), packet_size=PACKET)
        assert_occluded_match(oj, o, s["tf"][:n])
        assert int(h.valid.sum()) > n // 4
        np.testing.assert_array_equal(o.numpy(), h.valid.numpy())
    # the unchunked entries: a batch below the packet size, in any shape
    hj = ref_packet.intersect_packet(*ref_args, ref_rays(s, SMALL))
    h = packet.intersect_packet(*args, Rays2D(rays(s, SMALL)))
    ties += assert_hits_match(hj, type(h)(*(x.reshape((SMALL,) + x.shape[2:])
                                            for x in h)))
    o = packet.occluded_packet(*args, rays(s, SMALL))
    assert_occluded_match(ref_packet.occluded_packet(
        *ref_args, ref_rays(s, SMALL)), o, s["tf"][:SMALL])
    assert ties <= 2
    # the scene's entry point, on the same triangles and rays
    import embree_tpu as et

    verts = torch.stack(tuple(s["tris"][:3]), 1).reshape(-1, 3).numpy()
    idx = np.arange(len(verts), dtype=np.int32).reshape(-1, 3)
    ref_scene = et.Scene(et.Device("ignore_config_files=1"))
    ref_scene.attach(et.TriangleMesh(verts, idx))
    scene = ett.Scene(ett.Device("ignore_config_files=1", device="cpu"))
    scene.attach(ett.TriangleMesh(verts, idx))
    ref_scene.commit()
    scene.commit()
    occ = scene.occluded(rays(s, LARGE)).numpy()
    live = s["tf"] != -np.inf
    ref_xla = np.asarray(ref_scene.occluded(ref_rays(s, LARGE)))
    np.testing.assert_array_equal(occ[live], ref_xla[live])
    assert not ref_xla[~live].any()
    ref_kernel = np.asarray(et.scene_occluded(
        ref_scene._require_commit(), ref_rays(s, LARGE), isa="pallas"))
    np.testing.assert_array_equal(occ, ref_kernel)
    assert ref_kernel[~live].all()


def Rays2D(r):
    """The same rays as a (n/2, 2) batch."""
    n = r.tnear.shape[0]
    return type(r)(r.org.reshape(n // 2, 2, 3), r.dir.reshape(n // 2, 2, 3),
                   r.tnear.reshape(n // 2, 2), r.tfar.reshape(n // 2, 2))


def test_masks_and_backface_cull(scene):
    s = scene
    args = (s["bvh"], s["tris"])
    ref_args = (s["ref_bvh"], s["ref_tris"])
    pm, rm = s["mask"], s["ray_mask"]
    hj = ref_packet.intersect_chunked(
        *ref_args, ref_rays(s, LARGE), packet_size=PACKET,
        prim_mask=jnp.asarray(pm), ray_mask=jnp.asarray(rm),
        backface_cull=True)
    h = packet.intersect_chunked(
        *args, rays(s, LARGE), packet_size=PACKET,
        prim_mask=torch.tensor(pm), ray_mask=torch.tensor(rm),
        backface_cull=True)
    assert assert_hits_match(hj, h) <= 2
    # rays of mask 0 hit nothing; both masks and the cull took hits away
    assert not h.valid.numpy()[rm == 0].any()
    unmasked = packet.intersect_chunked(*args, rays(s, LARGE))
    assert int(h.valid.sum()) < int(unmasked.valid.sum())
    oj = ref_packet.occluded_chunked(
        *ref_args, ref_rays(s, LARGE), packet_size=PACKET,
        prim_mask=jnp.asarray(pm), ray_mask=jnp.asarray(rm),
        backface_cull=True)
    o = packet.occluded_chunked(
        *args, rays(s, LARGE), packet_size=PACKET,
        prim_mask=torch.tensor(pm), ray_mask=torch.tensor(rm),
        backface_cull=True)
    assert_occluded_match(oj, o, s["tf"])
    # a ray mask without a prim mask masks nothing, as in the JAX walk
    h1 = packet.intersect_chunked(*args, rays(s, LARGE),
                                  ray_mask=torch.tensor(rm))
    np.testing.assert_array_equal(h1.gprim.numpy(), unmasked.gprim.numpy())


def test_filter_restart_matches_the_in_walk_filter(scene):
    """The JAX walk calls the filter per candidate inside the walk; the
    port restarts the rejected rays past the rejected hit. Both give the
    closest accepted hit."""
    s = scene
    hj = ref_packet.intersect_chunked(
        s["ref_bvh"], s["ref_tris"], ref_rays(s, LARGE), packet_size=PACKET,
        filter_fn=reject_thirds)
    h = packet.intersect_chunked(s["bvh"], s["tris"], rays(s, LARGE),
                                 packet_size=PACKET, filter_fn=reject_thirds)
    assert assert_hits_match(hj, h) <= 2
    v = h.valid.numpy()
    assert v.sum() > LARGE // 5
    assert (h.prim_id.numpy()[v] % 3 != 0).all()
    plain = packet.intersect_chunked(s["bvh"], s["tris"], rays(s, LARGE))
    rejected = plain.valid.numpy() & (plain.prim_id.numpy() % 3 == 0)
    assert rejected.sum() > 10
    # a rejected ray found a farther hit or none
    assert (h.t.numpy()[rejected] > plain.t.numpy()[rejected]).all()


def test_schedule_arguments_and_caps(scene):
    """`packet_size`, `stack_depth` and `max_leaf` select nothing in the
    port; in the JAX walk a leaf cap cuts the answer and a stack too
    small for the tree never ends (ROADMAP.md C.2). A leaf of more triangles than kernel B2 tests is
    refused."""
    s = scene
    args = (s["bvh"], s["tris"])
    base = packet.intersect_chunked(*args, rays(s, LARGE))
    for kw in (dict(packet_size=32), dict(stack_depth=4, max_leaf=1)):
        h = packet.intersect_chunked(*args, rays(s, LARGE), **kw)
        for a, b in zip(h, base):
            assert torch.equal(a, b)
    o = packet.occluded_chunked(*args, rays(s, LARGE), stack_depth=4,
                                max_leaf=1)
    np.testing.assert_array_equal(o.numpy(), base.valid.numpy())
    # the JAX walk with a leaf cap of 1 loses hits the full walk finds
    # (with a stack of 4 or 8 its loop does not end: not run here)
    full = ref_packet.intersect_packet(s["ref_bvh"], s["ref_tris"],
                                       ref_rays(s, SMALL))
    cut = ref_packet.intersect_packet(s["ref_bvh"], s["ref_tris"],
                                      ref_rays(s, SMALL), max_leaf=1)
    assert int(np.asarray(cut.valid).sum()) < int(np.asarray(full.valid).sum())
    # a leaf of 9 triangles is refused, not cut
    big = s["bvh"]._replace(count=torch.where(s["bvh"].count > 0, 9,
                                              s["bvh"].count))
    with pytest.raises(ValueError, match="a leaf of 9 triangles"):
        packet.intersect_packet(big, s["tris"], rays(s, SMALL))
