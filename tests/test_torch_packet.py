"""The packet kernel's module (embree_tpu_torch/traverse/packet_kernel.py)
against embree_tpu/traverse/pallas_packet.py: the packer byte for byte,
and the port's plain version of the kernel against the JAX package's
Pallas kernel in interpret mode and against its XLA path, on the same
numpy inputs. This file holds the packer and any hit; the closest-hit
walk, the masks and the wrapper are in test_torch_packet_plain.py,
test_torch_packet_masks.py and test_torch_packet_wrapper.py, which use
the helpers below.

Tolerances: valid masks equal; t 5e-5 relative on every hit (XLA:CPU
contracts products into FMAs, the port rounds every product; on thin
triangles the two differ by up to 1.5e-5); prim equal except where the
two winners tie on t (the JAX kernel orders a node's children by the
nearest ray of a whole packet, the port by the ray's own distance, so
equal-t ties may resolve differently) — those rays are counted; u, v
1e-5 absolute; no dropped push."""
import numpy as np
import pytest
import torch

import embree_tpu as et
import embree_tpu_torch as ett
from embree_tpu.build import native as ref_native
from embree_tpu.traverse.pallas_packet import occluded_pallas
from embree_tpu.traverse.pallas_packet import pack_scene as ref_pack_scene
from embree_tpu_torch.build.sah import BuildSettings, build_sah
from embree_tpu_torch.scene.prims import prim_bounds_np
from embree_tpu_torch.traverse import packet_kernel as pk
from embree_tpu_torch.verify.fixtures import random_triangles
from test_torch_build import reference_native  # noqa: F401,E402


def soup(verts, idx):
    v = np.asarray(verts, np.float32)[np.asarray(idx)]
    return tuple(np.ascontiguousarray(v[:, k]) for k in range(3))


def packed(verts, idx, width=4, prim_mask=None):
    v0, v1, v2 = soup(verts, idx)
    lo, hi = prim_bounds_np(v0, v1, v2)
    bvh = build_sah(lo, hi, BuildSettings(branching_factor=width))
    return pk.pack_scene(bvh, (v0, v1, v2), "cpu", prim_mask=prim_mask)


def ref_committed(verts, idx, cfg="ignore_config_files=1"):
    scene = et.Scene(et.Device(cfg))
    scene.attach(et.TriangleMesh(verts, idx))
    return scene.commit()


def rays_np(rng, n, extent, normalize=True, aim=None):
    """Random origins and directions; with `aim` (verts, idx) every
    second ray points near a random triangle's centroid, so that small
    scenes get hit."""
    org = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    if aim is not None:
        cen = np.asarray(aim[0], np.float32)[np.asarray(aim[1])].mean(1)
        tgt = cen[rng.integers(0, len(cen), n)]
        tgt = tgt + rng.uniform(-0.1, 0.1, (n, 3)).astype(np.float32)
        d[::2] = (tgt - org)[::2]
    if normalize:
        d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org, d


def assert_matches(ref, port):
    """ref: JAX Hits; port: torch Hits. Returns the number of ties."""
    rv = np.asarray(ref.valid)
    np.testing.assert_array_equal(port.valid.numpy(), rv)
    rt, pt = np.asarray(ref.t), port.t.numpy()
    np.testing.assert_allclose(pt[rv], rt[rv], rtol=5e-5)
    np.testing.assert_array_equal(pt[~rv], rt[~rv])
    same = np.asarray(ref.gprim) == port.gprim.numpy()
    ties = int((~same).sum())
    # a different prim is a tie: the same t to within the t tolerance
    np.testing.assert_allclose(pt[~same], rt[~same], rtol=5e-5)
    m = rv & same
    np.testing.assert_array_equal(port.prim_id.numpy()[m],
                                  np.asarray(ref.prim_id)[m])
    np.testing.assert_allclose(port.u.numpy()[m], np.asarray(ref.u)[m],
                               atol=1e-5)
    np.testing.assert_allclose(port.v.numpy()[m], np.asarray(ref.v)[m],
                               atol=1e-5)
    return ties


def _check_pack_scene_byte_equal(rng, width):
    """Both packers on the SAME BVH arrays: the builder is not this
    test's subject (test_torch_build.py holds the two builders equal),
    and the JAX package's build_sah takes its numpy builder silently when
    its native library failed to load."""
    verts, idx = random_triangles(rng, 257, extent=5.0, size=1.0)
    v0, v1, v2 = soup(verts, idx)
    lo, hi = prim_bounds_np(v0, v1, v2)
    bvh = build_sah(lo, hi, BuildSettings(branching_factor=width))
    ref = ref_pack_scene(bvh, None, host_tris=(v0, v1, v2))
    ps = pk.pack_scene(bvh, (v0, v1, v2), "cpu")
    assert (ps.num_nodes, ps.num_prims, ps.width) == (
        ref.num_nodes, ref.num_prims, ref.width) == (
        bvh.child.shape[0], 257, width)
    for a, b in ((ps.nodes, ref.nodes), (ps.tdata, ref.tdata)):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy().view(np.int32),
                                      np.asarray(b).view(np.int32))
    assert ps.bvh_to_orig.dtype == torch.int32
    np.testing.assert_array_equal(ps.bvh_to_orig.numpy(),
                                  np.asarray(ref.bvh_to_orig))
    # 257 prims: 26 leaf rows + the pad row, 8 pad floats a row
    assert ps.tdata.shape == (27, 128)
    assert not ps.tdata[:, 120:].any() and not ps.tdata[-1].any()
    assert 2 <= ps.depth <= 64
    assert ps.depth == pk.tree_depth(bvh.child, bvh.count)


@pytest.mark.parametrize("width", [4, 8])
def test_pack_scene_byte_equal(rng, width):
    _check_pack_scene_byte_equal(rng, width)


@pytest.mark.parametrize("width", [4, 8])
def test_pack_scene_byte_equal_without_reference_native(monkeypatch, rng,
                                                        width):
    """With the JAX package's native loader in its failed state (what a
    half-written library from a concurrent in-place build leaves behind)
    the packing test still holds."""
    monkeypatch.setattr(ref_native, "_failed", True)
    monkeypatch.setattr(ref_native, "_lib", None)
    assert not ref_native.native_available()
    _check_pack_scene_byte_equal(rng, width)


def test_plain_occluded_matches(rng):
    verts, idx = random_triangles(rng, 30, extent=5.0, size=1.0)
    cs = ref_committed(verts, idx)
    org, d = rays_np(rng, 64, 8.0, normalize=False, aim=(verts, idx))
    ref_rays = et.make_rays(org, d)
    xla = et.scene_occluded(cs, ref_rays, isa="xla")
    pallas = occluded_pallas(cs.pallas, ref_rays, interpret=True)
    ps = packed(verts, idx)
    rays = ett.make_rays(org, d, device="cpu")
    occ = pk.occluded_packet_kernel(ps, rays)
    assert occ.dtype == torch.bool and occ.sum() >= 3
    np.testing.assert_array_equal(occ.numpy(), np.asarray(xla))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(pallas))
    # any-hit writes no prim and marks hits with t = -inf
    t, prim, _ = pk.packet_trace(ps, rays, occluded=True)
    assert (prim == -1).all()
    assert torch.equal(t == -np.inf, occ)
    assert torch.equal(t[~occ], rays.tfar[~occ])
