"""Per-ray treelet traversal of the PyTorch port (its plain version, on
the CPU) against the JAX package's Pallas kernel in interpret mode: one
treelet build, the same arrays and the same rays into both.

Tolerances. `prim` must be equal; where it is not, the two `t` must be
equal (an equal-t tie), and such rays must stay under 0.5 %. `t` is held
to 5e-5 relative on every hit and to 2e-6 on 90 % of them: both sides
compute in float32 in the same order, but XLA:CPU contracts products
and sums into FMAs and PyTorch does not, and on thin triangles either
result is itself several 1e-6 away from the float64 value."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import embree_tpu as et
from embree_tpu.build.treelets import TreeletScene as RefTreeletScene
from embree_tpu.traverse.rowtrace2 import intersect_rowtrace2 as ref_rowtrace2

import embree_tpu_torch as ett
from embree_tpu_torch.build.treelets import build_treelet_scene
from embree_tpu_torch.traverse.rowtrace2 import (intersect_rowtrace2,
                                                 rowtrace2_plain)
from embree_tpu_torch.verify.fixtures import random_triangles

T_RTOL = 5e-5
T_RTOL_BULK = 2e-6
MAX_TIE_FRACTION = 0.005


def build(verts, idx, fan):
    v = np.asarray(verts, np.float32)[np.asarray(idx)]
    return build_treelet_scene(v[:, 0], v[:, 1], v[:, 2],
                               np.arange(len(idx)), fan=fan)


def to_reference(ts_np) -> RefTreeletScene:
    """The port's host build as the JAX package's device pytree."""
    return RefTreeletScene(
        jnp.asarray(ts_np.blocks), jnp.asarray(ts_np.mid_boxes.reshape(-1)),
        jnp.asarray(ts_np.tre_boxes), ts_np.fan, ts_np.num_mids,
        ts_np.num_treelets, ts_np.num_prims)


def random_rays(rng, n, extent):
    org = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org, d


def both(ts_np, org, d, **kw):
    """(t, prim) of the reference kernel (interpret mode) and of the port."""
    t_r, p_r = ref_rowtrace2(to_reference(ts_np), et.make_rays(org, d),
                             interpret=True, **kw)
    t_p, p_p = intersect_rowtrace2(ts_np.to_device("cpu"),
                                   ett.make_rays(org, d, device="cpu"), **kw)
    return (np.asarray(t_r), np.asarray(p_r)), (t_p.numpy(), p_p.numpy())


def assert_closest_parity(ref, port, min_hits):
    (t_r, p_r), (t_p, p_p) = ref, port
    assert t_p.dtype == np.float32 and p_p.dtype == np.int32
    hit = p_r >= 0
    assert hit.sum() >= min_hits
    np.testing.assert_array_equal(p_p >= 0, hit)
    # a miss returns the ray's tfar
    assert np.isinf(t_p[~hit]).all() and np.isinf(t_r[~hit]).all()
    rel = np.abs(t_p[hit] - t_r[hit]) / np.abs(t_r[hit])
    assert rel.max() <= T_RTOL, rel.max()
    assert np.quantile(rel, 0.9) <= T_RTOL_BULK, np.quantile(rel, 0.9)
    differ = p_p[hit] != p_r[hit]
    assert differ.mean() <= MAX_TIE_FRACTION, differ.mean()
    np.testing.assert_array_equal(t_p[hit][differ], t_r[hit][differ])


@pytest.mark.parametrize("ntri,nray,fan,min_hits", [
    (40, 200, 4, 3),          # single treelet
    (500, 300, 4, 20),        # single treelet, both leaf chunks filled
    (700, 300, 4, 30),        # several treelets, one mid
    (2500, 500, 8, 100),      # several mids
])
def test_rowtrace2_matches_reference_kernel(rng, ntri, nray, fan, min_hits):
    verts, idx = random_triangles(rng, ntri, extent=5.0, size=1.2)
    ts_np = build(verts, idx, fan)
    if ntri == 2500:
        assert ts_np.num_mids >= 2
    if ntri == 500:
        # pairs 128..255 live in the second leaf chunk (rows 32..51)
        assert (ts_np.blocks[:, 32 + 18, :].view(np.int32) >= 0).sum() > 100
    org, d = random_rays(rng, nray, 8.0)
    ref, port = both(ts_np, org, d)
    assert_closest_parity(ref, port, min_hits)


def test_reference_kernel_is_permutation_invariant(rng):
    """The reference's (t, prim) of a ray does not depend on which rays
    share its tile: exact prim parity with it is therefore a fair target
    for a kernel that walks every ray on its own."""
    verts, idx = random_triangles(rng, 2500, extent=5.0, size=1.2)
    ts_np = build(verts, idx, 8)
    ts_ref = to_reference(ts_np)
    org, d = random_rays(rng, 500, 8.0)
    t0, p0 = ref_rowtrace2(ts_ref, et.make_rays(org, d), interpret=True)
    perm = rng.permutation(500)
    t1, p1 = ref_rowtrace2(ts_ref, et.make_rays(org[perm], d[perm]),
                           interpret=True)
    assert (np.asarray(p0) >= 0).sum() >= 100
    np.testing.assert_array_equal(np.asarray(p1), np.asarray(p0)[perm])
    np.testing.assert_array_equal(np.asarray(t1), np.asarray(t0)[perm])
    # and so is the port's plain version, across its lock-step batches
    ts = ts_np.to_device("cpu")
    a = rowtrace2_plain(ts, ett.make_rays(org, d, device="cpu"))
    b = rowtrace2_plain(ts, ett.make_rays(org[perm], d[perm], device="cpu"))
    assert torch.equal(b[0], a[0][perm]) and torch.equal(b[1], a[1][perm])
