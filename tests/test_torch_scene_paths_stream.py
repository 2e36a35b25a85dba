"""The ray-stream sort of the port against the JAX package: a sorted batch
gives the same answers, and the sort keys and permutation equal the
JAX package's."""
import numpy as np
import torch

import embree_tpu as et
import embree_tpu_torch as ett
from embree_tpu.traverse import stream as ref_stream
from embree_tpu_torch.traverse import packet_kernel as pk
from embree_tpu_torch.traverse import stream as port_stream
from embree_tpu_torch.verify.fixtures import random_triangles

from test_torch_build import reference_native  # noqa: F401

from test_torch_scene_paths import (  # noqa: F401
    port_scene_of, rays_np)


def test_stream_sorted_batch_gives_the_same_answers(rng):
    """Sort, trace in stream order, unsort: the answers of the unsorted
    batch, bit for bit (the kernel's result depends on the ray alone)."""
    verts, idx = random_triangles(rng, 300, extent=3.0, size=1.0)
    cs = port_scene_of(verts, idx).committed
    org, d = rays_np(rng, 500, 4.0)
    rays = ett.make_rays(org, d, device="cpu")
    masks = torch.from_numpy(rng.integers(0, 3, 500).astype(np.int32))
    srays, perm = port_stream.sort_rays_stream(rays, cs.world_lower,
                                               cs.world_upper)
    assert not torch.equal(perm, torch.arange(500))
    for rm in (None, masks):
        t, prim = pk.intersect_packet_kernel_raw(cs.packet, rays, ray_mask=rm)
        occ = pk.occluded_packet_kernel(cs.packet, rays, ray_mask=rm)
        srm = None if rm is None else rm[perm].contiguous()
        t_s, prim_s = port_stream.unsort_by_perm(
            perm, *pk.intersect_packet_kernel_raw(cs.packet, srays,
                                                  ray_mask=srm))
        occ_s = port_stream.unsort_by_perm(
            perm, pk.occluded_packet_kernel(cs.packet, srays, ray_mask=srm))
        assert (prim >= 0).sum() >= 40
        assert torch.equal(t, t_s) and torch.equal(prim, prim_s)
        assert torch.equal(occ, occ_s)


def test_stream_sort_keys_and_permutation_equal_reference(rng):
    import jax.numpy as jnp
    n = 3000
    org = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[::7, 1] = 0.0                               # zeros have no sign bit
    lo = np.array([-2, -2.5, -1], np.float32)
    hi = np.array([2, 2, 3], np.float32)
    ref_rays = et.make_rays(org, d)
    rays = ett.make_rays(org, d, device="cpu")
    tlo, thi = torch.from_numpy(lo), torch.from_numpy(hi)
    k_ref = np.asarray(ref_stream.stream_sort_keys(
        ref_rays, jnp.asarray(lo), jnp.asarray(hi)))
    k = port_stream.stream_sort_keys(rays, tlo, thi)
    assert k.dtype == torch.int64
    np.testing.assert_array_equal(k.numpy(), k_ref.astype(np.int64))
    assert len(np.unique(k_ref)) < n              # ties: stability matters
    s_ref, p_ref, i_ref = ref_stream.sort_rays_perm(
        ref_rays, jnp.asarray(lo), jnp.asarray(hi))
    s, p, i = port_stream.sort_rays_perm(rays, tlo, thi)
    np.testing.assert_array_equal(p.numpy(), np.asarray(p_ref))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    for a, b in zip(s, s_ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    s2, p2 = port_stream.sort_rays_stream(rays, tlo, thi)
    assert torch.equal(p2, p) and torch.equal(s2.org, s.org)
    # unsort restores the original order, one tensor or several
    x = torch.arange(n, dtype=torch.float32)
    flag = x % 3 == 0
    ref_un = ref_stream.unsort_by_perm(p_ref, jnp.asarray(x.numpy())[p_ref])
    np.testing.assert_array_equal(np.asarray(ref_un), x.numpy())
    assert torch.equal(port_stream.unsort_by_perm(p, x[p]), x)
    a, b = port_stream.unsort_by_perm(p, x[p], flag[p])
    assert torch.equal(a, x) and torch.equal(b, flag)
    assert torch.equal(x[p][i], x)                # inv is a gather index
