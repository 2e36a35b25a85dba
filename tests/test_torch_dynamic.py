"""The port's morton builder (embree_tpu_torch/build/morton.py) against
the JAX package's: `build_morton` node for node (boxes bit for bit) at
five prim counts, every prim in one leaf inside its box, the morton
codes. The dynamic scenes, the walks and the rotations are in
tests/test_torch_dynamic_scenes.py (each file holds at most 5 tests, so
that neither is handed out before tests/test_hair.py in the tier-1
run)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embree_tpu.build.morton import build_morton as jbuild_morton
from embree_tpu_torch.build.bvh import BVHArraysNP
from embree_tpu_torch.build.morton import build_morton, morton3d
from embree_tpu_torch.scene.prims import prim_bounds_np
from embree_tpu_torch.verify.fixtures import random_triangles


def _bounds(verts, idx):
    return prim_bounds_np(verts[idx[:, 0]], verts[idx[:, 1]],
                          verts[idx[:, 2]])


def _host(bvh) -> BVHArraysNP:
    return BVHArraysNP(*(np.asarray(a.cpu() if isinstance(a, torch.Tensor)
                                    else a) for a in bvh))


def _equal_trees(a, b):
    for x, y, name in zip(_host(a), _host(b), BVHArraysNP._fields):
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert x.tobytes() == y.tobytes(), name


@pytest.mark.parametrize("n", [1, 3, 16, 333, 4000])
def test_morton_tree_matches_jax(rng, n):
    verts, idx = random_triangles(rng, n)
    lo, hi = _bounds(verts, idx)
    tree = build_morton(torch.from_numpy(lo), torch.from_numpy(hi))
    _equal_trees(tree, jbuild_morton(jnp.asarray(lo), jnp.asarray(hi)))
    # every prim in exactly one leaf, inside its box
    order = tree.prim_order.numpy()
    assert sorted(order.tolist()) == list(range(n))
    cnt, ch = tree.count.numpy(), tree.child.numpy()
    for m, c in zip(*np.nonzero(cnt > 0)):
        sel = order[ch[m, c]:ch[m, c] + cnt[m, c]]
        assert (tree.lower.numpy()[m, c] <= lo[sel].min(0)).all()
        assert (tree.upper.numpy()[m, c] >= hi[sel].max(0)).all()
    if n == 1:
        c = morton3d(torch.tensor([1, 0, 0]), torch.tensor([0, 1, 0]),
                     torch.tensor([0, 0, 1]))
        assert c.tolist() == [1, 2, 4]
