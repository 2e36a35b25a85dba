"""Kernel B3's module (embree_tpu_torch/traverse/hair_kernel.py) against
embree_tpu/traverse/pallas_hair.py: the packer and the converter byte for
byte, the plain version (the kernel's function on CPU tensors) against
the JAX package's Pallas kernel in interpret mode on the same packed
cluster, closest and any hit, for the cone and the ribbon leaf; and what
the plain version guarantees by itself: pad segments are never taken,
an earlier segment keeps an equal t, any hit equals a closest hit found,
the stack is sized from the tree.

Tolerances against the interpret-mode kernel: t within 5e-5 relative
(XLA:CPU contracts products into FMAs, the port rounds every product);
the rays whose hit masks differ (flips) or whose t lies further apart
(grazing rays: the cone quadratic B*B - 4*A*C cancels most digits) are
counted together and bounded by 1 % of the rays, the JAX package's own
bound (tests/test_hair.py:143-166; observed: no flip, one cone ray of
128 at 5.2e-5), and stay within 1e-3; slot equal on the agreeing hits
(an equal-t tie would show here; observed none). The packer and the
converter are in test_torch_hair_kernel_pack.py, the plain version's
own guarantees in test_torch_hair_kernel_walk.py; both use the helpers
below."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embree_tpu.traverse import pallas_hair as ref_ph
from embree_tpu_torch.core.math import rows_times
from embree_tpu_torch.core.rayhit import Rays
from embree_tpu_torch.scene import scene as port_scene
from embree_tpu_torch.traverse import hair_kernel as hk
from embree_tpu_torch.verify.fixtures import hair_ball
from test_torch_build import reference_native  # noqa: F401,E402

CFG = "ignore_config_files=1"
T_RTOL = 5e-5
FLIPS = 0.01


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _curves(n=16, seed=7):
    """n random curves in one frame (no rotation): (cps, radii)."""
    verts, idx = hair_ball(np.random.default_rng(seed), n)
    cps = np.stack([verts[idx + k] for k in range(4)], 1)
    return cps[:, :, :3].copy(), cps[:, :, 3].copy()


def _aimed_rays(rng, n, seg, extent=3.0):
    """Half the rays aimed at a random point of a random segment."""
    org = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    k = rng.integers(0, seg.shape[0], n)
    w = rng.uniform(0, 1, (n, 1)).astype(np.float32)
    aim = seg[k, :3] * (1 - w) + seg[k, 3:6] * w - org
    d[::2] = aim[::2]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org, d


def _port_rays(org, d, tfar=None):
    n = org.shape[0]
    tf = (torch.full((n,), math.inf) if tfar is None
          else torch.from_numpy(tfar))
    return Rays(torch.from_numpy(org), torch.from_numpy(d), torch.zeros(n),
                tf)


@pytest.fixture(scope="module")
def interpret_runs():
    """One small cluster a leaf variant (16 curves, K = 4, 128 rays)
    through the JAX package's Pallas kernel in interpret mode (about 10 s
    a trace) and through the port's plain version."""
    cp3, rad = _curves(16)
    out = {}
    for flat in (False, True):
        rng = np.random.default_rng(17 + flat)
        hp = ref_ph.pack_hair_cluster(cp3, rad, K=4, flat=flat)
        ph = hk.pack_hair_cluster(cp3, rad, 4, flat, "cpu")
        org, d = _aimed_rays(rng, 128, np.asarray(hp.seg))
        tf = np.full(128, np.inf, np.float32)
        tf[5::11] = 1.5
        ref = ref_ph.intersect_hair_pallas(
            hp, jnp.asarray(org), jnp.asarray(d), jnp.zeros(128),
            jnp.asarray(tf), interpret=True)
        rays = _port_rays(org, d, tf)
        port = hk.intersect_hair_kernel(ph, rays.org, rays.dir, rays.tnear,
                                        rays.tfar)
        tk, slot, _ = hk.hair_trace(ph, rays)
        out[flat] = ([np.asarray(a) for a in ref], port, slot, ph, rays)
    return out


@pytest.mark.parametrize("flat", [False, True], ids=["cone", "ribbon"])
def test_plain_matches_pallas_interpret(interpret_runs, flat):
    ref, port, _slot, _ph, rays = interpret_runs[flat]
    t_r, u_r, v_r, ng_r, m_r, hit_r = ref
    t_p, u_p, v_p, ng_p, m_p, hit_p = (a.numpy() for a in port)
    with np.errstate(invalid="ignore"):       # inf - inf on misses
        rel = np.where(hit_r & hit_p, np.abs(t_p - t_r)
                       / np.where(hit_r, np.abs(t_r), 1.0), 0.0)
    assert rel.max() <= 1e-3
    off = (hit_r != hit_p) | (rel > T_RTOL)
    assert off.sum() <= FLIPS * hit_r.size, off.sum()
    both = hit_r & hit_p & ~off
    assert both.sum() >= 30
    assert (m_r[both] == m_p[both]).all()
    np.testing.assert_allclose(u_p[both], u_r[both], atol=1e-3)
    np.testing.assert_allclose(v_p[both], v_r[both], atol=1e-3)
    cos = ((ng_r[both] * ng_p[both]).sum(1)
           / (np.linalg.norm(ng_r[both], axis=1)
              * np.linalg.norm(ng_p[both], axis=1)))
    assert cos.min() > 0.999
    # misses keep t_in
    np.testing.assert_array_equal(t_p[~hit_p], rays.tfar.numpy()[~hit_p])


@pytest.mark.parametrize("flat", [False, True], ids=["cone", "ribbon"])
def test_any_hit_equals_closest_hit_found(interpret_runs, flat):
    _ref, port, slot, ph, rays = interpret_runs[flat]
    t_o, s_o, st_o = hk.hair_plain(ph, rays, occluded=True, stats=True)
    assert torch.equal(t_o == -math.inf, slot >= 0)
    assert (s_o == -1).all()
    _t, _s, st_c = hk.hair_plain(ph, rays, stats=True)
    # an any-hit ray stops at its first hit: never more work
    assert st_o["seg_tests"] <= st_c["seg_tests"]
    assert st_o["node_visits"] <= st_c["node_visits"]
    assert st_c["dropped_pushes"] == st_o["dropped_pushes"] == 0
    assert 0 < st_c["rows_touched"] <= ph.sdata.shape[0] - 1
    assert st_c["leaf_visits"] > 0 and st_c["nodes_touched"] > 0


def _fold_one_cluster_at_a_time(cs, flat, hits, hairs=None):
    """The hair fold as it ran before one launch served every cluster: a
    launch, a finalize and a fold a cluster (`hairs`, by default
    `cs.hairs`, in order), the rays rotated on the host
    (core/math.py::rows_times) and Ng rotated back."""
    for h in cs.hairs if hairs is None else hairs:
        t, u, v, ng, m, hitm = hk.intersect_hair_kernel(
            h.packed, rows_times(flat.org, h.rot),
            rows_times(flat.dir, h.rot), flat.tnear, hits.t.contiguous())
        use = hitm & (t < hits.t)
        hits = port_scene._fold(hits, use, t, u, v, rows_times(ng, h.rot.T),
                                h.members[m.clamp_min(0).long()], h.gid)
    return hits


def _bits(a):
    return a.view(torch.int32) if a.dtype == torch.float32 else a


def test_mixed_leaf_types_make_one_launch_a_type(monkeypatch):
    """Round and flat curves in one scene: the set puts the first leaf
    type's clusters first (scene order within a type), one run a type;
    a run longer than a launch serves splits, and the fold over the
    pieces still equals the fold one cluster at a time; against the fold
    in scene order (the JAX package's) only equal-t ties may differ."""
    from embree_tpu_torch import BezierCurves, Device, Scene
    rng = np.random.default_rng(23)
    sc = Scene(Device(CFG, device="cpu"))
    for flat in (True, False, True):
        v, i = hair_ball(rng, 20)
        sc.attach(BezierCurves(v, i, tessellation_rate=2, flat=flat))
    cs = sc.commit()
    kinds = [h.packed.flat for h in cs.hairs]
    n_flat = kinds.count(True)
    assert kinds == [True] * n_flat + [False] * (len(kinds) - n_flat)
    assert [h.gid for h in cs.hairs][:n_flat] == sorted(
        h.gid for h in cs.hairs[:n_flat])
    assert cs.hair_set.packed.runs() == [(True, 0, n_flat),
                                         (False, n_flat, len(kinds) - n_flat)]
    for k, h in enumerate(cs.hairs):
        view = cs.hair_set.packed.cluster(k)
        assert all(torch.equal(a, b) for a, b in zip(view[:4], h.packed[:4]))
        assert h.packed.nodes.data_ptr() == view.nodes.data_ptr()
    monkeypatch.setattr(hk, "MAX_CLUSTERS", 3)
    runs = cs.hair_set.packed.runs()
    assert len(runs) > 2 and all(c <= 3 for _f, _s, c in runs)
    assert [r[1] for r in runs] == list(np.cumsum([0] + [r[2] for r in runs]
                                                  )[:-1])
    seg = np.concatenate([h.packed.seg.numpy() for h in cs.hairs])
    org, d = _aimed_rays(rng, 256, seg, 2.0)
    flat = _port_rays(org, d)
    start = port_scene.miss_hits((256,), flat.tfar, device="cpu")
    one = port_scene._fold_hair(cs, flat, start)
    old = _fold_one_cluster_at_a_time(cs, flat, start)
    assert one.valid.sum() > 20
    for name in ("t", "u", "v", "ng", "prim_id", "geom_id"):
        assert torch.equal(_bits(getattr(one, name)),
                           _bits(getattr(old, name))), name
    # the JAX package folds the clusters in scene order (geometry by
    # geometry); grouping by leaf type moves only a hit that ties at equal
    # t with a cluster of the other type, and the ties are counted
    ref = _fold_one_cluster_at_a_time(
        cs, flat, start, sorted(cs.hairs, key=lambda h: h.gid))
    assert [h.gid for h in sorted(cs.hairs, key=lambda h: h.gid)] != [
        h.gid for h in cs.hairs]
    assert torch.equal(_bits(one.t), _bits(ref.t))
    own = torch.stack([hk.intersect_hair_kernel(
        h.packed, rows_times(flat.org, h.rot), rows_times(flat.dir, h.rot),
        flat.tnear, flat.tfar)[0] for h in cs.hairs])
    ties = ((own == one.t) & one.valid).sum(0) > 1
    moved = torch.zeros_like(ties)
    for name in ("u", "v", "ng", "prim_id", "geom_id"):
        a, b = _bits(getattr(one, name)), _bits(getattr(ref, name))
        moved |= (a != b).reshape(a.shape[0], -1).any(1)
    assert not (moved & ~ties).any()
    assert int(ties.sum()) == 0
