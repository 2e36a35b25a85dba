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
(an equal-t tie would show here; observed none)."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import embree_tpu as et
from embree_tpu.traverse import pallas_hair as ref_ph
from embree_tpu_torch.build.hair import cluster_curves
from embree_tpu_torch.convert import hair_clusters_from_reference
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


@pytest.mark.parametrize("builder", ["auto", "default"])
def test_pack_byte_equal(builder):
    cp3, rad = _curves(40)
    for K in (3, 8):
        ref = ref_ph.pack_hair_cluster(cp3, rad, K=K, flat=False,
                                       builder=builder)
        nodes, sdata, seg, payload, _c, _n = hk.pack_hair_arrays(
            cp3, rad, K, builder)
        for a, b in ((ref.nodes, nodes), (ref.sdata, sdata), (ref.seg, seg),
                     (ref.payload, payload)):
            a = np.asarray(a)
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()
        assert ref.num_segments == seg.shape[0] == 40 * K
        # segment rows: 16 a row, zero pads after the last segment, and
        # one zero row
        assert sdata.shape == (-(-40 * K // 16) + 1, 128)
        assert not sdata.reshape(-1, 8)[40 * K:].any()


@pytest.fixture(scope="module")
def scenes():
    """The same hair ball committed by both packages, round and flat."""
    out = {}
    verts, idx = hair_ball(np.random.default_rng(9), 60)
    for flat in (False, True):
        ref = et.Scene(et.Device(CFG))
        ref.attach(et.BezierCurves(verts, idx, tessellation_rate=5,
                                   flat=flat))
        from embree_tpu_torch import BezierCurves, Device, Scene
        port = Scene(Device(CFG, device="cpu"))
        port.attach(BezierCurves(verts, idx, tessellation_rate=5, flat=flat))
        out[flat] = (ref.commit(), port.commit())
    return out


@pytest.mark.parametrize("flat", [False, True], ids=["round", "flat"])
def test_converter_round_trip(scenes, flat):
    """hair_clusters_from_reference of the JAX package's committed
    clusters equals the port's own commit, tensor for tensor."""
    ref, port = scenes[flat]
    arrays = []
    for (gid, _fn), hp in zip(ref.hairs, ref.hair_pallas):
        arrays.append(dict(gid=gid, nodes=np.asarray(hp.nodes),
                           sdata=np.asarray(hp.sdata),
                           seg=np.asarray(hp.seg),
                           payload=np.asarray(hp.payload), K=hp.K,
                           flat=hp.flat))
    assert len(arrays) == len(port.hairs)
    for a, h in zip(arrays, port.hairs):
        a["rot"] = h.rot
        a["members"] = h.members.numpy()
    conv = hair_clusters_from_reference(arrays, "cpu")
    for c, h in zip(conv, port.hairs):
        assert c.gid == h.gid and np.array_equal(c.rot, h.rot)
        assert torch.equal(c.members, h.members)
        for a, b in zip(c.packed, h.packed):
            assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                    else a == b)


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


def test_pad_segments_are_never_taken():
    """Poison every pad slot of the segment rows (the zero segments after
    the last one and the trailing zero row) with a fat segment across the
    whole scene: no answer or counter changes, because a leaf's count
    bounds its tests."""
    cp3, rad = _curves(5)
    for flat in (False, True):
        ph = hk.pack_hair_cluster(cp3, rad, 3, flat, "cpu")
        S = ph.num_segments
        assert S % hk.NS_PER_ROW != 0
        rng = np.random.default_rng(3)
        org, d = _aimed_rays(rng, 512, ph.seg.numpy())
        rays = _port_rays(org, d)
        clean = hk.hair_plain(ph, rays, stats=True)
        clean_o = hk.hair_plain(ph, rays, occluded=True, stats=True)
        sd = ph.sdata.clone().view(-1, hk.SEG_FLOATS)
        sd[S:] = torch.tensor([-9.0, 0, 0, 9.0, 0, 0, 8.0, 8.0])
        bad = ph._replace(sdata=sd.view(-1, 128))
        dirty = hk.hair_plain(bad, rays, stats=True)
        dirty_o = hk.hair_plain(bad, rays, occluded=True, stats=True)
        for a, b in ((clean, dirty), (clean_o, dirty_o)):
            assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            assert a[2] == b[2]
        assert (clean[1] >= 0).any()


def test_earlier_segment_keeps_an_equal_t():
    """Two identical curves: every sub-segment twice at the same place.
    The leaf accepts `th < t` strictly, so a ray keeps the first of the
    two equal candidates it meets (the triangle leaf's `<=` would keep
    the second)."""
    cp3, rad = _curves(1, seed=4)
    cp3 = np.concatenate([cp3, cp3])
    rad = np.concatenate([rad, rad])
    for flat in (False, True):
        ph = hk.pack_hair_cluster(cp3, rad, 2, flat, "cpu")
        rng = np.random.default_rng(8)
        org, d = _aimed_rays(rng, 256, ph.seg.numpy())
        t, slot = hk.hair_plain(ph, _port_rays(org, d))
        hit = slot >= 0
        assert hit.sum() > 20
        pay = ph.payload[slot[hit].long()]
        twin = torch.where(pay >= 2, pay - 2, pay + 2)     # the other curve
        twin_slot = torch.nonzero(ph.payload[None] == twin[:, None])[:, 1]
        seg = ph.seg
        assert torch.equal(seg[slot[hit].long()], seg[twin_slot])
        # the slot taken is the one met first, and a leaf meets slots in
        # order: where both lie in one leaf, the lower slot
        same_leaf = (slot[hit] // 8) == (twin_slot // 8)
        assert (slot[hit][same_leaf] < twin_slot[same_leaf]).all()


def test_stack_and_inputs_are_checked():
    cp3, rad = _curves(4)
    ph = hk.pack_hair_cluster(cp3, rad, 2, False, "cpu")
    org, d = _aimed_rays(np.random.default_rng(1), 8, ph.seg.numpy())
    rays = _port_rays(org, d)
    with pytest.raises(ValueError, match="levels"):
        hk.hair_trace(ph._replace(depth=65), rays)
    with pytest.raises(ValueError, match="dtype"):
        hk.hair_trace(ph, rays._replace(org=rays.org.double()))
    with pytest.raises(ValueError, match="contiguous"):
        hk.hair_trace(ph, rays._replace(tfar=rays.tfar[:1].expand(8)))
    with pytest.raises(ValueError, match="shape"):
        hk.hair_trace(ph._replace(num_segments=ph.num_segments + 1), rays)
    # a smaller stack than the tree needs drops pushes, and counts them
    deep = hk.pack_hair_cluster(*_curves(60), 8, False, "cpu")
    org, d = _aimed_rays(np.random.default_rng(2), 256, deep.seg.numpy())
    _t, _s, st = hk.hair_plain(deep, _port_rays(org, d), stats=True,
                               stack_depth=2)
    assert st["dropped_pushes"] > 0
    assert hk.hair_plain(deep, _port_rays(org, d), stats=True)[2][
        "dropped_pushes"] == 0


def test_clusters_are_rotated_frames():
    """The scene packs every cluster in its own frame: the packed
    segments rotated back by rot.T are the world tessellation."""
    verts, idx = hair_ball(np.random.default_rng(12), 30)
    cps = np.stack([verts[idx + k] for k in range(4)], 1)
    cp3, rad = cps[:, :, :3], cps[:, :, 3]
    for rot, mem in cluster_curves(cp3):
        nodes, sdata, seg, payload, _c, _n = hk.pack_hair_arrays(
            cp3[mem] @ rot, rad[mem], 3)
        world = hk._bezier_points_np(cp3[mem], 3)
        back = seg[:, 0:3] @ rot.T
        m, k = payload // 3, payload % 3
        np.testing.assert_allclose(back, world[m, k], atol=1e-5)


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


def _occluded_one_cluster_at_a_time(cs, flat):
    """(occlusion, clusters entered summed over rays): a ray already
    occluded enters no further cluster."""
    occ = torch.zeros(flat.tnear.shape, dtype=torch.bool)
    entered = 0
    for h in cs.hairs:
        entered += int((~(occ | (flat.tfar == -math.inf))).sum())
        occ = occ | hk.occluded_hair_kernel(
            h.packed, rows_times(flat.org, h.rot),
            rows_times(flat.dir, h.rot), flat.tnear,
            torch.where(occ, -math.inf, flat.tfar))
    return occ, entered


def _bits(a):
    return a.view(torch.int32) if a.dtype == torch.float32 else a


@pytest.mark.parametrize("shape", ["fur", "ball"])
def test_one_launch_equals_the_per_cluster_fold(shape):
    """A request's hair fold, one launch over every cluster with the rays
    rotated in the kernel and one finalize, equals the fold one cluster at
    a time bit for bit (t, u, v, Ng, prim_id, geom_id), from a running t
    that starts anywhere: on the tutorial's fur at 400 strands (3 round
    clusters) and a hair ball of 60 flat curves (13 clusters)."""
    from embree_tpu_torch import BezierCurves, Device, Scene
    from embree_tpu_torch.render.tutorials import hair_geometry as hg
    if shape == "fur":
        verts, idx = hg.make_fur(400)
        geom, extent = BezierCurves(verts, idx, tessellation_rate=6), 1.5
    else:
        verts, idx = hair_ball(np.random.default_rng(21), 60)
        geom, extent = BezierCurves(verts, idx, tessellation_rate=4,
                                    flat=True), 2.5
    sc = Scene(Device(CFG, device="cpu"))
    sc.attach(geom)
    cs = sc.commit()
    assert len(cs.hairs) == (3 if shape == "fur" else 13)
    assert cs.hair_set.packed.runs() == [(shape == "ball", 0,
                                          len(cs.hairs))]
    world = torch.cat([torch.cat([rows_times(h.packed.seg[:, 0:3], h.rot.T),
                                  rows_times(h.packed.seg[:, 3:6], h.rot.T)],
                                 1) for h in cs.hairs]).numpy()
    rng = np.random.default_rng(22)
    n = 768
    org, d = _aimed_rays(rng, n, world, extent)
    tf = np.full(n, np.inf, np.float32)
    tf[1::5] = rng.uniform(0.5, 4.0, tf[1::5].shape)
    tf[3::17] = -np.inf
    flat = _port_rays(org, d, tf)
    start = port_scene.miss_hits((n,), flat.tfar, device="cpu")
    one = port_scene._fold_hair(cs, flat, start)
    old = _fold_one_cluster_at_a_time(cs, flat, start)
    for name in ("t", "u", "v", "ng", "prim_id", "geom_id", "gprim",
                 "inst_id"):
        a, b = getattr(one, name), getattr(old, name)
        assert torch.equal(_bits(a), _bits(b)), name
    c = cs.hair_set.packed
    _t, slot, cl = hk.hair_set_plain(c, flat)
    assert one.valid.sum() > 100 and len(set(cl[slot >= 0].tolist())) >= 3
    occ = port_scene.scene_occluded(cs, flat)
    occ_old, entered = _occluded_one_cluster_at_a_time(cs, flat)
    assert torch.equal(occ, occ_old)
    assert torch.equal(occ, one.valid | (flat.tfar == -math.inf))
    # an any-hit ray that hits enters no later cluster
    *_r, st_o = hk.hair_set_plain(c, flat, occluded=True, stats=True)
    assert st_o["clusters_entered"] == entered < n * len(cs.hairs)
    # the counters of one pass over the set are the clusters' own, each
    # cluster walked from the running t
    *_r, st = hk.hair_set_plain(c, flat, stats=True)
    t_run, sums = flat.tfar.clone(), {}
    for k, h in enumerate(cs.hairs):
        cr = Rays(rows_times(flat.org, h.rot), rows_times(flat.dir, h.rot),
                  flat.tnear, t_run)
        t_run, _s, st_k = hk.hair_plain(h.packed, cr, stats=True)
        for key, val in st_k.items():
            sums[key] = sums.get(key, 0) + val
    assert st == {**sums, "rays": n, "clusters_entered": n * len(cs.hairs)}


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
