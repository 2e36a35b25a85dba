"""What kernel B3's plain version guarantees by itself: an earlier segment
keeps an equal t, the stack and the inputs are checked, clusters walk
in their rotated frames, and one launch over every cluster equals the
fold one cluster at a time."""
import math
import numpy as np
import pytest
import torch

from embree_tpu_torch.build.hair import cluster_curves
from embree_tpu_torch.core.math import rows_times
from embree_tpu_torch.core.rayhit import Rays
from embree_tpu_torch.scene import scene as port_scene
from embree_tpu_torch.traverse import hair_kernel as hk
from embree_tpu_torch.verify.fixtures import hair_ball

from test_torch_build import reference_native  # noqa: F401

from test_torch_hair_kernel import (  # noqa: F401
    CFG, _aimed_rays, _bits, _curves, _fold_one_cluster_at_a_time, _port_rays,
    one_torch_thread)


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
