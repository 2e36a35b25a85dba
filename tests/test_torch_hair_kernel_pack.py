"""Kernel B3's packer and converter (embree_tpu_torch/traverse/hair_kernel.py)
against embree_tpu/traverse/pallas_hair.py byte for byte, and pad
segments never taken by the plain version."""
import numpy as np
import pytest
import torch

import embree_tpu as et
from embree_tpu.traverse import pallas_hair as ref_ph
from embree_tpu_torch.convert import hair_clusters_from_reference
from embree_tpu_torch.traverse import hair_kernel as hk
from embree_tpu_torch.verify.fixtures import hair_ball

from test_torch_build import reference_native  # noqa: F401

from test_torch_hair_kernel import (  # noqa: F401
    CFG, _aimed_rays, _curves, _port_rays, one_torch_thread)


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
