"""The packet kernel's wrapper: CPU tensors take the plain version without
a launch, and the counters accumulate when asked for."""
import embree_tpu_torch as ett
from embree_tpu_torch.core import stats as port_stats
from embree_tpu_torch.traverse import packet_kernel as pk
from embree_tpu_torch.verify.fixtures import random_triangles

from test_torch_build import reference_native  # noqa: F401

from test_torch_packet import (  # noqa: F401
    packed, rays_np)


def test_cpu_tensors_take_plain_version_without_a_launch(rng, monkeypatch):
    verts, idx = random_triangles(rng, 20)
    ps = packed(verts, idx)
    org, d = rays_np(rng, 16, 5.0, aim=(verts, idx))
    rays = ett.make_rays(org, d, device="cpu")

    def no_kernel(*a, **k):
        raise AssertionError("the kernel path was taken for a CPU tensor")

    monkeypatch.setattr(pk, "_load_kernel", no_kernel)
    monkeypatch.setattr(pk, "_launch", no_kernel)
    before = pk.launches
    pk.intersect_packet_kernel_raw(ps, rays)
    pk.occluded_packet_kernel(ps, rays)
    pk.traversal_stats(ps, rays)
    assert pk.launches == before


def test_stat_counters_accumulate_when_enabled(rng):
    verts, idx = random_triangles(rng, 50, extent=3.0, size=1.0)
    ps = packed(verts, idx)
    org, d = rays_np(rng, 40, 4.0, aim=(verts, idx))
    rays = ett.make_rays(org, d, device="cpu")
    stat = port_stats.instance()
    stat.clear()
    pk.intersect_packet_kernel_raw(ps, rays)
    assert stat.normal.travs == 0               # disabled: nothing counted
    stat.enable(True)
    try:
        pk.intersect_packet_kernel_raw(ps, rays)
        pk.occluded_packet_kernel(ps, rays)
    finally:
        stat.enable(False)
    want = pk.traversal_stats(ps, rays)
    assert stat.normal.travs == 40 and stat.shadow.travs == 40
    assert stat.normal.trav_nodes == want[0, 0]
    assert stat.normal.trav_prims == want[0, 1]
    assert 0 < stat.shadow.trav_nodes <= stat.normal.trav_nodes
    stat.clear()
