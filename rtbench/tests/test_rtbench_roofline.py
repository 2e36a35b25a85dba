"""The yardstick's byte counts, the trace reduction and the readers."""
import numpy as np

from conftest import ROOT
from rtbench import harness
from rtbench.scenes import obj_subdiv, triangle_sphere


def _reader(name):
    return harness.load_module("metrics", name)


def test_geometry_bytes():
    inp = triangle_sphere.inputs({"center": [0, 0, 0], "radius": 2.0,
                                  "n": 707}, ROOT)
    assert inp["triangles"].shape[0] == 998_284
    assert triangle_sphere.geometry_bytes(inp) == 998_284 * 36
    bm = obj_subdiv.inputs(harness.load_json(
        "rtbench/configs/bomberman.json")["params"], ROOT)
    assert bm["face_counts"].shape[0] == 727
    assert obj_subdiv.geometry_bytes(bm) == 727 * 65 * 65 * 12


def test_sphere_matches_the_programs_creator():
    from embree_tpu_torch.verify.fixtures import triangle_sphere as ts
    for n in (5, 40):
        v, t = ts((0.5, 0, -1), 1.5, n)
        inp = triangle_sphere.inputs({"center": [0.5, 0, -1],
                                      "radius": 1.5, "n": n}, ROOT)
        assert np.array_equal(inp["vertices"], v)
        assert np.array_equal(inp["triangles"], t)


def test_least_bytes():
    rays = 1 << 21
    b1 = _reader("b1_roofline")
    b2 = _reader("b2_roofline")
    b4 = _reader("b4_roofline")
    assert b1.least_bytes(rays, 998_284 * 36) == rays * 40 + 35_938_224
    assert b2.least_bytes(3840 * 2160, 998_284 * 36) == (
        3840 * 2160 * 40 + 35_938_224)
    assert b4.least_bytes(rays, 727 * 65 * 65 * 12) == rays * 48 + 36_858_900


def _events():
    # (name, is_device, start_us, end_us): a window of 100 us, two
    # kernels and an op, one gap of 30 us while the host was in an op
    return [("rtbench.window", False, 0.0, 100.0),
            ("rtbench.entry", False, 10.0, 60.0),
            ("aten::nonzero", False, 40.0, 55.0),
            ("void rowtrace2_kernel(float4 const*)", True, 5.0, 40.0),
            ("aten::index elementwise", True, 30.0, 45.0),
            ("rowtrace2_kernel", True, 75.0, 90.0)]


def test_reduce_trace_and_readers():
    tr = harness.reduce_trace(_events())
    assert abs(tr.window_s - 100e-6) < 1e-12
    assert abs(tr.busy_s - 55e-6) < 1e-12       # 5-45 and 75-90
    assert tr.idle_gaps[0][0] == "rtbench.entry / aten::nonzero"
    assert abs(tr.idle_gaps[0][1] - 30e-6) < 1e-12
    ctx = harness.LayerContext(
        trace=tr, requests=2, rays=1 << 21, entry_s=[1e-3, 3e-3],
        commit_s=5.0, scene_bytes=2e8, geometry_bytes=998_284 * 36,
        peak_bytes_per_s=3.35e12,
        traversal_kernels=["rowtrace2_kernel", "cbvh_kernel"])
    assert abs(_reader("kernel_ms.b1").read(ctx) - 1e3 * 50e-6 / 2) < 1e-9
    assert _reader("kernel_ms.b4").read(ctx) is None
    assert _reader("b4_roofline").read(ctx) is None
    assert abs(_reader("other_device_ms").read(ctx) - 1e3 * 15e-6 / 2) < 1e-9
    assert abs(_reader("device_idle_pct").read(ctx) - 45.0) < 1e-9
    assert abs(_reader("entry_host_ms").read(ctx) - 2.0) < 1e-12
    assert _reader("commit_s").read(ctx) == 5.0
    assert _reader("scene_mb").read(ctx) == 200.0
    least = ((1 << 21) * 40 + 998_284 * 36) / 3.35e12
    assert abs(_reader("b1_roofline").read(ctx)
               - 100 * least / 25e-6) < 1e-9
    none = harness.LayerContext(trace=None, requests=0, rays=1, entry_s=[],
                                commit_s=0.0, scene_bytes=None,
                                geometry_bytes=1, peak_bytes_per_s=None,
                                traversal_kernels=[])
    for m in ("kernel_ms.b1", "other_device_ms", "device_idle_pct",
              "entry_host_ms", "commit_s", "scene_mb", "b2_roofline"):
        assert _reader(m).read(none) is None
    assert harness.reduce_trace([("x", True, 0.0, 1.0)]) is None
