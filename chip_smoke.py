#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (embree_tpu_torch).

    python3 chip_smoke.py            # needs one CUDA card, about 3 minutes
    python3 chip_smoke.py --quick    # stop after the kernel-vs-plain phases

Builds every kernel from the sources in this checkout (one nvcc per
source, started together), holds each kernel against its plain PyTorch
version on the card, and drives the port's paths at full size through
the public entry points:

  * the treelet path (kernel `rowtrace2`): Device -> Scene -> attach ->
    commit -> intersect / occluded on a 998,284-triangle sphere with
    2^21 incoherent rays;
  * the packet path (kernel `packet`): a 99,012-triangle scene of two
    masked geometries with 2^21 incoherent rays (plain, filtered and
    masked requests), the 998,284-triangle scene with a 1920x1080 frame
    of coherent camera rays and with 2^15 incoherent rays, and the
    `triangle_geometry` tutorial through `TutorialApplication.run`,
    its image held against the reference renderer's own 128x128 render;
  * the trainer: 5 steps of forward (treelet kernel, no gradient) +
    `hit_t_grad` + backward + a plain gradient step on the vertices.

Answers are checked against the plain versions, against a brute-force
test of every triangle, between the two kernels, and against autograd;
kernels are timed with CUDA events. Any failed phase ends the run with a
non-zero exit code; there is no CPU fallback. The last line of the
output is `{"ok": true, "device": {...}}`; the line `{"kernels": [...]}`
before it reports each kernel's launches on the driven paths, its error
against the plain version, its time, the plain version's time and its
roofline bound.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke: no CUDA device is available\n")
    sys.exit(1)

import embree_tpu_torch as ett  # noqa: E402
from embree_tpu_torch.build import native as sah_native  # noqa: E402
from embree_tpu_torch.build.treelets import (BLOCK_ROWS,  # noqa: E402
                                             build_treelet_scene)
from embree_tpu_torch.build.sah import BuildSettings, build_sah  # noqa: E402
from embree_tpu_torch.core import nvcc  # noqa: E402
from embree_tpu_torch.core.profile import global_profiler  # noqa: E402
from embree_tpu_torch.core.rayhit import Rays  # noqa: E402
from embree_tpu_torch.diff.hit import hit_t_grad, reeval_hit_verts  # noqa: E402
from embree_tpu_torch.render.camera import Camera, primary_rays  # noqa: E402
from embree_tpu_torch.render.image import read_pfm  # noqa: E402
from embree_tpu_torch.render.tutorials import (  # noqa: E402
    triangle_geometry as tutorial)
from embree_tpu_torch.scene.prims import prim_bounds_np  # noqa: E402
from embree_tpu_torch.traverse import packet_kernel as pk  # noqa: E402
from embree_tpu_torch.traverse import rowtrace2 as rt2  # noqa: E402
from embree_tpu_torch.traverse.moeller import intersect_triangle  # noqa: E402
from embree_tpu_torch.traverse.packet import _finalize_hits  # noqa: E402
from embree_tpu_torch.traverse.stream import (sort_rays_stream,  # noqa: E402
                                              unsort_by_perm)
from embree_tpu_torch.verify.fixtures import (random_triangles,  # noqa: E402
                                              triangle_sphere)

SCENE_RES = 707            # triangle_sphere(707) = 998,284 triangles
SMALL_RES = 223            # triangle_sphere(223) = 99,012: under ROWTRACE_MIN_PRIMS
LOG2_RAYS = 21
RAY_SEED = 0xBE7C4
BRUTE_RAYS = 1024
B1_PLAIN_LOG2 = 18         # rays of the main path B1's plain version re-walks
B2_PLAIN_LOG2 = 16         # rays B2's plain version walks at full scene size
FRAME = (1920, 1080)
TRAIN_STEPS = 5
TRAIN_LR = 1e-6
# how far the trainer's analytic gradient may lie from autograd's (both
# float32), relative to the largest entry
GRAD_TOL = 2e-4
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                      "golden", "ref_triangle_geometry_128.pfm")

# published H100 SXM peaks the roofline bound is stated against
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# float32 operations of one slab test (12 for the six plane distances, 10
# min/max, 2 robust factors, 1 tnear clamp, 2 compares) and of one
# triangle test (9 Ng, 3 C, 9 R, 5 den, 3 x 6 for U V T, 3 more products
# and sums, 6 compares)
SLAB_FLOPS = 27
TRI_FLOPS = 53
# the packed leaves of the packet kernel carry Ng: 9 operations fewer
PACKED_TRI_FLOPS = TRI_FLOPS - 9


def log(msg: str) -> None:
    print(msg, flush=True)


def unit_dirs(rng, n):
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return d


def ulp_distance(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in float32 steps between a and b (equal
    infinities are 0 apart; a NaN or unequal infinities fail)."""
    if torch.isnan(a).any() or torch.isnan(b).any():
        raise AssertionError("NaN in a traversal result")
    ia = a.view(torch.int32).long()
    ib = b.view(torch.int32).long()
    # map the sign-magnitude float order onto a monotone integer order
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max().item()) if a.numel() else 0


def compare_kernel_plain(ts, rays, occluded, cull, label):
    """Kernel and plain version on the same card tensors: prim equal,
    t within 1 ulp. Returns (max_abs_err, plain_ms)."""
    t_k, p_k = rt2.intersect_rowtrace2(ts, rays, occluded=occluded, cull=cull)
    torch.cuda.synchronize()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ev0.record()
    t_p, p_p = rt2.rowtrace2_plain(ts, rays, occluded=occluded, cull=cull)
    ev1.record()
    torch.cuda.synchronize()
    plain_ms = ev0.elapsed_time(ev1)
    ulps, err = check_close(label, t_k, t_p, p_k, p_p)
    hits = int((t_k == -math.inf).sum()) if occluded else int((p_k >= 0).sum())
    log(f"  {label}: {rays.tnear.numel()} rays, {hits} hits, prim equal, "
        f"t within {ulps} ulp (max abs err {err:g}), plain {plain_ms:.0f} ms")
    return err, plain_ms


def small_scene_checks(device):
    """Phase 3: kernel vs plain version on small scenes that cover the
    branches, each for closest, occluded and cull."""
    rng = np.random.default_rng(0x5EED)
    cases = []

    def scene(name, verts, idx, fan, org, d):
        v = np.asarray(verts, np.float32)[np.asarray(idx)]
        ts = build_treelet_scene(v[:, 0], v[:, 1], v[:, 2],
                                 np.arange(len(idx)), fan=fan)
        cases.append((f"{name} fan {fan} ({ts.num_mids} mids)",
                      ts.to_device(device),
                      ett.make_rays(org, d, device=device)))

    n = 2048
    verts, idx = random_triangles(rng, 2500, extent=5.0, size=1.2)
    scene("random_triangles(2500)", verts, idx, 8,
          rng.uniform(-8, 8, (n, 3)).astype(np.float32), unit_dirs(rng, n))
    verts, idx = triangle_sphere((0, 0, 0), 2.0, 24)
    scene("triangle_sphere(24), origins inside", verts, idx, 4,
          rng.uniform(-3, 3, (n, 3)).astype(np.float32), unit_dirs(rng, n))
    verts, idx = triangle_sphere((0, 0, 0), 2.0, 100)
    scene("triangle_sphere(100)", verts, idx, 48,
          rng.uniform(-3, 3, (n, 3)).astype(np.float32), unit_dirs(rng, n))
    verts, idx = triangle_sphere((0, 0, 0), 2.0, 200)
    scene("triangle_sphere(200)", verts, idx, 1,
          rng.uniform(-3, 3, (n, 3)).astype(np.float32), unit_dirs(rng, n))
    verts, idx = random_triangles(rng, 3000, extent=1.5, size=0.9)
    d = unit_dirs(rng, n)
    scene("converging rays, random_triangles(3000)", verts, idx, 2,
          -d * 6.0, d)
    if not any(ts.num_mids > 256 for _, ts, _ in cases):
        raise AssertionError("no small scene has more than 256 mids")
    # leaf pairs 128..255 of a treelet live in block rows 32..51
    if not any((ts.blocks[:, 32 + 18, :].view(torch.int32) >= 0).any()
               for _, ts, _ in cases):
        raise AssertionError("no small scene fills the second leaf chunk")

    worst = 0.0
    for name, ts, rays in cases:
        for mode, occluded, cull in (("closest", False, False),
                                     ("occluded", True, False),
                                     ("cull", False, True)):
            err, _ = compare_kernel_plain(ts, rays, occluded, cull,
                                          f"{name}, {mode}")
            worst = max(worst, err)
    return worst


def time_ms(fn, reps: int = 5):
    """Median of `reps` CUDA-event timings after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        fn()
        ev1.record()
        torch.cuda.synchronize()
        out.append(ev0.elapsed_time(ev1))
    return float(np.median(out))


def roofline_bound(ts, stats):
    """Least time the card could take for what this run's rays needed:
    the larger of bytes / memory rate (rays in, (t, prim) out, the box
    tables and every touched block once) and counted float32 operations
    / the non-tensor fp32 peak."""
    rays = stats["rays"]
    nbytes = (rays * (8 * 4 + 2 * 4)
              + stats["treelets_touched"] * BLOCK_ROWS * 128 * 4
              + ts.mid_boxes.numel() * 4 + ts.tre_boxes.numel() * 4)
    slabs = (rays * ts.num_mids + stats["mids_entered"] * ts.fan
             + stats["node_visits"] * 4)
    flops = slabs * SLAB_FLOPS + stats["pair_tests"] * 2 * TRI_FLOPS
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    flops_ms = flops / PEAK_FP32_PER_S * 1e3
    return {"bytes": nbytes, "flops": flops, "bytes_ms": bytes_ms,
            "flops_ms": flops_ms, "bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations"}


def check_close(name, t_k, t_p, p_k, p_p):
    """prim equal, t within 1 ulp, same finite mask: (ulps, max abs err)
    of t."""
    if not torch.equal(p_k, p_p):
        n = int((p_k != p_p).sum())
        raise AssertionError(f"{name}: prim differs on {n} rays")
    ulps = ulp_distance(t_k, t_p)
    if ulps > 1:
        raise AssertionError(f"{name}: t differs by {ulps} ulp")
    fin = torch.isfinite(t_k) & torch.isfinite(t_p)
    if not torch.equal(torch.isfinite(t_k), torch.isfinite(t_p)):
        raise AssertionError(f"{name}: finite masks differ")
    return ulps, float((t_k[fin] - t_p[fin]).abs().max()) if fin.any() else 0.0


def compare_packet_plain(ps, rays, occluded, cull, label, ray_mask=None):
    """Packet kernel (main and counting build) and plain version on the
    same card tensors: prim equal, t within 1 ulp, counters equal, no
    dropped push. Returns (max_abs_err, plain_ms)."""
    t_k, p_k, _ = pk.packet_trace(ps, rays, occluded, cull, ray_mask)
    t_s, p_s, st_k = pk.packet_trace(ps, rays, occluded, cull, ray_mask,
                                     stats=True)
    torch.cuda.synchronize()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ev0.record()
    t_p, p_p, st_p = pk.packet_plain(ps, rays, occluded, cull,
                                     ray_mask=ray_mask, stats=True)
    ev1.record()
    torch.cuda.synchronize()
    plain_ms = ev0.elapsed_time(ev1)
    _ulps, err = check_close(label, t_k, t_p, p_k, p_p)
    check_close(label + " (counting build)", t_s, t_p, p_s, p_p)
    if st_k != st_p:
        raise AssertionError(f"{label}: counters differ: {st_k} vs {st_p}")
    if st_k["dropped_pushes"] != 0:
        raise AssertionError(f"{label}: {st_k['dropped_pushes']} dropped "
                             "pushes")
    if occluded and not torch.equal(p_k, torch.full_like(p_k, -1)):
        raise AssertionError(f"{label}: the occluded variant wrote a prim")
    hits = int((t_k == -math.inf).sum()) if occluded else int((p_k >= 0).sum())
    log(f"  {label}: {rays.tnear.numel()} rays, {hits} hits, prim equal, "
        f"t max abs err {err:g}, counters equal "
        f"({st_k['node_visits']} node visits, {st_k['tri_tests']} triangle "
        f"tests, 0 dropped), plain {plain_ms:.0f} ms")
    return err, plain_ms


def packed_scene(verts, idx, width, device, prim_mask=None):
    v = np.asarray(verts, np.float32)[np.asarray(idx)]
    v0, v1, v2 = (np.ascontiguousarray(v[:, k]) for k in range(3))
    lo, hi = prim_bounds_np(v0, v1, v2)
    bvh = build_sah(lo, hi, BuildSettings(branching_factor=width))
    return pk.pack_scene(bvh, (v0, v1, v2), device, prim_mask=prim_mask)


def packet_small_scene_checks(device):
    """Packet kernel vs plain version on small scenes that cover: BVH4
    and BVH8, leaves that straddle two leaf rows, closest / occluded /
    cull, masks, a one-triangle scene, 7 and 1,025 rays, retired rays."""
    rng = np.random.default_rng(0xB2)
    worst = 0.0

    def rays_for(n, extent):
        org = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
        r = ett.make_rays(org, unit_dirs(rng, n), device=device)
        # every fifth ray is retired (tfar = -inf): one node visit each
        tf = r.tfar.clone()
        tf[::5] = -math.inf
        return r._replace(tfar=tf)

    scenes = []
    verts, idx = random_triangles(rng, 2500, extent=5.0, size=1.2)
    for w in (4, 8):
        scenes.append((f"random_triangles(2500) BVH{w}",
                       packed_scene(verts, idx, w, device), 8.0, 2048))
    verts, idx = triangle_sphere((0, 0, 0), 2.0, 24)
    for w in (4, 8):
        scenes.append((f"triangle_sphere(24) BVH{w}, origins inside",
                       packed_scene(verts, idx, w, device), 3.0, 1025))
    verts, idx = random_triangles(rng, 10, extent=5.0, size=2.0)
    scenes.append(("random_triangles(10) BVH4",
                   packed_scene(verts, idx, 4, device), 5.0, 7))
    scenes.append(("one triangle BVH4", packed_scene(
        np.array([[-1, -1, 0], [1, -1, 0], [0, 1, 0]], np.float32),
        np.array([[0, 1, 2]], np.int32), 4, device), 1.0, 1025))
    for name, ps, extent, n in scenes:
        rays = rays_for(n, extent)
        for mode, occluded, cull in (("closest", False, False),
                                     ("occluded", True, False),
                                     ("cull", False, True)):
            err, _ = compare_packet_plain(ps, rays, occluded, cull,
                                          f"{name}, {mode}")
            worst = max(worst, err)
    # a leaf whose triangles lie in two leaf rows: start % 10 + count > 10
    straddle = False
    for _name, ps, _e, _n in scenes:
        w = ps.width
        row = ps.nodes[:, 6 * w:8 * w].cpu().numpy()
        start, count = row[:, :w].astype(int), row[:, w:].astype(int)
        straddle |= bool(((count > 0) & (start % 10 + count > 10)).any())
    if not straddle:
        raise AssertionError("no small scene has a leaf over two leaf rows")
    # masks: two geometry masks over one soup, ray masks 0..3
    verts, idx = random_triangles(rng, 2500, extent=5.0, size=1.2)
    prim_mask = (1 + (np.arange(len(idx)) % 2)).astype(np.int32)
    for w in (4, 8):
        ps = packed_scene(verts, idx, w, device, prim_mask=prim_mask)
        rays = rays_for(2048, 8.0)
        rm = torch.from_numpy(
            rng.integers(0, 4, 2048).astype(np.int32)).to(device)
        for mode, occluded in (("closest", False), ("occluded", True)):
            err, _ = compare_packet_plain(
                ps, rays, occluded, False, f"masked BVH{w}, {mode}",
                ray_mask=rm)
            worst = max(worst, err)
        t_m, _p, _ = pk.packet_trace(ps, rays, ray_mask=rm)
        t_u, _p, _ = pk.packet_trace(ps, rays)
        if torch.equal(t_m, t_u):
            raise AssertionError("the masks changed no answer")
    return worst


def brute_check(label, tris, flat: Rays, valid, t, keep=None, ray_mask=None,
                prim_mask=None):
    """The first BRUTE_RAYS rays (evenly strided over the batch) against
    every triangle; `keep` (T,) bool drops triangles, the masks drop
    (triangle, ray) pairs."""
    n = flat.tnear.shape[0]
    sel = torch.linspace(0, n - 1, BRUTE_RAYS, device=t.device).long()
    br = Rays(*(a[sel].contiguous() for a in flat))
    best = br.tfar.clone()
    hit = torch.zeros(BRUTE_RAYS, dtype=torch.bool, device=t.device)
    for s in range(0, tris.num_prims, 65536):
        e = s + 65536
        ok, tt, _u, _v, _ng = intersect_triangle(
            br.org[:, None, :], br.dir[:, None, :], br.tnear[:, None],
            br.tfar[:, None], tris.v0[None, s:e], tris.v1[None, s:e],
            tris.v2[None, s:e])
        if keep is not None:
            ok &= keep[None, s:e]
        if ray_mask is not None:
            ok &= (prim_mask[None, s:e] & ray_mask[sel][:, None]) != 0
        tt = torch.where(ok, tt, torch.full_like(tt, math.inf)).min(dim=1)
        hit |= torch.isfinite(tt.values)
        best = torch.minimum(best, tt.values)
    k_valid, k_t = valid.reshape(-1)[sel], t.reshape(-1)[sel]
    if not torch.equal(hit, k_valid):
        raise AssertionError(f"{label}: brute force: valid masks differ on "
                             f"{int((hit != k_valid).sum())} rays")
    rel = (float(((best - k_t).abs() / k_t.abs())[k_valid].max())
           if k_valid.any() else 0.0)
    if not rel <= 1e-5:
        raise AssertionError(f"{label}: brute force: t differs by {rel:g} "
                             "relative")
    log(f"  {label}: brute force over all triangles, {BRUTE_RAYS} rays: same "
        f"valid mask ({int(hit.sum())} hits), t within {rel:g} relative")


class Launches:
    """Sets both kernels' launch counts to 0 on entry, reads them on
    exit and adds them to the run's totals."""

    totals = {"rowtrace2": 0, "packet": 0}

    def __enter__(self):
        rt2.launches = 0
        pk.launches = 0
        return self

    def __exit__(self, *exc):
        self.rowtrace2, self.packet = rt2.launches, pk.launches
        Launches.totals["rowtrace2"] += self.rowtrace2
        Launches.totals["packet"] += self.packet
        return False

    def expect(self, what, rowtrace2, packet):
        if (self.rowtrace2, self.packet) != (rowtrace2, packet):
            raise AssertionError(
                f"{what}: {self.rowtrace2} rowtrace2 and {self.packet} "
                f"packet launches, expected {rowtrace2} and {packet}")


def flat_rays(rays: Rays) -> Rays:
    return Rays(rays.org.reshape(-1, 3).contiguous(),
                rays.dir.reshape(-1, 3).contiguous(),
                rays.tnear.reshape(-1).contiguous(),
                rays.tfar.reshape(-1).contiguous())


def check_hits(label, hits, shape):
    if hits.t.shape != shape or hits.ng.shape != shape + (3,):
        raise AssertionError(f"{label}: wrong output shapes")
    valid = hits.valid
    if not (torch.isfinite(hits.t[valid]).all()
            and torch.isfinite(hits.ng).all()
            and (hits.u[valid] >= 0).all() and (hits.v[valid] >= 0).all()
            and (hits.u[valid] + hits.v[valid] <= 1.0 + 1e-4).all()
            and torch.isinf(hits.t[~valid]).all()):
        raise AssertionError(f"{label}: hit fields out of range")


def packet_bound(ps, st):
    """Least time the card could take for what this run's rays needed
    of the packet kernel: the larger of bytes / memory rate (rays in,
    (t, prim) out, the used part of every touched node row and leaf row
    once) and counted float32 operations / the non-tensor fp32 peak."""
    nbytes = (st["rays"] * (8 * 4 + 2 * 4)
              + st["nodes_touched"] * 8 * ps.width * 4
              + st["rows_touched"] * pk.NT_PER_ROW * pk.TRI_FLOATS * 4)
    flops = (st["node_visits"] * ps.width * SLAB_FLOPS
             + st["tri_tests"] * PACKED_TRI_FLOPS)
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    flops_ms = flops / PEAK_FP32_PER_S * 1e3
    return {"bytes": nbytes, "flops": flops, "bytes_ms": bytes_ms,
            "flops_ms": flops_ms, "bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations"}


def packet_times(label, ps, flat, cull=False):
    """Times, counters and bound of the packet kernel on one batch."""
    out = {}
    n = flat.tnear.shape[0]
    for mode, occl in (("closest", False), ("occluded", True)):
        ms = time_ms(lambda: pk.packet_trace(ps, flat, occl, cull))
        _t, _p, st = pk.packet_trace(ps, flat, occl, cull, stats=True)
        if st["dropped_pushes"] != 0:
            raise AssertionError(f"{label}: dropped pushes")
        bound = packet_bound(ps, st)
        out[mode] = {"ms": ms, "stats": st, "bound": bound}
        log(f"  packet {mode}, {label}, {n} rays: {ms:.3f} ms, "
            f"{n / ms / 1e3:.1f} Mray/s; per ray "
            f"{st['node_visits'] / n:.2f} node visits, "
            f"{st['tri_tests'] / n:.2f} triangle tests; "
            f"{st['nodes_touched']} of {ps.num_nodes} node rows and "
            f"{st['rows_touched']} of {ps.tdata.shape[0]} leaf rows touched; "
            f"bound {bound['bound_ms']:.4f} ms by {bound['bound_by']} "
            f"(bytes {bound['bytes'] / 1e6:.1f} MB -> "
            f"{bound['bytes_ms']:.4f} ms, operations "
            f"{bound['flops'] / 1e9:.2f} GFLOP -> {bound['flops_ms']:.4f} ms)"
            f": {100 * bound['bound_ms'] / ms:.1f} % of the kernel's time")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="stop after the kernel-vs-plain phases on small "
                         "scenes (prints no result line)")
    args = ap.parse_args()
    t_start = time.perf_counter()

    # -- 1. device ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(f"[1] device: torch {torch.__version__}, CUDA {torch.version.cuda}, "
        "card and power limit:")
    log(card)

    # -- 2. build ----------------------------------------------------------
    # a build directory left by another machine is deleted, not trusted
    shutil.rmtree(nvcc.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    nvcc.build_libraries([rt2.KERNEL_NAME, pk.KERNEL_NAME], verbose=True)
    nvcc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if not sah_native.native_available():
        raise AssertionError("the native SAH builder did not build")
    gxx_s = time.perf_counter() - t0
    log(f"[2] build: nvcc rowtrace2.cu and packet.cu together {nvcc_s:.1f} s, "
        f"g++ sah_builder.cpp {gxx_s:.1f} s")

    # -- 3. kernels vs plain versions, small scenes --------------------------
    log("[3] rowtrace2 kernel vs plain version on small scenes")
    dev = ett.Device("ignore_config_files=1")
    small_err = small_scene_checks(dev.device)
    log("[3b] packet kernel vs plain version on small scenes")
    pk_small_err = packet_small_scene_checks(dev.device)
    if args.quick:
        log("--quick: stopping before the full-size phases")
        return 0

    # -- 4. treelet path at full size ----------------------------------------
    log("[4] treelet path: Device -> Scene -> attach -> commit -> queries")
    verts, idx = triangle_sphere((0.0, 0.0, 0.0), 2.0, SCENE_RES)
    scene = ett.Scene(dev)
    scene.attach(ett.TriangleMesh(verts, idx))
    prof = global_profiler()
    prof.samples.clear()
    t0 = time.perf_counter()
    cs = scene.commit()
    torch.cuda.synchronize()
    commit_s = time.perf_counter() - t0
    phases = {k: prof.stats(k)["avg"] for k in prof.samples}
    ts = cs.rowtrace
    if not (sah_native.native_available()
            and "treelets.cut_ranges" in phases):
        raise AssertionError("commit did not use the native SAH builder")
    log(f"  commit {commit_s:.2f} s: " + ", ".join(
        f"{k} {v:.2f} s" for k, v in phases.items()))
    log(f"  {cs.tris.num_prims} triangles, {ts.num_treelets} treelets in "
        f"{ts.num_mids} mids of fan {ts.fan}, "
        f"{ts.device_bytes / 1e6:.1f} MB on the card; BVH{cs.packet.width} of "
        f"{cs.packet.num_nodes} nodes in {cs.packet.depth} levels, "
        f"{cs.packet.device_bytes / 1e6:.1f} MB packed")
    if cs.tris.num_prims != 998284:
        raise AssertionError(f"{cs.tris.num_prims} triangles, not 998,284")

    n = 1 << LOG2_RAYS
    rng = np.random.default_rng(RAY_SEED)
    d = unit_dirs(rng, n)
    org = rng.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    rays = ett.make_rays(org, d, device=dev.device)

    t0 = time.perf_counter()
    with Launches() as lc:
        for _ in range(3):
            hits = scene.intersect(rays)
        occ = scene.occluded(rays)
        torch.cuda.synchronize()
    requests_s = time.perf_counter() - t0
    lc.expect("3 intersect + 1 occluded requests", 4, 0)
    check_hits("treelet path", hits, (n,))
    if occ.shape != (n,):
        raise AssertionError("wrong output shapes")
    valid = hits.valid
    frac = float(valid.float().mean())
    if not 0.15 < frac < 0.8:
        raise AssertionError(f"hit fraction {frac:.3f} is not plausible")
    if not torch.equal(occ, valid):
        raise AssertionError("occluded disagrees with intersect's valid mask")
    log(f"  3 intersect + 1 occluded requests of 2^{LOG2_RAYS} rays in "
        f"{requests_s:.3f} s, {lc.rowtrace2} rowtrace2 launches, "
        f"hit fraction {frac:.4f}, occluded == valid")

    # -- 5. treelet path: correctness at full size ---------------------------
    log("[5] treelet path: correctness at full size")
    nb1 = 1 << B1_PLAIN_LOG2
    head = Rays(*(a[:nb1].contiguous() for a in rays))
    full_err, plain_ms = compare_kernel_plain(
        ts, head, False, False,
        f"998,284 triangles, the first 2^{B1_PLAIN_LOG2} rays of the main "
        "path")
    brute_check("treelet path", cs.tris, rays, valid, hits.t)

    # -- 6. packet path at full size -----------------------------------------
    log("[6] packet path through the entry points")
    # (a) 99,012 triangles as two geometries with masks 1 and 2
    sverts, sidx = triangle_sphere((0.0, 0.0, 0.0), 2.0, SMALL_RES)
    half = len(sidx) // 2
    small = ett.Scene(dev)
    for part, gmask in ((sidx[:half], 1), (sidx[half:], 2)):
        mesh = ett.TriangleMesh(sverts, part)
        mesh.mask = gmask
        small.attach(mesh)
    t0 = time.perf_counter()
    scs = small.commit()
    torch.cuda.synchronize()
    log(f"  (a) commit {time.perf_counter() - t0:.2f} s: "
        f"{scs.tris.num_prims} triangles in 2 geometries, "
        f"BVH{scs.packet.width} of {scs.packet.num_nodes} nodes in "
        f"{scs.packet.depth} levels")
    if scs.tris.num_prims != 99012 or scs.rowtrace is not None:
        raise AssertionError("scene (a) is not a 99,012-triangle packet scene")
    with Launches() as lc:
        h_a = small.intersect(rays)
        occ_a = small.occluded(rays)
        torch.cuda.synchronize()
    lc.expect("(a) intersect + occluded", 0, 2)
    check_hits("(a)", h_a, (n,))
    if not torch.equal(occ_a, h_a.valid):
        raise AssertionError("(a): occluded disagrees with the valid mask")
    brute_check("(a) 2^21 incoherent rays", scs.tris, rays, h_a.valid, h_a.t)

    # (c) a filtered and a masked request on (a)
    small.set_intersection_filter(
        lambda org_, d_, t_, u_, v_, ng_, geom_, prim_: prim_ % 2 == 0)
    with Launches() as lc:
        h_f = small.intersect(rays)
        torch.cuda.synchronize()
    small.set_intersection_filter(None)
    if lc.rowtrace2 != 0 or lc.packet < 2:
        raise AssertionError(f"(c) filter: {lc.rowtrace2} rowtrace2 and "
                             f"{lc.packet} packet launches")
    check_hits("(c) filter", h_f, (n,))
    if (h_f.prim_id[h_f.valid] % 2 != 0).any():
        raise AssertionError("(c): a filtered-out primitive was returned")
    log(f"  (c) filter (keep even prim ids): {lc.packet} rounds of the "
        f"packet kernel, {int(h_f.valid.sum())} hits "
        f"({int(h_a.valid.sum())} unfiltered)")
    brute_check("(c) filtered request", scs.tris, rays, h_f.valid, h_f.t,
                keep=scs.tris.prim_id % 2 == 0)
    rmask = torch.from_numpy(np.random.default_rng(7).integers(
        0, 4, n).astype(np.int32)).to(dev.device)
    with Launches() as lc:
        h_m = small.intersect(rays, mask=rmask)
        occ_m = small.occluded(rays, mask=rmask)
        torch.cuda.synchronize()
    lc.expect("(c) masked intersect + occluded", 0, 2)
    check_hits("(c) mask", h_m, (n,))
    if not torch.equal(occ_m, h_m.valid):
        raise AssertionError("(c): masked occluded disagrees with valid")
    if h_m.valid[rmask == 0].any() or not torch.equal(
            h_m.valid[rmask == 3], h_a.valid[rmask == 3]):
        raise AssertionError("(c): ray masks 0 and 3 do not behave")
    brute_check("(c) masked request", scs.tris, rays, h_m.valid, h_m.t,
                ray_mask=rmask, prim_mask=scs.prim_mask)

    # (b) the 998,284-triangle scene: a coherent frame and a small batch
    cam = Camera(from_=(0.5, 1.0, -4.5), to=(0.0, 0.0, 0.0))
    frame = primary_rays(cam, *FRAME, device=dev.device)
    n15 = 1 << 15
    few = Rays(*(a[:n15].contiguous() for a in rays))
    with Launches() as lc:
        h_fr = scene.intersect(frame, coherent=True)
        h_few = scene.intersect(few)
        occ_few = scene.occluded(few)
        torch.cuda.synchronize()
    lc.expect("(b) coherent frame + 2^15 rays", 0, 3)
    check_hits("(b) frame", h_fr, (FRAME[1], FRAME[0]))
    check_hits("(b) 2^15 rays", h_few, (n15,))
    frac_fr = float(h_fr.valid.float().mean())
    if not 0.05 < frac_fr < 0.9:
        raise AssertionError(f"(b): frame hit fraction {frac_fr:.3f}")
    if not torch.equal(occ_few, h_few.valid):
        raise AssertionError("(b): occluded disagrees with the valid mask")
    log(f"  (b) {FRAME[0]}x{FRAME[1]} coherent camera rays: hit fraction "
        f"{frac_fr:.4f}")
    frame_flat = flat_rays(frame)
    brute_check("(b) coherent frame", cs.tris, frame_flat, h_fr.valid, h_fr.t)
    brute_check("(b) 2^15 incoherent rays", cs.tris, few, h_few.valid,
                h_few.t)
    # the packet kernel against the treelet kernel on the same rays
    t_b2, p_b2 = pk.intersect_packet_kernel_raw(cs.packet, head)
    t_b1, v_b1 = hits.t[:nb1], valid[:nb1]
    if not torch.equal(p_b2 >= 0, v_b1):
        raise AssertionError("packet vs rowtrace2: valid masks differ")
    rel = float(((t_b2 - t_b1).abs() / t_b1.abs())[v_b1].max())
    same_prim = float((p_b2 == hits.gprim[:nb1])[v_b1].float().mean())
    if not rel <= 1e-5:
        raise AssertionError(f"packet vs rowtrace2: t differs by {rel:g}")
    log(f"  packet vs rowtrace2 on the first 2^{B1_PLAIN_LOG2} rays of the "
        f"main path: same valid mask, t within {rel:g} relative, prim equal "
        f"on {100 * same_prim:.4f} % of the hits")
    nb2 = 1 << B2_PLAIN_LOG2
    head2 = Rays(*(a[:nb2].contiguous() for a in rays))
    pk_full_err, _ = compare_packet_plain(
        cs.packet, head2, False, False,
        f"998,284 triangles, the first 2^{B2_PLAIN_LOG2} rays of the main "
        "path")
    pk_a_err, pk_plain_ms = compare_packet_plain(
        scs.packet, head2, False, False,
        f"99,012 triangles, the first 2^{B2_PLAIN_LOG2} rays of (a)")

    # (d) the triangle_geometry tutorial
    app = tutorial.make_app()
    with Launches() as lc:
        rc = app.run(["--benchmark", "1", "3",
                      "-rtcore", "ignore_config_files=1"])
        torch.cuda.synchronize()
    if rc != 0:
        raise AssertionError(f"the tutorial returned {rc}")
    lc.expect("(d) tutorial: 5 frames of 2 batches", 0, 10)
    state = tutorial.build_scene(dev)
    with Launches() as lc:
        img, _nr = tutorial.render_frame(state, app.camera, (128, 128))
        img = img.cpu().numpy()
    lc.expect("(d) 128x128 frame", 0, 2)
    ref = read_pfm(GOLDEN)
    quant = np.floor(255.0 * np.clip(img, 0.0, 1.0)) / 255.0
    bad = float((np.abs(quant - ref).max(-1) > 1.5 / 255).mean())
    if not (np.isfinite(img).all() and bad <= 0.005):
        raise AssertionError(f"(d): {bad:.4%} of the pixels differ from the "
                             "reference render")
    log(f"  (d) tutorial at {app.default_size[0]}x{app.default_size[1]} "
        f"ran; 128x128 frame: {bad:.4%} of the pixels differ from the "
        "reference renderer's image (budget 0.5 %)")

    # -- 7. the trainer --------------------------------------------------------
    log(f"[7] trainer: {TRAIN_STEPS} steps on the 998,284-triangle scene, "
        f"2^{LOG2_RAYS} rays")
    vparam = torch.tensor(verts, device=dev.device, requires_grad=True)
    tidx = torch.from_numpy(idx).to(dev.device)
    step_ms = []
    with Launches() as lc:
        for step in range(TRAIN_STEPS):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            with torch.no_grad():
                sel = scene.intersect(rays)
            t_fused = hit_t_grad(vparam, tidx, rays, sel.gprim, sel.valid,
                                 sel.t, tris=cs.tris)
            loss = torch.where(sel.valid, t_fused,
                               torch.zeros_like(t_fused)).sum()
            ev[1].record()
            loss.backward()
            ev[2].record()
            torch.cuda.synchronize()
            step_ms.append((ev[0].elapsed_time(ev[1]),
                            ev[1].elapsed_time(ev[2])))
            if not math.isfinite(loss.item()):
                raise AssertionError(f"step {step}: loss {loss.item()}")
            grad = vparam.grad
            if step == 0:
                loss0, grad0 = loss.item(), grad.clone()
                sel0 = sel
            with torch.no_grad():
                vparam -= TRAIN_LR * grad
            vparam.grad = None
    lc.expect("trainer", TRAIN_STEPS, 0)
    # step 0's gradient against float32 autograd through the
    # re-evaluation. The largest entries belong to grazing hits, where
    # 1/den amplifies float32 rounding in both evaluations (against a
    # float64 re-evaluation either lies 7e-3 of the largest entry away
    # at 2^21 rays), so the two are held to GRAD_TOL, not to 1e-5
    vref = torch.tensor(verts, device=dev.device, requires_grad=True)
    t_re, _u, _v = reeval_hit_verts(vref, tidx, rays, sel0.gprim, sel0.valid)
    torch.where(sel0.valid, t_re, torch.zeros_like(t_re)).sum().backward()
    scale = float(vref.grad.abs().max())
    grad_rel = float((grad0 - vref.grad).abs().max()) / scale
    if not (torch.isfinite(grad0).all() and grad_rel <= GRAD_TOL):
        raise AssertionError(
            f"trainer: the analytic gradient is {grad_rel:g} of the largest "
            "entry away from autograd's")
    touched = torch.zeros(len(verts), dtype=torch.bool, device=dev.device)
    touched[tidx[sel0.gprim[sel0.valid].long()].reshape(-1).long()] = True
    if grad0[~touched].any() or not grad0[touched].any():
        raise AssertionError("trainer: gradient rows of untouched vertices "
                             "are not zero")
    fwd_ms = float(np.median([a for a, _ in step_ms[1:]]))
    bwd_ms = float(np.median([b for _, b in step_ms[1:]]))
    log(f"  loss {loss0:.6g} at step 0, {loss.item():.6g} at step "
        f"{TRAIN_STEPS - 1}; analytic gradient within {grad_rel:g} of "
        f"autograd's, relative to its largest entry {scale:g}; "
        f"{int(touched.sum())} of {len(verts)} vertices touched, all other "
        "rows zero")
    log(f"  step (median of steps 1..{TRAIN_STEPS - 1}, CUDA events): "
        f"forward {fwd_ms:.3f} ms, backward {bwd_ms:.3f} ms, step "
        f"{fwd_ms + bwd_ms:.3f} ms = "
        f"{n / (fwd_ms + bwd_ms) / 1e3:.1f} Mray/s")

    # -- 8. times -------------------------------------------------------------
    log("[8] times (CUDA events, median of 5 after a warm-up; the L2 cache "
        "is not flushed between launches)")
    times = {}
    for log2 in (20, 21):
        r = Rays(*(a[:1 << log2].contiguous() for a in rays))
        for mode, occl in (("closest", False), ("occluded", True)):
            ms = time_ms(lambda: rt2.intersect_rowtrace2(ts, r,
                                                         occluded=occl))
            times[f"{mode}_2^{log2}"] = ms
            log(f"  rowtrace2 {mode}, 2^{log2} rays: {ms:.3f} ms, "
                f"{(1 << log2) / ms / 1e3:.1f} Mray/s")
    t_k, p_k = rt2.intersect_rowtrace2(ts, rays)
    for label, r, tk, pkk in (
            (f"2^{LOG2_RAYS}", rays, t_k, p_k),
            ("2^20", Rays(*(a[:1 << 20].contiguous() for a in rays)),
             t_k[:1 << 20].contiguous(), p_k[:1 << 20].contiguous())):
        fin_ms = time_ms(lambda: _finalize_hits(cs.tris, r, tk, pkk))
        log(f"  _finalize_hits (plain torch ops), {label} rays: "
            f"{fin_ms:.3f} ms")
    for label, fn in (
            ("intersect request, treelet path, 2^21 rays",
             lambda: scene.intersect(rays)),
            ("occluded request, treelet path, 2^21 rays",
             lambda: scene.occluded(rays)),
            ("intersect request, packet path (a), 2^21 rays",
             lambda: small.intersect(rays)),
            ("intersect request, packet path (b), coherent frame",
             lambda: scene.intersect(frame, coherent=True))):
        log(f"  {label}: {time_ms(fn):.3f} ms")
    log(f"  rowtrace2 plain version, 2^{B1_PLAIN_LOG2} rays closest: "
        f"{plain_ms:.0f} ms")
    stats = {}
    for mode, occl in (("closest", False), ("occluded", True)):
        _t, _p, st = rt2.rowtrace2_stats(ts, rays, occluded=occl)
        stats[mode] = st
        per = {k: v / st["rays"] for k, v in st.items()
               if k not in ("rays", "treelets_touched")}
        log(f"  stats {mode}: per ray " + ", ".join(
            f"{k} {v:.2f}" for k, v in per.items())
            + f"; {st['treelets_touched']} of {ts.num_treelets} treelets "
              "touched")
    if not torch.equal(_p, torch.full_like(_p, -1)):
        raise AssertionError("the occluded variant wrote a prim id")
    bound = roofline_bound(ts, stats["closest"])
    kernel_ms = times[f"closest_2^{LOG2_RAYS}"]
    log(f"  bound at 2^{LOG2_RAYS} rays closest: bytes "
        f"{bound['bytes'] / 1e6:.1f} MB -> {bound['bytes_ms']:.4f} ms, "
        f"operations {bound['flops'] / 1e9:.2f} GFLOP -> "
        f"{bound['flops_ms']:.4f} ms; bound by {bound['bound_by']}; the "
        f"kernel's {kernel_ms:.3f} ms is "
        f"{100 * bound['bound_ms'] / kernel_ms:.1f} % of it")

    pk_a = packet_times("(a) 99,012 triangles, incoherent", scs.packet, rays)
    packet_times("(b) 998,284 triangles, coherent frame", cs.packet,
                 frame_flat)
    packet_times("(b) 998,284 triangles, 2^15 incoherent", cs.packet, few)
    packet_times("998,284 triangles, 2^21 incoherent (the treelet path's "
                 "batch)", cs.packet, rays)

    def sorted_closest():
        srays, perm = sort_rays_stream(rays, scs.world_lower, scs.world_upper)
        return unsort_by_perm(perm, *pk.intersect_packet_kernel_raw(
            scs.packet, srays))

    def sorted_occluded():
        srays, perm = sort_rays_stream(rays, scs.world_lower, scs.world_upper)
        return unsort_by_perm(perm, pk.occluded_packet_kernel(scs.packet,
                                                              srays))

    t_s, p_s = sorted_closest()
    if not (torch.equal(t_s, h_a.t) and torch.equal(p_s, h_a.gprim)):
        raise AssertionError("sorted and unsorted packet answers differ")
    sort_ms = time_ms(lambda: sort_rays_stream(rays, scs.world_lower,
                                               scs.world_upper))
    log(f"  (a) with sort_rays_stream + unsort_by_perm (sort alone "
        f"{sort_ms:.3f} ms): closest {time_ms(sorted_closest):.3f} ms "
        f"against {time_ms(lambda: pk.intersect_packet_kernel_raw(scs.packet, rays)):.3f} ms unsorted, "
        f"occluded {time_ms(sorted_occluded):.3f} ms against "
        f"{time_ms(lambda: pk.occluded_packet_kernel(scs.packet, rays)):.3f} "
        "ms unsorted; the scene path does not sort")

    # rowtrace2: ms and bound_ms belong to the closest-hit request of the
    # treelet path (2^21 rays, 998,284 triangles), plain_ms to its first
    # 2^18 rays. packet: ms and bound_ms belong to the closest-hit launch
    # of (a) (2^21 rays, 99,012 triangles), plain_ms to its first 2^16 rays
    kernels = {"kernels": [{
        "name": "rowtrace2", "route": "cuda",
        "source": "embree_tpu_torch/csrc/rowtrace2.cu",
        "replaces": "embree_tpu/traverse/rowtrace2.py:153",
        "launches": Launches.totals["rowtrace2"],
        "max_abs_err": max(small_err, full_err),
        "ms": kernel_ms, "plain_ms": plain_ms, "plain_rays": nb1,
        "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
        "library_ms": None,
    }, {
        "name": "packet", "route": "cuda",
        "source": "embree_tpu_torch/csrc/packet.cu",
        "replaces": "embree_tpu/traverse/pallas_packet.py:261",
        "launches": Launches.totals["packet"],
        "max_abs_err": max(pk_small_err, pk_full_err, pk_a_err),
        "ms": pk_a["closest"]["ms"], "plain_ms": pk_plain_ms,
        "plain_rays": nb2,
        "bound_ms": pk_a["closest"]["bound"]["bound_ms"],
        "bound_by": pk_a["closest"]["bound"]["bound_by"],
        "library_ms": None,
    }]}
    for k in kernels["kernels"]:
        if k["launches"] < 1:
            raise AssertionError(f"kernel {k['name']} was never launched on "
                                 "the driven paths")

    # -- 9. result lines ------------------------------------------------------
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
