#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (embree_tpu_torch).

    python3 chip_smoke.py            # needs one CUDA card, about 3 minutes
    python3 chip_smoke.py --quick    # stop after the kernel-vs-plain phase

Builds every kernel from the sources in this checkout, holds each kernel
against its plain PyTorch version on the card, drives the port's main
path at full size through the public entry points (Device -> Scene ->
attach -> commit -> intersect / occluded: a 998,284-triangle sphere and
2^21 incoherent rays), checks the answers against the plain version and
against a brute-force test of every triangle, and times the kernel with
CUDA events. Any failed phase ends the run with a non-zero exit code;
there is no CPU fallback. The last line of the output is
`{"ok": true, "device": {...}}`; the line `{"kernels": [...]}` before it
reports each kernel's launches on the main path, its error against the
plain version, its time, the plain version's time and its roofline bound.
"""
from __future__ import annotations

import argparse
import json
import math
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
from embree_tpu_torch.core.profile import global_profiler  # noqa: E402
from embree_tpu_torch.core.rayhit import Rays  # noqa: E402
from embree_tpu_torch.traverse import rowtrace2 as rt2  # noqa: E402
from embree_tpu_torch.traverse.moeller import intersect_triangle  # noqa: E402
from embree_tpu_torch.traverse.packet import _finalize_hits  # noqa: E402
from embree_tpu_torch.verify.fixtures import (random_triangles,  # noqa: E402
                                              triangle_sphere)

SCENE_RES = 707            # triangle_sphere(707) = 998,284 triangles
LOG2_RAYS = 21
RAY_SEED = 0xBE7C4
BRUTE_RAYS = 1024

# published H100 SXM peaks the roofline bound is stated against
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# float32 operations of one slab test (12 for the six plane distances, 10
# min/max, 2 robust factors, 1 tnear clamp, 2 compares) and of one
# triangle test (9 Ng, 3 C, 9 R, 5 den, 3 x 6 for U V T, 3 more products
# and sums, 6 compares)
SLAB_FLOPS = 27
TRI_FLOPS = 53


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
    if not torch.equal(p_k, p_p):
        n = int((p_k != p_p).sum())
        raise AssertionError(f"{label}: prim differs on {n} rays")
    ulps = ulp_distance(t_k, t_p)
    if ulps > 1:
        raise AssertionError(f"{label}: t differs by {ulps} ulp")
    fin = torch.isfinite(t_k) & torch.isfinite(t_p)
    if not torch.equal(torch.isfinite(t_k), torch.isfinite(t_p)):
        raise AssertionError(f"{label}: finite masks differ")
    err = float((t_k[fin] - t_p[fin]).abs().max()) if fin.any() else 0.0
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


def brute_force(tris, rays: Rays, chunk: int = 65536):
    """Closest hit by testing every triangle (no acceleration structure),
    in chunks of triangles: (valid, t) per ray."""
    n = rays.tnear.shape[0]
    best = rays.tfar.clone()
    hit = torch.zeros(n, dtype=torch.bool, device=best.device)
    for s in range(0, tris.num_prims, chunk):
        e = s + chunk
        valid, t, _u, _v, _ng = intersect_triangle(
            rays.org[:, None, :], rays.dir[:, None, :], rays.tnear[:, None],
            rays.tfar[:, None], tris.v0[None, s:e], tris.v1[None, s:e],
            tris.v2[None, s:e])
        t = torch.where(valid, t, torch.full_like(t, math.inf)).min(dim=1)
        hit |= torch.isfinite(t.values)
        best = torch.minimum(best, t.values)
    return hit, best


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="stop after the kernel-vs-plain phase on small "
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
    shutil.rmtree(rt2.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    rt2.build_kernel(verbose=True)
    nvcc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if not sah_native.native_available():
        raise AssertionError("the native SAH builder did not build")
    gxx_s = time.perf_counter() - t0
    log(f"[2] build: nvcc rowtrace2.cu {nvcc_s:.1f} s, "
        f"g++ sah_builder.cpp {gxx_s:.1f} s")

    # -- 3. kernel vs plain version, small scenes ---------------------------
    log("[3] kernel vs plain version on small scenes")
    dev = ett.Device("ignore_config_files=1")
    small_err = small_scene_checks(dev.device)
    if args.quick:
        log("--quick: stopping before the full-size phases")
        return 0

    # -- 4. main path at full size ------------------------------------------
    log("[4] main path: Device -> Scene -> attach -> commit -> queries")
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
        f"{ts.device_bytes / 1e6:.1f} MB on the card")
    if cs.tris.num_prims != 998284:
        raise AssertionError(f"{cs.tris.num_prims} triangles, not 998,284")

    n = 1 << LOG2_RAYS
    rng = np.random.default_rng(RAY_SEED)
    d = unit_dirs(rng, n)
    org = rng.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    rays = ett.make_rays(org, d, device=dev.device)

    rt2.launches = 0
    t0 = time.perf_counter()
    for _ in range(3):
        hits = scene.intersect(rays)
    occ = scene.occluded(rays)
    torch.cuda.synchronize()
    requests_s = time.perf_counter() - t0
    main_launches = rt2.launches
    if main_launches != 4:
        raise AssertionError(f"4 requests made {main_launches} launches")
    if hits.t.shape != (n,) or hits.ng.shape != (n, 3) or occ.shape != (n,):
        raise AssertionError("wrong output shapes")
    valid = hits.valid
    frac = float(valid.float().mean())
    if not 0.15 < frac < 0.8:
        raise AssertionError(f"hit fraction {frac:.3f} is not plausible")
    if not torch.equal(occ, valid):
        raise AssertionError("occluded disagrees with intersect's valid mask")
    if not (torch.isfinite(hits.t[valid]).all()
            and torch.isfinite(hits.ng).all()
            and (hits.u[valid] >= 0).all() and (hits.v[valid] >= 0).all()
            and (hits.u[valid] + hits.v[valid] <= 1.0 + 1e-4).all()
            and torch.isinf(hits.t[~valid]).all()):
        raise AssertionError("hit fields out of range")
    log(f"  3 intersect + 1 occluded requests of 2^{LOG2_RAYS} rays in "
        f"{requests_s:.3f} s, {main_launches} kernel launches, "
        f"hit fraction {frac:.4f}, occluded == valid")

    # -- 5. correctness at full size ----------------------------------------
    log("[5] correctness at full size")
    full_err, plain_ms = compare_kernel_plain(
        ts, rays, False, False,
        f"998,284 triangles, all 2^{LOG2_RAYS} rays of the main path")
    br = Rays(*(a[:BRUTE_RAYS].contiguous() for a in rays))
    b_hit, b_t = brute_force(cs.tris, br)
    k_valid, k_t = valid[:BRUTE_RAYS], hits.t[:BRUTE_RAYS]
    if not torch.equal(b_hit, k_valid):
        raise AssertionError("brute force: valid masks differ")
    rel = float(((b_t - k_t).abs() / k_t.abs())[k_valid].max())
    if not rel <= 1e-5:
        raise AssertionError(f"brute force: t differs by {rel:g} relative")
    log(f"  brute force over all triangles, {BRUTE_RAYS} rays: same valid "
        f"mask ({int(b_hit.sum())} hits), t within {rel:g} relative")

    # -- 6. times -------------------------------------------------------------
    log("[6] times (CUDA events, median of 5 after a warm-up; the 111 MB of "
        "blocks exceed the L2 cache, which is not flushed between launches)")
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
    fin_ms = time_ms(lambda: _finalize_hits(cs.tris, rays, t_k, p_k))
    log(f"  _finalize_hits (plain torch ops), 2^{LOG2_RAYS} rays: "
        f"{fin_ms:.3f} ms")
    log(f"  plain version, 2^{LOG2_RAYS} rays closest: {plain_ms:.0f} ms")
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

    # ms, plain_ms and bound_ms all belong to the main path's closest-hit
    # request: 2^21 rays against the 998,284-triangle scene
    kernels = {"kernels": [{
        "name": "rowtrace2", "route": "cuda",
        "source": "embree_tpu_torch/csrc/rowtrace2.cu",
        "replaces": "embree_tpu/traverse/rowtrace2.py:153",
        "launches": main_launches,
        "max_abs_err": max(small_err, full_err),
        "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
        "library_ms": None,
    }]}

    # -- 7. result lines ------------------------------------------------------
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
