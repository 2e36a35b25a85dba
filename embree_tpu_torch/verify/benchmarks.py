"""Traversal benchmark matrix (verify.cpp "benchmarks" group analog,
:4473-4560): {coherent, incoherent} x {triangles, quads, motion-blur
triangles, compressed subdivision} million-prim scenes x {intersect,
occluded}, reported as greppable keys.

Counterpart of embree_tpu/verify/benchmarks.py: the same matrix, keys
and ray generators through this package's API, timed on the host clock
around `torch.cuda.synchronize()` on a CUDA device. The motion-blur row's
occluded query is the closest hit's valid mask at time 0: this
package's `scene_occluded` refuses motion-blur geometry, which the JAX
package answers without its motion-blur accel.

Run: python -m embree_tpu_torch.verify.benchmarks [num_prims] [cpu]
(on the CUDA device unless the second argument is `cpu`).
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch


def _coherent_rays(n, rng):
    """Camera-style ray bundle (CoherentRaysBenchmark)."""
    side = int(np.sqrt(n))
    xs = np.linspace(-0.45, 0.45, side, dtype=np.float32)
    x, y = np.meshgrid(xs, xs)
    d = np.stack([x, y, -np.ones_like(x)], -1).reshape(-1, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    org = np.tile(np.array([0, 0, 5.0], np.float32), (d.shape[0], 1))
    return org, d


def _incoherent_rays(n, rng):
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    org = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    return org, d


def run(n_prims: int = 1_000_000, n_rays: int = 65536, reps: int = 8,
        device="cuda") -> dict:
    import embree_tpu_torch as ett
    from embree_tpu_torch.verify.fixtures import (quad_sphere, subdiv_cube,
                                                  triangle_sphere)

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device=\"cpu\"")
    rng = np.random.default_rng(11)
    out = {}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def committed(name, geom, cfg="ignore_config_files=1", levels=None,
                  n=None):
        s = ett.Scene(ett.Device(cfg, device=dev))
        s.attach(geom)
        if levels is not None:
            s.set_levels(*levels)
        t0 = time.perf_counter()
        cs = s.commit()
        sync()
        out[f"BENCHMARK_BUILD_{name.upper()}_MPRIMS_S"] = \
            n / (time.perf_counter() - t0) / 1e6
        return cs

    scenes = {}
    n = max(int(np.sqrt(n_prims / 2)), 8)
    scenes["tri"] = triangle_sphere((0, 0, 0), 2.0, n)
    nq = max(int(np.sqrt(n_prims / 2)), 8)
    qv, qi = quad_sphere((0, 0, 0), 2.0, nq // 2)
    scenes["quad"] = (qv, qi)

    for name, (verts, idx) in scenes.items():
        geom = (ett.QuadMesh(verts, idx) if name == "quad"
                else ett.TriangleMesh(verts, idx))
        cs = committed(name, geom, n=idx.shape[0])
        _trav_rows(out, ett, cs, name, n_rays, rng, reps, dev, sync)

    # tri_mb row (verify.cpp benchmark matrix includes *_mb scenes)
    verts, idx = scenes["tri"]
    cs = committed("tri_mb", ett.TriangleMeshMB(
        verts, verts + np.float32([0.1, 0, 0]), idx), n=idx.shape[0])
    _trav_rows(out, ett, cs, "tri_mb", n_rays, rng, reps, dev, sync)

    # subdiv row (compressed-leaf mode, the fork's accel)
    sv, sfc, sfi = subdiv_cube()
    cs = committed("subdiv", ett.SubdivMesh(sv, sfc, sfi),
                   "ignore_config_files=1,subdiv_accel=bvh4.compressed.leaf",
                   levels=(5, 3), n=len(sfc))
    _trav_rows(out, ett, cs, "subdiv", n_rays, rng, reps, dev, sync)

    for k, v in out.items():
        print(f"{k} {v:.4g}")
    return out


def _trav_rows(out, ett, cs, name, n_rays, rng, reps, dev, sync):
    mb = cs.mb is not None
    for mode, raygen in (("coherent", _coherent_rays),
                         ("incoherent", _incoherent_rays)):
        org, d = raygen(n_rays, rng)
        rays = ett.make_rays(org, d, device=dev)
        for q, fn in (("intersect",
                       lambda: ett.scene_intersect(cs, rays).t),
                      ("occluded",
                       (lambda: ett.scene_intersect(cs, rays).valid) if mb
                       else (lambda: ett.scene_occluded(cs, rays)))):
            fn()
            sync()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            sync()
            dt = time.perf_counter() - t0
            key = (f"BENCHMARK_TRAV_{name.upper()}_{mode.upper()}"
                   f"_{q.upper()}_MRAYPS")
            out[key] = reps * len(org) / dt / 1e6


if __name__ == "__main__":
    run(int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000,
        device=sys.argv[2] if len(sys.argv) > 2 else "cuda")
