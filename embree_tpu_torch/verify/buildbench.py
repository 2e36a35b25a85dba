"""buildbench: BVH build performance microbench.

Counterpart of embree_tpu/verify/buildbench.py, the analog of
tutorials/buildbench/buildbench_device.cpp: static create (:265),
dynamic create (:225), update/refit (:186). The static builds are the
host SAH builders (native C++, SBVH, the numpy frontier builder); the
dynamic create is the morton build (build/morton.py) and the update the
refit (build/refit.py), both torch ops on the device, timed with
`torch.cuda.synchronize()` on a CUDA device. Prints greppable
BENCHMARK_BUILD_* keys (the reference's key-line convention).

Run: python -m embree_tpu_torch.verify.buildbench [num_prims] [cpu]
(on the CUDA device unless the second argument is `cpu`).
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch


def run(n_prims: int = 100_000, reps: int = 5, device="cuda") -> dict:
    from ..build.morton import build_morton
    from ..build.refit import plan_refit, refit
    from ..build.sah import BuildSettings, build_sah
    from ..scene.prims import prim_bounds_np
    from ..verify.fixtures import triangle_sphere

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device=\"cpu\"")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def best(fn):
        """The least wall time of `reps` calls, after one warm-up."""
        fn()
        sync()
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            sync()
            ts.append(time.perf_counter() - t0)
        return min(ts)

    n = max(int(np.sqrt(n_prims / 2)), 4)
    verts, idx = triangle_sphere((0, 0, 0), 1.0, n)
    v0, v1, v2 = verts[idx[:, 0]], verts[idx[:, 1]], verts[idx[:, 2]]
    lo, hi = prim_bounds_np(v0, v1, v2)
    P = lo.shape[0]
    out = {}

    # static create: native SAH
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        bvh = build_sah(lo, hi, BuildSettings(), backend="default")
        ts.append(time.perf_counter() - t0)
    out["BENCHMARK_BUILD_STATIC_SAH_MPRIMS_S"] = P / min(ts) / 1e6

    # HIGH quality: binned spatial splits (SBVH, exact triangle clip)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        build_sah(lo, hi, BuildSettings(spatial_factor=1.2),
                  backend="default", tri_verts=(v0, v1, v2))
        ts.append(time.perf_counter() - t0)
    out["BENCHMARK_BUILD_STATIC_SBVH_MPRIMS_S"] = P / min(ts) / 1e6

    # python frontier builder (reference point)
    if P <= 20000:
        t0 = time.perf_counter()
        build_sah(lo, hi, BuildSettings(), backend="python")
        out["BENCHMARK_BUILD_PY_SAH_MPRIMS_S"] = (
            P / (time.perf_counter() - t0) / 1e6)

    # dynamic create: the morton build on the device (steady state)
    tlo = torch.from_numpy(lo).to(dev)
    thi = torch.from_numpy(hi).to(dev)
    out["BENCHMARK_BUILD_DYNAMIC_MORTON_MPRIMS_S"] = (
        P / best(lambda: build_morton(tlo, thi)) / 1e6)

    # update/refit on the device
    dbvh = bvh.to_device(dev)
    sched = plan_refit(dbvh)
    lo2, hi2 = tlo * 1.01, thi * 1.01
    out["BENCHMARK_BUILD_REFIT_MPRIMS_S"] = (
        P / best(lambda: refit(dbvh, sched, lo2, hi2)) / 1e6)

    out["BENCHMARK_BUILD_NUM_PRIMS"] = P
    for k, v in out.items():
        print(f"{k} {v:.4g}")
    return out


if __name__ == "__main__":
    run(int(sys.argv[1]) if len(sys.argv) > 1 else 100_000,
        device=sys.argv[2] if len(sys.argv) > 2 else "cuda")
