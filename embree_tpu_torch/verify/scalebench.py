"""scalebench: multi-rank scaling measurement.

Counterpart of embree_tpu/verify/scalebench.py. Measures rays/s of the
data-parallel intersect (dist/sharding.py) over meshes of the first 1,
2, 4, ... ranks of the world and reports the scaling efficiency, under
the JAX package's keys BENCHMARK_SCALE_{n}DEV_MRAYPS / _EFF. A
measurement is the wall time, on rank 0's host clock, from a barrier of
the mesh's ranks to the barrier after the last of `reps` requests.

Ranks that share one card (several processes on `cuda:0` under gloo, or
ranks on the CPU) measure how the program behaves, not hardware scaling:
they divide one device between them, as the JAX package's virtual CPU
mesh does. Only ranks on cards of their own measure scaling.

`measure` runs on every rank of an initialized world; `run` starts a
world of `world_size` ranks when none is initialized (`run_world`): with
NCCL where every rank has a card of its own, else with gloo.

Run: python -m embree_tpu_torch.verify.scalebench [num_rays] [world] [cpu]
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch
import torch.distributed as dist

SIZES = (1, 2, 4, 8, 16, 32)


def _rank_device(device, rank: int) -> torch.device:
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device=\"cpu\"")
    return torch.device("cuda", rank % torch.cuda.device_count())


def measure(n_rays: int = 262144, reps: int = 5, device=None) -> dict:
    """Every rank of the initialized world calls this; each returns the
    keys (rank 0 prints them). `device` is this rank's compute device,
    by default the CUDA card rank % device_count."""
    import embree_tpu_torch as ett
    from ..dist.sharding import make_mesh, shard_rays, sharded_intersect
    from .fixtures import triangle_sphere

    rank, world = dist.get_rank(), dist.get_world_size()
    dev = _rank_device(device, rank)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    rng = np.random.default_rng(7)
    verts, idx = triangle_sphere((0, 0, 0), 1.0, 40)
    scene = ett.Scene(ett.Device("ignore_config_files=1", device=dev))
    scene.attach(ett.TriangleMesh(verts, idx))
    cs = scene.commit()

    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    org = rng.uniform(-3, 3, (n_rays, 3)).astype(np.float32)
    rays = ett.make_rays(org, d, device=dev)

    out = {}
    base = None
    for n in (s for s in SIZES if s <= world):
        mesh = make_mesh(n)
        if mesh.get_coordinate() is not None:
            group = mesh.get_group("dp")
            srays, _r = shard_rays(rays, mesh)
            sharded_intersect(cs, srays, mesh)
            sync()
            dist.barrier(group=group)
            t0 = time.perf_counter()
            for _ in range(reps):
                sharded_intersect(cs, srays, mesh)
            sync()
            dist.barrier(group=group)
            dt = (time.perf_counter() - t0) / reps
            mrayps = n_rays / dt / 1e6
            if base is None:
                base = mrayps
            out[f"BENCHMARK_SCALE_{n}DEV_MRAYPS"] = mrayps
            out[f"BENCHMARK_SCALE_{n}DEV_EFF"] = mrayps / (base * n)
        dist.barrier()
    if rank == 0:
        for k, v in out.items():
            print(f"{k} {v:.4g}")
    return out


def _rank(rank, world, n_rays, reps, device):
    return measure(n_rays, reps, device)


def run(n_rays: int = 262144, reps: int = 5, world_size: int | None = None,
        device=None) -> dict:
    """Rank 0's keys. Inside an initialized world every rank calls it;
    otherwise it starts a world of `world_size` ranks (by default one a
    CUDA card) and returns rank 0's keys."""
    if dist.is_initialized():
        return measure(n_rays, reps, device)
    from ..dist.sharding import run_world

    cpu = device is not None and torch.device(device).type == "cpu"
    cards = 0 if cpu else torch.cuda.device_count()
    if not cpu and cards == 0:
        raise RuntimeError("no CUDA device is available; pass device=\"cpu\"")
    world = world_size or max(cards, 1)
    backend = "nccl" if not cpu and world <= cards else "gloo"
    return run_world(_rank, world, n_rays, reps, device,
                     backend=backend)[0]


if __name__ == "__main__":
    run(int(sys.argv[1]) if len(sys.argv) > 1 else 262144,
        world_size=int(sys.argv[2]) if len(sys.argv) > 2 else None,
        device=sys.argv[3] if len(sys.argv) > 3 else None)
