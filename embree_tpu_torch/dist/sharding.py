"""Data-parallel rays over a `torch.distributed` process group.

Counterpart of embree_tpu/dist/sharding.py. Rays are sharded over the
`dp` dimension of a one-dimensional `DeviceMesh`; the scene is
replicated: every rank commits it, or receives it, on its own device.
Each rank traverses its contiguous block of the padded ray batch (the
JAX package's `P(axis)` layout) and the gradients of a training step
are all-reduced over the mesh dimension's group.

Where the JAX package holds one global array sharded across devices,
each rank here holds its block: `shard_rays` cuts a rank's block out of
the global batch, `sharded_intersect` answers it, and `gather_hits`
all-gathers the blocks when a caller wants the global batch back.

Where collective and point-to-point buffers live is decided by the
group's backend, in one place (`buffer_device`): NCCL's on the rank's
compute device, gloo's on the host, since gloo does not send CUDA
tensors. Compute stays on the compute device either way; only the
buffers a collective reads and writes are staged.

`run_world` starts a world of N processes (spawned, with a `FileStore`
in a directory of its own) and runs a function on every rank: the
counterpart of the JAX package's in-process device mesh, used by the
tests and by `verify/scalebench.py`.
"""
from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
import traceback
from typing import Callable

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh
from torch.utils._pytree import tree_flatten, tree_unflatten

from ..core.rayhit import Hits, Rays
from ..scene.scene import CommittedScene, scene_intersect

WORLD_TIMEOUT_S = 600


def buffer_device(group, device) -> torch.device:
    """The device of the buffers a collective or point-to-point op of
    `group` reads and writes, for a rank that computes on `device`:
    `device` under NCCL, the host under any other backend (gloo)."""
    return (torch.device(device) if dist.get_backend(group) == "nccl"
            else torch.device("cpu"))


def make_mesh(n_devices: int | None = None, axis: str = "dp") -> DeviceMesh:
    """A one-dimensional mesh named `axis` over the first `n_devices`
    ranks (all of them by default) of the initialized default group.
    Every rank calls it; a rank outside the mesh gets one whose
    `get_coordinate()` is None. The mesh's device type is where its
    buffers live (`buffer_device`)."""
    world = dist.get_world_size()
    n = n_devices or world
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}")
    kind = buffer_device(None, "cuda").type
    return DeviceMesh(kind, torch.arange(n), mesh_dim_names=(axis,))


def pad_to_multiple(x: torch.Tensor, m: int, fill=0.0):
    """`x` padded along its first axis to a multiple of `m` with
    `fill`, and its unpadded length."""
    r = x.shape[0]
    rp = -(-r // m) * m
    if rp == r:
        return x, r
    pad = torch.full((rp - r,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x, pad]), r


def _block(mesh: DeviceMesh, axis: str, n: int) -> slice:
    """This rank's block of a padded batch of `n` rows."""
    size = mesh.size(mesh.mesh_dim_names.index(axis))
    k = mesh.get_local_rank(axis)
    b = n // size
    return slice(k * b, (k + 1) * b)


def shard_rays(rays: Rays, mesh: DeviceMesh, axis: str = "dp"):
    """Pad the flat ray batch to a multiple of the mesh size as the JAX
    package does (org 0, dir 1, tnear 0, tfar -inf: padded rays miss)
    and cut out this rank's contiguous block. Returns (the block's
    Rays, the unpadded ray count)."""
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    org, r = pad_to_multiple(rays.org.reshape(-1, 3), n)
    d, _ = pad_to_multiple(rays.dir.reshape(-1, 3), n, fill=1.0)
    tn, _ = pad_to_multiple(rays.tnear.reshape(-1), n)
    tf, _ = pad_to_multiple(rays.tfar.reshape(-1), n, fill=-torch.inf)
    s = _block(mesh, axis, tn.shape[0])
    return Rays(*(a[s].contiguous() for a in (org, d, tn, tf))), r


def sharded_intersect(cs: CommittedScene, rays: Rays, mesh: DeviceMesh,
                      axis: str = "dp", isa: str = "default") -> Hits:
    """DP intersect: this rank's block of rays (`shard_rays`) against its
    replicated committed scene, through the scene's own dispatch (the
    reference's tile parallel_for, across ranks). Needs no collective."""
    return scene_intersect(cs, rays, isa=isa)


def gather_hits(h: Hits, mesh: DeviceMesh, axis: str = "dp") -> Hits:
    """All-gather every rank's block of hits into the global (padded)
    batch, on the device the blocks lie on."""
    group = mesh.get_group(axis)
    dev = h.t.device
    buf = buffer_device(group, dev)
    out = []
    for x in h:
        x = x.contiguous().to(buf)
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        out.append(torch.cat(parts).to(dev))
    return Hits(*out)


def all_reduce_grads(grads, mesh: DeviceMesh, axis: str = "dp"):
    """Sum a pytree of tensors over the mesh dimension's group in one
    collective (the leaves are flattened into one buffer)."""
    leaves, spec = tree_flatten(grads)
    if not leaves:
        return grads
    group = mesh.get_group(axis)
    dev = leaves[0].device
    flat = torch.cat([g.reshape(-1).to(torch.float32) for g in leaves])
    flat = flat.to(buffer_device(group, dev))
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat = flat.to(dev)
    out, o = [], 0
    for g in leaves:
        out.append(flat[o:o + g.numel()].reshape(g.shape).to(g.dtype))
        o += g.numel()
    return tree_unflatten(out, spec)


def make_sharded_train_step(mesh: DeviceMesh, loss_fn: Callable,
                            axis: str = "dp"):
    """A training step over rays and targets sharded on `axis` and
    parameters replicated on every rank.

    `loss_fn(params, rays, target)` gives this rank's local loss; its
    gradient comes from autograd, the loss and the gradient are
    all-reduced, and every rank applies the same update `p - lr * g`.
    The returned `step(params, rays, target, lr=1e-3)` gives
    (global loss, new params); `params` is a tensor or a pytree of
    tensors, and the new ones carry no graph."""

    def step(params, rays: Rays, target, lr=1e-3):
        leaves, spec = tree_flatten(params)
        leaves = [p.detach().requires_grad_(True) for p in leaves]
        loss = loss_fn(tree_unflatten(leaves, spec), rays, target)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        loss, *grads = all_reduce_grads([loss.detach()] + grads, mesh, axis)
        new = [(p - lr * g).detach() for p, g in zip(leaves, grads)]
        return loss, tree_unflatten(new, spec)

    return step


def _rank_main(fn, rank, world, backend, workdir, args):
    """A spawned rank: join the world through the FileStore, run
    `fn(rank, world, *args)`, write its result (or its traceback) under
    `workdir`."""
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        store = dist.FileStore(os.path.join(workdir, "store"), world)
        dist.init_process_group(
            backend, store=store, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=WORLD_TIMEOUT_S))
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        with open(os.path.join(workdir, f"result_{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        with open(os.path.join(workdir, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_world(fn, world_size: int, *args, backend: str = "gloo",
              workdir: str | None = None):
    """Run `fn(rank, world_size, *args)` on a world of `world_size`
    spawned processes joined through a `FileStore` in a fresh directory
    (under `workdir`, else under the system's temporary directory), the
    default group initialized with `backend`. `fn` must be importable by
    the children (a module-level function) and return picklable values
    (numpy arrays, CPU tensors, numbers). Returns the list of the ranks'
    results. If a rank fails or the world outlives WORLD_TIMEOUT_S,
    every rank still running is ended and RuntimeError carries the
    failed ranks' tracebacks."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world_size, backend, tmp, args))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + WORLD_TIMEOUT_S
        try:
            while any(p.is_alive() for p in procs):
                if (any(p.exitcode not in (None, 0) for p in procs)
                        or time.monotonic() > deadline):
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join()
        errors = []
        for r, p in enumerate(procs):
            path = os.path.join(tmp, f"error_{r}.txt")
            if os.path.exists(path):
                with open(path) as f:
                    errors.append(f"rank {r}:\n{f.read()}")
            elif p.exitcode != 0:
                errors.append(f"rank {r}: exit code {p.exitcode}")
        if errors:
            raise RuntimeError("a rank of the world failed:\n"
                               + "\n".join(errors))
        out = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"result_{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
