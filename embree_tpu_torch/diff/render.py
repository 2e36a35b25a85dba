"""User-facing differentiable rendering: pixels -> cage vertices,
displacement parameters, and material parameters.

Counterpart of embree_tpu/diff/render.py. The commit-time tessellation
(subdiv/core.py refinement + limit projection + mesh-level displacement)
runs as torch ops, so one `torch.autograd.grad` flows from a pixel loss
back through shading -> hit re-evaluation (diff/hit.py) -> triangle soup
-> displaced limit surface -> control cage / displacement params /
material color. Hit *selection* stays discrete: `refresh_selection`
commits the soup as a real scene and traces it under `torch.no_grad()`
(the reference's REFIT-vs-rebuild split), through the main path's
kernels: B1 for a treelet scene under a request of at least
ROWTRACE_MIN_RAYS rays, B2 otherwise. The displacement is a torch
function (verts, normals, params) -> verts.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..core.device import Device
from ..core.rayhit import Rays
from ..scene.geometry import TriangleMesh
from ..scene.prims import TrianglePrims
from ..scene.scene import Scene, scene_intersect
from ..subdiv.cache import global_cache, plan_nbytes, topology_key
from ..subdiv.core import (apply_limit_stencil, evaluate_plan, limit_stencil,
                           plan_subdivision, plan_to, vertex_normals_torch)
from .hit import reeval_hit


def _device(device) -> Device:
    """A Device: `device` itself, the CUDA device for None, else a Device
    on the named torch device ("cpu")."""
    if isinstance(device, Device):
        return device
    return Device("ignore_config_files=1", device=device)


class DiffSubdivRenderer:
    """Differentiable renderer over one SubdivMesh.

    Build once (topology + ray set + frozen hit selection), then call
    `render(cage_verts, disp_params, kd)` under autograd. The frozen
    selection is refreshed with `refresh_selection()` after large
    parameter steps (the BVH refit analog). `device` is a Device or a
    torch device name; None means the CUDA device. `rays` lie on it."""

    def __init__(self, mesh, rays: Rays, level: int = 3,
                 displacement: Optional[Callable] = None,
                 light_dir=(1.0, -1.0, 1.0), isa: str = "default",
                 device=None):
        self.device = _device(device)
        dev = self.device.device
        self.mesh = mesh
        self.rays = rays
        self.displacement = displacement
        self.isa = isa
        ld = np.asarray(light_dir, np.float32)
        self.light_dir = torch.from_numpy(ld / np.linalg.norm(ld)).to(dev)

        nv = int(np.asarray(mesh.vertices).shape[0])
        key = topology_key(mesh.face_counts, mesh.face_indices, nv, level,
                           mesh.edge_creases, mesh.edge_crease_weights,
                           mesh.vertex_creases, mesh.vertex_crease_weights)
        plan = global_cache().get_or_build(
            ("plan", key),
            lambda: plan_subdivision(
                mesh.face_counts, mesh.face_indices, nv, level,
                edge_creases=mesh.edge_creases,
                edge_crease_weights=mesh.edge_crease_weights,
                vertex_creases=mesh.vertex_creases,
                vertex_crease_weights=mesh.vertex_crease_weights),
            plan_nbytes)
        rows, cols, w = limit_stencil(plan)
        # the stencils live on the device: a render uploads nothing
        self.plan = plan_to(plan, dev)
        self.stencil = (torch.from_numpy(rows).to(dev),
                        torch.from_numpy(cols).to(dev),
                        torch.from_numpy(w).to(dev))
        self.quads = torch.from_numpy(
            np.asarray(plan.final_quads, np.int64)).to(dev)
        self.level = level
        self.selection = None

    def _tensor(self, x):
        return torch.as_tensor(x, dtype=torch.float32,
                               device=self.device.device)

    # --- differentiable tessellation (the traced commit path) ----------
    def soup(self, cage_verts, disp_params=None) -> TrianglePrims:
        """cage -> refined -> limit -> displaced -> triangle soup, all
        torch ops (tessellate_mesh_to_triangles' differentiable twin,
        same prim order: [p0, p2] / [p1, p3] / [p3, p1])."""
        verts = evaluate_plan(self.plan, self._tensor(cage_verts))
        verts = apply_limit_stencil(self.stencil, verts)
        if self.displacement is not None:
            normals = vertex_normals_torch(verts, self.quads)
            verts = self.displacement(verts, normals, disp_params)
        q = self.quads
        p0, p1, p2, p3 = (verts.index_select(0, q[:, k]) for k in range(4))
        v0 = torch.cat([p0, p2])
        v1 = torch.cat([p1, p3])
        v2 = torch.cat([p3, p1])
        T = v0.shape[0]
        zeros = torch.zeros(T, dtype=torch.int32, device=v0.device)
        return TrianglePrims(v0, v1, v2, zeros,
                             torch.arange(T, dtype=torch.int32,
                                          device=v0.device), zeros)

    def refresh_selection(self, cage_verts, disp_params=None):
        """Commit a real scene at the current parameters on the
        renderer's device and freeze the per-ray winning primitive."""
        with torch.no_grad():
            tris = self.soup(cage_verts, disp_params)
            verts = torch.stack([tris.v0, tris.v1, tris.v2],
                                dim=1).reshape(-1, 3)
            scene = Scene(self.device)
            idx = np.arange(verts.shape[0], dtype=np.int32).reshape(-1, 3)
            scene.attach(TriangleMesh(verts, idx))
            cs = scene.commit()
            sel = scene_intersect(cs, self.rays, isa=self.isa)
        self.selection = (sel.gprim, sel.valid)
        return self.selection

    def render(self, cage_verts, disp_params=None, kd=(0.8, 0.8, 0.8)):
        """Differentiable image: lambert shading of the frozen hit
        selection re-evaluated against the traced soup."""
        if self.selection is None:
            raise RuntimeError("call refresh_selection() first")
        gprim, valid = self.selection
        tris = self.soup(cage_verts, disp_params)
        h = reeval_hit(tris, self.rays, gprim, valid)
        n = h.ng
        n = n / torch.linalg.norm(n, dim=-1, keepdim=True).clamp_min(1e-20)
        # two-sided lambert: |n . l|
        ndotl = (n * self.light_dir).sum(-1).abs()
        img = self._tensor(kd) * ndotl[..., None]
        return torch.where(valid[..., None], img, torch.zeros_like(img))

    def loss(self, cage_verts, disp_params=None, kd=(0.8, 0.8, 0.8),
             target=None):
        img = self.render(cage_verts, disp_params, kd)
        if target is None:
            return img.sum()
        return ((img - target) ** 2).mean()


def make_train_step(renderer: DiffSubdivRenderer, target, lr: float = 1e-2):
    """One SGD step over (cage_verts, disp_params, kd): `step(params)`
    returns (new params, the loss at `params`)."""

    def step(params):
        leaves = [renderer._tensor(p).detach().requires_grad_(True)
                  for p in params]
        loss = renderer.loss(*leaves, target=target)
        grads = torch.autograd.grad(loss, leaves)
        new = tuple((p - lr * g).detach() for p, g in zip(leaves, grads))
        return new, loss.detach()

    return step
