"""Differentiable shading through the pathtracer's material zoo.

Counterpart of embree_tpu/diff/materials.py: `shade_hits` evaluates the
pathtracer's own `eval_brdf` (MATTE / OBJ phong / METAL Cook-Torrance
conductor / VELVET / METALLIC_PAINT lobes) at frozen hit selections,
with the MaterialTable itself as the differentiated parameter, so
`torch.autograd.grad` yields d(pixel)/d(kd, ks, ns, eta, k, roughness)
through the exact NEE shading path.

Traversal, hit selection and light selection are discrete (run under
`torch.no_grad()`); the radiance evaluated at the frozen configuration
is smooth in the material parameters. A field that the loss does not
read gets a zero gradient, as under `jax.grad`.
"""
from __future__ import annotations

import torch

from ..core.math import normalize
from ..core.rayhit import Rays
from ..render.materials import MaterialTable, eval_brdf
from ..scene.scene import CommittedScene, scene_intersect, scene_occluded

FLOAT_FIELDS = ("kd", "ks", "ns", "d", "eta", "k", "rough", "le")


def freeze_hits(cs: CommittedScene, rays: Rays, light_p,
                isa: str = "default"):
    """Trace once (no gradient) and freeze everything discrete: the hit
    selection, shading geometry, and the shadow predicate for one point
    light at `light_p`. Returns a dict of tensors on the scene's device.
    One closest-hit and one any-hit request, each through the kernel the
    main path's dispatch picks for them. A missed ray's shading point is
    its origin (t = 0; it is never lit): the JAX package puts it at
    t = inf, whose NaN directions turn every gradient NaN once a ray
    misses (0 * NaN through the `where` of `shade_hits`)."""
    with torch.no_grad():
        hits = scene_intersect(cs, rays, isa=isa)
        light_p = torch.as_tensor(light_p, dtype=torch.float32,
                                  device=rays.org.device)
        t = torch.where(hits.valid, hits.t, torch.zeros_like(hits.t))
        p_hit = rays.org + t[..., None] * rays.dir
        wi_l = light_p - p_hit
        dist = torch.linalg.norm(wi_l, dim=-1)
        wi = wi_l / dist[..., None].clamp_min(1e-12)
        sh = Rays(p_hit.contiguous(), wi.contiguous(),
                  torch.full_like(dist, 1e-3), dist * (1.0 - 1e-3))
        occ = scene_occluded(cs, sh, isa=isa)
        ns = normalize(hits.ng)
        # face_forward toward the viewer (pathtracer postIntersect semantics)
        wo = -rays.dir
        ns = torch.where(((wo * ns).sum(-1, keepdim=True) < 0), -ns, ns)
        return dict(valid=hits.valid, prim_id=hits.prim_id,
                    geom_id=hits.geom_id, ns=ns, wo=wo, wi=wi, dist=dist,
                    lit=hits.valid & ~occ)


def shade_hits(mt: MaterialTable, frozen, geom_mat, light_intensity):
    """Differentiable NEE radiance at the frozen hits:

        L = f(wo, wi) * cos(wi) * I / dist^2

    with `f*cos` from the pathtracer's eval_brdf over the full material
    table — every MaterialTable field that a lobe reads carries a
    gradient."""
    mid = geom_mat[frozen["geom_id"].clamp(0, geom_mat.shape[0] - 1).long()]
    f = eval_brdf(mt, mid, frozen["wo"], frozen["ns"], frozen["wi"])
    falloff = 1.0 / (frozen["dist"] ** 2).clamp_min(1e-8)
    li = torch.as_tensor(light_intensity, dtype=torch.float32,
                         device=f.device) * falloff[..., None]
    out = f * li
    return torch.where(frozen["lit"][..., None], out, torch.zeros_like(out))


def material_loss(mt: MaterialTable, frozen, geom_mat, light_intensity,
                  target=None):
    """Scalar loss over the shaded image — L2 to `target` when given,
    else plain sum (the finite-difference form)."""
    img = shade_hits(mt, frozen, geom_mat, light_intensity)
    if target is None:
        return img.sum()
    return ((img - target) ** 2).mean()


def _grads(loss_of, mt: MaterialTable, fields):
    """(loss, {field: d loss / d field}) with zeros for a field the loss
    does not read."""
    leaves = {f: getattr(mt, f).detach().requires_grad_(True)
              for f in fields}
    loss, aux = loss_of(mt._replace(**leaves))
    gs = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return aux, {f: (torch.zeros_like(leaves[f]) if g is None else g)
                 for f, g in zip(fields, gs)}


def path_grads(cscene, mt: MaterialTable, lights, geom_mat,
               cam_vx, cam_vy, cam_vz, cam_p, *, width, height,
               spp=16, max_path=3, n_lights=1, seed=0,
               fields=FLOAT_FIELDS, sampler=None):
    """Multi-bounce material gradients through the pathtracer's
    wavefront (render/tutorials/pathtracer.py::render_pt, the
    reference's renderPixelFunction loop, pathtracer_device.cpp:
    1442-1546): d(sum image)/d(material float fields), differentiating
    the throughput product Lw = prod_j w_j and the per-bounce NEE sums at
    the FROZEN path configuration. Freezing is structural: traversal
    runs on detached rays through kernels autograd does not enter, the
    sampled directions carry no material gradient a.e., and discrete
    lobe choices are `where`-selected. `sampler` is render_pt's (a fresh
    `TorchSampler(seed)` by default, so the image is render_pt's with
    the same seed bit for bit). Returns (image, {field: grad})."""
    from ..render.tutorials.pathtracer import render_pt

    def f(mt_):
        img = render_pt(cscene, mt_, lights, geom_mat, cam_vx, cam_vy,
                        cam_vz, cam_p, seed, width=width, height=height,
                        spp=spp, n_lights=n_lights, max_path=max_path,
                        sampler=sampler)
        return img.sum(), img.detach()

    return _grads(f, mt, fields)


def material_grads(mt: MaterialTable, frozen, geom_mat, light_intensity,
                   target=None):
    """d loss / d {float material fields} (dict keyed by field name; the
    int `type` field is non-differentiable structure)."""
    def f(mt_):
        return material_loss(mt_, frozen, geom_mat, light_intensity,
                             target), None

    return _grads(f, mt, FLOAT_FIELDS)[1]
