"""embree_tpu_torch/diff/hit.py against embree_tpu/diff/hit.py: the same
meshes, rays and hit selection through `jax.grad` of the reference and
through autograd of the port.

Tolerance: gradients 1e-5 of the largest entry of the reference gradient
(both sides are float32 and sum a few contributions per vertex in
another order; `index_add_` on the CPU is deterministic, on CUDA it sums
with atomics in a changing order, which the on-card smoke run holds to
its own tolerance). Finite differences: 2e-2 relative, as the JAX
package's own test."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import embree_tpu as et
import embree_tpu_torch as ett
from embree_tpu.diff import hit as ref_hit
from embree_tpu.scene.scene import scene_intersect as ref_scene_intersect
from embree_tpu_torch.diff import hit as port_hit
from embree_tpu_torch.verify.fixtures import triangle_sphere
from test_torch_build import reference_native  # noqa: F401,E402

CFG = "ignore_config_files=1"


def commit_both(verts, idx):
    rs = et.Scene(et.Device(CFG))
    rs.attach(et.TriangleMesh(verts, idx))
    ps = ett.Scene(ett.Device(CFG, device="cpu"))
    ps.attach(ett.TriangleMesh(verts, idx))
    return rs.commit(), ps.commit()


@pytest.fixture
def sphere(rng):
    """A sphere, rays, and the (equal) hit selection of both packages."""
    verts, idx = triangle_sphere((0, 0, 0), 1.5, 10)
    rcs, pcs = commit_both(verts, idx)
    n = 400
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    org = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    rrays = et.make_rays(org, d)
    prays = ett.make_rays(org, d, device="cpu")
    rsel = ref_scene_intersect(rcs, rrays, isa="xla")
    with torch.no_grad():
        psel = ett.scene_intersect(pcs, prays)
    assert np.asarray(rsel.valid).sum() >= 30
    np.testing.assert_array_equal(psel.gprim.numpy(), np.asarray(rsel.gprim))
    return dict(verts=verts, idx=idx, rcs=rcs, pcs=pcs, rrays=rrays,
                prays=prays, rsel=rsel, psel=psel)


def port_grad(loss_of_vertices, verts):
    v = torch.tensor(verts, requires_grad=True)
    loss = loss_of_vertices(v)
    loss.backward()
    return loss.item(), v.grad.numpy()


def assert_grad_close(got, want):
    scale = np.abs(want).max()
    assert scale > 0 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("with_tris", [False, True])
def test_hit_t_grad_matches_reference(sphere, with_tris):
    s = sphere
    idxd = jnp.asarray(s["idx"])
    rsel, psel = s["rsel"], s["psel"]

    def ref_loss(v):
        t = ref_hit.hit_t_grad(v, idxd, s["rrays"], rsel.gprim, rsel.valid,
                               rsel.t,
                               tris=s["rcs"].tris if with_tris else None)
        return jnp.sum(jnp.where(rsel.valid, t, 0.0))

    ref_l, ref_g = jax.value_and_grad(ref_loss)(jnp.asarray(s["verts"]))

    def port_loss(v):
        t = port_hit.hit_t_grad(v, torch.from_numpy(s["idx"]), s["prays"],
                                psel.gprim, psel.valid, psel.t,
                                tris=s["pcs"].tris if with_tris else None)
        # the forward is the kernel's own t on hits, tfar on misses
        assert torch.equal(t, torch.where(psel.valid, psel.t,
                                          s["prays"].tfar))
        return torch.where(psel.valid, t, torch.zeros_like(t)).sum()

    loss, g = port_grad(port_loss, s["verts"])
    np.testing.assert_allclose(loss, float(ref_l), rtol=1e-5)
    assert_grad_close(g, np.asarray(ref_g))
    # vertices that no hit touches get exactly zero
    touched = np.zeros(len(s["verts"]), bool)
    touched[s["idx"][psel.gprim.numpy()[psel.valid.numpy()]].ravel()] = True
    assert touched.any() and (~touched).any()
    assert not g[~touched].any() and g[touched].any()


def test_reeval_hit_verts_matches_reference_and_hit_t_grad(sphere):
    s = sphere
    idxd = jnp.asarray(s["idx"])
    rsel, psel = s["rsel"], s["psel"]

    def ref_loss(v):
        t, u, w = ref_hit.reeval_hit_verts(v, idxd, s["rrays"], rsel.gprim,
                                           rsel.valid)
        return jnp.sum(jnp.where(rsel.valid, t + 0.5 * u - 0.25 * w, 0.0))

    ref_g = jax.grad(ref_loss)(jnp.asarray(s["verts"]))
    tidx = torch.from_numpy(s["idx"])

    def port_loss(v):
        t, u, w = port_hit.reeval_hit_verts(v, tidx, s["prays"], psel.gprim,
                                            psel.valid)
        return torch.where(psel.valid, t + 0.5 * u - 0.25 * w,
                           torch.zeros_like(t)).sum()

    _, g = port_grad(port_loss, s["verts"])
    assert_grad_close(g, np.asarray(ref_g))
    # values: t, u, v of the re-evaluation against the reference's
    rt, ru, rv = ref_hit.reeval_hit_verts(jnp.asarray(s["verts"]), idxd,
                                          s["rrays"], rsel.gprim, rsel.valid)
    with torch.no_grad():
        pt, pu, pv = port_hit.reeval_hit_verts(
            torch.from_numpy(s["verts"]), tidx, s["prays"], psel.gprim,
            psel.valid)
    m = psel.valid.numpy()
    np.testing.assert_allclose(pt.numpy()[m], np.asarray(rt)[m], rtol=1e-5)
    np.testing.assert_allclose(pu.numpy(), np.asarray(ru), atol=1e-5)
    np.testing.assert_allclose(pv.numpy(), np.asarray(rv), atol=1e-5)
    np.testing.assert_array_equal(pt.numpy()[~m], np.asarray(rt)[~m])

    # the fused t-gradient equals autograd through the re-evaluation
    def t_only(v):
        t, _u, _w = port_hit.reeval_hit_verts(v, tidx, s["prays"],
                                              psel.gprim, psel.valid)
        return torch.where(psel.valid, t, torch.zeros_like(t)).sum()

    def fused(v):
        t = port_hit.hit_t_grad(v, tidx, s["prays"], psel.gprim, psel.valid,
                                psel.t)
        return torch.where(psel.valid, t, torch.zeros_like(t)).sum()

    _, g_re = port_grad(t_only, s["verts"])
    _, g_fu = port_grad(fused, s["verts"])
    assert_grad_close(g_fu, g_re)
    # spot finite differences on the 3 largest-gradient coordinates
    scale = np.abs(g_re).max()
    for j in np.argsort(np.abs(g_re).ravel())[-3:]:
        vi, ax = divmod(int(j), 3)
        e = np.zeros_like(s["verts"])
        e[vi, ax] = 1e-3
        with torch.no_grad():
            fd = (float(t_only(torch.from_numpy(s["verts"] + e)))
                  - float(t_only(torch.from_numpy(s["verts"] - e)))) / 2e-3
        np.testing.assert_allclose(g_fu[vi, ax], fd, rtol=5e-2,
                                   atol=1e-3 * scale)


def _quad_scene(verts):
    idx = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    return commit_both(verts, idx) + (idx,)


def test_reeval_hit_grad_matches_reference_and_finite_difference():
    verts0 = np.array([[-1, -1, 2.0], [1, -1, 2.2], [1, 1, 2.4],
                       [-1, 1, 2.1]], np.float32)
    rcs, pcs, idx = _quad_scene(verts0)
    rng = np.random.default_rng(7)
    n = 64
    d = np.concatenate([rng.uniform(-0.3, 0.3, (n, 2)),
                        np.ones((n, 1))], 1).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    org = np.zeros((n, 3), np.float32)
    rrays = et.make_rays(org, d)
    prays = ett.make_rays(org, d, device="cpu")

    def ref_loss(vparam):
        tris = rcs.tris._replace(v0=vparam[idx[:, 0]], v1=vparam[idx[:, 1]],
                                 v2=vparam[idx[:, 2]])
        sel = jax.lax.stop_gradient(
            ref_scene_intersect(rcs, rrays, isa="xla"))
        h = ref_hit.reeval_hit(tris, rrays, sel.gprim, sel.valid)
        return jnp.sum(jnp.where(h.valid, h.t + 0.3 * h.u + 0.2 * h.v, 0.0))

    ref_g = np.asarray(jax.grad(ref_loss)(jnp.asarray(verts0)))
    tidx = torch.from_numpy(idx).long()

    def port_loss(vparam):
        tris = pcs.tris._replace(v0=vparam[tidx[:, 0]], v1=vparam[tidx[:, 1]],
                                 v2=vparam[tidx[:, 2]])
        with torch.no_grad():
            sel = ett.scene_intersect(pcs, prays)
        h = port_hit.reeval_hit(tris, prays, sel.gprim, sel.valid)
        assert h.valid.all() and h.ng.shape == (n, 3)
        return torch.where(h.valid, h.t + 0.3 * h.u + 0.2 * h.v,
                           torch.zeros_like(h.t)).sum()

    loss, g = port_grad(port_loss, verts0)
    np.testing.assert_allclose(loss, float(ref_loss(jnp.asarray(verts0))),
                               rtol=1e-5)
    assert_grad_close(g, ref_g)
    # central differences of the same frozen-selection loss
    eps = 1e-3
    for vi in range(4):
        for k in range(3):
            vp = verts0.copy()
            vp[vi, k] += eps
            vm = verts0.copy()
            vm[vi, k] -= eps
            with torch.no_grad():
                fd = (float(port_loss(torch.from_numpy(vp)))
                      - float(port_loss(torch.from_numpy(vm)))) / (2 * eps)
            np.testing.assert_allclose(g[vi, k], fd, rtol=2e-2, atol=2e-3)


def test_grad_zero_for_missing_rays_and_intersect_diff():
    verts0 = np.array([[-1, -1, 2.0], [1, -1, 2.0], [1, 1, 2.0],
                       [-1, 1, 2.0]], np.float32)
    _rcs, pcs, idx = _quad_scene(verts0)
    tidx = torch.from_numpy(idx).long()
    # rays pointing away: no hits, the gradient must be exactly zero
    away = ett.make_rays(np.zeros((8, 3), np.float32),
                         np.tile(np.float32([0, 0, -1]), (8, 1)),
                         device="cpu")

    def loss(vparam, rays):
        tris = pcs.tris._replace(v0=vparam[tidx[:, 0]], v1=vparam[tidx[:, 1]],
                                 v2=vparam[tidx[:, 2]])
        h = port_hit.intersect_diff(pcs._replace(tris=tris), rays)
        return h, torch.where(h.valid, h.t, torch.zeros_like(h.t)).sum()

    v = torch.tensor(verts0, requires_grad=True)
    h, val = loss(v, away)
    val.backward()
    assert not h.valid.any() and val.item() == 0.0
    assert (v.grad == 0).all()
    # intersect_diff: traversal without gradient, re-evaluation with it
    toward = ett.make_rays(np.zeros((8, 3), np.float32),
                           np.tile(np.float32([0.1, 0.05, 1]), (8, 1)),
                           device="cpu")
    v = torch.tensor(verts0, requires_grad=True)
    h, val = loss(v, toward)
    val.backward()
    assert h.valid.all() and h.t.requires_grad
    np.testing.assert_allclose(h.t.detach().numpy(), 2.0, rtol=1e-6)
    # moving the plane along z by dz moves every t by dz: the z column of
    # the gradient sums to the number of rays
    np.testing.assert_allclose(v.grad[:, 2].sum().item(), 8.0, rtol=1e-5)
