"""The port's differentiable rendering (embree_tpu_torch/diff/render.py,
the torch stencils of subdiv/core.py) against the JAX package's.

The stencils and the vertex normals forward and through their VJPs
(`jax.vjp` against `torch.autograd.grad`) on the cube at levels 1-3,
the renderer's triangle soup against the JAX `soup` run eagerly, the
gradients against tests/golden/grad_subdiv_cube.npz (only read here),
and the port's forms of the finite-difference gates and the train step
of tests/test_diff_render.py at its tolerances. One renderer on the CPU
(level 3, 512 rays, its selection committed once) serves the module."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import embree_tpu as et
import embree_tpu_torch as ett
from embree_tpu.diff.render import DiffSubdivRenderer as JRenderer
from embree_tpu.subdiv import core as jcore
from embree_tpu_torch.diff.render import DiffSubdivRenderer, make_train_step
from embree_tpu_torch.subdiv import core as tcore

GOLD = os.path.join(os.path.dirname(__file__), "golden",
                    "grad_subdiv_cube.npz")
AMP = 0.08
KD = (0.8, 0.5, 0.3)


def _cube(pkg):
    verts = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                      for z in (-1, 1)], np.float32)
    quads = np.array([[0, 1, 3, 2], [4, 6, 7, 5], [0, 4, 5, 1],
                      [2, 3, 7, 6], [0, 2, 6, 4], [1, 5, 7, 3]])
    return pkg.SubdivMesh(verts, np.full(6, 4), quads.reshape(-1))


def _rays_np(n=512):
    """tests/test_diff_render.py's rays, from its seed."""
    rng = np.random.default_rng(0xD1FF)
    org = np.zeros((n, 3), np.float32)
    org[:, 2] = -4.0
    org[:, 0] = rng.uniform(-1.5, 1.5, n)
    org[:, 1] = rng.uniform(-1.5, 1.5, n)
    d = np.zeros((n, 3), np.float32)
    d[:, 2] = 1.0
    return org, d


def _displacement(verts, normals, amp):
    ph = torch.sin(3.0 * verts[:, 0]) * torch.cos(2.0 * verts[:, 1])
    return verts + amp * ph[:, None] * normals


def _jdisplacement(verts, normals, amp):
    ph = jnp.sin(3.0 * verts[:, 0]) * jnp.cos(2.0 * verts[:, 1])
    return verts + amp * ph[:, None] * normals


def _t(x):
    return torch.tensor(np.asarray(x, np.float32))


def _close(a, b, rel=1e-6):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape
    err = np.abs(a - b).max()
    assert err <= rel * np.abs(b).max(), (err, np.abs(b).max())


@pytest.fixture(scope="module")
def renderer():
    org, d = _rays_np()
    r = DiffSubdivRenderer(_cube(ett), ett.make_rays(org, d, device="cpu"),
                           level=3, displacement=_displacement,
                           device="cpu")
    r.refresh_selection(r.mesh.vertices, torch.tensor(AMP))
    return r


def test_stencils_and_normals_match_jax_forward_and_vjp():
    """evaluate_plan, apply_limit_stencil and the vertex normals: values
    and VJPs against the JAX functions' at 1e-6 of the largest entry."""
    mesh = _cube(et)
    rng = np.random.default_rng(3)
    cage = np.asarray(mesh.vertices, np.float32)
    for level in (1, 2, 3):
        jplan = jcore.plan_subdivision(mesh.face_counts, mesh.face_indices,
                                       8, level)
        tplan = tcore.plan_subdivision(mesh.face_counts, mesh.face_indices,
                                       8, level)
        stencil = tcore.limit_stencil(tplan)
        quads = tplan.final_quads
        stages = (
            (lambda v: jcore.evaluate_plan(jplan, v, use_jax=True),
             lambda v: tcore.evaluate_plan(tplan, v)),
            (lambda v: jcore.apply_limit_stencil(jcore.limit_stencil(jplan),
                                                 v),
             lambda v: tcore.apply_limit_stencil(stencil, v)),
            (lambda v: jcore.vertex_normals_jnp(v, quads),
             lambda v: tcore.vertex_normals_torch(v, quads)))
        x = cage
        for jf, tf in stages:
            out_j, vjp = jax.vjp(jf, jnp.asarray(x))
            ct = rng.normal(size=out_j.shape).astype(np.float32)
            (g_j,) = vjp(jnp.asarray(ct))
            xt = _t(x).requires_grad_(True)
            out_t = tf(xt)
            (g_t,) = torch.autograd.grad(out_t, xt, _t(ct))
            _close(out_t.detach().numpy(), out_j)
            _close(g_t.numpy(), g_j)
            x = np.asarray(out_j)
        # the numpy forms of the port are the host tessellation's
        np.testing.assert_array_equal(
            tcore.evaluate_plan(tplan, cage),
            jcore.evaluate_plan(jplan, cage))


def test_soup_matches_jax(renderer):
    """The renderer's triangle soup (refine, limit, normals, displace,
    split) against the JAX renderer's run eagerly."""
    org, d = _rays_np()
    jr = JRenderer(_cube(et), et.make_rays(org, d), level=3,
                   displacement=_jdisplacement, isa="xla")
    cage = np.asarray(renderer.mesh.vertices, np.float32)
    js = jr.soup(jnp.asarray(cage), jnp.float32(AMP))
    ts = renderer.soup(cage, torch.tensor(AMP))
    for a, b in zip(ts, js):
        if a.is_floating_point():
            _close(a.numpy(), b)
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the frozen selection hits the cube from the front
    gprim, valid = renderer.selection
    assert 0.2 < float(valid.float().mean()) < 0.5
    assert (gprim[valid] >= 0).all()


def test_golden_gradients(renderer):
    """tests/test_diff_render.py's golden gate on the port: gradients of
    the summed image w.r.t. cage, amplitude and kd."""
    ref = np.load(GOLD)
    cage = _t(renderer.mesh.vertices).requires_grad_(True)
    amp = torch.tensor(AMP, requires_grad=True)
    kd = _t(KD).requires_grad_(True)
    gc, ga, gk = torch.autograd.grad(renderer.loss(cage, amp, kd=kd),
                                     (cage, amp, kd))
    np.testing.assert_allclose(gc.numpy(), ref["cage"], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(ga.numpy(), ref["amp"], rtol=1e-4)
    np.testing.assert_allclose(gk.numpy(), ref["kd"], rtol=1e-4)


def test_finite_difference_gates(renderer):
    """The three finite-difference gates of tests/test_diff_render.py
    (amplitude, kd, cage vertices) at their tolerances, on the port."""
    cage0 = _t(renderer.mesh.vertices)
    amp0 = torch.tensor(AMP)

    # displacement amplitude
    a = amp0.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(renderer.loss(cage0, a), a)
    h = 1e-3
    with torch.no_grad():
        fd = (renderer.loss(cage0, amp0 + h)
              - renderer.loss(cage0, amp0 - h)) / (2 * h)
    assert np.isfinite(float(g)) and abs(float(g)) > 1e-4
    np.testing.assert_allclose(float(g), float(fd), rtol=2e-2)

    # material kd against a zero target
    with torch.no_grad():
        tgt = torch.zeros_like(renderer.render(cage0, amp0))

    def f_kd(kd):
        return renderer.loss(cage0, amp0, kd=kd, target=tgt)

    kd0 = _t(KD)
    k = kd0.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(f_kd(k), k)
    g = g.numpy()
    with torch.no_grad():
        for c in range(3):
            e = torch.zeros(3)
            e[c] = 1e-3
            fd = (float(f_kd(kd0 + e)) - float(f_kd(kd0 - e))) / 2e-3
            np.testing.assert_allclose(g[c], fd, rtol=2e-2, atol=1e-6)
    assert np.abs(g).max() > 1e-5

    # control-cage vertices, through refinement + limit + displacement
    c = cage0.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(renderer.loss(c, amp0), c)
    g = g.numpy()
    assert np.isfinite(g).all() and np.abs(g).max() > 1e-4
    rng = np.random.default_rng(7)
    with torch.no_grad():
        for _ in range(3):
            i = rng.integers(0, cage0.shape[0])
            j = rng.integers(0, 3)
            dp = torch.zeros_like(cage0)
            dp[i, j] = 2e-3
            fd = (float(renderer.loss(cage0 + dp, amp0))
                  - float(renderer.loss(cage0 - dp, amp0))) / 4e-3
            np.testing.assert_allclose(g[i, j], fd, rtol=5e-2, atol=1e-3)


def test_train_step_descends(renderer):
    """make_train_step: a few SGD steps reduce an image-matching loss."""
    cage = _t(renderer.mesh.vertices)
    with torch.no_grad():
        target = renderer.render(cage, torch.tensor(0.12),
                                 kd=(0.6, 0.6, 0.6))
    step = make_train_step(renderer, target, lr=5e-3)
    params, l0 = step((cage, torch.tensor(AMP), _t(KD)))
    for _ in range(4):
        params, l1 = step(params)
    assert float(l1) < float(l0)
    assert all(not p.requires_grad for p in params)
