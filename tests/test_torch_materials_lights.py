"""The port's materials and lights (embree_tpu_torch/render/materials.py,
lights.py) against the JAX package's.

Every function after the material table, and `sample_light` for the four
light kinds, on the same seeded inputs: the port's sampling functions
take the uniforms that the JAX function draws from the same key (rtol
1e-5, atol 1e-6). Then the port's forms of tests/test_glass.py:47-195
(Snell and Fresnel, TIR, the medium round trip, the eta gradient through
a refracted chain against central differences and against `jax.grad`,
the hair lobes) and of tests/test_pathtracer.py:42-110,174-230 (light
sampling, material energy, the material zoo)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from embree_tpu.render import lights as jl
from embree_tpu.render import materials as jm
from embree_tpu_torch.render import lights as tl
from embree_tpu_torch.render import materials as tm

RTOL, ATOL = 1e-5, 1e-6
N = 512

# one material of every type, each lobe's parameters away from defaults
ZOO = [
    {"type": tm.MAT_MATTE, "kd": (0.8, 0.4, 0.2)},
    {"type": tm.MAT_OBJ, "kd": (0.5, 0.3, 0.2), "ks": (0.3, 0.3, 0.4),
     "ns": 20.0},
    {"type": tm.MAT_MIRROR, "ks": (0.9, 0.8, 0.7)},
    {"type": tm.MAT_DIELECTRIC, "eta": 1.45},
    {"type": tm.MAT_EMITTER, "le": (4.0, 3.0, 2.0)},
    {"type": tm.MAT_METAL, "ks": (0.9, 0.8, 0.7), "eta": 1.4, "k": 3.0,
     "roughness": 0.1},
    {"type": tm.MAT_REFLECTIVE_METAL, "ks": (0.95, 0.9, 0.8), "eta": 1.4,
     "k": 3.0},
    {"type": tm.MAT_VELVET, "kd": (0.6, 0.1, 0.1), "ks": (0.3, 0.2, 0.2),
     "ns": 4.0, "roughness": 0.5},
    {"type": tm.MAT_METALLIC_PAINT, "kd": (0.1, 0.3, 0.8), "eta": 1.5},
    {"type": tm.MAT_DIELECTRIC_SOLID, "eta": 1.5, "eta_outside": 1.1,
     "transmission": (0.9, 0.8, 0.7)},
    {"type": tm.MAT_HAIR, "ks": (0.8, 0.6, 0.4), "kd": (0.1, 0.2, 0.3),
     "ns": 20.0, "roughness": 2.0},
]


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL,
                               err_msg=what)


def _unit(rng, n, up=None):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    if up is not None:
        v[:, 2] = np.abs(v[:, 2]) + up
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _jax_uniforms(key, shape, k):
    """The uniforms a JAX sampling function draws from `key`: `split` into
    k keys, one `uniform(key_i, shape)` each, stacked on a last axis."""
    return np.stack([np.asarray(jax.random.uniform(ki, shape))
                     for ki in jax.random.split(key, k)], -1)


def _inputs(rng):
    mid = np.arange(N, dtype=np.int32) % len(ZOO)
    n = _unit(rng, N)
    wo = _unit(rng, N)
    wo = np.where((wo * n).sum(1, keepdims=True) < -0.2, -wo, wo)
    wi = _unit(rng, N)
    tx = _unit(rng, N)
    tx = tx - (tx * n).sum(1, keepdims=True) * n
    tx /= np.linalg.norm(tx, axis=1, keepdims=True)
    ty = np.cross(n, tx).astype(np.float32)
    return mid, n, wo.astype(np.float32), wi, tx.astype(np.float32), ty


def test_material_functions_match_the_jax_package():
    rng = np.random.default_rng(0x3A7)
    jt, tt = jm.make_material_table(ZOO), tm.make_material_table(
        ZOO, device="cpu")
    for a, b in zip(jt, tt):
        assert np.asarray(a).tobytes() == b.numpy().tobytes()
    mid, n, wo, wi, tx, ty = _inputs(rng)
    cos = rng.uniform(-1, 1, N).astype(np.float32)
    eta = rng.uniform(1.0, 2.5, N).astype(np.float32)
    k = rng.uniform(0.0, 4.0, N).astype(np.float32)
    _close(tm.fresnel_conductor(_t(cos), _t(eta), _t(k)),
           jm.fresnel_conductor(cos, eta, k), "fresnel_conductor")
    _close(tm.fresnel_dielectric_schlick(_t(cos), _t(eta)),
           jm.fresnel_dielectric_schlick(cos, eta), "schlick")
    ct = np.abs(cos[::-1]).copy()
    _close(tm.fresnel_dielectric_exact(_t(np.abs(cos)), _t(ct), _t(eta)),
           jm.fresnel_dielectric_exact(np.abs(cos), ct, eta), "exact")
    for a, b in zip(tm._ortho_basis(_t(n)), jm._ortho_basis(n)):
        _close(a, b, "_ortho_basis")
    u = rng.random((N, 2), dtype=np.float32)
    for a, b in zip(tm.cosine_sample(_t(n), _t(u[:, 0]), _t(u[:, 1])),
                    jm.cosine_sample(n, u[:, 0], u[:, 1])):
        _close(a, b, "cosine_sample")
    _close(tm.reflect(_t(wo), _t(n)), jm.reflect(wo, n), "reflect")

    # eval_brdf: every lobe; hair with the default frame and with its own
    # tangents and geometric normal
    ev = jax.jit(jm.eval_brdf)
    for kw in ({}, {"tan_x": tx, "tan_y": ty, "ng_geo": n}):
        got = tm.eval_brdf(tt, _t(mid), _t(wo), _t(n), _t(wi),
                           **{k: _t(v) for k, v in kw.items()})
        _close(got, ev(jt, mid, wo, n, wi, **kw), f"eval_brdf {list(kw)}")
        assert (got[mid == tm.MAT_MIRROR] == 0).all()

    # sample_bsdf and sample_bsdf_medium with the JAX key's uniforms; the
    # solid dielectric from outside and from inside its medium
    sb = jax.jit(jm.sample_bsdf)
    sm = jax.jit(jm.sample_bsdf_medium)
    inside = rng.random(N) < 0.5
    med_eta = np.where(inside, 1.5, 1.1).astype(np.float32)
    med_trans = np.where(inside[:, None], np.float32([0.9, 0.8, 0.7]),
                         np.float32(1.0)).astype(np.float32)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        u = _jax_uniforms(key, (N,), 3)
        for a, b in zip(tm.sample_bsdf(tt, _t(mid), _t(wo), _t(n), _t(u)),
                        sb(jt, mid, wo, n, key)):
            _close(a, b, "sample_bsdf")
        for kw in ({}, {"tan_x": tx, "tan_y": ty, "ng_geo": n}):
            got = tm.sample_bsdf_medium(
                tt, _t(mid), _t(wo), _t(n), _t(u), _t(med_eta),
                _t(med_trans), **{k: _t(v) for k, v in kw.items()})
            want = sm(jt, mid, wo, n, key, med_eta, med_trans, **kw)
            for name, a, b in zip(("wi", "w", "delta", "eta", "trans"),
                                  got, want):
                _close(a, b, f"sample_bsdf_medium {name} {list(kw)}")


def test_lights_match_the_jax_package():
    """make_light_table and sample_light for point, spot, directional and
    quad lights; the quad light's uv are the uniforms its JAX key gives."""
    spec = [
        {"type": tl.LIGHT_POINT, "pos": (0, 2, 0), "radiance": (4, 4, 4)},
        {"type": tl.LIGHT_SPOT, "pos": (1, 3, 0), "dir": (-0.3, -1, 0.1),
         "radiance": (9, 8, 7), "cos_angles": (0.95, 0.7)},
        {"type": tl.LIGHT_DIRECTIONAL, "dir": (0.2, -1, 0.3),
         "radiance": (1, 2, 3)},
        {"type": tl.LIGHT_QUAD, "pos": (-0.5, 3, -0.5), "e1": (1, 0, 0.2),
         "e2": (0, 0.1, 1), "radiance": (5, 6, 7)},
    ]
    jt = jl.make_light_table(spec, ambient=(0.1, 0.2, 0.3))
    tt = tl.make_light_table(spec, ambient=(0.1, 0.2, 0.3), device="cpu")
    assert tt.type == jt.type and tl.num_lights(tt) == jl.num_lights(jt) == 4
    for name in ("pos", "e1", "e2", "radiance", "angles", "ambient"):
        assert (getattr(tt, name).numpy().tobytes()
                == np.asarray(getattr(jt, name)).tobytes()), name
    rng = np.random.default_rng(0x11)
    p = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    for li in range(4):
        key = jax.random.PRNGKey(10 + li)
        uv = _jax_uniforms(key, (N,), 2)
        got = tl.sample_light(tt, li, _t(p), _t(uv))
        want = jl.sample_light(jt, li, p, key)
        for name, a, b in zip(("wi", "dist", "w"), got, want):
            _close(a, b, f"light {li} {name}")


def _glass(eta=1.5, trans=(1.0, 1.0, 1.0)):
    return tm.make_material_table([
        {"type": tm.MAT_DIELECTRIC_SOLID, "eta": eta, "eta_outside": 1.0,
         "transmission": trans, "transmission_outside": (1, 1, 1)}],
        device="cpu")


def _sample_one(mt, wo, n, u3, med_eta, med_trans):
    """One dielectric sample with the lobe uniform u3."""
    u = torch.tensor([[0.5, 0.5, u3]])
    return tm.sample_bsdf_medium(mt, torch.zeros(1, dtype=torch.int32), wo,
                                 n, u, med_eta, med_trans)


def test_dielectric_and_hair_forms():
    """tests/test_glass.py:47-125,164-195: reflection and Snell
    transmission with the medium pushed, TIR from inside, the medium
    round trip through parallel interfaces, and the hair lobes coloured
    by Kr on the reflection side and by Kt on the other, never delta."""
    mt = _glass()
    n = torch.tensor([[0.0, 0.0, 1.0]])
    wo = torch.tensor([[np.sin(0.4), 0.0, np.cos(0.4)]], dtype=torch.float32)
    vac_e, vac_t = torch.ones(1), torch.ones((1, 3))
    seen = set()
    for u3 in np.linspace(0.0, 0.999, 40):
        wi, w, delta, me, _mt = _sample_one(mt, wo, n, float(u3), vac_e,
                                            vac_t)
        wi = wi[0].numpy()
        assert bool(delta[0])
        if wi[2] > 0:
            seen.add("reflect")
            np.testing.assert_allclose(wi, [-np.sin(0.4), 0, np.cos(0.4)],
                                       atol=1e-6)
            assert float(me[0]) == 1.0
        else:
            seen.add("transmit")
            np.testing.assert_allclose(np.linalg.norm(wi[:2]),
                                       np.sin(0.4) / 1.5, atol=1e-6)
            assert abs(float(me[0]) - 1.5) < 1e-6
    assert seen == {"reflect", "transmit"}

    # total internal reflection from inside, beyond the critical angle
    wo_tir = torch.tensor([[np.sin(0.9), 0.0, np.cos(0.9)]],
                          dtype=torch.float32)
    for u3 in np.linspace(0.0, 0.999, 10):
        wi, w, _d, me, _mt = _sample_one(mt, wo_tir, n, float(u3),
                                         torch.full((1,), 1.5),
                                         torch.ones((1, 3)))
        assert float(wi[0, 2]) > 0 and abs(float(me[0]) - 1.5) < 1e-6
        np.testing.assert_allclose(float(w[0, 0]), 1.0, rtol=1e-5)

    # enter and leave through parallel interfaces: vacuum again
    mt = _glass(trans=(0.9, 0.8, 0.7))
    down = torch.tensor([[0.0, 0.0, 1.0]])
    wi, _w, _d, e2, t2 = _sample_one(mt, down, n, 0.999, vac_e, vac_t)
    assert float(wi[0, 2]) < 0 and abs(float(e2[0]) - 1.5) < 1e-6
    np.testing.assert_allclose(t2[0].numpy(), [0.9, 0.8, 0.7], rtol=1e-6)
    wi, _w, _d, e3, t3 = _sample_one(mt, down, n, 0.999, e2, t2)
    assert float(wi[0, 2]) < 0 and abs(float(e3[0]) - 1.0) < 1e-6
    np.testing.assert_allclose(t3[0].numpy(), [1.0, 1.0, 1.0], rtol=1e-6)

    hair = tm.make_material_table([
        {"type": tm.MAT_HAIR, "ks": (0.8, 0.6, 0.4), "kd": (0.1, 0.2, 0.3),
         "ns": 20.0, "roughness": 2.0}], device="cpu")
    mid = torch.zeros(1, dtype=torch.int32)
    frame = dict(tan_x=torch.tensor([[1.0, 0.0, 0.0]]),
                 tan_y=torch.tensor([[0.0, 1.0, 0.0]]), ng_geo=n)
    wo = torch.tensor([[np.sin(0.7), 0.0, np.cos(0.7)]], dtype=torch.float32)
    rng = np.random.default_rng(40)
    sides = set()
    for _ in range(40):
        u = torch.from_numpy(rng.random((1, 3), dtype=np.float32))
        wi, w, delta, _e, _t2 = tm.sample_bsdf_medium(
            hair, mid, wo, n, u, vac_e, vac_t, **frame)
        assert not bool(delta[0]) and torch.isfinite(w).all()
        f = tm.eval_brdf(hair, mid, wo, n, wi, **frame)[0].numpy()
        r = f / max(f[0], 1e-12)
        if float(wi[0, 2]) > 0:
            sides.add("Kr")
            np.testing.assert_allclose(r, [1.0, 0.75, 0.5], rtol=1e-4)
        else:
            sides.add("Kt")
            np.testing.assert_allclose(r, [1.0, 2.0, 3.0], rtol=1e-4)
    assert sides == {"Kr", "Kt"}


def test_eta_gradient_through_a_refracted_chain():
    """tests/test_glass.py:128-161: d(pixel)/d(eta) through two
    transmitting interfaces, the keys chosen as the JAX test chooses
    them. torch.autograd against central differences (rtol 2e-3) and
    against jax.grad of the JAX package's chain (rtol 1e-4)."""
    n1 = np.float32([[0.0, 0.0, 1.0]])
    wo1 = np.float32([[np.sin(0.5), 0.0, np.cos(0.5)]])
    look = np.float32([[0.3, 0.5, -0.8]])

    def jchain(eta, k1, k2):
        mt = jm.make_material_table([
            {"type": jm.MAT_DIELECTRIC_SOLID, "eta": 1.5,
             "eta_outside": 1.0}])._replace(eta=jnp.asarray([eta]))
        mid = jnp.zeros((1,), jnp.int32)
        e, t = jnp.ones((1,)), jnp.ones((1, 3))
        wi1, w1, _d, e1, t1 = jm.sample_bsdf_medium(mt, mid, wo1, n1, k1, e,
                                                    t)
        wi2, w2, _d, _e, _t = jm.sample_bsdf_medium(mt, mid, -wi1, n1, k2,
                                                    e1, t1)
        return (jnp.sum(wi2 * look, -1) * jnp.mean(w1 * w2, -1))[0], wi1, wi2

    def tchain(eta, u1, u2):
        mt = tm.make_material_table([
            {"type": tm.MAT_DIELECTRIC_SOLID, "eta": 1.5,
             "eta_outside": 1.0}], device="cpu")._replace(eta=eta.reshape(1))
        mid = torch.zeros(1, dtype=torch.int32)
        e, t = torch.ones(1), torch.ones((1, 3))
        wi1, w1, _d, e1, t1 = tm.sample_bsdf_medium(
            mt, mid, _t(wo1), _t(n1), u1, e, t)
        wi2, w2, _d, _e, _t2 = tm.sample_bsdf_medium(
            mt, mid, -wi1, _t(n1), u2, e1, t1)
        return ((wi2 * _t(look)).sum(-1) * (w1 * w2).mean(-1))[0]

    for s in range(60):
        ka, kb = jax.random.split(jax.random.PRNGKey(s))
        _p, wi1, wi2 = jchain(1.5, ka, kb)
        if float(wi1[0, 2]) < 0 and float(wi2[0, 2]) < 0:
            break
    else:
        raise AssertionError("no key transmits at both interfaces")
    ua = _t(_jax_uniforms(ka, (1,), 3))
    ub = _t(_jax_uniforms(kb, (1,), 3))
    eta = torch.tensor(1.5, requires_grad=True)
    val = tchain(eta, ua, ub)
    np.testing.assert_allclose(float(val.detach()),
                               float(jchain(1.5, ka, kb)[0]), rtol=RTOL)
    (g,) = torch.autograd.grad(val, eta)
    g = float(g)
    h = 1e-3
    with torch.no_grad():
        fd = float((tchain(torch.tensor(1.5 + h), ua, ub)
                    - tchain(torch.tensor(1.5 - h), ua, ub)) / (2 * h))
    jg = float(jax.grad(lambda e: jchain(e, ka, kb)[0])(1.5))
    assert abs(g) > 1e-4
    np.testing.assert_allclose(g, fd, rtol=2e-3)
    np.testing.assert_allclose(g, jg, rtol=1e-4)


def test_light_sampling_energy_and_material_zoo():
    """tests/test_pathtracer.py:42-110,174-230 on the port: point,
    directional and quad light samples; cosine-sampled matte weights equal
    kd, the mirror reflects exactly; every material of the zoo evaluates
    and samples finite, non-negative, bounded weights, and delta lobes
    give no NEE term."""
    lt = tl.make_light_table([
        {"type": tl.LIGHT_POINT, "pos": (0, 2, 0), "radiance": (4, 4, 4)},
        {"type": tl.LIGHT_DIRECTIONAL, "dir": (0, -1, 0),
         "radiance": (1, 1, 1)},
        {"type": tl.LIGHT_QUAD, "pos": (-0.5, 3, -0.5), "e1": (1, 0, 0),
         "e2": (0, 0, 1), "radiance": (5, 5, 5)},
    ], device="cpu")
    p = torch.zeros((8, 3))
    uv = torch.from_numpy(np.random.default_rng(0).random((8, 2),
                                                          dtype=np.float32))
    wi, dist, w = tl.sample_light(lt, 0, p)
    np.testing.assert_allclose(wi[0].numpy(), [0, 1, 0], atol=1e-6)
    np.testing.assert_allclose(dist.numpy(), 2.0)
    np.testing.assert_allclose(w.numpy(), 1.0)
    wi, dist, w = tl.sample_light(lt, 1, p)
    np.testing.assert_allclose(wi[0].numpy(), [0, 1, 0], atol=1e-6)
    assert float(dist[0]) > 1e20
    wi, dist, w = tl.sample_light(lt, 2, p, uv)
    assert (wi[:, 1] > 0.9).all() and (w > 0).all()

    mt = tm.make_material_table([
        {"type": tm.MAT_MATTE, "kd": (0.8, 0.4, 0.2)},
        {"type": tm.MAT_MIRROR, "ks": (1.0, 1.0, 1.0)}], device="cpu")
    n = torch.tensor([[0.0, 0.0, 1.0]]).expand(64, 3)
    wo = torch.tensor([[0.0, 0.6, 0.8]]).expand(64, 3)
    u = torch.from_numpy(np.random.default_rng(1).random((64, 3),
                                                         dtype=np.float32))
    zeros = torch.zeros(64, dtype=torch.int32)
    wi, w, delta = tm.sample_bsdf(mt, zeros, wo, n, u)
    assert (wi[:, 2] > 0).all()
    np.testing.assert_allclose(w.numpy(), [[0.8, 0.4, 0.2]] * 64, rtol=1e-5)
    wi, w, delta = tm.sample_bsdf(mt, zeros + 1, wo, n, u)
    np.testing.assert_allclose(wi.numpy(), [[0, -0.6, 0.8]] * 64, atol=1e-5)
    assert delta.all()
    assert (tm.eval_brdf(mt, zeros, wo, n, wo) >= 0).all()

    zoo = tm.make_material_table([ZOO[i] for i in (5, 6, 7, 8)],
                                 device="cpu")
    rng = np.random.default_rng(5)
    wo = _t(_unit(rng, 256, up=0.2))
    wi = _t(_unit(rng, 256, up=0.2))
    nrm = torch.tensor([[0.0, 0.0, 1.0]]).expand(256, 3)
    u = torch.from_numpy(rng.random((256, 3), dtype=np.float32))
    for k in range(4):
        mid = torch.full((256,), k, dtype=torch.int32)
        f = tm.eval_brdf(zoo, mid, wo, nrm, wi)
        assert torch.isfinite(f).all() and (f >= 0).all(), k
        d, w, _delta = tm.sample_bsdf(zoo, mid, wo, nrm, u)
        assert torch.isfinite(d).all() and torch.isfinite(w).all(), k
        assert (w >= 0).all() and float(w.max()) <= 1.5, k
    assert (tm.eval_brdf(zoo, torch.ones(256, dtype=torch.int32), wo, nrm,
                         wi) == 0).all()
