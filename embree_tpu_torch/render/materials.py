"""Material table + BSDF evaluation and sampling (SoA, wavefront-friendly).

Counterpart of embree_tpu/render/materials.py: the reference
pathtracer's material zoo (tutorials/pathtracer/pathtracer_device.cpp
:458-760): OBJ (diffuse + phong specular, the loader's default), MATTE,
MIRROR, THIN_DIELECTRIC, EMITTER, METAL (Cook-Torrance with a
power-cosine distribution and conductor fresnel, :601-626),
REFLECTIVE_METAL (delta mirror x conductor fresnel, :640-643), VELVET
(:164-196), METALLIC_PAINT (dielectric-coated lambertian, :741-760),
DIELECTRIC_SOLID (exact fresnel with Medium tracking, :683-707) and
HAIR (AnisotropicBlinn, :368-452). One SoA table holds every material;
evaluation and sampling are branch-free masked torch ops over the whole
wavefront, which autograd differentiates (eta, kd, ...).

The sampling functions draw nothing: they take their uniforms as a
tensor `u` of shape (..., 3), the JAX functions' u1, u2 and u3 in that
order, so a caller decides where the random numbers come from.
"""
from __future__ import annotations

from typing import NamedTuple

import math

import numpy as np
import torch

from ..core.math import dot, length

MAT_MATTE = 0
MAT_OBJ = 1
MAT_MIRROR = 2
MAT_DIELECTRIC = 3        # THIN dielectric (ThinDielectricMaterial)
MAT_THIN_DIELECTRIC = 3
MAT_EMITTER = 4
MAT_METAL = 5             # microfacet conductor (power-cosine D)
MAT_REFLECTIVE_METAL = 6  # delta mirror x conductor fresnel
MAT_VELVET = 7            # horizon scattering (Velvety BRDF); f = ns
MAT_METALLIC_PAINT = 8    # dielectric-coated lambertian
MAT_DIELECTRIC_SOLID = 9  # full dielectric w/ interior Medium tracking
MAT_HAIR = 10             # AnisotropicBlinn Kr/Kt lobes


class MaterialTable(NamedTuple):
    type: torch.Tensor   # (M,) i32
    kd: torch.Tensor     # (M, 3) diffuse / velvet horizonScatteringColor /
    #                      paint shadeColor / hair Kt
    ks: torch.Tensor     # (M, 3) specular / mirror / metal reflectance /
    #                      velvet Minneart reflectance / hair Kr
    ns: torch.Tensor     # (M,) phong exponent / velvet falloff / hair nx
    d: torch.Tensor      # (M,) opacity (OBJ "d")
    eta: torch.Tensor    # (M,) ior (dielectric inside / paint) or
    #                      conductor eta
    k: torch.Tensor      # (M,) conductor extinction (metal fresnel)
    rough: torch.Tensor  # (M,) metal roughness / velvet backScattering
    #                      exponent / hair ny
    le: torch.Tensor     # (M, 3) emission
    trans_in: torch.Tensor   # (M, 3) dielectric interior transmission
    trans_out: torch.Tensor  # (M, 3) dielectric exterior transmission
    eta_out: torch.Tensor    # (M,) dielectric exterior ior


def make_material_table(mats: list[dict], *, device) -> MaterialTable:
    """The table of `mats` (dicts as the loaders make them; missing keys
    take the OBJ material's defaults) on `device`."""
    n = max(len(mats), 1)
    t = np.zeros(n, np.int32)
    kd = np.full((n, 3), 0.5, np.float32)
    ks = np.zeros((n, 3), np.float32)
    ns = np.full(n, 10.0, np.float32)
    d = np.ones(n, np.float32)
    eta = np.full(n, 1.5, np.float32)
    kk = np.zeros(n, np.float32)
    rough = np.full(n, 0.1, np.float32)
    le = np.zeros((n, 3), np.float32)
    t_in = np.ones((n, 3), np.float32)
    t_out = np.ones((n, 3), np.float32)
    eta_out = np.ones(n, np.float32)
    for i, m in enumerate(mats):
        t[i] = m.get("type", MAT_OBJ)
        kd[i] = m.get("kd", (0.5, 0.5, 0.5))
        ks[i] = m.get("ks", (0.0, 0.0, 0.0))
        ns[i] = m.get("ns", 10.0)
        d[i] = m.get("d", 1.0)
        eta[i] = m.get("eta", 1.5)
        kk[i] = m.get("k", 0.0)
        rough[i] = m.get("roughness", 0.1)
        le[i] = m.get("le", (0.0, 0.0, 0.0))
        t_in[i] = m.get("transmission", (1.0, 1.0, 1.0))
        t_out[i] = m.get("transmission_outside", (1.0, 1.0, 1.0))
        eta_out[i] = m.get("eta_outside", 1.0)
    return MaterialTable(*(torch.from_numpy(a).to(device) for a in
                           (t, kd, ks, ns, d, eta, kk, rough, le, t_in,
                            t_out, eta_out)))


class _TableRows(torch.autograd.Function):
    """table[idx] for a 1-D idx: an `index_select` forward; the backward
    sums every lane's cotangent into its row in float64 with one
    `index_add_`. A material's row is read by every lane that hit it, up
    to millions: advanced indexing's backward sorts the lanes and walks a
    row's lanes one after another in float32 (seconds on the card for
    2^21 lanes, and ~3e-5 of the largest entry off the exact sum); the
    float64 atomics land within float32's rounding of the exact sum
    (PERF.md, phase 27b)."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.table_shape = table.shape
        return table.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        acc = g.new_zeros(ctx.table_shape, dtype=torch.float64)
        acc.index_add_(0, idx, g.double())
        return acc.to(g.dtype), None


def table_rows(table, mid):
    """table[mid] for a long tensor `mid` of any shape (`_TableRows` when
    the table carries a gradient)."""
    flat = mid.reshape(-1)
    out = (_TableRows.apply(table, flat) if table.requires_grad
           else table.index_select(0, flat))
    return out.reshape(mid.shape + table.shape[1:])


def _ipow(x, n: int):
    """x ** n for a python int n >= 1 by binary exponentiation, the
    products in the order of the JAX package's `integer_pow`."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n:
            x = x * x
    return acc


def _sum3(a):
    """Sum over the last axis of size 3, left to right."""
    return a[..., 0] + a[..., 1] + a[..., 2]


def fresnel_conductor(cos_o, eta, k):
    """Unpolarized conductor Fresnel (average of Rs/Rp), scalar eta/k."""
    c = cos_o.abs().clamp(0.0, 1.0)
    e2k2 = eta * eta + k * k
    c2 = c * c
    rs = (e2k2 - 2.0 * eta * c + c2) / (e2k2 + 2.0 * eta * c + c2 + 1e-12)
    rp = (e2k2 * c2 - 2.0 * eta * c + 1.0) / (e2k2 * c2 + 2.0 * eta * c
                                              + 1.0 + 1e-12)
    return (0.5 * (rs + rp)).clamp(0.0, 1.0)


def fresnel_dielectric_schlick(cos_o, eta):
    r0 = _ipow((1.0 - eta) / (1.0 + eta), 2)
    return r0 + (1.0 - r0) * _ipow(1.0 - cos_o.abs(), 5)


def _ortho_basis(n):
    """Branchless ONB (Duff et al. / pixar)."""
    s = torch.where(n[..., 2] >= 0, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t1 = torch.stack([1.0 + s * _ipow(n[..., 0], 2) * a, s * b,
                      -s * n[..., 0]], -1)
    t2 = torch.stack([b, s + _ipow(n[..., 1], 2) * a, -n[..., 1]], -1)
    return t1, t2


def cosine_sample(n, u1, u2):
    """Cosine-weighted hemisphere around n; returns (dir, pdf)."""
    r = torch.sqrt(u1)
    phi = 2.0 * math.pi * u2
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = torch.sqrt((1.0 - u1).clamp_min(0.0))
    t1, t2 = _ortho_basis(n)
    d = x[..., None] * t1 + y[..., None] * t2 + z[..., None] * n
    pdf = (z / math.pi).clamp_min(1e-6)
    return d, pdf


def reflect(d, n):
    return d - 2.0 * dot(d, n)[..., None] * n


def _hair_d(whv, tan_x, tan_y, dz, nx, ny, norm2):
    """AnisotropicBlinn's D(wh) over (Tx, Ty, Ng) (:415-430)."""
    cph = dot(whv, tan_x)
    sph = dot(whv, tan_y)
    cth = dot(whv, dz)
    Rh = _ipow(cph, 2) + _ipow(sph, 2)
    nh = torch.where(Rh > 0, (nx * _ipow(cph, 2) + ny * _ipow(sph, 2))
                     / Rh.clamp_min(1e-12), 0.0)
    return torch.where(Rh == 0, norm2, norm2 * cth.abs() ** nh)


def eval_brdf(mt: MaterialTable, mid, wo, ns_normal, wi,
              tan_x=None, tan_y=None, ng_geo=None):
    """f(wo, wi) * cos(wi) for NEE: the matte, OBJ phong, metal, velvet,
    metallic-paint and hair lobes; delta BSDFs give 0."""
    mid = mid.long()
    t, kd, ks, ns, eta, kc, rough = (
        table_rows(a, mid) for a in (mt.type, mt.kd, mt.ks, mt.ns, mt.eta,
                                     mt.k, mt.rough))
    cos_i = dot(wi, ns_normal).clamp_min(0.0)
    diffuse = kd / math.pi * cos_i[..., None]
    # phong specular
    r = reflect(-wo, ns_normal)
    spec_cos = dot(wi, r).clamp_min(0.0)
    phong = ks * ((ns + 2) / (2 * math.pi)
                  * spec_cos ** ns * cos_i)[..., None]
    f = torch.where((t == MAT_MATTE)[..., None], diffuse, 0.0)
    f = torch.where((t == MAT_OBJ)[..., None], diffuse + phong, f)

    cos_o = dot(wo, ns_normal).clamp_min(0.0)
    # METAL: Cook-Torrance, power-cosine D, conductor F, V-cavity G
    # (MetalMaterial__eval, pathtracer_device.cpp:601-617)
    wh = wo + wi
    wh = wh / length(wh)[..., None].clamp_min(1e-12)
    cos_h = dot(wh, ns_normal).clamp_min(0.0)
    cos_ih = dot(wi, wh).clamp_min(1e-6)
    ex = 1.0 / rough.clamp_min(1e-4)
    D = (ex + 2.0) / (2.0 * math.pi) * cos_h ** ex
    F = fresnel_conductor(cos_ih, eta, kc)
    G = torch.minimum(2.0 * cos_h * cos_o / cos_ih,
                      2.0 * cos_h * cos_i / cos_ih).clamp_max(1.0)
    metal = ks * (F * D * G / (4.0 * cos_o).clamp_min(1e-6)
                  * cos_i)[..., None]
    ok = (cos_i > 0) & (cos_o > 0)
    f = torch.where((t == MAT_METAL)[..., None],
                    torch.where(ok[..., None], metal, 0.0), f)

    # VELVET = Minneart(reflectance=ks, backScattering=rough)
    #        + Velvety(horizonScatteringColor=kd, falloff=ns)
    # (VelvetMaterial__eval, pathtracer_device.cpp:654-659)
    sin_o = torch.sqrt((1.0 - cos_o * cos_o).clamp_min(0.0))
    velvety = kd * (sin_o ** ns * cos_i / math.pi)[..., None]
    back = dot(wo, wi).clamp(0.0, 1.0) ** rough
    minneart = ks * (back * cos_i / math.pi)[..., None]
    f = torch.where((t == MAT_VELVET)[..., None], velvety + minneart, f)

    # METALLIC_PAINT: dielectric-layered lambertian base (coat is delta)
    fo = fresnel_dielectric_schlick(cos_o, eta)
    fi = fresnel_dielectric_schlick(cos_i, eta)
    paint = kd * (((1.0 - fo) * (1.0 - fi)) / math.pi * cos_i)[..., None]
    f = torch.where((t == MAT_METALLIC_PAINT)[..., None], paint, f)

    # HAIR: AnisotropicBlinn eval (:415-430) — Kr lobe when wi is on
    # the Ng side, Kt lobe otherwise, both through the anisotropic
    # power-cosine D over (Tx, Ty, Ng)
    if tan_x is None or tan_y is None:
        tan_x, tan_y = _ortho_basis(ns_normal)
    dz = ns_normal if ng_geo is None else ng_geo
    nx = ns
    ny = rough
    norm2 = torch.sqrt((nx + 2) * (ny + 2)) / (2.0 * math.pi)
    cos_iz = dot(wi, dz)
    wh_r = wo + wi
    wh_t = wo + (wi - 2.0 * cos_iz[..., None] * dz)   # reflect(wi, dz)
    whv = torch.where((cos_iz > 0)[..., None], wh_r, wh_t)
    whv = whv / length(whv)[..., None].clamp_min(1e-12)
    d_h = _hair_d(whv, tan_x, tan_y, dz, nx, ny, norm2)
    hair = torch.where((cos_iz > 0)[..., None], ks, kd) \
        * (d_h * cos_iz.abs())[..., None]
    f = torch.where((t == MAT_HAIR)[..., None], hair, f)
    # mirror / dielectric(s) / reflective-metal are delta BSDFs -> no NEE
    return f


def fresnel_dielectric_exact(cos_i, cos_t, eta):
    """Exact unpolarized dielectric fresnel (optics.h:60-65); eta =
    from-side ior / to-side ior, both cosines positive."""
    rper = (eta * cos_i - cos_t) / (eta * cos_i + cos_t).clamp_min(1e-12)
    rpar = (cos_i - eta * cos_t) / (cos_i + eta * cos_t).clamp_min(1e-12)
    return (0.5 * (rpar * rpar + rper * rper)).clamp(0.0, 1.0)


def sample_bsdf(mt: MaterialTable, mid, wo, ns_normal, u):
    """Sample continuation direction; returns (wi, weight, is_delta).
    Vacuum-medium convenience wrapper over sample_bsdf_medium."""
    R = tuple(mid.shape)
    dev = wo.device
    wi, w, delta, _e, _t = sample_bsdf_medium(
        mt, mid, wo, ns_normal, u,
        torch.ones(R, dtype=torch.float32, device=dev),
        torch.ones(R + (3,), dtype=torch.float32, device=dev))
    return wi, w, delta


def sample_bsdf_medium(mt: MaterialTable, mid, wo, ns_normal, u,
                       med_eta, med_trans, tan_x=None, tan_y=None,
                       ng_geo=None):
    """Sample with Medium tracking (pathtracer_device.cpp:57-81):
    `med_eta`/`med_trans` is the per-ray medium the path currently
    travels in; MAT_DIELECTRIC_SOLID refraction pushes/pops it. `u`
    (..., 3) holds the uniforms u1, u2, u3 in [0, 1).
    Returns (wi, weight, is_delta, med_eta', med_trans'). `tan_x/tan_y`
    are the shading tangents for MAT_HAIR (AnisotropicBlinn axes);
    `ng_geo` the geometric normal (defaults to ns_normal)."""
    mid = mid.long()
    u1, u2, u3 = u[..., 0], u[..., 1], u[..., 2]

    t, kd, ks, ns, eta, kc, rough, eta_ot, ti_in, ti_ot = (
        table_rows(a, mid) for a in (mt.type, mt.kd, mt.ks, mt.ns, mt.eta,
                                     mt.k, mt.rough, mt.eta_out,
                                     mt.trans_in, mt.trans_out))

    # diffuse lobe
    wi_d, _pdf_d = cosine_sample(ns_normal, u1, u2)
    w_d = kd  # (kd/pi * cos) / (cos/pi)

    # mirror lobe
    wi_m = reflect(-wo, ns_normal)
    w_m = torch.where((_sum3(ks) > 0)[..., None], ks, kd)

    # dielectric: reflect or refract by fresnel (thin approximation:
    # refraction continues straight through, the reference's
    # ThinDielectric transmission)
    cos_o = dot(wo, ns_normal).clamp(-1.0, 1.0)
    r0 = _ipow((1 - eta) / (1 + eta), 2)
    fres = r0 + (1 - r0) * _ipow(1 - cos_o.abs(), 5)
    refl = u3 < fres
    wi_g = torch.where(refl[..., None], wi_m, -wo)
    w_g = torch.ones_like(kd)

    # OBJ: choose diffuse vs specular by energy; the specular lobe is
    # sampled as the mirror direction, as in the JAX package
    pd = _sum3(kd)
    psum = pd + _sum3(ks)
    p_diff = torch.where(psum > 0, pd / psum.clamp_min(1e-6), 1.0)
    choose_d = u3 < p_diff
    wi_o = torch.where(choose_d[..., None], wi_d, wi_m)
    w_o = torch.where(choose_d[..., None],
                      kd / p_diff.clamp_min(1e-6)[..., None],
                      ks / (1 - p_diff).clamp_min(1e-6)[..., None])

    cos_oo = dot(wo, ns_normal).clamp_min(0.0)

    # METAL: sample the power-cosine half-vector distribution around the
    # normal, reflect wo about it (MetalMaterial__sample :619-626);
    # weight = reflectance * F (the D/pdf terms cancel)
    ex = 1.0 / rough.clamp_min(1e-4)
    cos_h = u1 ** (1.0 / (ex + 2.0))
    sin_h = torch.sqrt((1.0 - cos_h * cos_h).clamp_min(0.0))
    phi = 2.0 * math.pi * u2
    t1, t2 = _ortho_basis(ns_normal)
    wh = (sin_h * torch.cos(phi))[..., None] * t1 \
        + (sin_h * torch.sin(phi))[..., None] * t2 \
        + cos_h[..., None] * ns_normal
    wi_metal = reflect(-wo, wh)
    f_cond = fresnel_conductor(dot(wo, wh), eta, kc)
    # hemisphere rejection (MetalMaterial__sample :624-626)
    metal_up = (dot(wi_metal, ns_normal) > 0.0) \
        & (dot(wo, ns_normal) > 0.0)
    w_metal = torch.where(metal_up[..., None], ks * f_cond[..., None], 0.0)

    # REFLECTIVE_METAL: delta mirror x conductor fresnel (:640-643)
    w_rmetal = ks * fresnel_conductor(cos_oo, eta, kc)[..., None]

    # VELVET: cosine sample; weight = eval * pi / cos
    # (VelvetMaterial__sample :661-669 via sample_component2)
    sin_o = torch.sqrt((1.0 - cos_oo * cos_oo).clamp_min(0.0))
    back_d = dot(wo, wi_d).clamp(0.0, 1.0) ** rough
    w_velvet = kd * (sin_o ** ns)[..., None] \
        + ks * back_d[..., None]

    # METALLIC_PAINT: coat (delta mirror) with prob F(cosO), else the
    # dielectric-layered lambertian base
    f_coat = fresnel_dielectric_schlick(cos_oo, eta)
    coat = u3 < f_coat
    wi_p = torch.where(coat[..., None], wi_m, wi_d)
    w_p = torch.where(coat[..., None], torch.ones_like(kd),
                      kd * (1.0 - f_coat)[..., None])

    # DIELECTRIC_SOLID: reflect/refract with exact fresnel + Medium
    # push/pop (DielectricMaterial__sample :683-707). The medium we are
    # IN decides the eta ratio: front=current medium, back=the other.
    eta_in = eta
    inside = ((med_eta - eta_in).abs() < 1e-6) \
        & ((med_trans - ti_in).abs().amax(-1) < 1e-6)
    eta_r = torch.where(inside, eta_in / eta_ot.clamp_min(1e-6),
                        eta_ot / eta_in.clamp_min(1e-6))
    cosO_d = cos_o.clamp(0.0, 1.0)
    kk_d = 1.0 - eta_r * eta_r * (1.0 - cosO_d * cosO_d)
    tir = kk_d < 0.0
    cosT = torch.sqrt(kk_d.clamp_min(0.0))
    # refract(wo, Ns, eta) (optics.h:47-54); pdf = eta^2
    wi_t = (eta_r[..., None] * (cosO_d[..., None] * ns_normal - wo)
            - cosT[..., None] * ns_normal)
    Rf = torch.where(tir, 1.0,
                     fresnel_dielectric_exact(cosO_d, cosT, eta_r))
    # sample_component2 (:80-109): pick by max-component of c/pdf
    c_refl = Rf
    c_tran = (1.0 - Rf) / (eta_r * eta_r).clamp_min(1e-12)
    csum = c_refl + c_tran
    p_refl = torch.where(csum > 0, c_refl / csum.clamp_min(1e-12), 1.0)
    refl_d = (u3 < p_refl) | tir
    wi_ds = torch.where(refl_d[..., None], wi_m, wi_t)
    # weight = c / (pdf * CP): reflect -> R/CP0; transmit ->
    # (1-R)/(eta^2 * CP1)
    w_ds_s = torch.where(refl_d, Rf / p_refl.clamp_min(1e-12),
                         (1.0 - Rf) / (eta_r * eta_r
                                       * (1.0 - p_refl)).clamp_min(1e-12))
    w_ds = torch.where((csum > 0)[..., None],
                       w_ds_s[..., None].expand(kd.shape), 0.0)
    # medium after the event: reflect stays, transmit crosses
    die = t == MAT_DIELECTRIC_SOLID
    crossed = die & ~refl_d
    new_eta = torch.where(crossed, torch.where(inside, eta_ot, eta_in),
                          med_eta)
    new_trans = torch.where(crossed[..., None],
                            torch.where(inside[..., None], ti_ot, ti_in),
                            med_trans)

    # HAIR: AnisotropicBlinn (:368-452) over (Tx, Ty, Ng) with
    # Kr = ks (reflection), Kt = kd (transmission), (nx, ny) = (ns,
    # rough)
    if tan_x is None or tan_y is None:
        tan_x, tan_y = _ortho_basis(ns_normal)
    dz = ns_normal if ng_geo is None else ng_geo
    nx = ns
    ny = rough
    norm1 = torch.sqrt((nx + 1) * (ny + 1)) / (2.0 * math.pi)
    norm2 = torch.sqrt((nx + 2) * (ny + 2)) / (2.0 * math.pi)
    phi_h = 2.0 * math.pi * u1
    sin0 = torch.sqrt(nx + 1) * torch.sin(phi_h)
    cos0 = torch.sqrt(ny + 1) * torch.cos(phi_h)
    nrm_h = 1.0 / torch.sqrt((_ipow(sin0, 2)
                              + _ipow(cos0, 2)).clamp_min(1e-12))
    sinp = sin0 * nrm_h
    cosp = cos0 * nrm_h
    n_h = nx * _ipow(cosp, 2) + ny * _ipow(sinp, 2)
    cos_th = u2 ** (1.0 / (n_h + 1.0))
    sin_th = torch.sqrt((1.0 - _ipow(cos_th, 2)).clamp_min(0.0))
    pdf_h = norm1 * cos_th ** n_h
    wh_h = ((cosp * sin_th)[..., None] * tan_x
            + (sinp * sin_th)[..., None] * tan_y
            + cos_th[..., None] * dz)

    kr_max = ks.amax(-1)
    kt_max = kd.amax(-1)
    side = kr_max / (kr_max + kt_max).clamp_min(1e-12)
    h_refl = u3 < side
    wi_hr = reflect(-wo, wh_h)
    wi_ht = reflect(reflect(-wo, wh_h), dz)
    wi_h = torch.where(h_refl[..., None], wi_hr, wi_ht)
    cos_ih = dot(wi_h, dz).abs()
    d_wh = _hair_d(wh_h, tan_x, tan_y, dz, nx, ny, norm2)
    pdf_hs = pdf_h * torch.where(h_refl, side, 1.0 - side)
    c_h = torch.where(h_refl[..., None], ks, kd) \
        * (d_wh * cos_ih)[..., None]
    w_h = c_h / pdf_hs.clamp_min(1e-12)[..., None]

    def pick(m, a, b):
        return torch.where(m[..., None], a, b)

    wi = pick(t == MAT_MIRROR, wi_m, wi_d)
    w = pick(t == MAT_MIRROR, w_m, w_d)
    for m, wi_x, w_x in ((t == MAT_OBJ, wi_o, w_o),
                         (t == MAT_DIELECTRIC, wi_g, w_g),
                         (t == MAT_METAL, wi_metal, w_metal),
                         (t == MAT_REFLECTIVE_METAL, wi_m, w_rmetal),
                         (t == MAT_VELVET, wi_d, w_velvet),
                         (t == MAT_METALLIC_PAINT, wi_p, w_p),
                         (die, wi_ds, w_ds),
                         (t == MAT_HAIR, wi_h, w_h)):
        wi = pick(m, wi_x, wi)
        w = pick(m, w_x, w)
    is_delta = (t == MAT_MIRROR) | (t == MAT_DIELECTRIC) | die \
        | (t == MAT_REFLECTIVE_METAL) \
        | ((t == MAT_OBJ) & ~choose_d) \
        | ((t == MAT_METALLIC_PAINT) & coat)
    return wi, w, is_delta, new_eta, new_trans
