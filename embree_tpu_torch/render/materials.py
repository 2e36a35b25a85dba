"""Material table (SoA, wavefront-friendly).

Counterpart of the table part of embree_tpu/render/materials.py: the
material type constants of the reference pathtracer's material zoo
(tutorials/pathtracer/pathtracer_device.cpp:458-760) and the SoA table
that the viewer reads Kd from. The BRDF evaluation and sampling
functions are not ported yet (they come with the pathtracer).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

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
