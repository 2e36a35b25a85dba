"""Texture sampling (tutorials/common/texture/texture2d analog).

Counterpart of embree_tpu/render/texture.py. Textures are stacked into
one padded tensor so a whole wavefront samples with a single gather;
bilinear or nearest filtering with repeat wrap — the texture2d.cpp
sampling modes. MTL `map_Kd` images load through render/image.py.
`%` on tensors is the floored remainder, as `%` is in the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class TextureSet(NamedTuple):
    data: torch.Tensor    # (T, Hmax, Wmax, 3) f32
    size: torch.Tensor    # (T, 2) i32 (h, w)

    @property
    def num_textures(self):
        return self.data.shape[0]


def make_texture_set(images: list, *, device) -> TextureSet:
    """images: list of (H, W, 3) float arrays (empty -> 1 white texel),
    stacked on `device`."""
    if not images:
        images = [np.ones((1, 1, 3), np.float32)]
    hmax = max(im.shape[0] for im in images)
    wmax = max(im.shape[1] for im in images)
    data = np.zeros((len(images), hmax, wmax, 3), np.float32)
    size = np.zeros((len(images), 2), np.int32)
    for i, im in enumerate(images):
        im = np.asarray(im, np.float32)
        data[i, :im.shape[0], :im.shape[1]] = im[..., :3]
        size[i] = (im.shape[0], im.shape[1])
    return TextureSet(torch.from_numpy(data).to(device),
                      torch.from_numpy(size).to(device))


def sample_texture(ts: TextureSet, tex_id, u, v, bilinear: bool = True):
    """Sample texture `tex_id` (per-lane int) at (u, v) with repeat wrap.
    v follows the reference convention (v=0 at the bottom row)."""
    tex_id = tex_id.long()
    h = ts.size[tex_id, 0].to(torch.float32)
    w = ts.size[tex_id, 1].to(torch.float32)
    uu = (u % 1.0) * w - 0.5
    vv = ((1.0 - (v % 1.0)) % 1.0) * h - 0.5

    if not bilinear:
        x = torch.minimum(torch.round(uu).clamp_min(0), w - 1).long()
        y = torch.minimum(torch.round(vv).clamp_min(0), h - 1).long()
        return ts.data[tex_id, y, x]

    x0 = torch.floor(uu)
    y0 = torch.floor(vv)
    fx = (uu - x0)[..., None]
    fy = (vv - y0)[..., None]
    wi = w.to(torch.int32).clamp_min(1)
    hi = h.to(torch.int32).clamp_min(1)

    def texel(xi, yi):
        x = xi.to(torch.int32) % wi
        y = yi.to(torch.int32) % hi
        return ts.data[tex_id, y.long(), x.long()]

    c00 = texel(x0, y0)
    c10 = texel(x0 + 1, y0)
    c01 = texel(x0, y0 + 1)
    c11 = texel(x0 + 1, y0 + 1)
    return (c00 * (1 - fx) * (1 - fy) + c10 * fx * (1 - fy)
            + c01 * (1 - fx) * fy + c11 * fx * fy)


def sample_bilinear(tex, u, v):
    """Differentiable bilinear sample of ONE (H, W) or (H, W, C) texture
    tensor at (u, v) in [0,1] (repeat wrap, v=0 at the bottom row —
    texture2d semantics). Gradients flow to `tex` through autograd, so a
    displacement texture can be a trainable parameter."""
    chan = tex.ndim == 3
    h, w = tex.shape[0], tex.shape[1]
    uu = (u % 1.0) * w - 0.5
    vv = ((1.0 - (v % 1.0)) % 1.0) * h - 0.5
    i0 = torch.floor(vv).to(torch.int32)
    j0 = torch.floor(uu).to(torch.int32)
    fi = vv - i0
    fj = uu - j0
    i0m = (i0 % h).long()
    i1m = ((i0 + 1) % h).long()
    j0m = (j0 % w).long()
    j1m = ((j0 + 1) % w).long()
    a00 = tex[i0m, j0m]
    a01 = tex[i0m, j1m]
    a10 = tex[i1m, j0m]
    a11 = tex[i1m, j1m]
    if chan:
        fi = fi[..., None]
        fj = fj[..., None]
    return (a00 * (1 - fi) * (1 - fj) + a01 * (1 - fi) * fj
            + a10 * fi * (1 - fj) + a11 * fi * fj)
