"""The port's `pathtracer` tutorial (embree_tpu_torch/render/tutorials/
pathtracer.py) against the JAX package's `render_pt`.

Both packages render the Cornell box (16x16, 1 spp, 8 bounces) and
tests/golden/glass_sphere.xml (16x16, 1 spp) with the same uniforms: the
port's sampler here derives each of them from the JAX `render_pt`'s own
key tree (`split(PRNGKey(seed), spp)`, `split(., 3)` -> kx, ky, kpath,
`fold_in(kpath, bounce)`, `fold_in(kb, 1000 + li)` + `split` for a quad
light, `fold_in(kb, 7)` + `split(., 3)` for the BSDF). At least 98 % of
the pixels agree within 1e-4 relative + 1e-5 absolute and the means
within 1e-3 relative; every pixel that does not agree must sit on a
discontinuity of the port's own render (a tie or a branch flip): moving
every uniform by 2e-6 moves that pixel beyond the tolerance. Then the
port's forms of tests/test_pathtracer.py:18-40 (colour bleeding,
determinism per seed with the port's own torch sampler) and the CLI.

The JAX package compiles one `render_pt` a scene (~15-20 s here); the
module fixture lowers both and compiles them on two threads."""
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import embree_tpu as et
import embree_tpu_torch as ett
from embree_tpu.render import xmlloader as jxml
from embree_tpu.render.camera import Camera as JCamera
from embree_tpu.render.camera import pixel_morton_order_device as jmorton
from embree_tpu.render.materials import make_material_table as jmaterials
from embree_tpu.render.tutorials import pathtracer as jpt
from embree_tpu_torch.render import xmlloader as txml
from embree_tpu_torch.render.camera import Camera, pixel_morton_order_device
from embree_tpu_torch.render.image import read_ppm
from embree_tpu_torch.render.tutorials import pathtracer as pt

GLASS = os.path.join(os.path.dirname(__file__), "golden", "glass_sphere.xml")
SIZE = 16
CORNELL_CAM = dict(from_=(0.5, 0.5, 2.4), to=(0.5, 0.5, 0.0), fov=40)
GLASS_CAM = dict(from_=(0, 1.2, 2.6), to=(0, 0.6, 0), fov=90)
RTOL, ATOL = 1e-4, 1e-5
NUDGE = 2e-6


class JaxKeySampler:
    """The uniforms the JAX `render_pt` draws, for every lane of every
    sample, bounce and light, as CPU tensors; `shift` moves each by that
    much (kept in [0, 1))."""

    def __init__(self, seed, spp, n, n_lights, max_path=pt.MAX_PATH_LENGTH,
                 shift=0.0):
        def u(k):
            return np.asarray(jax.random.uniform(k, (n,)))

        def stack(*cols):
            a = np.stack(cols, 1) + np.float32(shift)
            return torch.from_numpy(np.clip(a, 0.0, np.float32(1 - 2 ** -24)))

        self.tables = {}
        for s, key in enumerate(jax.random.split(jax.random.PRNGKey(seed),
                                                 spp)):
            kx, ky, kpath = jax.random.split(key, 3)
            self.tables["pixel", s] = stack(u(kx), u(ky))
            for b in range(max_path):
                kb = jax.random.fold_in(kpath, b)
                for li in range(n_lights):
                    kl = jax.random.fold_in(kb, 1000 + li)
                    self.tables["light", s, b, li] = stack(
                        *(u(k) for k in jax.random.split(kl)))
                self.tables["bsdf", s, b] = stack(
                    *(u(k) for k in jax.random.split(jax.random.fold_in(kb, 7),
                                                     3)))

    def pixel(self, s):
        return self.tables["pixel", s]

    def light(self, s, bounce, li):
        return self.tables["light", s, bounce, li]

    def bsdf(self, s, bounce):
        return self.tables["bsdf", s, bounce]


def _jax_glass_state():
    xs = jxml.load_xml(GLASS)
    scene = et.Scene(et.Device("ignore_config_files=1"))
    gm = [0] * len(xs.geometries)
    for g, m in xs.geometries:
        gm[scene.attach(g)] = m
    return dict(cscene=scene.commit(), materials=jmaterials(xs.materials),
                lights=jxml.light_table_from_xml(xs),
                geom_mat=jnp.asarray(np.asarray(gm, np.int32)))


@pytest.fixture(scope="module")
def renders():
    """{name: (JAX image, camera arrays, seed, the port's state)} for the
    two scenes; the JAX programs are lowered one after the other and
    compiled on two threads."""
    cpu = ett.Device("ignore_config_files=1", device="cpu")
    cases = {
        "cornell": (jpt.build_cornell_scene(), CORNELL_CAM, 3,
                    pt.build_cornell_scene(cpu)),
        "glass": (_jax_glass_state(), GLASS_CAM, 5,
                  pt.build_xml_scene(txml.load_xml(GLASS), cpu)),
    }
    perm, inv = jmorton(SIZE, SIZE)
    lowered = {}
    for name, (js, cam, seed, _st) in cases.items():
        camv = JCamera(**cam).ispc_camera(SIZE, SIZE)
        args = (js["cscene"], js["materials"], js["lights"], js["geom_mat"],
                *camv, seed, perm, inv)
        lowered[name] = (jpt.render_pt.lower(
            *args, width=SIZE, height=SIZE, spp=1,
            n_lights=len(js["lights"].type)), args, camv)
    with ThreadPoolExecutor(2) as ex:
        compiled = dict(zip(lowered, ex.map(lambda lo: lo[0].compile(),
                                            lowered.values())))
    out = {}
    for name, (js, cam, seed, st) in cases.items():
        _lo, args, camv = lowered[name]
        out[name] = (np.asarray(compiled[name](*args)),
                     tuple(torch.from_numpy(np.array(a)) for a in camv),
                     seed, st)
    return out


def _port_render(st, camv, seed, sampler):
    perm, inv = pixel_morton_order_device(SIZE, SIZE, "cpu")
    return pt.render_pt(st["cscene"], st["materials"], st["lights"],
                        st["geom_mat"], *camv, seed, perm, inv, width=SIZE,
                        height=SIZE, spp=1, n_lights=len(st["lights"].type),
                        sampler=sampler).numpy()


def _off(a, b):
    return (np.abs(a - b) > RTOL * np.abs(b) + ATOL).any(-1)


@pytest.mark.parametrize("name", ["cornell", "glass"])
def test_render_matches_the_jax_package(renders, name):
    ref, camv, seed, st = renders[name]
    n = SIZE * SIZE
    nl = len(st["lights"].type)
    img = _port_render(st, camv, seed, JaxKeySampler(seed, 1, n, nl))
    assert img.shape == ref.shape == (SIZE, SIZE, 3)
    assert np.isfinite(img).all() and ref.mean() > 0.02
    off = _off(img, ref)
    share = 1.0 - float(off.mean())
    err = float(np.abs(img - ref).max())
    rel_mean = abs(float(img.mean()) / float(ref.mean()) - 1.0)
    print(f"{name}: {share:.4%} of the pixels within {RTOL:g} relative + "
          f"{ATOL:g}; max |diff| {err:.3g}; means {img.mean():.6f} / "
          f"{ref.mean():.6f} ({rel_mean:.2e} relative)")
    assert share >= 0.98 and rel_mean <= 1e-3
    if off.any():
        # each divergent pixel sits on a discontinuity of the port's own
        # render: nudging every uniform moves it beyond the tolerance
        jump = np.zeros_like(off)
        for shift in (NUDGE, -NUDGE):
            moved = _port_render(st, camv, seed, JaxKeySampler(
                seed, 1, n, nl, shift=shift))
            jump |= _off(moved, img)
        assert not (off & ~jump).any(), np.argwhere(off & ~jump)


def test_colour_bleeding_and_determinism():
    """tests/test_pathtracer.py:18-40 on the port with its own torch
    sampler: finite, non-negative, red on the left wall and green on the
    right; one seed gives one image, another seed another, and the same
    sampler passed in gives the same image."""
    st = pt.build_cornell_scene(ett.Device("ignore_config_files=1",
                                           device="cpu"))
    cam = Camera(**CORNELL_CAM)
    img, rays = pt.render_frame(st, cam, (40, 40), spp=2)
    img = img.numpy()
    assert np.isfinite(img).all() and (img >= 0).all()
    assert 0.02 < img.mean() < 1.0
    assert 40 * 40 * 2 < rays <= 2 * 40 * 40 * 2 * pt.MAX_PATH_LENGTH
    left = img[16:24, 2:6].mean((0, 1))
    right = img[16:24, 34:38].mean((0, 1))
    assert left[0] > left[1] > left[2]
    assert right[1] > right[0]
    a, _ = pt.render_frame(st, cam, (8, 8), spp=1, seed=0)
    b, _ = pt.render_frame(st, cam, (8, 8), spp=1, seed=0)
    c, _ = pt.render_frame(st, cam, (8, 8), spp=1, seed=1)
    assert torch.equal(a, b)
    assert float((a - c).abs().max()) > 0
    # the default sampler made explicit, and the requests tallied
    counts = {}
    d, rays = pt.render_frame(st, cam, (8, 8), spp=1, seed=5,
                              sampler=pt.TorchSampler(0, 64, "cpu"),
                              counts=counts)
    assert torch.equal(a, d)
    assert counts["rays"] == rays and counts["intersect"] >= 1


def test_command_line(tmp_path, capsys):
    """`--benchmark` prints the BENCHMARK_RENDER_* keys and `-o` writes
    the frame."""
    out = tmp_path / "pt.ppm"
    assert pt.make_app().run(["--size", "12", "8", "-o", str(out),
                              "--benchmark", "0", "1", "-rtcore",
                              "device=cpu"]) == 0
    text = capsys.readouterr().out
    for key in ("BENCHMARK_RENDER_AVG", "BENCHMARK_RENDER_MRAYPS_AVG"):
        assert key in text
    img = read_ppm(str(out))
    assert img.shape == (8, 12, 3) and img.max() > 0
