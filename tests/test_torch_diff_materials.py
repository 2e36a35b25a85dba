"""The port's material gradients (embree_tpu_torch/diff/materials.py)
against the JAX package's.

`freeze_hits` on triangle_sphere(12) with 128 rays against the JAX one;
`material_grads` against `jax.grad(material_loss)` for the five
materials of tests/test_diff_materials.py at 1e-5 relative (on the same
frozen dict); the port's finite-difference gates and optimisation step
of that file; and `path_grads` on its `_indirect_scene`, held by central
finite differences through the port's own `render_pt` (no `jax.grad`
through the JAX `render_pt`, which takes minutes)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import embree_tpu as et
import embree_tpu_torch as ett
from embree_tpu.diff import materials as jdm
from embree_tpu.render.materials import make_material_table as jmaterials
from embree_tpu_torch.core.rayhit import Rays
from embree_tpu_torch.diff.materials import (FLOAT_FIELDS, freeze_hits,
                                             material_grads, material_loss,
                                             path_grads, shade_hits)
from embree_tpu_torch.render.lights import LIGHT_POINT, make_light_table
from embree_tpu_torch.render.materials import (MAT_MATTE, MAT_METAL,
                                               MAT_METALLIC_PAINT, MAT_OBJ,
                                               MAT_VELVET,
                                               make_material_table)
from embree_tpu_torch.render.tutorials.pathtracer import render_pt
from embree_tpu_torch.scene.scene import scene_occluded
from embree_tpu_torch.verify.fixtures import triangle_sphere

LIGHT = (10.0, 10.0, 10.0)
LIGHT_P = (2.0, 3.0, 1.0)
# tests/test_diff_materials.py's materials and the (field, coord, rel, h)
# of its finite-difference gates
MATERIALS = (
    ({"type": MAT_MATTE, "kd": (0.4, 0.6, 0.2)}, (("kd", 1, 5e-2, 1e-3),)),
    ({"type": MAT_OBJ, "kd": (0.5, 0.3, 0.2), "ks": (0.4, 0.4, 0.4),
      "ns": 12.0}, (("kd", 0, 5e-2, 1e-3), ("ks", 2, 5e-2, 1e-3),
                    ("ns", 0, 8e-2, 1e-3))),
    ({"type": MAT_METAL, "ks": (0.9, 0.7, 0.5), "eta": 1.4, "k": 3.0,
      "roughness": 0.2}, (("eta", 0, 8e-2, 1e-3), ("k", 0, 8e-2, 1e-3),
                          ("rough", 0, 8e-2, 1e-4))),
    ({"type": MAT_VELVET, "kd": (0.6, 0.2, 0.2), "ks": (0.3, 0.3, 0.3),
      "ns": 8.0, "roughness": 6.0}, (("kd", 0, 5e-2, 1e-3),
                                     ("ns", 0, 8e-2, 1e-3))),
    ({"type": MAT_METALLIC_PAINT, "kd": (0.7, 0.2, 0.2), "eta": 1.6},
     (("kd", 0, 5e-2, 1e-3), ("eta", 0, 8e-2, 1e-3))),
)


def _rays_np(rng, n=128):
    """tests/test_diff_materials.py's rays: aimed at the sphere from a
    shell, jittered."""
    org = rng.normal(size=(n, 3)).astype(np.float32)
    org = 3.0 * org / np.linalg.norm(org, axis=1, keepdims=True)
    d = -org / np.linalg.norm(org, axis=1, keepdims=True)
    d = d + rng.normal(size=(n, 3)).astype(np.float32) * 0.1
    return org, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(
        np.float32)


@pytest.fixture(scope="module")
def frozen_pair():
    """(the port's frozen dict, the JAX package's) of the same scene and
    rays."""
    org, d = _rays_np(np.random.default_rng(0x5EED))
    verts, idx = triangle_sphere((0, 0, 0), 1.0, 12)
    s = ett.Scene(ett.Device("ignore_config_files=1", device="cpu"))
    s.attach(ett.TriangleMesh(verts, idx))
    ft = freeze_hits(s.commit(), ett.make_rays(org, d, device="cpu"),
                     LIGHT_P)
    js = et.Scene(et.Device("ignore_config_files=1"))
    js.attach(et.TriangleMesh(verts, idx))
    fj = jdm.freeze_hits(js.commit(), et.make_rays(org, d),
                         jnp.asarray(LIGHT_P))
    return ft, fj


def test_freeze_hits_matches_jax(frozen_pair):
    ft, fj = frozen_pair
    for k in ("valid", "prim_id", "geom_id", "lit"):
        np.testing.assert_array_equal(ft[k].numpy(), np.asarray(fj[k]), k)
    v = ft["valid"].numpy()
    for k in ("ns", "wo", "wi", "dist"):
        np.testing.assert_allclose(ft[k].numpy()[v], np.asarray(fj[k])[v],
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    assert int(ft["lit"].sum()) > 20


def _jax_frozen(ft):
    """The port's frozen dict as JAX arrays: both packages shade the same
    inputs."""
    return {k: jnp.asarray(v.numpy()) for k, v in ft.items()}


def test_material_grads_match_jax(frozen_pair):
    """material_grads against jax.grad(material_loss) for every float
    field of the five materials, plain sum and L2 to a target, at 1e-5
    of the field's largest gradient."""
    ft, _ = frozen_pair
    fj = _jax_frozen(ft)
    gm_t = torch.zeros(1, dtype=torch.int32)
    gm_j = jnp.zeros(1, jnp.int32)
    for mat, _gates in MATERIALS:
        mt = make_material_table([mat], device="cpu")
        mj = jmaterials([mat])
        tgt = 0.5 * shade_hits(mt, ft, gm_t, LIGHT).detach()
        for t_tgt, j_tgt in ((None, None), (tgt, jnp.asarray(tgt.numpy()))):
            gt = material_grads(mt, ft, gm_t, LIGHT, t_tgt)
            gj = jdm.material_grads(mj, fj, gm_j, LIGHT, j_tgt)
            assert set(gt) == set(FLOAT_FIELDS) == set(gj)
            for f in FLOAT_FIELDS:
                a, b = gt[f].numpy(), np.asarray(gj[f])
                assert a.shape == b.shape, f
                scale = max(np.abs(b).max(), 1e-30)
                assert np.abs(a - b).max() <= 1e-5 * scale, (mat, f, a, b)
            np.testing.assert_allclose(
                float(material_loss(mt, ft, gm_t, LIGHT, t_tgt)),
                float(jdm.material_loss(mj, fj, gm_j, LIGHT, j_tgt)),
                rtol=1e-5)


def test_material_finite_difference_gates(frozen_pair):
    """tests/test_diff_materials.py's finite-difference gates on the
    port: each (field, coordinate) at its tolerance, nonzero."""
    ft, _ = frozen_pair
    gm = torch.zeros(1, dtype=torch.int32)
    for mat, gates in MATERIALS:
        mt = make_material_table([mat], device="cpu")
        g = material_grads(mt, ft, gm, LIGHT)
        for field, coord, rel, h in gates:
            base = getattr(mt, field)

            def loss_at(x):
                v = base.clone().reshape(-1)
                v[coord] = x
                return float(material_loss(
                    mt._replace(**{field: v.reshape(base.shape)}), ft, gm,
                    LIGHT))

            x0 = float(base.reshape(-1)[coord])
            fd = (loss_at(x0 + h) - loss_at(x0 - h)) / (2 * h)
            gval = float(g[field].reshape(-1)[coord])
            assert np.isfinite(gval) and np.isfinite(fd)
            assert abs(gval - fd) / max(abs(fd), 1e-4) < rel, (
                mat["type"], field, gval, fd)
            assert gval != 0.0


def test_material_optimization_step(frozen_pair):
    """Recover a target kd by gradient descent through the frozen-hit
    shading (tests/test_diff_materials.py's optimisation step)."""
    ft, _ = frozen_pair
    gm = torch.zeros(1, dtype=torch.int32)
    mt = make_material_table([{"type": MAT_OBJ, "kd": (0.2, 0.2, 0.2)}],
                             device="cpu")
    target = shade_hits(mt._replace(kd=torch.tensor([[0.7, 0.4, 0.1]])),
                        ft, gm, LIGHT)
    kd = mt.kd
    l0 = float(material_loss(mt, ft, gm, LIGHT, target))
    for _ in range(300):
        kd = kd - 30.0 * material_grads(mt._replace(kd=kd), ft, gm, LIGHT,
                                        target)["kd"]
    l1 = float(material_loss(mt._replace(kd=kd), ft, gm, LIGHT, target))
    assert l1 < 0.05 * l0
    np.testing.assert_allclose(kd[0].numpy(), [0.7, 0.4, 0.1], atol=0.05)


def _indirect_scene():
    """tests/test_diff_materials.py's `_indirect_scene` on the port: a
    floor point P blocked from the point light by an occluder, lit only
    through one diffuse bounce off a tall wall."""
    scene = ett.Scene(ett.Device("ignore_config_files=1", device="cpu"))
    mats, geom_mat = [], []

    def add_quad(p0, du, dv, mat):
        p0 = np.asarray(p0, np.float32)
        v = np.stack([p0, p0 + du, p0 + np.asarray(du) + np.asarray(dv),
                      p0 + dv]).astype(np.float32)
        gid = scene.attach(ett.QuadMesh(v, np.asarray([[0, 1, 2, 3]])))
        while len(geom_mat) <= gid:
            geom_mat.append(0)
        geom_mat[gid] = len(mats)
        mats.append(mat)

    add_quad((-3, 0, -3), (6, 0, 0), (0, 0, 6),
             dict(type=MAT_MATTE, kd=(0.7, 0.7, 0.7)))
    add_quad((2, 0, -3), (0, 3, 0), (0, 0, 6),
             dict(type=MAT_MATTE, kd=(0.2, 0.8, 0.3)))
    add_quad((-0.4, 1.0, -0.4), (0.8, 0, 0), (0, 0, 0.8),
             dict(type=MAT_MATTE, kd=(0.05, 0.05, 0.05)))
    lt = make_light_table([{"type": LIGHT_POINT, "pos": (0.0, 2.0, 0.0),
                            "radiance": (30.0, 30.0, 30.0)}], device="cpu")
    return (scene.commit(), make_material_table(mats, device="cpu"), lt,
            torch.tensor(geom_mat, dtype=torch.int32))


def test_path_grads_finite_difference():
    """d(pixel)/d(kd_wall) of a bounce-2-only pixel through the port's
    multi-bounce accumulation against central differences of the port's
    render_pt with the same seed (5e-2, the JAX gate's), the image equal
    to render_pt's bit for bit, the floor's kd gradient nonzero."""
    cs, mt, lt, geom_mat = _indirect_scene()
    cam_p = torch.tensor([0.0, 1.5, 0.9])
    vz = -cam_p / torch.linalg.norm(cam_p)
    vx = torch.tensor([1e-3, 0.0, 0.0])
    vy = torch.linalg.cross(vz, vx)
    vy = 1e-3 * vy / torch.linalg.norm(vy)
    cam = (vx, vy, vz, cam_p)

    # P is occluded from the light
    P = torch.zeros((1, 3))
    L = torch.tensor([0.0, 2.0, 0.0])
    sh = Rays(P, (L / torch.linalg.norm(L))[None], torch.tensor([1e-3]),
              torch.tensor([2.0 * 0.999]))
    assert bool(scene_occluded(cs, sh)[0])

    kw = dict(width=1, height=1, spp=16, max_path=3, n_lights=1)
    img, g = path_grads(cs, mt, lt, geom_mat, *cam, seed=3,
                        fields=("kd",), **kw)
    assert set(g) == {"kd"}
    assert float(img.sum()) > 1e-4, "the pixel must be lit indirectly"
    assert torch.equal(img, render_pt(cs, mt, lt, geom_mat, *cam, 3, **kw))
    g_kd = g["kd"].numpy()
    assert np.abs(g_kd[1]).max() > 1e-5, "the wall's kd must matter"
    assert np.abs(g_kd[0]).max() > 1e-5

    eps = 1e-2

    def run(kd):
        return float(render_pt(cs, mt._replace(kd=kd), lt, geom_mat, *cam,
                               3, **kw).sum())

    kdp = mt.kd.clone()
    kdp[1, 1] += eps
    kdm = mt.kd.clone()
    kdm[1, 1] -= eps
    fd = (run(kdp) - run(kdm)) / (2 * eps)
    assert abs(fd - g_kd[1, 1]) < 5e-2 * max(abs(fd), 1e-3), (fd, g_kd[1, 1])
