"""Instances through the port's scene against the JAX package: the rays
each instance gathers and the kernel its child takes, and a bad
instance transform refused (the tolerances of
tests/test_torch_instances_user.py, whose helpers these use)."""
import numpy as np
import pytest
import torch

import embree_tpu as et
import embree_tpu_torch as ett
from embree_tpu_torch.scene import scene as port_scene
from embree_tpu_torch.traverse import rowtrace2 as rt2
from embree_tpu_torch.verify.fixtures import triangle_sphere

from test_torch_build import reference_native  # noqa: F401

from test_torch_instances_user import (  # noqa: F401
    CFG, PKGS, compare, device, make_rays, rays_np, xfm)


def test_reaching_rays_and_the_childs_kernel_choice(rng, monkeypatch):
    """The instance fold walks only the rays that pass the test against
    the union of an instance's entry boxes: among rays with NaN and
    infinite lanes and -inf tfar, exactly those `_entry_cull` keeps enter
    the child with a finite tfar. The child's kernel is chosen for the
    whole request: under 1,024 rays B1 serves a child that fewer than
    ROWTRACE_MIN_RAYS of them reach, as in the JAX package, and the
    answers equal its."""
    verts, idx = triangle_sphere((0, 0, 0), 1.0, 12)
    cfg = CFG + ",tri_accel=bvh4.rowtrace"
    scenes = {}
    for pkg in PKGS:
        dev = device(pkg, cfg)
        child = pkg.Scene(dev)
        child.attach(pkg.TriangleMesh(verts, idx))
        child.commit()
        top = pkg.Scene(dev)
        top.attach(pkg.Instance(child, xfm(30, 0.8, (6.0, 0.0, 0.0))))
        top.attach(pkg.Instance(child, xfm(70, 1.2, (-6.0, 1.0, 0.0))))
        top.commit()
        scenes[pkg] = top
    cs = scenes[ett].committed
    org, d = rays_np(rng, 1024, -9.0, 9.0)
    d[:8] = np.nan
    d[8:16, 0] = np.inf
    org[16:24, 1] = -np.inf
    rays = make_rays(ett, org, d)
    tfar = rays.tfar.clone()
    tfar[24:200:3] = -np.inf
    tfar[200:400:5] = torch.from_numpy(
        rng.uniform(0, 4, 40).astype(np.float32))
    for inst in cs.instances:
        sel, tfar_in = port_scene._reaching(inst, rays, tfar)
        want = port_scene._entry_cull(inst.cull_lower, inst.cull_upper,
                                      rays, tfar)
        got = torch.zeros_like(want)
        got[sel[tfar_in > -np.inf]] = True
        assert torch.equal(got, want) and 0 < int(want.sum()) < 256
        assert torch.equal(tfar_in[tfar_in > -np.inf],
                           tfar[sel][tfar_in > -np.inf])

    monkeypatch.setattr(port_scene, "ROWTRACE_MIN_RAYS", 512)
    calls = {"rowtrace2": 0}
    plain = rt2.rowtrace2_plain

    def count(*a, **k):
        calls["rowtrace2"] += 1
        return plain(*a, **k)

    monkeypatch.setattr(rt2, "rowtrace2_plain", count)
    assert cs.instances[0].child.rowtrace is not None
    # 200 rays aimed at each instance, the rest in random directions
    org, d = rays_np(rng, 1024, -9.0, 9.0)
    aim = np.repeat(np.float32([[6, 0, 0], [-6, 1, 0]]), 200, 0)
    d[:400] = aim + rng.uniform(-1, 1, (400, 3)) - org[:400]
    d[:400] /= np.linalg.norm(d[:400], axis=1, keepdims=True)
    n = compare("two instances, fewer rays than ROWTRACE_MIN_RAYS reach "
                "each", scenes[et], scenes[ett], make_rays(et, org, d),
                make_rays(ett, org, d), occ=False)
    assert n > 200 and calls["rowtrace2"] == 2


@pytest.mark.parametrize("shape", [(3, 3), (4, 3), (12,)])
def test_instance_transform_shape_is_checked(shape):
    """A transform that is neither (3, 4) nor (4, 4) is refused with
    INVALID_ARGUMENT when the instance is made, under `python -O` too."""
    with pytest.raises(ett.RaytracerError, match="INVALID_ARGUMENT"):
        ett.Instance(ett.Scene(device(ett)), np.zeros(shape, np.float32))
