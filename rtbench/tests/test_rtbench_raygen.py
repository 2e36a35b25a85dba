"""The ray generators: deterministic in (seed, request index), apart
across both, normalized, at the traffic's sizes."""
import math

import numpy as np
import torch

from rtbench import harness, raygen

SEEDS = (7, 2**31 + 5, 2**40 + 3)


def _gen(kind, seed, **kw):
    if kind == "uniform":
        traffic = {"generator": "uniform", "rays": 1000}
        cfg = {"ray_box": [[-3, -3, -3], [3, 3, 3]]}
    else:
        traffic = {"generator": "pinhole_orbit", "width": 32, "height": 18,
                   "orbit": 0.05}
        cfg = {"camera": {"from": [0.5, 1.0, -4.5], "to": [0, 0, 0]}}
    return harness.load_module("generators", kind).make(traffic, cfg, None,
                                                        seed, "cpu")


def _rays(g, index):
    req = g.request(index)
    assert req["index"] == index
    return req["org"], req["dir"]


def test_deterministic_and_distinct():
    for kind in ("uniform", "pinhole_orbit"):
        for seed in SEEDS:
            g1, g2 = _gen(kind, seed), _gen(kind, seed)
            a = _rays(g1, 5)
            _rays(g2, 3)                     # another request first
            b = _rays(g2, 5)
            assert all(torch.equal(x, y) for x, y in zip(a, b))
            assert torch.equal(g1.sample(16), g2.sample(16))
            c = _rays(g1, 6)
            assert not torch.equal(a[1], c[1])
            other = _rays(_gen(kind, seed + 1), 5)
            assert not torch.equal(a[1], other[1])
            n = torch.linalg.vector_norm(a[1], dim=1)
            assert torch.allclose(n, torch.ones_like(n), atol=1e-6)
            assert a[0].shape == a[1].shape == (g1.n, 3)
            assert g1.tnear.shape == (g1.n,) and math.isinf(float(g1.tfar[0]))


def test_uniform_box_and_camera():
    g = _gen("uniform", 11)
    org, d = _rays(g, 0)
    assert float(org.min()) >= -3 and float(org.max()) <= 3
    b = harness.load_module("generators", "uniform").make(
        {"generator": "uniform", "rays": 64}, {"ray_box": "bounds"},
        (np.float32([0, 0, 0]), np.float32([1, 2, 3])), 1, "cpu")
    o, _ = _rays(b, 0)
    assert float(o[:, 1].max()) <= 2 and float(o[:, 2].min()) >= 0
    f = _gen("pinhole_orbit", 11)
    eye, basis = f.camera(0)
    assert abs(float(torch.linalg.vector_norm(eye - torch.tensor(
        [0.5, 1.0, -4.5]))) - 0.05 * math.sqrt(0.25 + 1 + 20.25)) < 1e-5
    assert torch.allclose(basis @ basis.T, torch.eye(3), atol=1e-6)
    o, d = _rays(f, 0)
    centre = d.reshape(18, 32, 3)[9, 16]
    toward = -eye / torch.linalg.vector_norm(eye)
    assert float(torch.dot(centre, toward)) > 0.99
    # pixel (0, 0) looks up and to the left of the camera (x right, y down)
    corner = d.reshape(18, 32, 3)[0, 0]
    assert float(torch.dot(corner, basis[0])) > 0
    assert float(torch.dot(corner, basis[1])) > 0


def test_request_seed_range():
    for seed in SEEDS:
        for i in (0, 1, 2**40):
            s = raygen.request_seed(seed, i)
            assert 0 <= s < 2**63
    assert raygen.request_seed(1, 2) != raygen.request_seed(2, 1)
