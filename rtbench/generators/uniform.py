"""Generator `uniform`: `rays` rays a request, origins uniform in the
configuration's `ray_box` ([lo, hi], or "bounds": the scene's box),
directions uniform on the sphere (normalized Gaussians): Embree's
IncoherentRaysBenchmark shape
(embree_tpu_torch/verify/benchmarks.py::_incoherent_rays)."""
from __future__ import annotations

import torch

from rtbench.raygen import RequestRng


class Uniform(RequestRng):
    def __init__(self, traffic, cfg, box, seed, device):
        super().__init__(seed, traffic["rays"], device)
        rb = cfg["ray_box"]
        lo, hi = box if rb == "bounds" else rb
        self.lo = torch.tensor(lo, dtype=torch.float32, device=self.device)
        self.ext = (torch.tensor(hi, dtype=torch.float32, device=self.device)
                    - self.lo)

    def request(self, index: int) -> dict:
        self.start(index)
        u = torch.rand((self.n, 3), generator=self.gen, device=self.device)
        org = self.lo + u * self.ext
        d = torch.randn((self.n, 3), generator=self.gen, device=self.device)
        d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
        return self.rays(index, org, d)


def make(traffic, cfg, box, seed, device):
    return Uniform(traffic, cfg, box, seed, device)
