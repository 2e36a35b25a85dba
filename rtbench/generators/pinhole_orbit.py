"""Generator `pinhole_orbit`: a `width` x `height` frame of primary rays a
request, row after row, from a pinhole camera at the configuration's
`camera` ("from", "to", "up", "fov" in degrees) moved each request to a
point drawn uniformly on a sphere of radius `orbit` x |from - to| around
"from", still looking at "to"; unit directions. The request carries its
camera too (`"eye"`, `"basis"`)."""
from __future__ import annotations

import math

import numpy as np
import torch

from rtbench.raygen import RequestRng


class PinholeOrbit(RequestRng):
    def __init__(self, traffic, cfg, box, seed, device):
        self.w, self.h = int(traffic["width"]), int(traffic["height"])
        super().__init__(seed, self.w * self.h, device)
        cam = cfg["camera"]
        self.eye = np.asarray(cam["from"], np.float64)
        self.at = np.asarray(cam["to"], np.float64)
        self.up = np.asarray(cam.get("up", (0.0, 1.0, 0.0)), np.float64)
        self.fov = float(cam.get("fov", 90.0))
        self.radius = (float(traffic["orbit"])
                       * float(np.linalg.norm(self.eye - self.at)))
        ys, xs = torch.meshgrid(
            torch.arange(self.h, dtype=torch.float64, device=self.device),
            torch.arange(self.w, dtype=torch.float64, device=self.device),
            indexing="ij")
        # each pixel's unit direction in the camera's frame (right, up,
        # forward), the same for every request: a request turns them by
        # its camera's basis
        f = 0.5 * self.h / math.tan(math.radians(0.5 * self.fov))
        c = torch.stack([0.5 * self.w - xs.reshape(-1),
                         0.5 * self.h - ys.reshape(-1),
                         torch.full_like(xs, f).reshape(-1)], 1)
        self.cam_dirs = (c / torch.linalg.vector_norm(
            c, dim=1, keepdim=True)).float()

    def camera(self, index: int):
        """(eye (3,), basis (3, 3)) float32 of request `index`: the rows of
        `basis` are the camera's right, up and forward axes in the world
        (camera.h's ISPC camera: pixel (x, y) looks along
        (w/2 - x) right + (h/2 - y) up + (h/2) / tan(fov/2) forward)."""
        rng = np.random.default_rng([self.seed & (2**64 - 1),
                                     index & (2**64 - 1)])
        g = rng.normal(size=3)
        eye = self.eye + self.radius * g / np.linalg.norm(g)
        fwd = self.at - eye
        fwd /= np.linalg.norm(fwd)
        right = np.cross(self.up, fwd)
        right /= np.linalg.norm(right)
        up = np.cross(fwd, right)
        return (torch.tensor(eye, dtype=torch.float32, device=self.device),
                torch.tensor(np.stack([right, up, fwd]), dtype=torch.float32,
                             device=self.device))

    def request(self, index: int) -> dict:
        self.start(index)
        eye, basis = self.camera(index)
        req = self.rays(index, eye.expand(self.n, 3).contiguous(),
                        self.cam_dirs @ basis)
        req.update(eye=eye, basis=basis)
        return req


def make(traffic, cfg, box, seed, device):
    return PinholeOrbit(traffic, cfg, box, seed, device)
