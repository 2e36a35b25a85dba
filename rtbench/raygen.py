"""What every request generator shares: the per-request seed and the
tensors a batch of rays carries.

A generator is a file `rtbench/generators/<name>.py`, named by a traffic
file's `"generator"`, with a function

    make(traffic, cfg, box, seed, device) -> generator

whose result has `n` (the rays a request; the rate counts them),
`request(index) -> dict` (the request's inputs on the device, with its
`"index"`; rays as `"org"`, `"dir"`, `"tnear"`, `"tfar"`) and
`sample(count)` (indices of `count` of the request's rays, drawn after
it). Every request draws from its own generator seeded with (seed,
index), so no two requests repeat and a request's inputs do not depend
on what ran before it.
"""
from __future__ import annotations

import math

import torch

_MIX = 0x9E3779B97F4A7C15


def request_seed(seed: int, index: int) -> int:
    """A 63-bit seed of (seed, index) for torch.Generator.manual_seed."""
    x = (int(seed) * _MIX + int(index) * 0xBF58476D1CE4E5B9 + 0x94D049BB133111EB)
    x &= (1 << 64) - 1
    x ^= x >> 31
    x = (x * 0xD6E8FEB86657D7A9) & ((1 << 64) - 1)
    return (x ^ (x >> 29)) & ((1 << 63) - 1)


class RequestRng:
    """A device generator reseeded for each request from (seed, index),
    with `n` rays a request and their unbounded [0, inf) intervals."""

    def __init__(self, seed: int, n: int, device):
        self.seed, self.n = int(seed), int(n)
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.tnear = torch.zeros(self.n, dtype=torch.float32,
                                 device=self.device)
        self.tfar = torch.full((self.n,), math.inf, dtype=torch.float32,
                               device=self.device)

    def start(self, index: int):
        self.gen.manual_seed(request_seed(self.seed, index))

    def rays(self, index: int, org, d) -> dict:
        return {"index": index, "org": org, "dir": d, "tnear": self.tnear,
                "tfar": self.tfar}

    def sample(self, count: int):
        """`count` ray indices of the current request, drawn after it."""
        return torch.randint(0, self.n, (count,), generator=self.gen,
                             device=self.device)
