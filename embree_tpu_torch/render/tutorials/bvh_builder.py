"""bvh_builder tutorial: user-space BVH construction over random prims.

Counterpart of embree_tpu/render/tutorials/bvh_builder.py, the
re-creation of tutorials/bvh_builder/bvh_builder_device.cpp: N random
AABBs fed to rtcBuildBVH with user InnerNode/LeafNode callbacks
(:44-104), built at every quality (LOW/MEDIUM/HIGH — the reference loops
build() over qualities in device_init :150-230, HIGH exercising
splitPrimitive :34-42), then reports each tree's SAH (InnerNode::sah
:59-61). The build runs on the host (build/user_builder.py) whatever
device `rtcNewDevice` binds.

    python -m embree_tpu_torch.render.tutorials.bvh_builder   # the CUDA device
    ... -rtcore device=cpu                                    # the CPU
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from ... import rtcore as rtc
from ...build.user_builder import BuildQualityEnum


class InnerNode:
    def __init__(self):
        self.bounds = []
        self.children = []

    def sah(self):
        def area(b):
            d = np.maximum(b[1] - b[0], 0.0)
            return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])
        lo = np.min([b[0] for b in self.bounds], 0)
        hi = np.max([b[1] for b in self.bounds], 0)
        total = max(area((lo, hi)), 1e-30)
        return 1.0 + sum(area(b) * c.sah() for b, c in
                         zip(self.bounds, self.children)) / total


class LeafNode:
    def __init__(self, prims):
        self.prims = prims

    def sah(self):
        return 1.0


def make_random_prims(n: int, seed: int = 8062):
    rng = np.random.default_rng(seed)
    org = rng.uniform(-10.0, 10.0, (n, 3)).astype(np.float32)
    ext = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    return org, org + ext


def split_primitive(prim, dim, pos):
    """The reference splitPrimitive (:34-42): clip the box at pos."""
    llo, lhi = prim.lower.copy(), prim.upper.copy()
    rlo, rhi = prim.lower.copy(), prim.upper.copy()
    lhi[dim] = pos
    rlo[dim] = pos
    return (llo, lhi), (rlo, rhi)


def build(quality: int, lower, upper, branching: int = 2,
          rtcore: str = "ignore_config_files=1"):
    device = rtc.rtcNewDevice(rtcore)
    bvh = rtc.rtcNewBVH(device)
    args = rtc.rtcDefaultBuildArguments()
    args.build_quality = quality
    args.max_branching_factor = branching
    args.max_leaf_size = 1
    args.create_node = lambda n: InnerNode()
    args.set_node_children = lambda node, ch: node.children.extend(ch)
    args.set_node_bounds = lambda node, bs: node.bounds.extend(bs)
    args.create_leaf = lambda prims: LeafNode(prims)
    args.split_primitive = split_primitive
    args.progress = lambda f: True
    t0 = time.perf_counter()
    root = rtc.rtcBuildBVH(bvh, args, lower, upper)
    dt = time.perf_counter() - t0
    rtc.rtcReleaseBVH(bvh)
    rtc.rtcReleaseDevice(device)
    return root, dt


def main(argv=None, n: int = 20000) -> int:
    ap = argparse.ArgumentParser(prog="bvh_builder")
    ap.add_argument("-rtcore", "--rtcore", type=str, default="",
                    help="device config string")
    args = ap.parse_args(argv)
    lower, upper = make_random_prims(n)
    for name, q in (("LOW", BuildQualityEnum.LOW),
                    ("MEDIUM", BuildQualityEnum.MEDIUM),
                    ("HIGH", BuildQualityEnum.HIGH)):
        root, dt = build(q, lower, upper, rtcore=args.rtcore)
        print(f"quality={name:6s} prims={n} sah={root.sah():.3f} "
              f"build={dt * 1e3:.1f}ms "
              f"({n / max(dt, 1e-9) / 1e6:.3f} Mprims/s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
