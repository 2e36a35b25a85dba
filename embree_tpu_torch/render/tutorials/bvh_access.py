"""bvh_access tutorial: walk and print the committed scene's BVH4.

Counterpart of embree_tpu/render/tutorials/bvh_access.py, the
re-creation of tutorials/bvh_access/bvh_access.cpp: build a cube +
ground-plane scene (:60-130), then traverse the internal BVH4 printing
AlignedNode bounds and leaf triangles (print_bvh4_triangle4v :152-199),
and count inner nodes, leaves and triangles. The committed scene keeps
the wide BVH's arrays (build/bvh.py BVH) as tensors; the walk reads
them on the host.

    python -m embree_tpu_torch.render.tutorials.bvh_access  # the CUDA device
    ... -rtcore device=cpu                                  # the CPU
"""
from __future__ import annotations

import argparse

import numpy as np

from ...core.device import Device
from ...scene.geometry import TriangleMesh
from ...scene.scene import Scene

CUBE_V = np.asarray([
    [-1, -1, -1], [1, -1, -1], [1, -1, 1], [-1, -1, 1],
    [-1, 1, -1], [1, 1, -1], [1, 1, 1], [-1, 1, 1]], np.float32)
CUBE_T = np.asarray([
    [1, 4, 5], [0, 4, 1], [2, 5, 6], [1, 5, 2], [3, 6, 7], [2, 6, 3],
    [4, 3, 7], [0, 3, 4], [5, 7, 6], [4, 7, 5], [3, 1, 2], [0, 1, 3]],
    np.int32)


def build_scene(device=None):
    """`device` is a Device; None means the CUDA device."""
    scene = Scene(device or Device())
    scene.attach(TriangleMesh(CUBE_V, CUBE_T))
    pv = np.asarray([[-10, -2, -10], [-10, -2, 10], [10, -2, -10],
                     [10, -2, 10]], np.float32)
    pt = np.asarray([[0, 2, 1], [1, 2, 3]], np.int32)
    scene.attach(TriangleMesh(pv, pt))
    return scene, scene.commit()


def print_bvh4(cs, out=print):
    """print_bvh4_triangle4v analog over the BVH arrays; returns the
    counts of inner nodes, leaves and triangles."""
    bvh = cs.bvh
    child = bvh.child.cpu().numpy()
    count = bvh.count.cpu().numpy()
    lower = bvh.lower.cpu().numpy()
    upper = bvh.upper.cpu().numpy()
    order = bvh.prim_order.cpu().numpy()
    gid = cs.tris.geom_id.cpu().numpy()
    pid = cs.tris.prim_id.cpu().numpy()
    stats = {"inner": 0, "leaves": 0, "prims": 0}

    def rec(node, depth):
        pad = "  " * depth
        out(pad + "AlignedNode {")
        stats["inner"] += 1
        for c in range(child.shape[1]):
            if count[node, c] < 0:
                continue
            lo, hi = lower[node, c], upper[node, c]
            out(f"{pad}  bounds{c} = [{lo[0]:g},{lo[1]:g},{lo[2]:g}]..."
                f"[{hi[0]:g},{hi[1]:g},{hi[2]:g}]")
        for c in range(child.shape[1]):
            cn = count[node, c]
            if cn < 0:
                continue
            if cn == 0:
                rec(child[node, c], depth + 1)
            else:
                out(pad + "  Leaf {")
                stats["leaves"] += 1
                for k in range(cn):
                    t = order[child[node, c] + k]
                    stats["prims"] += 1
                    out(f"{pad}    Triangle geomID={gid[t]} primID={pid[t]}")
                out(pad + "  }")
        out(pad + "}")

    if child.shape[0]:
        rec(0, 0)
    return stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bvh_access")
    ap.add_argument("-rtcore", "--rtcore", type=str, default="",
                    help="device config string")
    args = ap.parse_args(argv)
    _scene, cs = build_scene(Device(args.rtcore))
    stats = print_bvh4(cs)
    print(f"inner={stats['inner']} leaves={stats['leaves']} "
          f"prims={stats['prims']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
