"""Motion-blur traversal over packed rows: the kernel's wrapper, its
plain version and the packer.

Counterpart of embree_tpu/traverse/pallas_mb.py. `pack_rows` lays an
`MBAccel` (traverse/mb.py) out exactly as the JAX package does (its
`MBPallas`), each row padded to a multiple of 128 floats:

  node_rows (M, pad128(2W + 6WS + 2W)) f32
      child W | count W | for each knot s: lo_x lo_y lo_z hi_x hi_y hi_z,
      W each | time_lo W | time_hi W   ([0, 1] without temporal splits)
  tri_rows  (T, pad128(9S)) f32
      for each knot s: v0 v1 v2 of the triangle, in triangle order
  prim_order (P,) i32   leaf slot -> triangle

and `compact_rows` cuts those rows to what the kernel reads, every float
the one it came from (`PackedMB` holds these):

  node_rows (M, 4W + 6WS) f32   the used floats in the same order, a
      multiple of 4 for W = 4 (352 B at S = 3 against 512 B);
  tri_rows  (T, 12S) f32        a knot's v0 v1 v2 and three zero pads, so
      that a knot is three aligned float4s (144 B at S = 3 against 512
      B; 9 floats a knot would save 32 B a triangle and cost six float4
      loads a triangle test that straddle knot boundaries).

`intersect_mb_kernel` (closest hit, finalized against the lerped
triangle) and `occluded_mb_kernel` (any hit) are the entries, the
counterparts of `intersect_mb_pallas(occluded=False/True)`. On CUDA
tensors they launch the hand-written kernel of `csrc/mb.cu` (built and
loaded at first use by core/nvcc.py) or raise; on CPU tensors they run
`mb_plain`, traverse/mb.py::walk_mb over views of the same rows. What a
ray computes, and in which order, is set out in traverse/mb.py; kernel
(built with `-fmad=false`) and plain version agree bit for bit, counters
included. Against the JAX package's kernel, which shares one stack and
one time range among the 1,024 rays of a packet and visits children in
slot order, `t` and the valid mask are the contract and `prim` may
differ where two triangles tie on t.

`pack_rows` refuses a leaf of more than MAX_LEAF triangles instead of
cutting it short as the JAX package's kernel does; the builder makes
leaves of at most 4.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.nvcc import check_tensor, load_library
from ..core.rayhit import Hits, Rays
from ..core.stats import stats_enabled
from . import mb
from .mb import MBAccel, MBRows
from .packet_kernel import _record_stats, tree_depth

KERNEL_NAME = "mb"              # csrc/mb.cu -> _build/libmb.so
WIDTH = 4                       # the node width the kernel is compiled for
MAX_KNOTS = 65                  # the build's cap on the common knot grid
MAX_DEPTH = 64                  # levels of nodes the compiled stack serves
MAX_LEAF = 8
TRI_KNOT = 12                   # floats of one knot in a compact triangle row

# number of kernel launches made by this module, by variant (plain-version
# calls do not count); a caller that wants to know whether a path went
# through the kernel sets them to 0 before and reads them after
launches = {"closest": 0, "occluded": 0}


class PackedMB(NamedTuple):
    """The kernel-packed MB accel produced at commit time."""

    node_rows: torch.Tensor     # (M, 4W + 6WS) f32, `compact_rows`
    tri_rows: torch.Tensor      # (T, 12S) f32
    prim_order: torch.Tensor    # (P,) i32
    S: int
    W: int
    num_nodes: int
    num_prims: int
    depth: int                  # levels of nodes, the root being 1

    @property
    def device_bytes(self) -> int:
        return 4 * (self.node_rows.numel() + self.tri_rows.numel()
                    + self.prim_order.numel())


def _pad128(a):
    w = -(-a.shape[1] // 128) * 128
    out = np.zeros((a.shape[0], w), np.float32)
    out[:, :a.shape[1]] = a
    return out


def pack_rows(arrays: dict) -> dict:
    """The row arrays (host numpy, the JAX package's bytes) of an MB
    accel given as numpy arrays under the MBAccel field names
    (`bvh.child`, `bvh.count`, `bvh.prim_order`, `lower_ts`, `upper_ts`,
    `v0_ts`, `v1_ts`, `v2_ts`, and `time_lo` / `time_hi` or None).
    Raises ValueError on a leaf of more than MAX_LEAF triangles."""
    low, upp = arrays["lower_ts"], arrays["upper_ts"]     # (S, M, W, 3)
    S, M, W, _ = low.shape
    count = np.asarray(arrays["bvh.count"])
    if count.max(initial=0) > MAX_LEAF:
        raise ValueError(f"a leaf of {int(count.max())} triangles: the "
                         f"kernel serves at most {MAX_LEAF}")
    rows = np.empty((M, 2 * W + S * 6 * W + 2 * W), np.float32)
    rows[:, 0:W] = np.asarray(arrays["bvh.child"], np.float32)
    rows[:, W:2 * W] = count.astype(np.float32)
    for s in range(S):
        base = 2 * W + s * 6 * W
        for a in range(3):
            rows[:, base + a * W: base + (a + 1) * W] = low[s, :, :, a]
            rows[:, base + (3 + a) * W: base + (4 + a) * W] = upp[s, :, :, a]
    tb = 2 * W + S * 6 * W
    if arrays.get("time_lo") is not None:
        rows[:, tb:tb + W] = arrays["time_lo"]
        rows[:, tb + W:tb + 2 * W] = arrays["time_hi"]
    else:
        rows[:, tb:tb + W] = 0.0
        rows[:, tb + W:tb + 2 * W] = 1.0
    T = arrays["v0_ts"].shape[1]
    tri = np.empty((T, S * 9), np.float32)
    for s in range(S):
        for k, name in enumerate(("v0_ts", "v1_ts", "v2_ts")):
            tri[:, s * 9 + 3 * k: s * 9 + 3 * k + 3] = arrays[name][s]
    return {"node_rows": _pad128(rows), "tri_rows": _pad128(tri),
            "prim_order": np.asarray(arrays["bvh.prim_order"], np.int32)}


def node_floats(S: int, W: int) -> int:
    """Width of a compact node row: the 4W + 6WS used floats, padded to
    a multiple of 4 (a float4)."""
    return -(-(4 * W + 6 * W * S) // 4) * 4


def compact_rows(rows: dict, S: int, W: int) -> dict:
    """`pack_rows`' arrays cut to what the kernel reads: node rows to
    their used floats (padded to a float4), triangle rows to 12 floats a
    knot (v0 v1 v2, three zero pads). Every float is the one it came
    from."""
    nr, tr = rows["node_rows"], rows["tri_rows"]
    T = tr.shape[0]
    tri = np.zeros((T, S, TRI_KNOT), np.float32)
    tri[:, :, :9] = tr[:, :9 * S].reshape(T, S, 9)
    return {"node_rows": np.ascontiguousarray(nr[:, :node_floats(S, W)]),
            "tri_rows": tri.reshape(T, S * TRI_KNOT),
            "prim_order": rows["prim_order"]}


def accel_arrays(accel: MBAccel) -> dict:
    """An MBAccel as the dict of numpy arrays `pack_rows` takes."""
    out = {f"bvh.{k}": getattr(accel.bvh, k).cpu().numpy()
           for k in ("child", "count", "prim_order")}
    for k in ("lower_ts", "upper_ts", "v0_ts", "v1_ts", "v2_ts",
              "time_lo", "time_hi"):
        a = getattr(accel, k)
        out[k] = None if a is None else a.cpu().numpy()
    return out


def packed_from_rows(rows: dict, S: int, W: int, child, count,
                     device) -> PackedMB:
    """Upload `pack_rows`' arrays, compacted, as a PackedMB."""
    return PackedMB(
        **{k: torch.from_numpy(v).to(device)
           for k, v in compact_rows(rows, S, W).items()},
        S=S, W=W, num_nodes=rows["node_rows"].shape[0],
        num_prims=rows["tri_rows"].shape[0],
        depth=tree_depth(np.asarray(child), np.asarray(count)))


def pack_mb(accel: MBAccel) -> PackedMB:
    """Pack an MBAccel into the kernel's rows on the accel's device."""
    arrs = accel_arrays(accel)
    return packed_from_rows(pack_rows(arrs), accel.num_timesteps,
                            accel.bvh.width, arrs["bvh.child"],
                            arrs["bvh.count"], accel.bvh.child.device)


def packed_rows(pm: PackedMB) -> MBRows:
    """The walk's view of the packed rows: what the kernel reads."""
    W, S = pm.W, pm.S
    nr = pm.node_rows
    tb = 2 * W + 6 * W * S
    return MBRows(child=nr[:, :W].long(), count=nr[:, W:2 * W].long(),
                  boxes=nr[:, 2 * W:tb].unflatten(1, (S, 6, W)),
                  gates=nr[:, tb:tb + 2 * W].unflatten(1, (2, W)),
                  prim_order=pm.prim_order.long(),
                  tris=pm.tri_rows.unflatten(1, (S, TRI_KNOT))[:, :, :9],
                  S=S, W=W, depth=pm.depth)


# ---------------------------------------------------------------------------
# wrapper
# ---------------------------------------------------------------------------

def _load_kernel():
    lib = load_library(KERNEL_NAME)
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.mb_launch.restype = ctypes.c_int
    lib.mb_launch.argtypes = [
        p, ll, p, p, ctypes.c_int, ctypes.c_int,       # accel, S, W
        p, p, p, p, p, ll,                             # rays, time
        p, p, p, ctypes.c_int,                         # t, prim, occ, variant
        p, p, p, p]                                    # stats, stream
    lib.mb_max_depth.restype = ctypes.c_int
    lib.mb_max_depth.argtypes = []
    lib.mb_error_string.restype = ctypes.c_char_p
    lib.mb_error_string.argtypes = [ctypes.c_int]
    return lib


def _checked_inputs(pm: PackedMB, rays: Rays, time, t_in=None):
    """Flat ray tensors and times after the checks both versions share."""
    dev = pm.node_rows.device
    f32, i32 = torch.float32, torch.int32
    if pm.W != WIDTH:
        raise ValueError(f"node width {pm.W}: the kernel serves {WIDTH}")
    if not 2 <= pm.S <= MAX_KNOTS:
        raise ValueError(f"{pm.S} knots: the kernel serves 2..{MAX_KNOTS}")
    if not 1 <= pm.depth <= MAX_DEPTH:
        raise ValueError(f"tree of {pm.depth} levels: the kernel's stack "
                         f"serves at most {MAX_DEPTH}")
    check_tensor("node_rows", pm.node_rows, dev, f32,
                 (pm.num_nodes, node_floats(pm.S, pm.W)))
    check_tensor("tri_rows", pm.tri_rows, dev, f32,
                 (pm.num_prims, TRI_KNOT * pm.S))
    check_tensor("prim_order", pm.prim_order, dev, i32,
                 (pm.prim_order.shape[0],))
    org, d, tn, tf = mb._flat(rays, t_in)
    R = tn.shape[0]
    check_tensor("rays.org", org, dev, f32, (R, 3))
    check_tensor("rays.dir", d, dev, f32, (R, 3))
    check_tensor("rays.tnear", tn, dev, f32, (R,))
    check_tensor("rays.tfar", tf, dev, f32, (R,))
    tm = mb.ray_times(time, R, dev)
    return org, d, tn, tf, tm


def _stats_dict(R, nodes, slabs, tris, drops, nodes_touched,
                prims_touched):
    return {"rays": int(R), "node_visits": int(nodes),
            "slab_tests": int(slabs), "tri_tests": int(tris),
            "dropped_pushes": int(drops),
            "nodes_touched": int(nodes_touched),
            "prims_touched": int(prims_touched)}


def _raise_on(lib, err, what):
    if err != 0:
        msg = lib.mb_error_string(err).decode()
        raise RuntimeError(f"mb {what} kernel launch failed: {err} ({msg})")


def mb_trace(pm: PackedMB, rays: Rays, time, t_in=None,
             occluded: bool = False, stats: bool = False):
    """One traversal at the rays' times (a scalar or one a ray), flat
    over rays: (t, prim, counters or None) for closest hit, with t the
    ray's tfar (or `t_in`) and prim -1 on a miss; (occluded bool, None,
    counters or None) for `occluded`. With `stats` the counters of this
    call come back as a dict; on CUDA that launches the kernel's counting
    build, which is slower (atomics) and is not the main path."""
    org, d, tn, tf, tm = _checked_inputs(pm, rays, time, t_in)
    if tn.device.type == "cpu":
        return mb_plain(pm, Rays(org, d, tn, tf), tm, occluded=occluded,
                        stats=stats)
    lib = _load_kernel()
    if pm.depth > lib.mb_max_depth():
        raise ValueError(f"tree of {pm.depth} levels exceeds the compiled "
                         f"stack ({lib.mb_max_depth()} levels)")
    R, dev = tn.shape[0], tn.device
    occluded = bool(occluded)
    if occluded:
        occ = torch.empty(R, dtype=torch.bool, device=dev)
        t = prim = None
    else:
        t = torch.empty(R, dtype=torch.float32, device=dev)
        prim = torch.empty(R, dtype=torch.int32, device=dev)
        occ = None
    buf = ((torch.zeros(4, dtype=torch.int64, device=dev),
            torch.zeros(pm.num_nodes, dtype=torch.int32, device=dev),
            torch.zeros(pm.num_prims, dtype=torch.int32, device=dev))
           if stats else (None, None, None))

    def ptr(a):
        return None if a is None else a.data_ptr()

    with torch.cuda.device(dev):
        err = lib.mb_launch(
            pm.node_rows.data_ptr(), pm.node_rows.shape[1],
            pm.tri_rows.data_ptr(), pm.prim_order.data_ptr(), pm.S, pm.W,
            org.data_ptr(), d.data_ptr(), tn.data_ptr(), tf.data_ptr(),
            tm.data_ptr(), R, ptr(t), ptr(prim), ptr(occ), int(occluded),
            ptr(buf[0]), ptr(buf[1]), ptr(buf[2]),
            torch.cuda.current_stream().cuda_stream)
    launches["occluded" if occluded else "closest"] += 1
    _raise_on(lib, err, "occlusion" if occluded else "closest-hit")
    st = (_stats_dict(R, *buf[0].tolist(), buf[1].sum().item(),
                      buf[2].sum().item()) if stats else None)
    return (occ, None, st) if occluded else (t, prim, st)


def intersect_mb_kernel(pm: PackedMB, accel: MBAccel, rays: Rays, time,
                        t_in=None) -> Hits:
    """Closest hit at the rays' times, Hits of the rays' batch shape;
    `t_in` seeds the per-ray tfar, a miss keeps the rays' tfar."""
    t, prim, st = mb_trace(pm, rays, time, t_in, stats=stats_enabled())
    _record_stats(False, st)
    tm = mb.ray_times(time, t.shape[0], t.device)
    return mb._finalize_mb(accel, rays, t, prim, tm)


def occluded_mb_kernel(pm: PackedMB, rays: Rays, time) -> torch.Tensor:
    """Any hit at the rays' times: bool tensor of the rays' batch shape."""
    occ, _, st = mb_trace(pm, rays, time, occluded=True,
                          stats=stats_enabled())
    _record_stats(True, st)
    return occ.reshape(rays.batch_shape)


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def mb_plain(pm: PackedMB, rays: Rays, time, occluded: bool = False,
             stats: bool = False, stack_depth: Optional[int] = None):
    """The kernel's function in plain PyTorch ops, float32, on whatever
    device the tensors lie, with `mb_trace`'s results. A `stack_depth`
    below (W - 1) * depth + 1 drops pushes, which are counted."""
    org, d, tn, tf, tm = _checked_inputs(pm, rays, time)
    dev = tn.device
    cnt = (mb.new_counters(pm.num_nodes, pm.num_prims, dev) if stats
           else mb.new_counters())
    t, prim = mb.walk_mb(packed_rows(pm), org, d, tn, tf, tm, occluded, cnt,
                         stack_depth)
    st = (_stats_dict(tn.shape[0], cnt["nodes"], cnt["slab_tests"],
                      cnt["tri_tests"], cnt["drops"],
                      cnt["node_touched"].sum().item(),
                      cnt["prim_touched"].sum().item()) if stats else None)
    if occluded:
        return t == -math.inf, None, st
    return t, prim, st
