"""Compressed-patch (cBVH) traversal: the two kernels' wrappers, their
plain versions, the packer and the compact device form.

Counterpart of embree_tpu/traverse/pallas_cbvh.py. `pack_compressed`
lays the compressed accel out exactly as the JAX package does
(`PackedCompressed` is its `PallasCompressed`), in rows of 128 lanes:

  topnodes (M, 128) f32   BVH4 node rows: lo_x lo_y lo_z hi_x hi_y hi_z
                          child count, four lanes each
  theader  (T, 128) f32   space 9 | proj 9 | iproj 9 | frustum 10 | uv0 2 |
                          uvd 2 | extent 1 | geom 1 | prim 1   (44 used)
  tnodes   (T, 128) i32   up to 85 4-byte 'com' node words
                          (xz | x<<8 | yz<<16 | y<<24)
  tleaf    (T, 128) i32   two pizza-box cells a word (z12 | z34<<8 each),
                          'leaf' mode
  tgrid    (T, 8, 128) f32  (g+1)^2*3 world floats, 'grid' mode only (the
                          JAX package allocates it, all zero, in every
                          mode; here it is empty outside 'grid' mode)
  tile_of_leaf (T,) i32   top-level leaf slot -> tile

`pack_compact` cuts those rows to what the kernels read, every word the
one it came from (`CompactCompressed`, the form a committed scene holds
on the device):

  topnodes (M, 32) f32    the 32 used floats of a node row: 128 bytes
  tiles    (T, W) f32     one record a tile: the 44 header floats, the
                          node words from float 44, then the leaf words
                          or the grid floats, each section starting on a
                          float4 (`tile_layout`); 400 bytes in 'leaf' mode
                          at level 3, where the three rows take 1,536
  tile_of_leaf (T,) i32

`intersect_compressed_kernel` (closest hit) and
`occluded_compressed_kernel` (conservative occlusion: a ray is occluded
when it reaches any tile's top-level leaf box) are the entries. On CUDA
tensors they launch the hand-written kernels of `csrc/cbvh.cu` (built
and loaded at first use by core/nvcc.py) over the compact form or raise;
on CPU tensors they run `cbvh_plain` / `cbvh_occluded_plain`, the same
per-ray walk in masked tensor ops (traverse/cbvh.py::walk_closest /
walk_occluded) over either form (`CompactSource`, `PackedSource`). What a
ray computes, and in which order, is set out in traverse/cbvh.py; the
kernel (built with `-fmad=false`) and the plain version agree bit for
bit, counters included. Against the JAX package's kernel, which orders
visits by the nearest ray of a 1,024-ray packet, `t` and the valid mask
are the contract and `tile` may differ where two tiles give the same t.

Not carried over from the JAX package, because they belong to its
schedule and not to the function: the shared stacks of a packet, the
K-wide pops and row DMAs, the adaptive pop width, the tables in scalar
memory, the two-pops-an-iteration unroll and the iteration cap.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.nvcc import check_tensor, load_library
from ..core.rayhit import Rays
from . import cbvh
from .cbvh import CompressedAccel, _CHit
from .packet_kernel import tree_depth

KERNEL_NAME = "cbvh"            # csrc/cbvh.cu -> _build/libcbvh.so
MAX_DEPTH = 64                  # top-level levels the compiled stack serves
MODES = ("box", "leaf", "grid")
GRID_ROWS = 8
HEADER_WORDS = 44               # floats of a tile header
TOP_WORDS = 32                  # used floats of a top-level node row

# number of kernel launches made by this module, by kernel (plain-version
# calls do not count); a caller that wants to know whether a path went
# through a kernel sets them to 0 before and reads them after
launches = {"closest": 0, "occluded": 0}


class PackedCompressed(NamedTuple):
    """The kernel-packed compressed accel produced at commit time."""

    topnodes: torch.Tensor      # (M, 128) f32
    theader: torch.Tensor       # (T, 128) f32
    tnodes: torch.Tensor        # (T, 128) i32
    tleaf: torch.Tensor         # (T, 128) i32
    tgrid: torch.Tensor         # (T, 8, 128) f32 in 'grid' mode, else (0, 8, 128)
    tile_of_leaf: torch.Tensor  # (T,) i32
    uv0: torch.Tensor           # (T, 2) f32
    uvd: torch.Tensor           # (T, 2) f32
    comp_level: int
    mode: str
    top_depth: int              # levels of top-level nodes, the root being 1

    @property
    def num_nodes(self) -> int:
        return self.topnodes.shape[0]

    @property
    def num_tiles(self) -> int:
        return self.theader.shape[0]

    @property
    def device_bytes(self) -> int:
        return sum(a.numel() * a.element_size() for a in self[:8])


def pack_rows(accel_np: dict, comp_level: int, mode: str):
    """The row arrays (host numpy, the JAX package's bytes) of a
    compressed accel given as numpy arrays: `top.lower`, `top.upper`
    (M, 4, 3), `top.child`, `top.count` (M, 4), `top.prim_order` (T,) and
    the `CompressedTiles` fields under `tiles.<name>`. Returns a dict of
    the six row arrays, or None for a mode or level the kernel does not
    serve."""
    if mode not in MODES:
        return None
    cl = comp_level
    g = 1 << cl
    n_nodes = (4 ** cl - 1) // 3
    if n_nodes > 128 or (g * g) // 2 > 128:
        return None
    lower, upper = accel_np["top.lower"], accel_np["top.upper"]
    M = lower.shape[0]
    rows = np.zeros((M, 128), np.float32)
    for a in range(3):
        rows[:, 4 * a: 4 * a + 4] = lower[:, :, a]
        rows[:, 12 + 4 * a: 12 + 4 * a + 4] = upper[:, :, a]
    rows[:, 24:28] = accel_np["top.child"].astype(np.float32)
    rows[:, 28:32] = accel_np["top.count"].astype(np.float32)

    T = accel_np["tiles.space"].shape[0]
    hdr = np.zeros((T, 128), np.float32)
    hdr[:, 0:9] = accel_np["tiles.space"].reshape(T, 9)
    hdr[:, 9:18] = accel_np["tiles.proj"].reshape(T, 9)
    hdr[:, 18:27] = accel_np["tiles.iproj"].reshape(T, 9)
    hdr[:, 27:37] = accel_np["tiles.frustum"]
    hdr[:, 37:39] = accel_np["tiles.uv0"]
    hdr[:, 39:41] = accel_np["tiles.uvd"]
    hdr[:, 41] = accel_np["tiles.extent"]
    hdr[:, 42] = accel_np["tiles.geom_id"].astype(np.float32)
    hdr[:, 43] = accel_np["tiles.prim_id"].astype(np.float32)

    nd = accel_np["tiles.nodes"].astype(np.int64)  # (T, n_nodes, 4)
    words = (nd[:, :, 0] | (nd[:, :, 1] << 8) | (nd[:, :, 2] << 16)
             | (nd[:, :, 3] << 24)).astype(np.uint32)
    tn = np.zeros((T, 128), np.uint32)
    tn[:, :words.shape[1]] = words

    tl = np.zeros((T, 128), np.uint32)
    if mode == "leaf":
        lz = accel_np["tiles.leaf_z"].astype(np.int64)  # (T, cells, 2)
        cw = (lz[:, :, 0] | (lz[:, :, 1] << 8)).astype(np.uint32)
        if cw.shape[1] % 2 == 1:
            cw = np.concatenate([cw, np.zeros((T, 1), np.uint32)], 1)
        packed = cw[:, 0::2] | (cw[:, 1::2] << 16)
        tl[:, :packed.shape[1]] = packed

    tg = np.zeros((T if mode == "grid" else 0, GRID_ROWS, 128), np.float32)
    if mode == "grid":
        gr = accel_np["tiles.grid"].reshape(T, -1)  # (T, (g+1)^2*3), i-major
        if gr.shape[1] > GRID_ROWS * 128:
            return None
        tg.reshape(T, -1)[:, :gr.shape[1]] = gr

    return {"topnodes": rows, "theader": hdr, "tnodes": tn.view(np.int32),
            "tleaf": tl.view(np.int32), "tgrid": tg,
            "tile_of_leaf": accel_np["top.prim_order"].astype(np.int32)}


def accel_arrays(accel: CompressedAccel) -> dict:
    """A compressed accel as the dict of numpy arrays `pack_rows` and
    convert.compressed_accel_from_reference take."""
    out = {f"top.{k}": getattr(accel.top, k).cpu().numpy()
           for k in accel.top._fields}
    out.update({f"tiles.{k}": getattr(accel.tiles, k).cpu().numpy()
                for k in accel.tiles.ARRAYS})
    return out


def pack_compressed(accel: CompressedAccel) -> Optional[PackedCompressed]:
    """Repack the compressed accel for the kernels and upload it to the
    accel's device; None for what they do not serve (mode 'full'; the
    caller keeps node flavors other than 'com' away)."""
    tiles = accel.tiles
    arrs = accel_arrays(accel)
    rows = pack_rows(arrs, tiles.comp_level, tiles.mode)
    if rows is None:
        return None
    dev = tiles.space.device
    return PackedCompressed(
        **{k: torch.from_numpy(v).to(dev) for k, v in rows.items()},
        uv0=tiles.uv0, uvd=tiles.uvd, comp_level=tiles.comp_level,
        mode=tiles.mode,
        top_depth=tree_depth(arrs["top.child"], arrs["top.count"]))


class PackedSource:
    """Tile source of traverse/cbvh.py::walk_closest over the packed
    rows: what the kernel reads, word for word."""

    def __init__(self, pc: PackedCompressed):
        self.pc = pc
        self.mode = pc.mode
        self.comp_level = pc.comp_level
        self.tile_of_leaf = pc.tile_of_leaf
        self.hdr = pc.theader
        self.top_depth = pc.top_depth
        self._tables = cbvh._tables(pc.topnodes.device)

    def top_node(self, node):
        f = self.pc.topnodes[node, :32].view(-1, 8, 4)
        return tuple(f[:, k] for k in range(8))

    def children(self, ti, curr, blo, bhi):
        w = self.pc.tnodes[ti, curr]
        return cbvh.decode_com(w & 0xFF, (w >> 8) & 0xFF, (w >> 16) & 0xFF,
                               (w >> 24) & 0xFF, blo, bhi, self._tables)

    def leaf_z(self, ti, idx):
        w = self.pc.tleaf[ti, idx >> 1]
        cw = torch.where((idx & 1) == 0, w & 0xFFFF, (w >> 16) & 0xFFFF)
        return cw & 0xFF, (cw >> 8) & 0xFF

    def grid_vertex(self, ti, ii, jj):
        g1 = (1 << self.comp_level) + 1
        base = ti * (GRID_ROWS * 128) + 3 * (ii * g1 + jj)
        flat = self.pc.tgrid.view(-1)
        return torch.stack([flat[base], flat[base + 1], flat[base + 2]], 1)


class CompactCompressed(NamedTuple):
    """The compact device form of a compressed accel (`pack_compact`),
    what the kernels read."""

    topnodes: torch.Tensor      # (M, TOP_WORDS) f32
    tiles: torch.Tensor         # (T, tile_words) f32, ints as bit patterns
    tile_of_leaf: torch.Tensor  # (T,) i32
    uv0: torch.Tensor           # (T, 2) f32
    uvd: torch.Tensor           # (T, 2) f32
    comp_level: int
    mode: str
    top_depth: int              # levels of top-level nodes, the root being 1

    @property
    def num_nodes(self) -> int:
        return self.topnodes.shape[0]

    @property
    def num_tiles(self) -> int:
        return self.tiles.shape[0]

    @property
    def device_bytes(self) -> int:
        return sum(a.numel() * a.element_size() for a in self[:5])


def _pad4(n: int) -> int:
    return -(-n // 4) * 4


def tile_layout(comp_level: int, mode: str):
    """(floats of a compact tile record, offset of its node words, offset
    of its leaf words or grid floats); every section starts on a float4."""
    g = 1 << comp_level
    elems = (4 ** comp_level - 1) // 3
    leaf_ofs = HEADER_WORDS + _pad4(elems)
    payload = {"box": 0, "leaf": g * g // 2, "grid": 3 * (g + 1) ** 2}[mode]
    return leaf_ofs + _pad4(payload), HEADER_WORDS, leaf_ofs


def compact_rows(rows: dict, comp_level: int, mode: str) -> dict:
    """`pack_rows`' arrays (host numpy) cut to the compact form: node rows
    to their 32 used floats, a tile's header, node words and leaf words or
    grid floats into one record (`tile_layout`). Every word is the one it
    came from, bit for bit; the pads are zero."""
    g = 1 << comp_level
    elems = (4 ** comp_level - 1) // 3
    T = rows["theader"].shape[0]
    words, node_ofs, leaf_ofs = tile_layout(comp_level, mode)
    rec = np.zeros((T, words), np.int32)
    rec[:, :HEADER_WORDS] = rows["theader"].view(np.int32)[:, :HEADER_WORDS]
    rec[:, node_ofs:node_ofs + elems] = rows["tnodes"][:, :elems]
    if mode == "leaf":
        rec[:, leaf_ofs:leaf_ofs + g * g // 2] = rows["tleaf"][:, :g * g // 2]
    elif mode == "grid":
        n = 3 * (g + 1) ** 2
        rec[:, leaf_ofs:leaf_ofs + n] = (
            rows["tgrid"].reshape(T, -1).view(np.int32)[:, :n])
    return {"topnodes": np.ascontiguousarray(
                rows["topnodes"][:, :TOP_WORDS]),
            "tiles": rec.view(np.float32),
            "tile_of_leaf": rows["tile_of_leaf"]}


def pack_compact(accel: CompressedAccel) -> Optional[CompactCompressed]:
    """`pack_rows`' arrays of the accel cut to the compact form
    (`compact_rows`) and uploaded to the accel's device: the form a scene
    commits; None for what the kernels do not serve."""
    tiles = accel.tiles
    arrs = accel_arrays(accel)
    rows = pack_rows(arrs, tiles.comp_level, tiles.mode)
    if rows is None:
        return None
    dev = tiles.space.device
    return CompactCompressed(
        **{k: torch.from_numpy(v).to(dev)
           for k, v in compact_rows(rows, tiles.comp_level,
                                    tiles.mode).items()},
        uv0=tiles.uv0, uvd=tiles.uvd, comp_level=tiles.comp_level,
        mode=tiles.mode,
        top_depth=tree_depth(arrs["top.child"], arrs["top.count"]))


class CompactSource:
    """Tile source of traverse/cbvh.py::walk_closest over the compact form:
    what the kernel reads, word for word."""

    def __init__(self, cc: CompactCompressed):
        self.cc = cc
        self.mode = cc.mode
        self.comp_level = cc.comp_level
        self.tile_of_leaf = cc.tile_of_leaf
        self.hdr = cc.tiles[:, :HEADER_WORDS]
        self.top_depth = cc.top_depth
        self._words = cc.tiles.view(torch.int32)
        _, self._node_ofs, self._leaf_ofs = tile_layout(cc.comp_level,
                                                        cc.mode)
        self._tables = cbvh._tables(cc.topnodes.device)

    def top_node(self, node):
        f = self.cc.topnodes[node].view(-1, 8, 4)
        return tuple(f[:, k] for k in range(8))

    def children(self, ti, curr, blo, bhi):
        w = self._words[ti, self._node_ofs + curr]
        return cbvh.decode_com(w & 0xFF, (w >> 8) & 0xFF, (w >> 16) & 0xFF,
                               (w >> 24) & 0xFF, blo, bhi, self._tables)

    def leaf_z(self, ti, idx):
        w = self._words[ti, self._leaf_ofs + (idx >> 1)]
        cw = torch.where((idx & 1) == 0, w & 0xFFFF, (w >> 16) & 0xFFFF)
        return cw & 0xFF, (cw >> 8) & 0xFF

    def grid_vertex(self, ti, ii, jj):
        g1 = (1 << self.comp_level) + 1
        col = self._leaf_ofs + 3 * (ii * g1 + jj)
        t = self.cc.tiles
        return torch.stack([t[ti, col], t[ti, col + 1], t[ti, col + 2]], 1)


def _source(pc):
    return CompactSource(pc) if isinstance(pc, CompactCompressed) \
        else PackedSource(pc)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _load_kernel():
    lib = load_library(KERNEL_NAME)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cbvh_launch.restype = ctypes.c_int
    lib.cbvh_launch.argtypes = [
        p, p, p, i, i, i, i,                            # accel, layout
        p, p, p, p, ctypes.c_longlong,                  # rays
        p, p, p, p, p,                                  # t u v tile, counter
        p, p, p, p]                                     # stats, stream
    lib.cbvh_occluded_launch.restype = ctypes.c_int
    lib.cbvh_occluded_launch.argtypes = [
        p, i, p, p, p, p, ctypes.c_longlong, p, p, p, p]
    lib.cbvh_error_string.restype = ctypes.c_char_p
    lib.cbvh_error_string.argtypes = [ctypes.c_int]
    return lib


def _checked_inputs(pc, rays: Rays, t_in=None):
    """Flat ray tensors after the checks both versions share; `pc` is a
    CompactCompressed or, for the plain versions, a PackedCompressed."""
    dev = pc.topnodes.device
    f32, i32 = torch.float32, torch.int32
    if pc.mode not in MODES:
        raise ValueError(f"mode {pc.mode!r}: the kernel serves {MODES}")
    if not 1 <= pc.comp_level <= cbvh.MAX_COMP_LEVEL:
        raise ValueError(f"compression level {pc.comp_level}: the kernel "
                         f"serves 1..{cbvh.MAX_COMP_LEVEL}")
    if not 1 <= pc.top_depth <= MAX_DEPTH:
        raise ValueError(f"top level of {pc.top_depth} levels: the kernel's "
                         f"stack serves at most {MAX_DEPTH}")
    M, T = pc.num_nodes, pc.num_tiles
    if isinstance(pc, CompactCompressed):
        words = tile_layout(pc.comp_level, pc.mode)[0]
        # a record's sections, named after the rows they come from
        sections = {"box": "theader|tnodes", "leaf": "theader|tnodes|tleaf",
                    "grid": "theader|tnodes|tgrid"}[pc.mode]
        check_tensor("topnodes", pc.topnodes, dev, f32, (M, TOP_WORDS))
        check_tensor(f"tiles ({sections})", pc.tiles, dev, f32, (T, words))
    else:
        check_tensor("topnodes", pc.topnodes, dev, f32, (M, 128))
        check_tensor("theader", pc.theader, dev, f32, (T, 128))
        check_tensor("tnodes", pc.tnodes, dev, i32, (T, 128))
        check_tensor("tleaf", pc.tleaf, dev, i32, (T, 128))
        check_tensor("tgrid", pc.tgrid, dev, f32,
                     (T if pc.mode == "grid" else 0, GRID_ROWS, 128))
    check_tensor("tile_of_leaf", pc.tile_of_leaf, dev, i32, (T,))
    R = rays.tnear.numel()
    org = rays.org.reshape(-1, 3)
    d = rays.dir.reshape(-1, 3)
    tn = rays.tnear.reshape(-1)
    tf = (rays.tfar if t_in is None else t_in).reshape(-1)
    check_tensor("rays.org", org, dev, f32, (R, 3))
    check_tensor("rays.dir", d, dev, f32, (R, 3))
    check_tensor("rays.tnear", tn, dev, f32, (R,))
    check_tensor("rays.tfar", tf, dev, f32, (R,))
    if tn.device.type != "cpu" and not isinstance(pc, CompactCompressed):
        raise ValueError("the CUDA kernels read the compact form: "
                         "pack_compact(accel)")
    return org, d, tn, tf


def _stats_dict(R, top_nodes, tiles, quad_nodes, leaves, drops,
                nodes_touched, tiles_touched):
    return {"rays": int(R), "top_nodes": int(top_nodes),
            "tiles_entered": int(tiles), "quad_nodes": int(quad_nodes),
            "leaf_tests": int(leaves), "dropped_pushes": int(drops),
            "nodes_touched": int(nodes_touched),
            "tiles_touched": int(tiles_touched)}


def _stat_buffers(pc, dev):
    return (torch.zeros(5, dtype=torch.int64, device=dev),
            torch.zeros(pc.num_nodes, dtype=torch.int32, device=dev),
            torch.zeros(pc.num_tiles, dtype=torch.int32, device=dev))


def _ptr(a):
    return None if a is None else a.data_ptr()


def _raise_on(lib, err, what):
    if err != 0:
        msg = lib.cbvh_error_string(err).decode()
        raise RuntimeError(f"cbvh {what} kernel launch failed: {err} ({msg})")


def cbvh_trace(pc, rays: Rays, t_in=None, stats: bool = False):
    """One closest-hit traversal: (t, tile-local u, tile-local v, tile,
    counters or None), flat over rays. `t` is the ray's tfar (or `t_in`)
    and `tile` -1 where no tile was hit. With `stats` the counters of
    this call come back as a dict; on CUDA that launches the kernel's
    counting build, which is slower (atomics) and is not the main path.
    `pc` is a CompactCompressed (a PackedCompressed too on the CPU)."""
    org, d, tn, tf = _checked_inputs(pc, rays, t_in)
    R = tn.shape[0]
    if tn.device.type == "cpu":
        out = cbvh_plain(pc, Rays(org, d, tn, tf), stats=stats)
        return out if stats else out + (None,)
    lib = _load_kernel()
    dev = tn.device
    t = torch.empty(R, dtype=torch.float32, device=dev)
    u = torch.empty(R, dtype=torch.float32, device=dev)
    v = torch.empty(R, dtype=torch.float32, device=dev)
    tile = torch.empty(R, dtype=torch.int32, device=dev)
    next_ray = torch.zeros(1, dtype=torch.int64, device=dev)
    buf = _stat_buffers(pc, dev) if stats else (None, None, None)
    with torch.cuda.device(dev):
        err = lib.cbvh_launch(
            pc.topnodes.data_ptr(), pc.tiles.data_ptr(),
            pc.tile_of_leaf.data_ptr(), MODES.index(pc.mode), pc.comp_level,
            pc.tiles.shape[1], pc.top_depth,
            org.data_ptr(), d.data_ptr(), tn.data_ptr(), tf.data_ptr(), R,
            t.data_ptr(), u.data_ptr(), v.data_ptr(), tile.data_ptr(),
            next_ray.data_ptr(), _ptr(buf[0]), _ptr(buf[1]), _ptr(buf[2]),
            torch.cuda.current_stream().cuda_stream)
    launches["closest"] += 1
    _raise_on(lib, err, "closest-hit")
    if not stats:
        return t, u, v, tile, None
    return t, u, v, tile, _stats_dict(R, *buf[0].tolist(),
                                      buf[1].sum().item(),
                                      buf[2].sum().item())


def cbvh_occluded_trace(pc, rays: Rays, stats: bool = False):
    """One occlusion traversal: (occluded bool (R,), counters or None)."""
    org, d, tn, tf = _checked_inputs(pc, rays)
    R = tn.shape[0]
    if tn.device.type == "cpu":
        out = cbvh_occluded_plain(pc, Rays(org, d, tn, tf), stats=stats)
        return out if stats else (out, None)
    lib = _load_kernel()
    dev = tn.device
    occ = torch.empty(R, dtype=torch.bool, device=dev)
    buf = _stat_buffers(pc, dev) if stats else (None, None, None)
    with torch.cuda.device(dev):
        err = lib.cbvh_occluded_launch(
            pc.topnodes.data_ptr(), pc.top_depth, org.data_ptr(),
            d.data_ptr(), tn.data_ptr(), tf.data_ptr(), R, occ.data_ptr(),
            _ptr(buf[0]), _ptr(buf[1]),
            torch.cuda.current_stream().cuda_stream)
    launches["occluded"] += 1
    _raise_on(lib, err, "occlusion")
    if not stats:
        return occ, None
    return occ, _stats_dict(R, *buf[0].tolist(), buf[1].sum().item(), 0)


def intersect_compressed_kernel(pc, rays: Rays, t_in=None) -> _CHit:
    """Closest hit over the packed accel, flat over rays, uv remapped to
    patch space. `t_in` seeds the per-ray tfar."""
    t, u, v, tile, _ = cbvh_trace(pc, rays, t_in)
    u, v = cbvh.remap_uv(pc.uv0, pc.uvd, u, v, tile)
    return _CHit(t=t, u=u, v=v, tile=tile)


def occluded_compressed_kernel(pc, rays: Rays):
    """Conservative occlusion: bool tensor of the rays' batch shape."""
    occ, _ = cbvh_occluded_trace(pc, rays)
    return occ.reshape(rays.batch_shape)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _finish_stats(R, cnt):
    return _stats_dict(R, cnt["top_nodes"], cnt["tiles"], cnt["quad_nodes"],
                       cnt["leaves"], cnt["drops"],
                       cnt["node_touched"].sum().item(),
                       cnt["tile_touched"].sum().item())


def cbvh_plain(pc, rays: Rays, stats: bool = False):
    """The closest-hit kernel's function in plain PyTorch ops, float32, on
    whatever device the tensors lie: (t, tile-local u, tile-local v,
    tile), and the counters dict as a fifth value with `stats`."""
    org, d, tn, tf = _checked_inputs(pc, rays)
    dev = tn.device
    cnt = (cbvh.new_counters(pc.num_nodes, pc.num_tiles, dev) if stats
           else cbvh.new_counters())
    out = cbvh.walk_closest(_source(pc), org, d, tn, tf, cnt)
    return out + (_finish_stats(tn.shape[0], cnt),) if stats else out


def cbvh_occluded_plain(pc, rays: Rays, stats: bool = False):
    """The occlusion kernel's function in plain PyTorch ops: bool (R,),
    and the counters dict as a second value with `stats`."""
    org, d, tn, tf = _checked_inputs(pc, rays)
    dev = tn.device
    cnt = (cbvh.new_counters(pc.num_nodes, pc.num_tiles, dev) if stats
           else cbvh.new_counters())
    occ = cbvh.walk_occluded(_source(pc), org, d, tn, tf, cnt)
    return (occ, _finish_stats(tn.shape[0], cnt)) if stats else occ
