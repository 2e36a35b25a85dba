"""Two-level treelet decomposition for the per-ray traversal kernel.

Copy (numpy) of embree_tpu/build/treelets.py's host build, byte-equal to
the JAX package's blocks (`TreeletSceneNP`). Every ray traverses
independently (single-ray BVH traversal, bvh_intersector1.cpp). The
blocks keep the 128-lane rows the JAX package chose for its per-lane
gathers; `compact_treelets` rewrites them into the records the CUDA
kernel reads with 16-byte loads (`TreeletScene`, the one form on the
device):

  scene
   └─ mids   (≤ 256): union boxes of FAN consecutive treelets;
   └─ treelets (mid*FAN + b): ≤ 512 prims each, laid out as an IMPLICIT
      complete BVH4 — 85 inner slots (children of i = 4i+1) over 256
      leaf-pair slots (L3 node i∈[21,85) has pairs 4(i-21)+{0..3}).
      Leaf slots inline TWO precomputed-Moeller triangles (v0/e1/e2,
      triangle_intersector_moeller.h:75-112 layout; Ng is recomputed
      in-kernel from e1×e2) plus their global prim ids — no separate
      prim table, so the per-lane fetch is a single gather per field.

Treelet membership comes from cutting the binary SAH tree (build/sah.py)
at subtrees with ≤ P_CAP prims, so treelet quality is SAH quality; the
interior quartering rides the SAH prim order. All arrays are built
vectorized over every treelet at once (host numpy, commit-time).

Block layout per treelet, f32 (BLOCK_ROWS=52, 128) rows:
  rows 0..11   packed CONSERVATIVE-bf16 node bounds, lanes 0..84:
               row a*4+c holds, per inner slot, (lo rounded down,
               hi rounded up) of axis a child c as two bf16 halves of
               one f32 lane (hi16 = lo bound, lo16 = hi bound) — the
               QuantizedNode analog (bvh.h:1150-1324): halves both the
               node-row DMA bytes and the per-visit gather count.
  rows 12..31  leaf chunk 0 (pairs 0..127), 20 fields:
               v0a/e1a/e2a (9), v0b/e1b/e2b (9), pid_a, pid_b
  rows 32..51  leaf chunk 1 (pairs 128..255), same 20 fields.
Prim ids are stored as int32 BIT PATTERNS in the f32 planes.

Compact form (`compact_treelets`, every word the block word it came from):
  nodes     (Ntr_pad, 85, 12) f32  an inner slot's 12 packed-bf16 words,
            word a*4+c = axis a of child c: three float4s (x, y, z of the
            four children), 48 B a record
  pairs     (Ntr_pad, 256, 20) f32  a leaf pair's 20 fields in block
            order (v0a e1a e2a, v0b e1b e2b, pid_a, pid_b): five float4s
  fan_boxes (Ntr_pad, 8) f32  a treelet's box [lo3 hi3 0 0]: one 32-B
            sector, a mid's fan one after another
  mid_boxes (M, 8) f32  [lo3 hi3 0 0]
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.profile import profile_phase

N_INNER = 85           # 1 + 4 + 16 + 64 implicit inner slots
N_PAIRS = 256          # leaf-pair slots (2 chunks of 128)
P_CAP = 2 * N_PAIRS    # prims per treelet
L3_BASE = 21           # first L3 inner slot
NODE_ROWS = 12         # packed-bf16 bound rows (2 fields per row)
LEAF_FIELDS = 20       # per-chunk leaf rows
BLOCK_ROWS = NODE_ROWS + 2 * LEAF_FIELDS   # 52
BOX_WORDS = 8          # floats of a compact fan or mid box: lo3 hi3 0 0


class TreeletScene(NamedTuple):
    """Device-side treelet scene in its compact form (`compact_treelets`):
    torch tensors + static ints."""

    nodes: torch.Tensor       # (Ntr_pad, N_INNER, NODE_ROWS) f32
    pairs: torch.Tensor       # (Ntr_pad, N_PAIRS, LEAF_FIELDS) f32
    fan_boxes: torch.Tensor   # (Ntr_pad, BOX_WORDS) f32 [lo3 hi3 0 0]
    mid_boxes: torch.Tensor   # (M, BOX_WORDS) f32 [lo3 hi3 0 0]
    fan: int
    num_mids: int
    num_treelets: int
    num_prims: int

    @property
    def device_bytes(self) -> int:
        return sum(a.numel() * a.element_size()
                   for a in (self.nodes, self.pairs, self.fan_boxes,
                             self.mid_boxes))

    @property
    def hbm_bytes(self) -> int:
        """Bytes of the JAX package's treelet blocks for these treelets:
        (Ntr_pad, BLOCK_ROWS, 128) f32."""
        return 4 * self.nodes.shape[0] * BLOCK_ROWS * 128


def _box_rows(boxes: np.ndarray) -> np.ndarray:
    """(n, 6) boxes [lo3 hi3] as (n, BOX_WORDS) rows with zero pads."""
    out = np.zeros((boxes.shape[0], BOX_WORDS), np.float32)
    out[:, :6] = boxes
    return out


def compact_treelets(blocks, mid_boxes, tre_boxes, fan: int) -> dict:
    """The JAX package's treelet arrays (`TreeletSceneNP`'s blocks, mid
    boxes (M, 6) and per-mid treelet planes (M, 6, 128)) as the compact
    numpy arrays `TreeletScene` holds. Every word is the word it came
    from, bit for bit."""
    blocks = np.asarray(blocks, np.float32)
    tre_boxes = np.asarray(tre_boxes, np.float32)
    M = tre_boxes.shape[0]
    nodes = blocks[:, :NODE_ROWS, :N_INNER].transpose(0, 2, 1)
    chunks = [blocks[:, NODE_ROWS + k * LEAF_FIELDS:
                     NODE_ROWS + (k + 1) * LEAF_FIELDS, :].transpose(0, 2, 1)
              for k in (0, 1)]
    fan_boxes = tre_boxes[:, :, :fan].transpose(0, 2, 1).reshape(M * fan, 6)
    return {"nodes": np.ascontiguousarray(nodes),
            "pairs": np.ascontiguousarray(np.concatenate(chunks, axis=1)),
            "fan_boxes": _box_rows(fan_boxes),
            "mid_boxes": _box_rows(np.asarray(mid_boxes,
                                              np.float32).reshape(M, 6))}


class TreeletSceneNP(NamedTuple):
    """Host-side build output."""

    blocks: np.ndarray       # (Ntr_pad, BLOCK_ROWS, 128) f32 treelet blocks
    mid_boxes: np.ndarray    # (M, 6) f32 [lo3 hi3]
    tre_boxes: np.ndarray    # (M, 6, 128) f32 per-mid treelet plane rows
    fan: int
    num_mids: int
    num_treelets: int
    num_prims: int

    def to_device(self, device) -> TreeletScene:
        """The compact form (`compact_treelets`) on `device`."""
        device = torch.device(device)
        arrs = compact_treelets(self.blocks, self.mid_boxes, self.tre_boxes,
                                self.fan)
        return TreeletScene(
            **{k: torch.from_numpy(v).to(device) for k, v in arrs.items()},
            fan=self.fan, num_mids=self.num_mids,
            num_treelets=self.num_treelets, num_prims=self.num_prims)


def choose_fan(num_prims: int) -> int:
    """Pick FAN (treelets per mid) so the mid count stays small enough
    for the per-ray mid scan (~150 boxes) while FAN stays <= 128 lanes."""
    est_treelets = max(1, num_prims // 300)
    return int(min(128, max(8, -(-est_treelets // 150))))


def pack_bf16_bounds(lo, hi):
    """Pack conservative bf16 bounds into one f32 bit pattern per value
    pair: hi 16 bits = lo bound rounded DOWN to bf16, lo 16 bits = hi
    bound rounded UP. Directed rounding keeps the slab test conservative
    (no missed hits, only extra visits) — the QuantizedNode floor/ceil
    correction (bvh.h:1220-1274) expressed as bf16 truncation."""
    lob = np.ascontiguousarray(lo, np.float32).view(np.uint32)
    hib = np.ascontiguousarray(hi, np.float32).view(np.uint32)
    lo_t = lob & np.uint32(0xFFFF0000)
    bump = ((lob & np.uint32(0xFFFF)) != 0) & ((lob >> 31) == 1)
    lo_t = np.where(bump, lo_t + np.uint32(0x10000), lo_t)  # toward -inf
    hi_t = hib & np.uint32(0xFFFF0000)
    bumph = ((hib & np.uint32(0xFFFF)) != 0) & ((hib >> 31) == 0)
    hi_t = np.where(bumph, hi_t + np.uint32(0x10000), hi_t)  # toward +inf
    packed = lo_t | (hi_t >> np.uint32(16))
    return packed.view(np.float32)


def _morton_np(c, lo, hi):
    """30-bit morton codes of points c within [lo, hi] (numpy)."""
    q = np.clip((c - lo) / np.maximum(hi - lo, 1e-20) * 1023.0,
                0, 1023).astype(np.uint64)
    out = np.zeros(c.shape[0], np.uint64)
    for a in range(3):
        v = q[:, a]
        v = (v | (v << 16)) & np.uint64(0x030000FF)
        v = (v | (v << 8)) & np.uint64(0x0300F00F)
        v = (v | (v << 4)) & np.uint64(0x030C30C3)
        v = (v | (v << 2)) & np.uint64(0x09249249)
        out |= v << np.uint64(a)
    return out


def _cut_ranges_native(prim_lower, prim_upper):
    """Fast path: cut the NATIVE C++ SAH builder's BVH4 (children always
    index past their parent; subtree prim ranges are contiguous)."""
    from .native import build_sah_native

    b = build_sah_native(prim_lower, prim_upper, branching=4, max_leaf=16)
    if b is None:
        return None
    ch = np.asarray(b.child, np.int64)
    cnt = np.asarray(b.count, np.int64)
    order = np.asarray(b.prim_order, np.int64)
    M = ch.shape[0]
    BIG = np.int64(1) << 62
    ncount = np.zeros(M, np.int64)
    nstart = np.full(M, BIG)
    # leaf slots' ch encodes prim starts (can exceed M): clamp for the
    # gathers; the where() only uses node-slot values
    chs = np.clip(ch, 0, M - 1)
    for _ in range(80):   # converges in tree-depth passes (children > parent)
        cc = np.where(cnt > 0, cnt, ncount[chs])
        cc = np.where(cnt >= 0, cc, 0)
        new_c = cc.sum(1)
        ss = np.where(cnt > 0, ch, nstart[chs])
        ss = np.where(cnt >= 0, ss, BIG)
        new_s = ss.min(1)
        if np.array_equal(new_c, ncount) and np.array_equal(new_s, nstart):
            break
        ncount, nstart = new_c, new_s

    ranges = []
    stack = [0]
    while stack:
        i = stack.pop()
        if ncount[i] <= P_CAP:
            ranges.append((int(nstart[i]), int(ncount[i])))
            continue
        for c in range(ch.shape[1]):
            if cnt[i, c] > 0:
                ranges.append((int(ch[i, c]), int(cnt[i, c])))
            elif cnt[i, c] == 0:
                j = int(ch[i, c])
                if ncount[j] <= P_CAP:
                    ranges.append((int(nstart[j]), int(ncount[j])))
                else:
                    stack.append(j)
    ranges.sort()
    return np.asarray(ranges, np.int64), order


def _cut_ranges(prim_lower, prim_upper):
    """SAH-cut treelet prim ranges: cut the SAH tree at subtrees with
    count <= P_CAP (contiguous ranges of the builder's reordered prim
    array). Native C++ builder when available; python BVH2 fallback."""
    from .sah import BuildSettings, build_bvh2

    n = prim_lower.shape[0]
    if n <= P_CAP:
        return np.asarray([[0, n]], np.int64), np.arange(n, dtype=np.int64)
    fast = _cut_ranges_native(prim_lower, prim_upper)
    if fast is not None:
        return fast
    child2, _nlo2, _nhi2, order, root_ref, leaf_mult = build_bvh2(
        prim_lower, prim_upper, BuildSettings(max_leaf_size=64))
    ranges = []

    def leaf_range(ref):
        v = -(ref + 1)
        return int(v // leaf_mult), int(v % leaf_mult)

    # iterative walk: cut when subtree count <= P_CAP. Subtree ranges are
    # contiguous by construction (in-place partition builder).
    def subtree_range(ref):
        # (start, count) via leftmost/rightmost descent
        lo_ref = ref
        while lo_ref >= 0:
            lo_ref = child2[lo_ref, 0]
        start = leaf_range(lo_ref)[0]
        hi_ref = ref
        while hi_ref >= 0:
            hi_ref = child2[hi_ref, 1]
        s, c = leaf_range(hi_ref)
        return start, s + c - start

    # compute counts bottom-up without recursion: nodes are created
    # parent-before-child, so a reverse sweep sees children first
    n2 = child2.shape[0]
    counts = np.zeros(n2, np.int64)
    for i in range(n2 - 1, -1, -1):
        c = 0
        for k in (0, 1):
            r = child2[i, k]
            if r >= 0:
                c += counts[r]
            else:
                c += leaf_range(r)[1]
        counts[i] = c

    stack = [root_ref]
    while stack:
        ref = stack.pop()
        if ref < 0:
            s, c = leaf_range(ref)
            ranges.append((s, c))
            continue
        if counts[ref] <= P_CAP:
            s, c = subtree_range(ref)
            ranges.append((s, c))
            continue
        stack.append(child2[ref, 0])
        stack.append(child2[ref, 1])
    ranges.sort()
    return np.asarray(ranges, np.int64), order


def build_treelet_scene(v0, v1, v2, prim_ids, fan: int = 40) -> TreeletSceneNP:
    """Build the full two-level treelet scene from host triangle arrays.

    prim_ids: (T,) global prim ids carried into leaf slots (original
    scene prim numbering, so hits need no remap)."""
    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    T = v0.shape[0]
    lo = np.minimum(np.minimum(v0, v1), v2)
    hi = np.maximum(np.maximum(v0, v1), v2)

    with profile_phase("treelets.cut_ranges"):
        ranges, order = _cut_ranges(lo, hi)
    # intra-treelet spatial order (morton) so leaf-pairing and the
    # implicit quartering see coherent prims (the coarse SAH cut leaves
    # the within-leaf order arbitrary)
    cent = 0.5 * (lo + hi)
    code = _morton_np(cent[order], cent.min(0), cent.max(0))
    tre_of = np.zeros(T, np.int64)
    for t, (s, c) in enumerate(ranges):
        tre_of[s:s + c] = t
    perm = np.lexsort((code, tre_of))
    order = order[perm]

    Ntr = ranges.shape[0]
    M = -(-Ntr // fan)
    Ntr_pad = M * fan

    # gather prims per treelet into an (Ntr_pad, P_CAP) id grid (-1 = pad)
    grid = np.full((Ntr_pad, P_CAP), -1, np.int64)
    for t, (s, c) in enumerate(ranges):
        grid[t, :c] = order[s:s + c]
    gv = grid.reshape(-1)
    pad = gv < 0
    gsafe = np.where(pad, 0, gv)

    def take(a, fill):
        out = a[gsafe].astype(np.float32)
        out[pad] = fill
        return out.reshape(Ntr_pad, P_CAP, -1)

    tv0 = take(v0, np.nan)
    tv1 = take(v1, np.nan)
    tv2 = take(v2, np.nan)
    tlo = take(lo, np.inf)
    thi = take(hi, -np.inf)
    # global prim ids as int32 BIT PATTERNS in the f32 block planes
    # (bitcast back in the kernel) — exact for any id, unlike f32 values
    # which corrupt ids above 2^24 (ADVICE round 2)
    tpid = np.where(pad, -1,
                    prim_ids[gsafe]).astype(np.int32).reshape(Ntr_pad, P_CAP)

    # --- implicit complete BVH4 bounds (vectorized over all treelets) ---
    pair_lo = tlo.reshape(Ntr_pad, N_PAIRS, 2, 3).min(2)   # (N,256,3)
    pair_hi = thi.reshape(Ntr_pad, N_PAIRS, 2, 3).max(2)
    # L3: 64 nodes, children = pairs 4j+{0..3}
    l3_lo = pair_lo.reshape(Ntr_pad, 64, 4, 3)
    l3_hi = pair_hi.reshape(Ntr_pad, 64, 4, 3)
    lvl_lo = [l3_lo]
    lvl_hi = [l3_hi]
    for sz in (16, 4, 1):   # L2, L1, L0
        cl = lvl_lo[-1].min(2).reshape(Ntr_pad, sz, 4, 3)
        ch = lvl_hi[-1].max(2).reshape(Ntr_pad, sz, 4, 3)
        lvl_lo.append(cl)
        lvl_hi.append(ch)
    node_lo = np.concatenate([lvl_lo[3], lvl_lo[2], lvl_lo[1], lvl_lo[0]],
                             axis=1)  # (N, 85, 4, 3) order L0,L1,L2,L3
    node_hi = np.concatenate([lvl_hi[3], lvl_hi[2], lvl_hi[1], lvl_hi[0]],
                             axis=1)

    # --- block packing ---
    blocks = np.zeros((Ntr_pad, BLOCK_ROWS, 128), np.float32)
    # rows 0..11: packed conservative-bf16 node bounds at lanes 0..84
    for a in range(3):
        for c in range(4):
            blocks[:, a * 4 + c, :N_INNER] = pack_bf16_bounds(
                node_lo[:, :, c, a], node_hi[:, :, c, a])
    # leaf chunks: 20 fields each (Ng is recomputed in-kernel from e1/e2)
    e1a = tv0 - tv1
    e2a = tv2 - tv0
    trif = np.concatenate([tv0, e1a, e2a], axis=-1)  # (N, P_CAP, 9)
    trif = np.nan_to_num(trif, nan=0.0)
    # degenerate pad prims: e1=e2=0 -> Ng=0 -> den=0 -> never hits
    pairs = trif.reshape(Ntr_pad, N_PAIRS, 2, 9)
    for ck, sl in ((0, slice(0, 128)), (1, slice(128, 256))):
        base = NODE_ROWS + ck * LEAF_FIELDS
        for f in range(9):
            blocks[:, base + f, :] = pairs[:, sl, 0, f]
            blocks[:, base + 9 + f, :] = pairs[:, sl, 1, f]
    pidp = tpid.reshape(Ntr_pad, N_PAIRS, 2)
    for ck, sl in ((0, slice(0, 128)), (1, slice(128, 256))):
        base = NODE_ROWS + ck * LEAF_FIELDS
        blocks[:, base + 18, :] = pidp[:, sl, 0].view(np.float32)
        blocks[:, base + 19, :] = pidp[:, sl, 1].view(np.float32)

    # --- treelet root boxes + mid boxes (exact f32, pre-quantization) ---
    t_lo = node_lo.reshape(Ntr_pad, -1, 3).min(1)
    t_hi = node_hi.reshape(Ntr_pad, -1, 3).max(1)
    t_lo = np.where(np.isfinite(t_lo), t_lo, np.inf)
    t_hi = np.where(np.isfinite(t_hi), t_hi, -np.inf)
    mid_lo = t_lo.reshape(M, fan, 3).min(1)
    mid_hi = t_hi.reshape(M, fan, 3).max(1)
    mid_boxes = np.concatenate([mid_lo, mid_hi], axis=1).astype(np.float32)

    # fan-padded to 128 lanes (the JAX package's layout); pad boxes are +inf/-inf so they never become candidates
    tre_boxes = np.empty((M, 6, 128), np.float32)
    tre_boxes[:, :3, :] = np.inf
    tre_boxes[:, 3:, :] = -np.inf
    tb = np.concatenate([t_lo, t_hi], axis=1)  # (Ntr_pad, 6)
    tre_boxes[:, :, :fan] = tb.reshape(M, fan, 6).transpose(0, 2, 1)

    return TreeletSceneNP(blocks=blocks, mid_boxes=mid_boxes,
                          tre_boxes=tre_boxes, fan=fan, num_mids=M,
                          num_treelets=Ntr_pad, num_prims=T)
