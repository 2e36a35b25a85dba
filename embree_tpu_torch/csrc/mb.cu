// Motion-blur BVH4 traversal, one thread per ray at the ray's own time:
// closest hit (t, MB triangle index) or any hit (a bool) over the compact
// rows of traverse/mb_kernel.py::compact_rows (node rows: child W,
// count W, per knot lo xyz / hi xyz W each, time gates 2W, 4W + 6WS
// floats; triangle rows: v0 v1 v2 and three zero pads per knot, 12S
// floats, so that a knot is three float4s).
//
// Replaces the Pallas kernel embree_tpu/traverse/pallas_mb.py::_mb_kernel
// (S, W, occluded). It keeps that kernel's function for a packet of one
// ray, not its schedule, and walks the tree as kernel B2 does
// (csrc/packet.cu). Per ray:
//
//   time = clamp(time, 0, 1), a NaN staying NaN (torch.clamp's rule);
//     x = time * (S - 1); seg = clamp(int(x), 0, S - 2) (0 for a NaN);
//     w = x - seg;
//   a private stack of (ref, entry distance), the root first; a popped
//     entry is skipped when its entry distance exceeds the ray's t;
//   a popped node's W children in slot order: a child with count < 0 is
//     skipped; the others are slab-tested against their box LERPED to
//     the ray's time, box[seg] * (1 - w) + box[seg + 1] * w (the linear
//     bounds of Embree's AlignedNodeMB), with the robust slab test (entry
//     scaled by 1 - 3*2^-23, exit by 1 + 3*2^-23, entry clamped to
//     tnear; min and max propagate NaN, as torch.minimum / maximum do),
//     and gated by time_lo <= time <= time_hi; the children that pass,
//     inner nodes and leaves alike, are pushed far to near by their
//     entry distance, the lower slot on top among equal distances;
//   a popped leaf's triangles in order, each lerped between knots seg and
//     seg + 1 (v[seg] * (1 - w) + v[seg + 1] * w) and put through the
//     precomputed-cross Moeller test; `t_s <= |den| * t` accepts, so a
//     later triangle at equal t wins;
//   an any-hit ray stops at its first hit; its answer is t == -inf, as
//     the JAX package reads its kernel's output.
//
// The box lerp is the vertex lerp, the same expression in the same order
// with the same w and 1 - w. Rounding is monotone (a <= b gives
// round(a * c) <= round(b * c) for c >= 0, and round(a + b) <= round(c +
// d) for a <= c, b <= d), so a knot box that holds a triangle's vertices
// at both knots holds the lerped vertices exactly, in floats: the lerped
// box never loses a hit. Every triangle of the accel is linear between
// the common knots by construction (the scene resamples each geometry's
// motion onto the common grid, chorded where its knots do not land on
// it, and the walk tests that resampled motion), and the refit bounds at
// each knot hold it there, so no accel needs the union of knot boxes.
// A NaN time fails every time gate and misses; +-Inf clamp to 1 and 0.
//
// Not carried over, because they are the TPU kernel's schedule or its
// limits: the packets of 1,024 rays behind one stack, the row DMAs into
// scalar memory, the packet-wide time range and the union of the knot
// boxes it activates, the unrolled S-way select of the segment, the cap
// of 4,096 pops a packet, the 96-deep stack that drops pushes silently
// and the cut of leaves beyond 8 triangles (the packer refuses such a
// leaf). The stack here holds (W - 1) * 64 + 1 entries, what a tree of 64
// levels can need; the wrapper refuses a deeper tree and the counting
// build counts dropped pushes all the same.
//
// What bounds it on an H100: bytes, as for kernel B2. A node visit reads
// 16 floats of header and gates and two knot boxes of 24 floats; a
// triangle test reads six float4s. The walk pays the latency of dependent
// loads (pop -> node row -> child row) and divergence inside a warp;
// warp-wide traversal is later work. PERF.md has the measured times and
// the bound.
//
// Build with -fmad=false: the plain PyTorch version (traverse/mb.py::
// walk_mb) rounds every product before it is added, and the two are held
// equal bit for bit, counters included.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_DEPTH = 64;   // deepest tree the compiled stack serves
constexpr int MAX_KNOTS = 65;
constexpr int MAX_LEAF = 8;
constexpr int THREADS = 128;
constexpr int SENT = INT_MIN;   // "child not pushed"
constexpr int TRI_KNOT = 12;    // floats of one knot in a triangle row

constexpr float ROBUST_MIN = static_cast<float>(1.0 - 3.0 / 8388608.0);
constexpr float ROBUST_MAX = static_cast<float>(1.0 + 3.0 / 8388608.0);

__device__ __forceinline__ float rcp_safe(float a) {
  return (fabsf(a) < 1e-30f) ? (a < 0.0f ? -1e30f : 1e30f) : 1.0f / a;
}

// min / max that return NaN when either argument is NaN
// (torch.minimum / torch.maximum), unlike fminf / fmaxf; one PTX
// instruction on the card, a portable form in a host compiler's pass
__device__ __forceinline__ float minp(float a, float b) {
#if defined(__CUDA_ARCH__)
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return (a != a || b != b) ? a + b : fminf(a, b);
#endif
}

__device__ __forceinline__ float maxp(float a, float b) {
#if defined(__CUDA_ARCH__)
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return (a != a || b != b) ? a + b : fmaxf(a, b);
#endif
}

template <int W, bool OCCLUDED, bool STATS>
__global__ void __launch_bounds__(THREADS)
mb_kernel(const float* __restrict__ nodes, long long node_stride,
          const float* __restrict__ tris,
          const int* __restrict__ prim_order, int S,
          const float* __restrict__ org,      // (R, 3)
          const float* __restrict__ dir,      // (R, 3)
          const float* __restrict__ tnear,
          const float* __restrict__ tfar,
          const float* __restrict__ time, long long num_rays,
          float* __restrict__ t_out, int* __restrict__ prim_out,
          bool* __restrict__ occ_out,
          unsigned long long* __restrict__ stats,  // [4], STATS only
          int* __restrict__ node_touched,          // [M], STATS only
          int* __restrict__ prim_touched) {        // [T], STATS only
  constexpr int STACK = (W - 1) * MAX_DEPTH + 1;
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= num_rays) return;

  const float ox = org[3 * i + 0], oy = org[3 * i + 1], oz = org[3 * i + 2];
  const float dx = dir[3 * i + 0], dy = dir[3 * i + 1], dz = dir[3 * i + 2];
  const float rdx = rcp_safe(dx), rdy = rcp_safe(dy), rdz = rcp_safe(dz);
  const float orx = ox * rdx, ory = oy * rdy, orz = oz * rdz;
  const float tn = tnear[i];

  const float t_raw = time[i];
  const float tm = (t_raw != t_raw) ? t_raw : fminf(fmaxf(t_raw, 0.0f), 1.0f);
  const float x = tm * static_cast<float>(S - 1);
  const int seg = (x >= 0.0f) ? min(static_cast<int>(x), S - 2) : 0;
  const float wgt = x - static_cast<float>(seg);
  const float one_minus_w = 1.0f - wgt;
  const long long tb = 2 * W + 6 * W * S;   // time gates in a node row
  const long long kb = 2 * W + 6 * W * seg; // knot seg's boxes
  const int tri_ofs = TRI_KNOT * seg;
  const int tri_stride = TRI_KNOT * S;

  float t = tfar[i];
  int prim = -1;
  unsigned n_nodes = 0, n_slabs = 0, n_tris = 0, n_drops = 0;

  int sref[STACK];
  float sdist[STACK];
  int sp = 1;
  sref[0] = 0;  // root
  sdist[0] = -INFINITY;

  while (sp > 0) {
    --sp;
    const int ref = sref[sp];
    if (sdist[sp] > t) continue;

    if (ref >= 0) {
      // ---- inner node: header, gates and the boxes of knots seg, seg+1
      if (STATS) {
        n_nodes += 1;
        node_touched[ref] = 1;
      }
      const float* row = nodes + static_cast<size_t>(ref) * node_stride;
      const float4 ch4 = __ldg(reinterpret_cast<const float4*>(row));
      const float4 cn4 = __ldg(reinterpret_cast<const float4*>(row + W));
      const float4 lo4 = __ldg(reinterpret_cast<const float4*>(row + tb));
      const float4 hi4 = __ldg(reinterpret_cast<const float4*>(row + tb + W));
      const float ch[4] = {ch4.x, ch4.y, ch4.z, ch4.w};
      const float cn[4] = {cn4.x, cn4.y, cn4.z, cn4.w};
      const float glo[4] = {lo4.x, lo4.y, lo4.z, lo4.w};
      const float ghi[4] = {hi4.x, hi4.y, hi4.z, hi4.w};
      // box component k (lo x y z, hi x y z) of the W children, lerped
      float b[6][4];
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(
            row + kb + k * W));
        const float4 c = __ldg(reinterpret_cast<const float4*>(
            row + kb + 6 * W + k * W));
        b[k][0] = a.x * one_minus_w + c.x * wgt;
        b[k][1] = a.y * one_minus_w + c.y * wgt;
        b[k][2] = a.z * one_minus_w + c.z * wgt;
        b[k][3] = a.w * one_minus_w + c.w * wgt;
      }
      // candidates in DESCENDING slot order, so that the stable sort
      // below leaves the higher slot first among equal distances and
      // the lower slot on top of the stack
      float key[W];
      int cref[W];
#pragma unroll
      for (int c = 0; c < W; ++c) {
        // child and count are exact small floats in the row
        const int cc = static_cast<int>(ch[c]);
        const int cnt = static_cast<int>(cn[c]);
        key[W - 1 - c] = -INFINITY;
        cref[W - 1 - c] = SENT;
        if (cnt < 0) continue;
        if (STATS) n_slabs += 1;
        const float tx0 = b[0][c] * rdx - orx;
        const float tx1 = b[3][c] * rdx - orx;
        const float ty0 = b[1][c] * rdy - ory;
        const float ty1 = b[4][c] * rdy - ory;
        const float tz0 = b[2][c] * rdz - orz;
        const float tz1 = b[5][c] * rdz - orz;
        float tmin = maxp(maxp(minp(tx0, tx1), minp(ty0, ty1)),
                          minp(tz0, tz1)) * ROBUST_MIN;
        const float tmax = minp(minp(maxp(tx0, tx1), maxp(ty0, ty1)),
                                maxp(tz0, tz1)) * ROBUST_MAX;
        tmin = maxp(tmin, tn);
        const bool ok = (tmin <= tmax) && (tmin <= t) && (tm >= glo[c]) &&
                        (tm <= ghi[c]);
        if (ok) {
          key[W - 1 - c] = tmin;
          cref[W - 1 - c] = cnt > 0 ? -(((cc << 4) | cnt) + 1) : cc;
        }
      }
      // stable bubble network, far to near
#pragma unroll
      for (int a = 0; a < W - 1; ++a) {
#pragma unroll
        for (int q = 0; q < W - 1 - a; ++q) {
          if (key[q] < key[q + 1]) {
            const float kt = key[q];
            key[q] = key[q + 1];
            key[q + 1] = kt;
            const int rt = cref[q];
            cref[q] = cref[q + 1];
            cref[q + 1] = rt;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < W; ++k) {
        if (cref[k] != SENT) {
          if (sp < STACK) {
            sref[sp] = cref[k];
            sdist[sp] = key[k];
            ++sp;
          } else if (STATS) {
            // unreachable for a tree of at most MAX_DEPTH levels, which
            // the wrapper checks; counted all the same
            n_drops += 1;
          }
        }
      }
    } else {
      // ---- leaf: triangles prim_order[start .. start + cnt - 1]
      const int v = -ref - 1;
      const int start = v >> 4;
      const int cnt = min(v & 15, MAX_LEAF);
      for (int k = 0; k < cnt; ++k) {
        const int p = __ldg(prim_order + start + k);
        if (STATS) {
          n_tris += 1;
          prim_touched[p] = 1;
        }
        const float4* tr = reinterpret_cast<const float4*>(
            tris + static_cast<size_t>(p) * tri_stride + tri_ofs);
        const float4 a0 = __ldg(tr + 0), a1 = __ldg(tr + 1), a2 = __ldg(tr + 2);
        const float4 c0 = __ldg(tr + 3), c1 = __ldg(tr + 4), c2 = __ldg(tr + 5);
        const float v0x = a0.x * one_minus_w + c0.x * wgt;
        const float v0y = a0.y * one_minus_w + c0.y * wgt;
        const float v0z = a0.z * one_minus_w + c0.z * wgt;
        const float v1x = a0.w * one_minus_w + c0.w * wgt;
        const float v1y = a1.x * one_minus_w + c1.x * wgt;
        const float v1z = a1.y * one_minus_w + c1.y * wgt;
        const float v2x = a1.z * one_minus_w + c1.z * wgt;
        const float v2y = a1.w * one_minus_w + c1.w * wgt;
        const float v2z = a2.x * one_minus_w + c2.x * wgt;
        const float e1x = v0x - v1x, e1y = v0y - v1y, e1z = v0z - v1z;
        const float e2x = v2x - v0x, e2y = v2y - v0y, e2z = v2z - v0z;
        const float ngx = e2y * e1z - e2z * e1y;
        const float ngy = e2z * e1x - e2x * e1z;
        const float ngz = e2x * e1y - e2y * e1x;
        const float cx = v0x - ox;
        const float cy = v0y - oy;
        const float cz = v0z - oz;
        const float rx = cy * dz - cz * dy;
        const float ry = cz * dx - cx * dz;
        const float rz = cx * dy - cy * dx;
        const float den = ngx * dx + ngy * dy + ngz * dz;
        const float absden = fabsf(den);
        const float sgn = den >= 0.0f ? 1.0f : -1.0f;
        const float u_s = (rx * e2x + ry * e2y + rz * e2z) * sgn;
        const float v_s = (rx * e1x + ry * e1y + rz * e1z) * sgn;
        const float t_s = (ngx * cx + ngy * cy + ngz * cz) * sgn;
        const bool ok = (den != 0.0f) && (u_s >= 0.0f) && (v_s >= 0.0f) &&
                        (u_s + v_s <= absden) && (absden * tn < t_s) &&
                        (t_s <= absden * t);
        if (ok) {
          if (OCCLUDED) {
            t = -INFINITY;
            sp = 0;
            break;
          }
          t = t_s / fmaxf(absden, 1e-37f);
          prim = p;
        }
      }
    }
  }

  if (OCCLUDED) {
    occ_out[i] = (t == -INFINITY);
  } else {
    t_out[i] = t;
    prim_out[i] = prim;
  }
  if (STATS) {
    atomicAdd(stats + 0, static_cast<unsigned long long>(n_nodes));
    atomicAdd(stats + 1, static_cast<unsigned long long>(n_slabs));
    atomicAdd(stats + 2, static_cast<unsigned long long>(n_tris));
    atomicAdd(stats + 3, static_cast<unsigned long long>(n_drops));
  }
}

template <int W, bool OCCLUDED, bool STATS>
void launch(const float* nodes, long long node_stride, const float* tris,
            const int* prim_order, int S, const float* org, const float* dir,
            const float* tnear, const float* tfar, const float* time,
            long long num_rays, float* t_out, int* prim_out, bool* occ_out,
            unsigned long long* stats, int* node_touched, int* prim_touched,
            cudaStream_t stream) {
  const unsigned grid =
      static_cast<unsigned>((num_rays + THREADS - 1) / THREADS);
  mb_kernel<W, OCCLUDED, STATS><<<grid, THREADS, 0, stream>>>(
      nodes, node_stride, tris, prim_order, S, org, dir, tnear, tfar, time,
      num_rays, t_out, prim_out, occ_out, stats, node_touched, prim_touched);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched). Does
// not synchronise and allocates nothing. `width` must be 4, `S` in 2..65,
// `node_stride` the node rows' width (4 * width + 6 * width * S) and
// triangle rows 12 * S floats wide. The closest-hit variant writes
// `t_out` and `prim_out`, the occlusion variant (`occluded` != 0)
// writes `occ_out` only. `stats`, `node_touched` and `prim_touched` are
// all null (the main path) or all device buffers (the counting build:
// nodes popped, child slab tests, triangles tested, dropped pushes).
extern "C" int mb_launch(const float* nodes, long long node_stride,
                         const float* tris, const int* prim_order, int S,
                         int width, const float* org, const float* dir,
                         const float* tnear, const float* tfar,
                         const float* time, long long num_rays, float* t_out,
                         int* prim_out, bool* occ_out, int occluded,
                         unsigned long long* stats, int* node_touched,
                         int* prim_touched, void* stream) {
  if (width != 4 || S < 2 || S > MAX_KNOTS ||
      node_stride != 4 * width + 6 * width * S)
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_rays <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int variant = (occluded ? 2 : 0) | (stats != nullptr ? 1 : 0);
#define MB_CASE(V, O, ST)                                                    \
  case V:                                                                    \
    launch<4, O, ST>(nodes, node_stride, tris, prim_order, S, org, dir,      \
                     tnear, tfar, time, num_rays, t_out, prim_out, occ_out,  \
                     stats, node_touched, prim_touched, s);                  \
    break;
  switch (variant) {
    MB_CASE(0, false, false)
    MB_CASE(1, false, true)
    MB_CASE(2, true, false)
    MB_CASE(3, true, true)
  }
#undef MB_CASE
  return static_cast<int>(cudaGetLastError());
}

// The deepest tree (levels of nodes, the root being level 1) that the
// compiled stack serves without dropping a push.
extern "C" int mb_max_depth(void) { return MAX_DEPTH; }

extern "C" const char* mb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
