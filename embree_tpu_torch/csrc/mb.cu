// Motion-blur BVH4 traversal, one thread per ray at the ray's own time:
// closest hit (t, MB triangle index) or any hit (a bool) over the rows
// that traverse/mb_kernel.py::pack_mb lays out (node rows: child W,
// count W, per knot lo xyz / hi xyz W each, time gates 2W; triangle rows:
// v0 v1 v2 per knot; both padded to multiples of 128 floats).
//
// Replaces the Pallas kernel embree_tpu/traverse/pallas_mb.py::_mb_kernel
// (S, W, occluded). It keeps that kernel's function for a packet of one
// ray, not its schedule. Per ray:
//
//   time = clamp(time, 0, 1); x = time * (S - 1); seg = clamp(int(x), 0,
//     S - 2); w = x - seg;
//   the active knots, computed once: s with k1 >= time and k0 <= time,
//     k0 = (s - 1) / (S - 1) and k1 = (s + 1) / (S - 1) double quotients
//     rounded to float (the JAX package compares Python floats with a
//     float32 time); they form one range [s_lo, s_hi];
//   a private stack of node refs, the root first; a popped node's W
//     children in slot order: a child with count < 0 is skipped; the
//     others are slab-tested against the union of their active knot
//     boxes (entry scaled by 1 - 3*2^-23, exit by 1 + 3*2^-23, exit -inf
//     where the union is empty along x, entry clamped to tnear, hit when
//     tmin <= tmax and tmin <= t) and gated by time_lo <= time <= time_hi;
//     an inner child that passes is pushed, a leaf child that passes is
//     tested at once, so child c sees the t that the leaves of children
//     0..c-1 left, and children pop last slot first;
//   a leaf's triangles in order, each lerped between knots seg and seg+1
//     (v[seg] * (1 - w) + v[seg+1] * w) and put through the
//     precomputed-cross Moeller test; `t_s <= |den| * t` accepts, so a
//     later triangle at equal t wins;
//   an any-hit ray stops at its first hit; its answer is t == -inf, as
//     the JAX package reads its kernel's output.
//
// Not carried over, because they are the TPU kernel's schedule or its
// limits: the packets of 1,024 rays behind one stack, the row DMAs into
// scalar memory, the packet-wide time range, the unrolled S-way select
// of the segment, the cap of 4,096 pops a packet, the 96-deep stack that
// drops pushes silently and the cut of leaves beyond 8 triangles (the
// packer refuses such a leaf). The stack here holds (W - 1) * 64 + 1
// refs, what a tree of 64 levels can need; the wrapper refuses a deeper
// tree and the counting build counts dropped pushes all the same.
//
// What bounds it on an H100: operations, where the motion is large
// against the triangles. A node box is the union of the knot boxes of
// the ray's segment, so it holds the whole sweep of its triangles over
// the segment, and a ray that crosses a moving surface tests the
// triangles of every leaf whose sweep it crosses; each test lerps nine
// coordinates before the Moeller test. A node row's used part is 88
// floats at S = 3; a child reads 6 of them a knot, a triangle 18 floats
// of its row. The design spends nothing on that yet: rows are read
// through __ldg where they are used, the stack lives in local memory.
// Lerped node boxes, a compact layout, warp-wide traversal and ordering
// children by distance are later work (ROADMAP.md D). PERF.md has the
// measured times and the bound.
//
// Build with -fmad=false: the plain PyTorch version (traverse/mb.py::
// walk_mb) rounds every product before it is added, and the two are held
// equal bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_DEPTH = 64;   // deepest tree the compiled stack serves
constexpr int MAX_KNOTS = 65;
constexpr int THREADS = 128;

constexpr float ROBUST_MIN = static_cast<float>(1.0 - 3.0 / 8388608.0);
constexpr float ROBUST_MAX = static_cast<float>(1.0 + 3.0 / 8388608.0);

__device__ __forceinline__ float rcp_safe(float a) {
  return (fabsf(a) < 1e-30f) ? (a < 0.0f ? -1e30f : 1e30f) : 1.0f / a;
}

template <int W, bool OCCLUDED, bool STATS>
__global__ void __launch_bounds__(THREADS)
mb_kernel(const float* __restrict__ nodes, long long node_stride,
          const float* __restrict__ tris, long long tri_stride,
          const int* __restrict__ prim_order, int S,
          const float* __restrict__ org,      // (R, 3)
          const float* __restrict__ dir,      // (R, 3)
          const float* __restrict__ tnear,
          const float* __restrict__ tfar,
          const float* __restrict__ time, long long num_rays,
          float* __restrict__ t_out, int* __restrict__ prim_out,
          bool* __restrict__ occ_out,
          unsigned long long* __restrict__ stats,  // [5], STATS only
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

  const float tm = fminf(fmaxf(time[i], 0.0f), 1.0f);
  const float x = tm * static_cast<float>(S - 1);
  const int seg = min(max(static_cast<int>(x), 0), S - 2);
  const float wgt = x - static_cast<float>(seg);
  const float one_minus_w = 1.0f - wgt;
  int s_lo = S, s_hi = -1;
  for (int s = 0; s < S; ++s) {
    const float k0 = static_cast<float>(static_cast<double>(s - 1) /
                                        static_cast<double>(S - 1));
    const float k1 = static_cast<float>(static_cast<double>(s + 1) /
                                        static_cast<double>(S - 1));
    if (k1 >= tm && k0 <= tm) {
      s_lo = min(s_lo, s);
      s_hi = s;
    }
  }
  const unsigned nact = s_hi >= s_lo ? static_cast<unsigned>(s_hi - s_lo + 1)
                                     : 0u;
  const int tb = 2 * W + 6 * W * S;  // time gates in a node row

  float t = tfar[i];
  int prim = -1;
  unsigned n_nodes = 0, n_slabs = 0, n_knots = 0, n_tris = 0, n_drops = 0;

  int stack[STACK];
  int sp = 1;
  stack[0] = 0;  // root

  while (sp > 0) {
    const int node = stack[--sp];
    if (STATS) {
      n_nodes += 1;
      node_touched[node] = 1;
    }
    const float* row = nodes + static_cast<size_t>(node) * node_stride;
    bool stop = false;
#pragma unroll
    for (int c = 0; c < W; ++c) {
      // child and count are exact small floats in the row
      const int cnt = static_cast<int>(__ldg(row + W + c));
      if (cnt < 0) continue;
      if (STATS) {
        n_slabs += 1;
        n_knots += nact;
      }
      float lx = INFINITY, ly = INFINITY, lz = INFINITY;
      float hx = -INFINITY, hy = -INFINITY, hz = -INFINITY;
      for (int s = s_lo; s <= s_hi; ++s) {
        const float* b = row + 2 * W + 6 * W * s + c;
        lx = fminf(lx, __ldg(b + 0 * W));
        ly = fminf(ly, __ldg(b + 1 * W));
        lz = fminf(lz, __ldg(b + 2 * W));
        hx = fmaxf(hx, __ldg(b + 3 * W));
        hy = fmaxf(hy, __ldg(b + 4 * W));
        hz = fmaxf(hz, __ldg(b + 5 * W));
      }
      const float tx0 = lx * rdx - orx;
      const float tx1 = hx * rdx - orx;
      const float ty0 = ly * rdy - ory;
      const float ty1 = hy * rdy - ory;
      const float tz0 = lz * rdz - orz;
      const float tz1 = hz * rdz - orz;
      float tmin = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                         fminf(tz0, tz1)) * ROBUST_MIN;
      float tmax = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                         fmaxf(tz0, tz1)) * ROBUST_MAX;
      if (!(lx <= hx)) tmax = -INFINITY;
      tmin = fmaxf(tmin, tn);
      if (!((tmin <= tmax) && (tmin <= t))) continue;
      if (!((tm >= __ldg(row + tb + c)) && (tm <= __ldg(row + tb + W + c))))
        continue;
      const int cc = static_cast<int>(__ldg(row + c));
      if (cnt == 0) {
        if (sp < STACK) {
          stack[sp++] = cc;
        } else if (STATS) {
          // unreachable for a tree of at most MAX_DEPTH levels, which the
          // wrapper checks; counted all the same
          n_drops += 1;
        }
        continue;
      }
      // ---- leaf: triangles prim_order[cc .. cc + cnt - 1]
      for (int k = 0; k < cnt; ++k) {
        const int p = __ldg(prim_order + cc + k);
        if (STATS) {
          n_tris += 1;
          prim_touched[p] = 1;
        }
        const float* tr = tris + static_cast<size_t>(p) * tri_stride + 9 * seg;
        float v[9];
#pragma unroll
        for (int j = 0; j < 9; ++j)
          v[j] = __ldg(tr + j) * one_minus_w + __ldg(tr + 9 + j) * wgt;
        const float e1x = v[0] - v[3], e1y = v[1] - v[4], e1z = v[2] - v[5];
        const float e2x = v[6] - v[0], e2y = v[7] - v[1], e2z = v[8] - v[2];
        const float ngx = e2y * e1z - e2z * e1y;
        const float ngy = e2z * e1x - e2x * e1z;
        const float ngz = e2x * e1y - e2y * e1x;
        const float cx = v[0] - ox;
        const float cy = v[1] - oy;
        const float cz = v[2] - oz;
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
            stop = true;
            break;
          }
          t = t_s / fmaxf(absden, 1e-37f);
          prim = p;
        }
      }
      if (OCCLUDED && stop) break;
    }
    if (OCCLUDED && stop) break;
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
    atomicAdd(stats + 2, static_cast<unsigned long long>(n_knots));
    atomicAdd(stats + 3, static_cast<unsigned long long>(n_tris));
    atomicAdd(stats + 4, static_cast<unsigned long long>(n_drops));
  }
}

template <int W, bool OCCLUDED, bool STATS>
void launch(const float* nodes, long long node_stride, const float* tris,
            long long tri_stride, const int* prim_order, int S,
            const float* org, const float* dir, const float* tnear,
            const float* tfar, const float* time, long long num_rays,
            float* t_out, int* prim_out, bool* occ_out,
            unsigned long long* stats, int* node_touched, int* prim_touched,
            cudaStream_t stream) {
  const unsigned grid =
      static_cast<unsigned>((num_rays + THREADS - 1) / THREADS);
  mb_kernel<W, OCCLUDED, STATS><<<grid, THREADS, 0, stream>>>(
      nodes, node_stride, tris, tri_stride, prim_order, S, org, dir, tnear,
      tfar, time, num_rays, t_out, prim_out, occ_out, stats, node_touched,
      prim_touched);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched). Does
// not synchronise and allocates nothing. `width` must be 4 and `S` in
// 2..65. The closest-hit variant writes `t_out` and `prim_out`, the
// occlusion variant (`occluded` != 0) writes `occ_out` only. `stats`,
// `node_touched` and `prim_touched` are all null (the main path) or all
// device buffers (the counting build: nodes popped, child slab tests,
// knot boxes read, triangles tested, dropped pushes).
extern "C" int mb_launch(const float* nodes, long long node_stride,
                         const float* tris, long long tri_stride,
                         const int* prim_order, int S, int width,
                         const float* org, const float* dir,
                         const float* tnear, const float* tfar,
                         const float* time, long long num_rays, float* t_out,
                         int* prim_out, bool* occ_out, int occluded,
                         unsigned long long* stats, int* node_touched,
                         int* prim_touched, void* stream) {
  if (width != 4 || S < 2 || S > MAX_KNOTS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_rays <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int variant = (occluded ? 2 : 0) | (stats != nullptr ? 1 : 0);
#define MB_CASE(V, O, ST)                                                    \
  case V:                                                                    \
    launch<4, O, ST>(nodes, node_stride, tris, tri_stride, prim_order, S,    \
                     org, dir, tnear, tfar, time, num_rays, t_out, prim_out, \
                     occ_out, stats, node_touched, prim_touched, s);         \
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
