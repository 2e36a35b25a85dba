// BVH4 / BVH8 traversal, one thread per ray: closest hit (t, prim in BVH
// order) or any hit (t = -inf) over the packed scene that
// traverse/packet_kernel.py::pack_scene lays out (node rows of 128 floats
// with 8 stride-W fields, leaf rows of 10 x [v0 e1 e2 Ng]).
//
// Replaces the Pallas kernel embree_tpu/traverse/pallas_packet.py::
// _traversal_kernel_v3. It keeps that kernel's function per ray, not its
// schedule. Per ray:
//
//   a private stack of (ref, entry distance), the root first;
//   a popped entry is skipped when its entry distance exceeds the ray's
//     current t;
//   a node's W children are slab-tested in slot order (robust slab test,
//     entry scaled by 1 - 3*2^-23 and exit by 1 + 3*2^-23, entry clamped
//     to tnear, accepted when tmin <= tmax and tmin <= t); the children
//     that are hit, inner nodes and leaves alike, are pushed far to near
//     by the ray's own entry distance, so the nearest pops first; among
//     equal distances the lower slot pops first;
//   a leaf's triangles (at most 8, contiguous in BVH order, possibly over
//     two leaf rows) are tested in slot order with the precomputed
//     Moeller test; `t_s <= |den| * t` accepts, so a later candidate at
//     equal t replaces an earlier one;
//   with masks, a hit stands only where (prim_mask[p] & ray_mask) != 0;
//   any-hit rays stop at their first hit and write no prim.
//
// A ray with tfar = -inf costs one node visit: the root's children all
// fail `tmin <= t`.
//
// The shared stack of a packet of rays, the K-wide pops, the row DMAs and
// the pop-cull over the packet's largest t are how the TPU kernel copes
// with a machine that cannot load at a per-lane address; none of it
// exists here. The order of visits therefore depends on the ray alone.
//
// What bounds it on an H100: bytes. A ray visits about five nodes and
// tests about one triangle, so the 40 bytes a ray brings and takes away
// outweigh both the rows it touches and its float32 operations. The
// kernel runs at a few percent of that bound: it waits on the latency of
// dependent loads (pop -> node row -> child row) and loses lanes to
// divergence inside a warp. The design spends nothing on that yet: the
// used part of a BVH4 node row is one 128-byte line read as eight
// float4s, a triangle is three float4s, the stack lives in local memory
// (1.5 KB a thread for BVH4, 3.5 KB for BVH8). Warp-wide packets, a
// shared-memory stack and a layout without the 384 unused bytes of a
// node row are later work. PERF.md has the measured times and the bound.
//
// Build with -fmad=false: the plain PyTorch version rounds every product
// before it is added, and the two are held equal bit for bit.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int ROW = 128;           // floats in a node row and in a leaf row
constexpr int TRIS_PER_ROW = 10;
constexpr int TRI_FLOATS = 12;     // v0 e1 e2 Ng
constexpr int MAX_LEAF = 8;
constexpr int MAX_DEPTH = 64;      // deepest tree the compiled stack serves
constexpr int THREADS = 128;
constexpr int SENT = INT_MIN;      // "child not pushed"

constexpr float ROBUST_MIN = static_cast<float>(1.0 - 3.0 / 8388608.0);
constexpr float ROBUST_MAX = static_cast<float>(1.0 + 3.0 / 8388608.0);

struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float rdx, rdy, rdz, orx, ory, orz;
  float tnear;
};

__device__ __forceinline__ float rcp_safe(float a) {
  return (fabsf(a) < 1e-30f) ? (a < 0.0f ? -1e30f : 1e30f) : 1.0f / a;
}

template <int W, bool OCCLUDED, bool STATS>
__global__ void __launch_bounds__(THREADS)
packet_kernel(const float* __restrict__ nodes,     // (M, 128)
              const float* __restrict__ tdata,     // (rows, 128)
              const int* __restrict__ prim_mask,   // (T,) BVH order or null
              const int* __restrict__ ray_mask,    // (R,) or null
              int cull,
              const float* __restrict__ org,       // (R, 3)
              const float* __restrict__ dir,       // (R, 3)
              const float* __restrict__ tnear,
              const float* __restrict__ tfar, long long num_rays,
              float* __restrict__ t_out, int* __restrict__ prim_out,
              unsigned long long* __restrict__ stats,  // [4], STATS only
              int* __restrict__ node_touched,      // [M], STATS only
              int* __restrict__ row_touched) {     // [rows], STATS only
  constexpr int STACK = (W - 1) * MAX_DEPTH + 1;
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= num_rays) return;

  Ray r;
  r.ox = org[3 * i + 0];
  r.oy = org[3 * i + 1];
  r.oz = org[3 * i + 2];
  r.dx = dir[3 * i + 0];
  r.dy = dir[3 * i + 1];
  r.dz = dir[3 * i + 2];
  r.rdx = rcp_safe(r.dx);
  r.rdy = rcp_safe(r.dy);
  r.rdz = rcp_safe(r.dz);
  r.orx = r.ox * r.rdx;
  r.ory = r.oy * r.rdy;
  r.orz = r.oz * r.rdz;
  r.tnear = tnear[i];
  const int rmask = ray_mask != nullptr ? ray_mask[i] : -1;

  float t = tfar[i];
  int prim = -1;
  unsigned n_nodes = 0, n_leaves = 0, n_tris = 0, n_drops = 0;

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
      // ---- inner node: the used part of the row is 8 * W floats
      if (STATS) {
        n_nodes += 1;
        node_touched[ref] = 1;
      }
      const float4* row =
          reinterpret_cast<const float4*>(nodes + static_cast<size_t>(ref) * ROW);
      float f[8 * W];
#pragma unroll
      for (int q = 0; q < 2 * W; ++q) {
        const float4 v = __ldg(row + q);
        f[4 * q + 0] = v.x;
        f[4 * q + 1] = v.y;
        f[4 * q + 2] = v.z;
        f[4 * q + 3] = v.w;
      }
      // candidates in DESCENDING slot order, so that the stable sort
      // below leaves the higher slot first among equal distances and
      // the lower slot on top of the stack
      float key[W];
      int cref[W];
#pragma unroll
      for (int c = 0; c < W; ++c) {
        const float tx0 = f[0 * W + c] * r.rdx - r.orx;
        const float tx1 = f[3 * W + c] * r.rdx - r.orx;
        const float ty0 = f[1 * W + c] * r.rdy - r.ory;
        const float ty1 = f[4 * W + c] * r.rdy - r.ory;
        const float tz0 = f[2 * W + c] * r.rdz - r.orz;
        const float tz1 = f[5 * W + c] * r.rdz - r.orz;
        float tmin = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                           fminf(tz0, tz1)) * ROBUST_MIN;
        const float tmax = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                                 fmaxf(tz0, tz1)) * ROBUST_MAX;
        tmin = fmaxf(tmin, r.tnear);
        // child and count are exact small floats in the row
        const int cc = static_cast<int>(f[6 * W + c]);
        const int cnt = static_cast<int>(f[7 * W + c]);
        const bool ok = (tmin <= tmax) && (tmin <= t) && (cnt >= 0);
        key[W - 1 - c] = ok ? tmin : -INFINITY;
        cref[W - 1 - c] =
            ok ? (cnt > 0 ? -(((cc << 4) | cnt) + 1) : cc) : SENT;
      }
      // stable bubble network, far to near
#pragma unroll
      for (int a = 0; a < W - 1; ++a) {
#pragma unroll
        for (int b = 0; b < W - 1 - a; ++b) {
          if (key[b] < key[b + 1]) {
            const float kt = key[b];
            key[b] = key[b + 1];
            key[b + 1] = kt;
            const int rt = cref[b];
            cref[b] = cref[b + 1];
            cref[b + 1] = rt;
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
      // ---- leaf: triangles start .. start + cnt - 1 in BVH order
      const int v = -ref - 1;
      const int start = v >> 4;
      const int cnt = min(v & 15, MAX_LEAF);
      if (STATS) n_leaves += 1;
      for (int k = 0; k < cnt; ++k) {
        const int p = start + k;
        const int trow = p / TRIS_PER_ROW;
        if (STATS) {
          n_tris += 1;
          row_touched[trow] = 1;
        }
        const float4* g = reinterpret_cast<const float4*>(
            tdata + static_cast<size_t>(trow) * ROW +
            (p - trow * TRIS_PER_ROW) * TRI_FLOATS);
        const float4 a = __ldg(g + 0);
        const float4 b = __ldg(g + 1);
        const float4 c = __ldg(g + 2);
        const float v0x = a.x, v0y = a.y, v0z = a.z;
        const float e1x = a.w, e1y = b.x, e1z = b.y;
        const float e2x = b.z, e2y = b.w, e2z = c.x;
        const float ngx = c.y, ngy = c.z, ngz = c.w;
        const float cx = v0x - r.ox;
        const float cy = v0y - r.oy;
        const float cz = v0z - r.oz;
        const float rx = cy * r.dz - cz * r.dy;
        const float ry = cz * r.dx - cx * r.dz;
        const float rz = cx * r.dy - cy * r.dx;
        const float den = ngx * r.dx + ngy * r.dy + ngz * r.dz;
        const float absden = fabsf(den);
        const float sgn = den >= 0.0f ? 1.0f : -1.0f;
        const float u_s = (rx * e2x + ry * e2y + rz * e2z) * sgn;
        const float v_s = (rx * e1x + ry * e1y + rz * e1z) * sgn;
        const float t_s = (ngx * cx + ngy * cy + ngz * cz) * sgn;
        const bool front = cull ? (den < 0.0f) : (den != 0.0f);
        // pad triangles are all zero, so den = 0 and they never hit
        bool ok = front && (u_s >= 0.0f) && (v_s >= 0.0f) &&
                  (u_s + v_s <= absden) && (absden * r.tnear < t_s) &&
                  (t_s <= absden * t);
        if (ok && prim_mask != nullptr) ok = (__ldg(prim_mask + p) & rmask) != 0;
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

  t_out[i] = t;
  prim_out[i] = prim;
  if (STATS) {
    atomicAdd(stats + 0, static_cast<unsigned long long>(n_nodes));
    atomicAdd(stats + 1, static_cast<unsigned long long>(n_tris));
    atomicAdd(stats + 2, static_cast<unsigned long long>(n_drops));
    atomicAdd(stats + 3, static_cast<unsigned long long>(n_leaves));
  }
}

template <int W, bool OCCLUDED, bool STATS>
void launch(const float* nodes, const float* tdata, const int* prim_mask,
            const int* ray_mask, int cull, const float* org, const float* dir,
            const float* tnear, const float* tfar, long long num_rays,
            float* t_out, int* prim_out, unsigned long long* stats,
            int* node_touched, int* row_touched, cudaStream_t stream) {
  const unsigned grid =
      static_cast<unsigned>((num_rays + THREADS - 1) / THREADS);
  packet_kernel<W, OCCLUDED, STATS><<<grid, THREADS, 0, stream>>>(
      nodes, tdata, prim_mask, ray_mask, cull, org, dir, tnear, tfar,
      num_rays, t_out, prim_out, stats, node_touched, row_touched);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched). Does
// not synchronise and allocates nothing. `width` is 4 or 8. `prim_mask` and
// `ray_mask` are both null (no masks) or both device buffers. `stats`,
// `node_touched` and `row_touched` are all null (the main path) or all
// device buffers (the counting build).
extern "C" int packet_launch(const float* nodes, const float* tdata,
                             int width, const int* prim_mask,
                             const int* ray_mask, const float* org,
                             const float* dir, const float* tnear,
                             const float* tfar, long long num_rays,
                             float* t_out, int* prim_out, int occluded,
                             int cull, unsigned long long* stats,
                             int* node_touched, int* row_touched,
                             void* stream) {
  if (width != 4 && width != 8) return static_cast<int>(cudaErrorInvalidValue);
  if (num_rays <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int variant = (width == 8 ? 4 : 0) | (occluded ? 2 : 0) |
                      (stats != nullptr ? 1 : 0);
#define PACKET_CASE(V, W, O, S)                                              \
  case V:                                                                    \
    launch<W, O, S>(nodes, tdata, prim_mask, ray_mask, cull, org, dir,       \
                    tnear, tfar, num_rays, t_out, prim_out, stats,           \
                    node_touched, row_touched, s);                           \
    break;
  switch (variant) {
    PACKET_CASE(0, 4, false, false)
    PACKET_CASE(1, 4, false, true)
    PACKET_CASE(2, 4, true, false)
    PACKET_CASE(3, 4, true, true)
    PACKET_CASE(4, 8, false, false)
    PACKET_CASE(5, 8, false, true)
    PACKET_CASE(6, 8, true, false)
    PACKET_CASE(7, 8, true, true)
  }
#undef PACKET_CASE
  return static_cast<int>(cudaGetLastError());
}

// The deepest tree (levels of nodes, the root being level 1) that the
// compiled stack serves without dropping a push.
extern "C" int packet_max_depth(void) { return MAX_DEPTH; }

extern "C" const char* packet_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
