// Per-ray treelet traversal: closest hit (t, prim) or any hit over the
// two-level treelet scene that build/treelets.py packs.
//
// Replaces the Pallas kernel embree_tpu/traverse/rowtrace2.py::
// _rowtrace2_kernel together with its mid-mask prepass and its regroup
// loop. It computes the same function per ray, in the same visit order:
//
//   mids in ascending id, each slab-tested against the ray's live t;
//   the fan treelets of an entered mid in ascending id, their boxes
//     tested once against the t the ray has when it enters the mid;
//   inside a treelet, every node test prunes against the t at walk start
//     and only marks leaf pairs; the marked pairs then drain in ascending
//     pair id, triangle a before triangle b, against the live t;
//   a candidate with t_s <= |den| * t replaces the current hit, so the
//     visit order decides equal-t ties.
//
// None of the TPU schedule (consensus turns, row DMAs, regroup sorts,
// unrolls, iteration caps) exists here: one thread walks one ray, and
// blocks and boxes are read straight from device memory.
//
// What bounds it on an H100: of the two roofline terms, counted float32
// operations are the larger one at the 1M-triangle scene (the scan over
// every mid box costs a ray more slab tests than its node visits do);
// the bytes it must move are a quarter of that. It runs far from either:
// the block layout is still the 128-lane row layout of the JAX package
// (52 rows of 128 floats a treelet), so a thread's 12 loads of a node and
// 20 loads of a leaf pair are 4 bytes wide and 512 bytes apart, and the
// kernel waits on memory latency. The design keeps that layout on purpose,
// so that both packages walk the same bytes while parity is established;
// a layout made for the GPU, a top level over the mids, shared-memory
// staging and warp-level regrouping are later work.
//
// Build with -fmad=false: the plain PyTorch version rounds every product
// before it is added, and the two are held equal bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;
constexpr int NODE_ROWS = 12;
constexpr int LEAF_FIELDS = 20;
constexpr int BLOCK_ROWS = NODE_ROWS + 2 * LEAF_FIELDS;  // 52
constexpr int BLOCK_FLOATS = BLOCK_ROWS * LANES;
constexpr int L3_BASE = 21;
constexpr int THREADS = 128;

constexpr float ROBUST_MIN = static_cast<float>(1.0 - 3.0 / 8388608.0);
constexpr float ROBUST_MAX = static_cast<float>(1.0 + 3.0 / 8388608.0);

struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float rdx, rdy, rdz, orx, ory, orz;
  float tnear;
};

// stats build only: sums over rays
struct Counters {
  unsigned mids, treelets, nodes, pairs;
};

__device__ __forceinline__ float rcp_safe(float a) {
  return (fabsf(a) < 1e-30f) ? (a < 0.0f ? -1e30f : 1e30f) : 1.0f / a;
}

// One slab test for mid boxes, fan boxes and node children alike. An
// inverted box (lo > hi, the pad boxes) misses.
__device__ __forceinline__ bool slab_hit(float lox, float loy, float loz,
                                         float hix, float hiy, float hiz,
                                         const Ray& r, float tlimit) {
  const float tx0 = lox * r.rdx - r.orx;
  const float tx1 = hix * r.rdx - r.orx;
  const float ty0 = loy * r.rdy - r.ory;
  const float ty1 = hiy * r.rdy - r.ory;
  const float tz0 = loz * r.rdz - r.orz;
  const float tz1 = hiz * r.rdz - r.orz;
  float tmin = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                     fminf(tz0, tz1)) * ROBUST_MIN;
  float tmax = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                     fmaxf(tz0, tz1)) * ROBUST_MAX;
  if (!(lox <= hix)) tmax = -INFINITY;
  tmin = fmaxf(tmin, r.tnear);
  return (tmin <= tmax) && (tmin <= tlimit);
}

// Packed conservative-bf16 bounds: high 16 bits = lo bound, low 16 bits
// (shifted up) = hi bound.
__device__ __forceinline__ void unpack_bounds(float v, float& lo, float& hi) {
  const uint32_t bits = __float_as_uint(v);
  lo = __uint_as_float(bits & 0xFFFF0000u);
  hi = __uint_as_float(bits << 16);
}

// Slab-test the 4 children of inner slot `cur`; bit c of the result is
// child c. Row a*4+c holds axis a of child c, one lane per inner slot.
__device__ __forceinline__ unsigned node_nibble(const float* __restrict__ blk,
                                                int cur, const Ray& r,
                                                float t0) {
  unsigned nib = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float lox, hix, loy, hiy, loz, hiz;
    unpack_bounds(__ldg(blk + (0 * 4 + c) * LANES + cur), lox, hix);
    unpack_bounds(__ldg(blk + (1 * 4 + c) * LANES + cur), loy, hiy);
    unpack_bounds(__ldg(blk + (2 * 4 + c) * LANES + cur), loz, hiz);
    if (slab_hit(lox, loy, loz, hix, hiy, hiz, r, t0)) nib |= 1u << c;
  }
  return nib;
}

// Walk one treelet: implicit complete BVH4 of 85 inner slots (children of
// slot i at 4i+1..4i+4; slots >= 21 own leaf pairs 4(i-21)..+3), then the
// marked leaf pairs.
template <bool OCCLUDED, bool CULL, bool STATS>
__device__ __forceinline__ void walk(const float* __restrict__ blk,
                                     const Ray& r, float& t, int& prim,
                                     Counters& cnt) {
  const float t0 = t;
  uint64_t nm_lo = 0, nm_hi = 0;      // pending inner slots 1..84
  uint64_t pm[4] = {0, 0, 0, 0};      // marked leaf pairs 0..255

  nm_lo = static_cast<uint64_t>(node_nibble(blk, 0, r, t0)) << 1;
  if (STATS) cnt.nodes += 1;
  while (nm_lo | nm_hi) {
    int cur;
    if (nm_lo) {
      cur = __ffsll(static_cast<long long>(nm_lo)) - 1;
      nm_lo &= nm_lo - 1;
    } else {
      cur = 64 + __ffsll(static_cast<long long>(nm_hi)) - 1;
      nm_hi &= nm_hi - 1;
    }
    const uint64_t nib = node_nibble(blk, cur, r, t0);
    if (STATS) cnt.nodes += 1;
    if (cur < L3_BASE) {
      const int start = 4 * cur + 1;  // 5..81, may straddle bit 64
      if (start < 64) {
        nm_lo |= nib << start;
        if (start > 60) nm_hi |= nib >> (64 - start);
      } else {
        nm_hi |= nib << (start - 64);
      }
    } else {
      const int pidx = 4 * (cur - L3_BASE);  // multiple of 4: one word
      const uint64_t bits = nib << (pidx & 63);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (k == (pidx >> 6)) pm[k] |= bits;
    }
  }

#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint64_t m = pm[k];
    while (m) {
      const int p = k * 64 + __ffsll(static_cast<long long>(m)) - 1;
      m &= m - 1;
      if (STATS) cnt.pairs += 1;
      // pairs 0..127 in rows 12..31, pairs 128..255 in rows 32..51;
      // fields: v0 e1 e2 of triangle a (9), of triangle b (9), pid a, pid b
      const float* f =
          blk + (NODE_ROWS + (p >> 7) * LEAF_FIELDS) * LANES + (p & 127);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float* g = f + q * 9 * LANES;
        const float v0x = __ldg(g + 0 * LANES);
        const float v0y = __ldg(g + 1 * LANES);
        const float v0z = __ldg(g + 2 * LANES);
        const float e1x = __ldg(g + 3 * LANES);
        const float e1y = __ldg(g + 4 * LANES);
        const float e1z = __ldg(g + 5 * LANES);
        const float e2x = __ldg(g + 6 * LANES);
        const float e2y = __ldg(g + 7 * LANES);
        const float e2z = __ldg(g + 8 * LANES);
        const float ngx = e2y * e1z - e2z * e1y;
        const float ngy = e2z * e1x - e2x * e1z;
        const float ngz = e2x * e1y - e2y * e1x;
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
        const bool front = CULL ? (den < 0.0f) : (den != 0.0f);
        // pad prims have e1 = e2 = 0, so den = 0 and they never hit
        const bool ok = front && (u_s >= 0.0f) && (v_s >= 0.0f) &&
                        (u_s + v_s <= absden) && (absden * r.tnear < t_s) &&
                        (t_s <= absden * t);
        if (ok) {
          if (OCCLUDED) {
            t = -INFINITY;
            return;
          }
          t = t_s / fmaxf(absden, 1e-37f);
          // prim ids are int32 bit patterns inside the f32 planes
          prim = __float_as_int(__ldg(f + (18 + q) * LANES));
        }
      }
    }
  }
}

template <bool OCCLUDED, bool CULL, bool STATS>
__global__ void __launch_bounds__(THREADS)
rowtrace2_kernel(const float* __restrict__ blocks,
                 const float* __restrict__ tre_boxes,  // (M, 6, 128)
                 const float* __restrict__ mid_boxes,  // (M, 6)
                 int fan, int num_mids,
                 const float* __restrict__ org,        // (R, 3)
                 const float* __restrict__ dir,        // (R, 3)
                 const float* __restrict__ tnear,
                 const float* __restrict__ tfar, long long num_rays,
                 float* __restrict__ t_out, int* __restrict__ prim_out,
                 unsigned long long* __restrict__ stats,  // [4], STATS only
                 int* __restrict__ touched) {  // [num_treelets], STATS only
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

  float t = tfar[i];
  int prim = -1;
  Counters cnt = {0, 0, 0, 0};
  bool done = false;

  for (int m = 0; m < num_mids && !done; ++m) {
    const float* mb = mid_boxes + 6 * m;
    if (!slab_hit(__ldg(mb + 0), __ldg(mb + 1), __ldg(mb + 2), __ldg(mb + 3),
                  __ldg(mb + 4), __ldg(mb + 5), r, t))
      continue;
    if (STATS) cnt.mids += 1;

    // seed the fan mask once, against the t the ray enters the mid with
    const float* tb = tre_boxes + static_cast<size_t>(m) * 6 * LANES;
    uint32_t fm[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      uint32_t word = 0;
      const int nb = min(32, fan - 32 * w);
      for (int j = 0; j < nb; ++j) {
        const int b = 32 * w + j;
        if (slab_hit(__ldg(tb + 0 * LANES + b), __ldg(tb + 1 * LANES + b),
                     __ldg(tb + 2 * LANES + b), __ldg(tb + 3 * LANES + b),
                     __ldg(tb + 4 * LANES + b), __ldg(tb + 5 * LANES + b), r,
                     t))
          word |= 1u << j;
      }
      fm[w] = word;
    }

#pragma unroll
    for (int w = 0; w < 4; ++w) {
      uint32_t word = fm[w];
      while (word && !done) {
        const int b = 32 * w + __ffs(static_cast<int>(word)) - 1;
        word &= word - 1;
        const size_t tid = static_cast<size_t>(m) * fan + b;
        if (STATS) {
          cnt.treelets += 1;
          touched[tid] = 1;
        }
        walk<OCCLUDED, CULL, STATS>(blocks + tid * BLOCK_FLOATS, r, t, prim,
                                    cnt);
        if (OCCLUDED && t == -INFINITY) done = true;
      }
    }
  }

  if (!OCCLUDED && prim < 0) t = tfar[i];
  t_out[i] = t;
  prim_out[i] = prim;
  if (STATS) {
    atomicAdd(stats + 0, static_cast<unsigned long long>(cnt.mids));
    atomicAdd(stats + 1, static_cast<unsigned long long>(cnt.treelets));
    atomicAdd(stats + 2, static_cast<unsigned long long>(cnt.nodes));
    atomicAdd(stats + 3, static_cast<unsigned long long>(cnt.pairs));
  }
}

template <bool OCCLUDED, bool CULL, bool STATS>
void launch(const float* blocks, const float* tre_boxes,
            const float* mid_boxes, int fan, int num_mids, const float* org,
            const float* dir, const float* tnear, const float* tfar,
            long long num_rays, float* t_out, int* prim_out,
            unsigned long long* stats, int* touched, cudaStream_t stream) {
  const unsigned grid =
      static_cast<unsigned>((num_rays + THREADS - 1) / THREADS);
  rowtrace2_kernel<OCCLUDED, CULL, STATS><<<grid, THREADS, 0, stream>>>(
      blocks, tre_boxes, mid_boxes, fan, num_mids, org, dir, tnear, tfar,
      num_rays, t_out, prim_out, stats, touched);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched). Does
// not synchronise and allocates nothing. `stats` and `touched` are either
// both null (the main path) or both device buffers (the counting build).
extern "C" int rowtrace2_launch(const float* blocks, const float* tre_boxes,
                                const float* mid_boxes, int fan, int num_mids,
                                const float* org, const float* dir,
                                const float* tnear, const float* tfar,
                                long long num_rays, float* t_out,
                                int* prim_out, int occluded, int cull,
                                unsigned long long* stats, int* touched,
                                void* stream) {
  if (num_rays <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int variant =
      (occluded ? 4 : 0) | (cull ? 2 : 0) | (stats != nullptr ? 1 : 0);
#define ROWTRACE2_CASE(V, O, C, S)                                          \
  case V:                                                                   \
    launch<O, C, S>(blocks, tre_boxes, mid_boxes, fan, num_mids, org, dir,  \
                    tnear, tfar, num_rays, t_out, prim_out, stats, touched, \
                    s);                                                     \
    break;
  switch (variant) {
    ROWTRACE2_CASE(0, false, false, false)
    ROWTRACE2_CASE(1, false, false, true)
    ROWTRACE2_CASE(2, false, true, false)
    ROWTRACE2_CASE(3, false, true, true)
    ROWTRACE2_CASE(4, true, false, false)
    ROWTRACE2_CASE(5, true, false, true)
    ROWTRACE2_CASE(6, true, true, false)
    ROWTRACE2_CASE(7, true, true, true)
  }
#undef ROWTRACE2_CASE
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rowtrace2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
