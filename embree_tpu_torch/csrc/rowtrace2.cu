// Per-ray treelet traversal: closest hit (t, prim) or any hit over the
// compact treelet scene of build/treelets.py::compact_treelets.
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
// unrolls, iteration caps) exists here: one thread walks one ray.
//
// What bounds it on an H100: of the two roofline terms, counted float32
// operations are the larger one at the 1M-triangle scene (the scan over
// every mid box costs a ray more slab tests than its node visits do);
// the bytes it must move are a quarter of that. Divergence keeps a
// per-ray walk far from both: had the threads of a warp looped over the
// mids in step, a warp would enter ~56 distinct mids of 181 with a lane or
// two busy each, and run that lane's fan tests and walks while the others
// wait. The design:
//
//   * a thread moves through its own candidate mids (the boxes its line
//     meets, from one scan), testing each at its live t when it gets
//     there; the warp tests the fan boxes of an entering ray a lane a box
//     and votes the mask; the walks of different mids run side by side;
//   * every record is read with 16-byte loads: a node (the 12 packed
//     bf16 words of an inner slot, x y z of its four children) is three
//     float4s in two sectors, a leaf pair (two Moeller triangles and both
//     prim ids) five float4s, a fan box two float4s in one sector; the
//     JAX package's 128-lane rows put each of those words 512 bytes from
//     the next, one sector a word;
//   * the mid boxes, which every ray scans, are staged once per block in
//     shared memory, MID_CHUNK at a time (8 KB), so the scan that sets the
//     operations bound reads no device memory.
//
// Slab tests use PTX min.NaN / max.NaN, as the plain version's
// torch.minimum / maximum keep a NaN that fminf / fmaxf drop: the answer
// on a NaN lane is a miss either way, and the two also count the same
// visits there.
//
// Build with -fmad=false: the plain PyTorch version rounds every product
// before it is added, and the two are held equal bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int N_INNER = 85;
constexpr int N_PAIRS = 256;
constexpr int NODE_VEC = 3;        // float4s of a node record (12 words)
constexpr int PAIR_VEC = 5;        // float4s of a leaf-pair record
constexpr int BOX_VEC = 2;         // float4s of a fan or mid box
constexpr int L3_BASE = 21;
constexpr int THREADS = 128;       // threads a block
constexpr int MID_CHUNK = 256;     // mid boxes staged in shared memory
constexpr int GEO_WORDS = MID_CHUNK / 32;
constexpr unsigned FULL_MASK = 0xFFFFFFFFu;

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

// min / max that return NaN when either argument is NaN, as the plain
// version's torch.minimum / maximum do; one PTX instruction on the card,
// a portable form in a host compiler's pass
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
  float tmin = maxp(maxp(minp(tx0, tx1), minp(ty0, ty1)), minp(tz0, tz1)) *
               ROBUST_MIN;
  float tmax = minp(minp(maxp(tx0, tx1), maxp(ty0, ty1)), maxp(tz0, tz1)) *
               ROBUST_MAX;
  if (!(lox <= hix)) tmax = -INFINITY;
  tmin = maxp(tmin, r.tnear);
  return (tmin <= tmax) && (tmin <= tlimit);
}

// A box of the compact form: lo x y z, hi x y z, two pads.
__device__ __forceinline__ bool box_hit(float4 a, float4 b, const Ray& r,
                                        float tlimit) {
  return slab_hit(a.x, a.y, a.z, a.w, b.x, b.y, r, tlimit);
}

// Packed conservative-bf16 bounds: high 16 bits = lo bound, low 16 bits
// (shifted up) = hi bound.
__device__ __forceinline__ void unpack_bounds(float v, float& lo, float& hi) {
  const uint32_t bits = __float_as_uint(v);
  lo = __uint_as_float(bits & 0xFFFF0000u);
  hi = __uint_as_float(bits << 16);
}

__device__ __forceinline__ bool child_hit(float x, float y, float z,
                                          const Ray& r, float t0) {
  float lox, hix, loy, hiy, loz, hiz;
  unpack_bounds(x, lox, hix);
  unpack_bounds(y, loy, hiy);
  unpack_bounds(z, loz, hiz);
  return slab_hit(lox, loy, loz, hix, hiy, hiz, r, t0);
}

// Slab-test the 4 children of one inner slot's record (x, y, z of the
// four children, three float4s); bit c of the result is child c.
__device__ __forceinline__ unsigned node_nibble(const float4* __restrict__ rec,
                                                const Ray& r, float t0) {
  const float4 x = __ldg(rec + 0);
  const float4 y = __ldg(rec + 1);
  const float4 z = __ldg(rec + 2);
  return (child_hit(x.x, y.x, z.x, r, t0) ? 1u : 0u) |
         (child_hit(x.y, y.y, z.y, r, t0) ? 2u : 0u) |
         (child_hit(x.z, y.z, z.z, r, t0) ? 4u : 0u) |
         (child_hit(x.w, y.w, z.w, r, t0) ? 8u : 0u);
}

// Moeller test of one precomputed triangle (v0, e1, e2 at f[0..8]); on a
// hit lowers t (closest) or sets it to -inf (any hit).
template <bool OCCLUDED, bool CULL>
__device__ __forceinline__ bool tri_test(const float* f, const Ray& r,
                                         float& t) {
  const float v0x = f[0], v0y = f[1], v0z = f[2];
  const float e1x = f[3], e1y = f[4], e1z = f[5];
  const float e2x = f[6], e2y = f[7], e2z = f[8];
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
  if (ok) t = OCCLUDED ? -INFINITY : t_s / fmaxf(absden, 1e-37f);
  return ok;
}

// Walk one treelet: implicit complete BVH4 of 85 inner slots (children of
// slot i at 4i+1..4i+4; slots >= 21 own leaf pairs 4(i-21)..+3), then the
// marked leaf pairs.
template <bool OCCLUDED, bool CULL, bool STATS>
__device__ __forceinline__ void walk(const float4* __restrict__ nodes,
                                     const float4* __restrict__ pairs,
                                     const Ray& r, float& t, int& prim,
                                     Counters& cnt) {
  const float t0 = t;
  uint64_t nm_lo = 0, nm_hi = 0;      // pending inner slots 1..84
  uint64_t pm[4] = {0, 0, 0, 0};      // marked leaf pairs 0..255

  nm_lo = static_cast<uint64_t>(node_nibble(nodes, r, t0)) << 1;
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
    const uint64_t nib = node_nibble(nodes + cur * NODE_VEC, r, t0);
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
      // v0 e1 e2 of triangle a (9), of triangle b (9), pid a, pid b
      const float4* pr = pairs + p * PAIR_VEC;
      float f[20];
#pragma unroll
      for (int q = 0; q < PAIR_VEC; ++q) {
        const float4 w = __ldg(pr + q);
        f[4 * q + 0] = w.x;
        f[4 * q + 1] = w.y;
        f[4 * q + 2] = w.z;
        f[4 * q + 3] = w.w;
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (tri_test<OCCLUDED, CULL>(f + 9 * q, r, t)) {
          if (OCCLUDED) return;
          // prim ids are int32 bit patterns among the floats
          prim = __float_as_int(f[18 + q]);
        }
      }
    }
  }
}

// The mids of a chunk whose box the ray's line meets (tmin <= tmax):
// the only ones it can enter, whatever its t. Bit j of word w is mid
// 32 w + j of the chunk.
__device__ __forceinline__ void geo_mask(const float4* smid, int nm,
                                         const Ray& r, uint32_t* geo) {
#pragma unroll
  for (int w = 0; w < GEO_WORDS; ++w) {
    uint32_t word = 0;
    const int n = min(32, nm - 32 * w);
    for (int b = 0; b < n; ++b) {
      const int j = 32 * w + b;
      if (box_hit(smid[BOX_VEC * j], smid[BOX_VEC * j + 1], r, INFINITY))
        word |= 1u << b;
    }
    geo[w] = word;
  }
}

// Take the lowest set bit of the mask: its index, or -1 when it is empty.
__device__ __forceinline__ int pop_lowest(uint32_t* geo) {
#pragma unroll
  for (int w = 0; w < GEO_WORDS; ++w) {
    if (geo[w]) {
      const int b = __ffs(static_cast<int>(geo[w])) - 1;
      geo[w] &= geo[w] - 1;
      return 32 * w + b;
    }
  }
  return -1;
}

// One thread walks one ray; the warp keeps its threads busy together. A
// thread whose fan mask is drained moves on to the next mid it enters
// (the next of its candidate mids, in ascending id, whose box it hits at
// its live t); then every thread that entered a mid gets its fan mask,
// the warp testing one such ray's fan boxes at a time, a lane a box, with
// the ray's t at entry; then every thread with a marked treelet walks the
// next one. So the walks of different mids run side by side, where a
// loop over mids in step would walk them one after another with a lane
// or two busy, and a ray still visits what it visited, in its order.
template <bool OCCLUDED, bool CULL, bool STATS>
__global__ void __launch_bounds__(THREADS)
rowtrace2_kernel(const float4* __restrict__ nodes,      // (N, 85, 3) float4
                 const float4* __restrict__ pairs,      // (N, 256, 5) float4
                 const float4* __restrict__ fan_boxes,  // (N, 2) float4
                 const float4* __restrict__ mid_boxes,  // (M, 2) float4
                 int fan, int num_mids,
                 const float* __restrict__ org,         // (R, 3)
                 const float* __restrict__ dir,         // (R, 3)
                 const float* __restrict__ tnear,
                 const float* __restrict__ tfar, long long num_rays,
                 float* __restrict__ t_out, int* __restrict__ prim_out,
                 unsigned long long* __restrict__ stats,  // [4], STATS only
                 int* __restrict__ touched) {  // [num_treelets], STATS only
  extern __shared__ float4 smid[];  // min(num_mids, MID_CHUNK) boxes
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  // every thread of the block stages mid boxes and takes part in its
  // warp's votes; a thread without a ray walks nothing
  const bool live = i < num_rays;

  Ray r = {};
  float t = 0.0f;
  if (live) {
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
    t = tfar[i];
  }
  int prim = -1;
  Counters cnt = {0, 0, 0, 0};
  bool done = !live;

  for (int base = 0; base < num_mids; base += MID_CHUNK) {
    const int nm = min(MID_CHUNK, num_mids - base);
    __syncthreads();  // the previous chunk is no longer read
    for (int k = threadIdx.x; k < BOX_VEC * nm; k += blockDim.x)
      smid[k] = __ldg(mid_boxes + BOX_VEC * base + k);
    __syncthreads();

    uint32_t geo[GEO_WORDS];
    geo_mask(smid, done ? 0 : nm, r, geo);
    uint32_t fm[4] = {0, 0, 0, 0};  // the entered mid's marked treelets
    int m = 0;                      // the entered mid, within the chunk
    bool pending = !done;           // candidate mids left in this chunk
    while (true) {
      // (1) drained: on to the next mid the ray enters at its live t
      bool entered = false;
      if (!done && pending && !(fm[0] | fm[1] | fm[2] | fm[3])) {
        while (true) {
          const int j = pop_lowest(geo);
          if (j < 0) {
            pending = false;
            break;
          }
          if (box_hit(smid[BOX_VEC * j], smid[BOX_VEC * j + 1], r, t)) {
            m = j;
            entered = true;
            break;
          }
        }
      }
      // (2) the fan masks of the rays that entered a mid, one ray at a
      // time, a lane a fan box, against the t the ray enters with
      uint32_t seeders = __ballot_sync(FULL_MASK, entered);
      while (seeders) {
        const int src = __ffs(static_cast<int>(seeders)) - 1;
        seeders &= seeders - 1;
        Ray q = {};
        q.rdx = __shfl_sync(FULL_MASK, r.rdx, src);
        q.rdy = __shfl_sync(FULL_MASK, r.rdy, src);
        q.rdz = __shfl_sync(FULL_MASK, r.rdz, src);
        q.orx = __shfl_sync(FULL_MASK, r.orx, src);
        q.ory = __shfl_sync(FULL_MASK, r.ory, src);
        q.orz = __shfl_sync(FULL_MASK, r.orz, src);
        q.tnear = __shfl_sync(FULL_MASK, r.tnear, src);
        const float tq = __shfl_sync(FULL_MASK, t, src);
        const int mq = __shfl_sync(FULL_MASK, m, src);
        const float4* fb =
            fan_boxes + static_cast<size_t>(base + mq) * fan * BOX_VEC;
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          if (32 * w < fan) {
            const int b = 32 * w + lane;
            bool h = false;
            if (b < fan)
              h = box_hit(__ldg(fb + b * BOX_VEC), __ldg(fb + b * BOX_VEC + 1),
                          q, tq);
            const uint32_t word = __ballot_sync(FULL_MASK, h);
            if (lane == src) fm[w] = word;
          }
        }
        if (STATS && lane == src) cnt.mids += 1;
      }
      // (3) the next marked treelet of the entered mid
      if (!done && (fm[0] | fm[1] | fm[2] | fm[3])) {
        int b = 0;
#pragma unroll
        for (int w = 3; w >= 0; --w) {
          if (fm[w]) b = 32 * w + __ffs(static_cast<int>(fm[w])) - 1;
        }
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          if (w == (b >> 5)) fm[w] &= fm[w] - 1;
        }
        const size_t tid = static_cast<size_t>(base + m) * fan + b;
        if (STATS) {
          cnt.treelets += 1;
          touched[tid] = 1;
        }
        walk<OCCLUDED, CULL, STATS>(nodes + tid * (N_INNER * NODE_VEC),
                                    pairs + tid * (N_PAIRS * PAIR_VEC), r, t,
                                    prim, cnt);
        if (OCCLUDED && t == -INFINITY) done = true;
      }
      const bool more =
          !done && (pending || (fm[0] | fm[1] | fm[2] | fm[3]));
      if (!__ballot_sync(FULL_MASK, more)) break;
    }
  }
  if (!live) return;

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
void launch(const float4* nodes, const float4* pairs, const float4* fan_boxes,
            const float4* mid_boxes, int fan, int num_mids, const float* org,
            const float* dir, const float* tnear, const float* tfar,
            long long num_rays, float* t_out, int* prim_out,
            unsigned long long* stats, int* touched, cudaStream_t stream) {
  const unsigned grid =
      static_cast<unsigned>((num_rays + THREADS - 1) / THREADS);
  const size_t smem =
      static_cast<size_t>(min(num_mids, MID_CHUNK)) * BOX_VEC * sizeof(float4);
  rowtrace2_kernel<OCCLUDED, CULL, STATS><<<grid, THREADS, smem, stream>>>(
      nodes, pairs, fan_boxes, mid_boxes, fan, num_mids, org, dir, tnear,
      tfar, num_rays, t_out, prim_out, stats, touched);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched). Does
// not synchronise and allocates nothing. The scene arrays are the compact
// form (16-byte aligned, as torch allocates). `stats` and `touched` are
// either both null (the main path) or both device buffers (the counting
// build).
extern "C" int rowtrace2_launch(const float* nodes, const float* pairs,
                                const float* fan_boxes,
                                const float* mid_boxes, int fan, int num_mids,
                                const float* org, const float* dir,
                                const float* tnear, const float* tfar,
                                long long num_rays, float* t_out,
                                int* prim_out, int occluded, int cull,
                                unsigned long long* stats, int* touched,
                                void* stream) {
  if (fan < 1 || fan > 128 || num_mids < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_rays <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* n4 = reinterpret_cast<const float4*>(nodes);
  const float4* p4 = reinterpret_cast<const float4*>(pairs);
  const float4* f4 = reinterpret_cast<const float4*>(fan_boxes);
  const float4* m4 = reinterpret_cast<const float4*>(mid_boxes);
  const int variant =
      (occluded ? 4 : 0) | (cull ? 2 : 0) | (stats != nullptr ? 1 : 0);
#define ROWTRACE2_CASE(V, O, C, S)                                        \
  case V:                                                                 \
    launch<O, C, S>(n4, p4, f4, m4, fan, num_mids, org, dir, tnear, tfar, \
                    num_rays, t_out, prim_out, stats, touched, s);        \
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
