// BVH4 / BVH8 traversal, one thread per ray: closest hit (t, prim in BVH
// order) or any hit (t = -inf) over the compact scene that
// traverse/packet_kernel.py::compact_scene lays out: node records of the
// 8W used floats (8 stride-W fields; a child field holds the ref the walk
// pushes for that child as int bits), triangle records of 12 floats
// [v0 e1 e2 Ng], both back to back.
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
//   a leaf's triangles (at most 8, contiguous in BVH order) are tested in
//     slot order with the precomputed Moeller test; `t_s <= |den| * t`
//     accepts, so a later candidate at equal t replaces an earlier one;
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
// What bounds it on an H100: bytes, by the roofline. A ray visits about
// five nodes and tests about one triangle, so the 40 bytes a ray brings
// and takes away outweigh both the records it touches and its float32
// operations. The kernel runs at a few percent of that bound, and what
// holds it was measured step by step (PERF.md): not the bytes of the
// records (cutting them to a quarter left the time where it was), not L1
// wavefronts (loading a warp's records together was slower), not the
// first levels of the tree (staging them in shared memory was slower).
// Persistent threads, a ray taken from a counter when a thread's ray is
// done, made incoherent rays 0.8 times as slow and a coherent frame 1.3
// times as slow, and are not kept. The design keeps what paid or cost
// nothing:
//
//   * compact records: a node is one 128-byte line for BVH4 (two for
//     BVH8) read as float4s, a triangle three float4s: the nodes and
//     triangles of PERF.md's 998,284-triangle scene take 82 MB where the
//     JAX package's rows took 187 MB;
//   * the pushed ref precomputed in the record's child field, which spares
//     a node visit W float-to-int conversions and the leaf encoding;
//   * a stack sized from the tree: (W - 1) * 16 + 1 entries for a tree of
//     at most 16 levels, (W - 1) * 64 + 1 above, in local memory (a
//     thread-minor stack in shared memory measured slower);
//   * one loop a ray that pops a node or a leaf an iteration (descending
//     to a leaf before testing it, the while-while loop, made a coherent
//     frame slower: a warp's lanes that reach a leaf wait for the rest).
//
// Kernel B3 (hair) is the same walk with curve leaves: the walk is one
// device function, `walk`, whose node source reads B2's compact records
// (`CompactNodes`) or the JAX package's 128-float node rows
// (`RowNodes`), and whose LEAF argument selects B2's triangle leaf (TRI)
// or a hair leaf row of 16 segments x [p0 p1 r0 r1] tested with the
// swept-cone quadratic (CONE) or the ribbon closest approach (RIBBON),
// the JAX package's pallas_hair.py::_cone_leaf_test / _ribbon_leaf_test
// operation for operation. Both accept `th < t` strictly, so an earlier
// segment keeps an equal t. `hair_kernel` walks every cluster of a
// scene's packed set (all clusters' node and segment rows concatenated,
// each cluster's row bases and its 3x3 rotation) in one launch: a ray
// reads its origin, direction, tnear and tfar once, then for each cluster
// in order rotates itself into the cluster's frame (the products of
// traverse/hair_kernel.py's rotation summed left to right, as
// core/math.py::rows_times sums them) and walks the cluster's BVH from
// its running t; it returns (t, slot, cluster). An any-hit ray stops at
// the first cluster that hits. The bases and rotations of the launch's
// clusters are staged in shared memory. `hair_set_launch` is its entry.
// B3 is bounded the same way as B2 (bytes, and in practice the latency of
// dependent loads); a cone test is ~60 float32 operations with three
// divisions and a square root, a ribbon test ~55.
//
// The slab test's min and max propagate NaN (PTX min.NaN / max.NaN), as
// torch.minimum / maximum do in the plain version: a ray with a NaN
// origin or direction component, or one that a rotation turns NaN, fails
// every slab test on both sides.
//
// Build with -fmad=false: the plain PyTorch version rounds every product
// before it is added, and the two are held equal bit for bit. Division and
// square root stay IEEE (no --use_fast_math, -prec-div and -prec-sqrt at
// their defaults), as torch's are.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int ROW = 128;           // floats in a hair node or leaf row
// triangles in a leaf row of the JAX package's layout: the unit in which
// the counting build counts the leaf rows a launch touches
constexpr int TRIS_PER_ROW = 10;
constexpr int MAX_LEAF = 8;
constexpr int MAX_DEPTH = 64;      // deepest tree the compiled stack serves
constexpr int SHALLOW = 16;        // levels the small stack serves
constexpr int THREADS = 128;
constexpr int SENT = INT_MIN;      // "child not pushed"

constexpr int SEGS_PER_ROW = 16;   // hair leaf rows
// clusters a hair_set_launch walks: their bases and rotations fill 44 B of
// shared memory each, within the 48 KB a block gets without an opt-in
constexpr int MAX_HAIR_CLUSTERS = 1024;
constexpr int SEG_FLOATS = 8;      // p0 p1 r0 r1

enum Leaf { TRI = 0, CONE = 1, RIBBON = 2 };

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

// per-thread counters of the counting build
struct Counters {
  unsigned nodes = 0, leaves = 0, tris = 0, drops = 0;
};

__device__ __forceinline__ void set_ray(Ray& r, float ox, float oy, float oz,
                                        float dx, float dy, float dz,
                                        float tnear) {
  r.ox = ox;
  r.oy = oy;
  r.oz = oz;
  r.dx = dx;
  r.dy = dy;
  r.dz = dz;
  r.rdx = rcp_safe(dx);
  r.rdy = rcp_safe(dy);
  r.rdz = rcp_safe(dz);
  r.orx = ox * r.rdx;
  r.ory = oy * r.rdy;
  r.orz = oz * r.rdz;
  r.tnear = tnear;
}

// Swept-cone segment (line_intersector.h cone; pallas_hair.py:41-76):
// true where the ray hits with tnear < th < t; th is written either way.
__device__ __forceinline__ bool cone_hit(const Ray& r, float4 a, float4 b,
                                         float t, float& th) {
  const float ax0 = a.x, ay0 = a.y, az0 = a.z;
  const float ax1 = a.w, ay1 = b.x, az1 = b.y;
  const float r0 = b.z, r1 = b.w;
  const float vx = ax1 - ax0;
  const float vy = ay1 - ay0;
  const float vz = az1 - az0;
  const float aa = fmaxf(vx * vx + vy * vy + vz * vz, 1e-20f);
  const float rr = r1 - r0;
  const float qx = r.ox - ax0;
  const float qy = r.oy - ay0;
  const float qz = r.oz - az0;
  const float alpha = qx * vx + qy * vy + qz * vz;
  const float beta = r.dx * vx + r.dy * vy + r.dz * vz;
  const float dd = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
  const float q0d = qx * r.dx + qy * r.dy + qz * r.dz;
  const float q0q0 = qx * qx + qy * qy + qz * qz;
  const float rb = rr * beta;
  const float aa2 = aa * aa;
  const float A = dd - beta * beta / aa - rb * rb / aa2;
  const float B = 2.0f * q0d - 2.0f * alpha * beta / aa -
                  2.0f * r0 * rr * beta / aa -
                  2.0f * rr * rr * alpha * beta / aa2;
  const float C = q0q0 - alpha * alpha / aa - r0 * r0 -
                  2.0f * r0 * rr * alpha / aa - rr * rr * alpha * alpha / aa2;
  const float disc = B * B - 4.0f * A * C;
  const float sq = sqrtf(fmaxf(disc, 0.0f));
  const float As = fabsf(A) < 1e-20f ? 1e-20f : A;
  const float t0 = (-B - sq) / (2.0f * As);
  const float t1 = (-B + sq) / (2.0f * As);
  th = t0 > r.tnear ? t0 : t1;
  const float s = (alpha + th * beta) / aa;
  return disc >= 0.0f && th > r.tnear && th < t && s >= 0.0f && s <= 1.0f;
}

// Flat ribbon facing the ray (bezier_hair_intersector.h; pallas_hair.py:
// 79-116): the 2D closest approach in a ray-centric frame.
__device__ __forceinline__ bool ribbon_hit(const Ray& r, float4 a, float4 b,
                                           float t, float& th) {
  const float dd = fmaxf(r.dx * r.dx + r.dy * r.dy + r.dz * r.dz, 1e-20f);
  const float ax = a.x - r.ox;
  const float ay = a.y - r.oy;
  const float az = a.z - r.oz;
  const float bx = a.w - r.ox;
  const float by = b.x - r.oy;
  const float bz = b.y - r.oz;
  const float za = (ax * r.dx + ay * r.dy + az * r.dz) / dd;
  const float zb = (bx * r.dx + by * r.dy + bz * r.dz) / dd;
  const float apx = ax - za * r.dx;
  const float apy = ay - za * r.dy;
  const float apz = az - za * r.dz;
  const float bpx = bx - zb * r.dx;
  const float bpy = by - zb * r.dy;
  const float bpz = bz - zb * r.dz;
  const float abx = bpx - apx;
  const float aby = bpy - apy;
  const float abz = bpz - apz;
  const float denom = fmaxf(abx * abx + aby * aby + abz * abz, 1e-20f);
  const float s = fminf(
      fmaxf(-(apx * abx + apy * aby + apz * abz) / denom, 0.0f), 1.0f);
  const float px = apx + s * abx;
  const float py = apy + s * aby;
  const float pz = apz + s * abz;
  const float dist2 = px * px + py * py + pz * pz;
  const float oms = 1.0f - s;
  const float rad = b.z * oms + b.w * s;
  th = za * oms + zb * s;
  return dist2 <= rad * rad && th > r.tnear && th < t;
}

// ---- the walk, shared by kernels B2 and B3 --------------------------------

// B3's node rows: 128 floats a row, the 8W used ones first.
template <int W>
struct RowNodes {
  static constexpr bool ENCODED = false;
  const float* __restrict__ rows;
  __device__ __forceinline__ void load(int ref, float* f) const {
    const float4* row =
        reinterpret_cast<const float4*>(rows + static_cast<size_t>(ref) * ROW);
#pragma unroll
    for (int q = 0; q < 2 * W; ++q) {
      const float4 v = __ldg(row + q);
      f[4 * q + 0] = v.x;
      f[4 * q + 1] = v.y;
      f[4 * q + 2] = v.z;
      f[4 * q + 3] = v.w;
    }
  }
};

// B2's compact node records: 8W floats back to back, each child field
// holding the ref the walk pushes for that child as int bits
// (traverse/packet_kernel.py::compact_scene).
template <int W>
struct CompactNodes {
  static constexpr bool ENCODED = true;
  const float4* __restrict__ recs;
  __device__ __forceinline__ void load(int ref, float* f) const {
    const float4* p = recs + static_cast<size_t>(ref) * (2 * W);
#pragma unroll
    for (int q = 0; q < 2 * W; ++q) {
      const float4 v = __ldg(p + q);
      f[4 * q + 0] = v.x;
      f[4 * q + 1] = v.y;
      f[4 * q + 2] = v.z;
      f[4 * q + 3] = v.w;
    }
  }
};

// A thread's stack of (ref, entry distance) in local memory.
template <int N>
struct LocalStack {
  int ref[N];
  float dist[N];
  __device__ __forceinline__ void put(int e, int r, float d) {
    ref[e] = r;
    dist[e] = d;
  }
  __device__ __forceinline__ int get(int e, float& d) const {
    d = dist[e];
    return ref[e];
  }
};

// Tests the W children of one node record `f` against the ray in slot
// order and pushes the ones hit far to near, the lower slot on top among
// equal distances. ENC: the child fields hold the ref to push as int bits.
template <int W, int STACK, bool STATS, bool ENC, class Stack>
__device__ __forceinline__ void visit(const float* f, const Ray& r, float t,
                                      Stack& st, int& sp, Counters& n) {
  // candidates in DESCENDING slot order, so that the stable sort below
  // leaves the higher slot first among equal distances and the lower
  // slot on top of the stack
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
    float tmin = maxp(maxp(minp(tx0, tx1), minp(ty0, ty1)),
                      minp(tz0, tz1)) * ROBUST_MIN;
    const float tmax = minp(minp(maxp(tx0, tx1), maxp(ty0, ty1)),
                            maxp(tz0, tz1)) * ROBUST_MAX;
    tmin = maxp(tmin, r.tnear);
    if constexpr (ENC) {
      const int enc = __float_as_int(f[6 * W + c]);
      const bool ok = (tmin <= tmax) && (tmin <= t) && (enc != SENT);
      key[W - 1 - c] = ok ? tmin : -INFINITY;
      cref[W - 1 - c] = ok ? enc : SENT;
    } else {
      // child and count are exact small floats in the record
      const int cc = static_cast<int>(f[6 * W + c]);
      const int cnt = static_cast<int>(f[7 * W + c]);
      const bool ok = (tmin <= tmax) && (tmin <= t) && (cnt >= 0);
      key[W - 1 - c] = ok ? tmin : -INFINITY;
      cref[W - 1 - c] = ok ? (cnt > 0 ? -(((cc << 4) | cnt) + 1) : cc) : SENT;
    }
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
        st.put(sp, cref[k], key[k]);
        ++sp;
      } else if (STATS) {
        // unreachable for a tree of at most STACK's depth, which the
        // launch checks; counted all the same
        n.drops += 1;
      }
    }
  }
}

// A triangle leaf of B2 (`ref` as pushed): its triangles start .. start +
// cnt - 1, each a record of three float4s [v0 e1 e2 Ng], tested in slot
// order with the precomputed Moeller test; `t_s <= |den| * t` accepts.
// An any-hit ray that hits empties its stack.
template <bool OCCLUDED, bool STATS>
__device__ __forceinline__ void tri_leaf(const float4* __restrict__ tris,
                                         const int* __restrict__ prim_mask,
                                         int rmask, int cull, const Ray& r,
                                         int ref, float& t, int& prim,
                                         int& sp, Counters& n,
                                         int* __restrict__ row_touched) {
  const int v = -ref - 1;
  const int start = v >> 4;
  const int cnt = min(v & 15, MAX_LEAF);
  if (STATS) n.leaves += 1;
  for (int k = 0; k < cnt; ++k) {
    const int p = start + k;
    if (STATS) {
      n.tris += 1;
      // counted in the JAX package's leaf rows of ten triangles
      row_touched[p / TRIS_PER_ROW] = 1;
    }
    const float4* g = tris + static_cast<size_t>(p) * 3;
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
    bool ok = front && (u_s >= 0.0f) && (v_s >= 0.0f) &&
              (u_s + v_s <= absden) && (absden * r.tnear < t_s) &&
              (t_s <= absden * t);
    if (ok && prim_mask != nullptr) ok = (__ldg(prim_mask + p) & rmask) != 0;
    if (ok) {
      if (OCCLUDED) {
        t = -INFINITY;
        sp = 0;
        return;
      }
      t = t_s / fmaxf(absden, 1e-37f);
      prim = p;
    }
  }
}

// A hair leaf of B3: segments start .. start + cnt - 1 in BVH order, 16
// to a 128-float row as [p0 p1 r0 r1].
template <bool OCCLUDED, bool STATS, int LEAF>
__device__ __forceinline__ void hair_leaf(const float* __restrict__ sdata,
                                          const Ray& r, int ref, float& t,
                                          int& prim, int& sp, Counters& n,
                                          int* __restrict__ row_touched) {
  const int v = -ref - 1;
  const int start = v >> 4;
  const int cnt = min(v & 15, MAX_LEAF);
  if (STATS) n.leaves += 1;
  for (int k = 0; k < cnt; ++k) {
    const int p = start + k;
    const int srow = p / SEGS_PER_ROW;
    if (STATS) {
      n.tris += 1;
      row_touched[srow] = 1;
    }
    const float4* g = reinterpret_cast<const float4*>(
        sdata + static_cast<size_t>(srow) * ROW +
        (p - srow * SEGS_PER_ROW) * SEG_FLOATS);
    const float4 a = __ldg(g + 0);
    const float4 b = __ldg(g + 1);
    float th;
    bool ok;
    if constexpr (LEAF == CONE) {
      ok = cone_hit(r, a, b, t, th);
    } else {
      ok = ribbon_hit(r, a, b, t, th);
    }
    if (ok) {
      if (OCCLUDED) {
        t = -INFINITY;
        sp = 0;
        return;
      }
      t = th;
      prim = p;
    }
  }
}

// The whole walk of one ray through one BVH, B2's and B3's: `t` and
// `prim` in and out (prim the BVH slot of the winning triangle or
// segment; any-hit rays set t to -inf and leave prim), counters into `n`
// in the counting build. A popped entry whose distance exceeds t is
// skipped; a node is loaded from `nodes` (B2's compact records or B3's
// rows) and visited; a leaf is tested by LEAF's test over `leaves`
// (B2's triangle records or B3's segment rows).
template <int W, int STACK, bool OCCLUDED, bool STATS, int LEAF, class Nodes>
__device__ __forceinline__ void walk(const Nodes& nodes,
                                     const float* __restrict__ leaves,
                                     const int* __restrict__ prim_mask,
                                     int rmask, int cull, const Ray& r,
                                     float& t, int& prim, Counters& n,
                                     int* __restrict__ node_touched,
                                     int* __restrict__ row_touched) {
  LocalStack<STACK> st;
  int sp = 1;
  st.put(0, 0, -INFINITY);  // root
  while (sp > 0) {
    --sp;
    float d;
    const int ref = st.get(sp, d);
    if (d > t) continue;
    if (ref >= 0) {
      if (STATS) {
        n.nodes += 1;
        node_touched[ref] = 1;
      }
      float f[8 * W];
      nodes.load(ref, f);
      visit<W, STACK, STATS, Nodes::ENCODED>(f, r, t, st, sp, n);
    } else if constexpr (LEAF == TRI) {
      tri_leaf<OCCLUDED, STATS>(reinterpret_cast<const float4*>(leaves),
                                prim_mask, rmask, cull, r, ref, t, prim, sp,
                                n, row_touched);
    } else {
      hair_leaf<OCCLUDED, STATS, LEAF>(leaves, r, ref, t, prim, sp, n,
                                       row_touched);
    }
  }
}

__device__ __forceinline__ void add_stats(unsigned long long* stats,
                                          const Counters& n) {
  atomicAdd(stats + 0, static_cast<unsigned long long>(n.nodes));
  atomicAdd(stats + 1, static_cast<unsigned long long>(n.tris));
  atomicAdd(stats + 2, static_cast<unsigned long long>(n.drops));
  atomicAdd(stats + 3, static_cast<unsigned long long>(n.leaves));
}

// Kernel B2: closest or any hit of every ray over the compact scene, a
// thread a ray.
template <int W, int DEPTH, bool OCCLUDED, bool STATS>
__global__ void __launch_bounds__(THREADS)
packet_kernel(const float4* __restrict__ nodes,    // (M, 2W) float4
              const float* __restrict__ tris,      // (T, 12)
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
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= num_rays) return;
  Ray r;
  set_ray(r, org[3 * i + 0], org[3 * i + 1], org[3 * i + 2], dir[3 * i + 0],
          dir[3 * i + 1], dir[3 * i + 2], tnear[i]);
  const int rmask = ray_mask != nullptr ? ray_mask[i] : -1;
  float t = tfar[i];
  int prim = -1;
  Counters n;
  walk<W, (W - 1) * DEPTH + 1, OCCLUDED, STATS, TRI>(
      CompactNodes<W>{nodes}, tris, prim_mask, rmask, cull, r, t, prim, n,
      node_touched, row_touched);
  t_out[i] = t;
  prim_out[i] = prim;
  if (STATS) add_stats(stats, n);
}

// Kernel B3 over clusters first .. first + count - 1 of a packed set, rays
// in the world frame. bases (C, 4): a cluster's first node row, first
// segment row, first slot and sub-segments a curve (the last two are the
// finalize's); rots (C, 9): its rotation m, row-major, a point x going to
// x_j = x0 * m[j] + x1 * m[3 + j] + x2 * m[6 + j]; null: no rotation (the
// rays are in the cluster's frame). Dynamic shared memory holds the
// launch's count x 11 words.
template <bool OCCLUDED, bool STATS, int LEAF>
__global__ void __launch_bounds__(THREADS)
hair_kernel(const float* __restrict__ nodes,       // (all node rows, 128)
            const float* __restrict__ sdata,       // (all segment rows, 128)
            const int* __restrict__ bases,         // (C, 4)
            const float* __restrict__ rots,        // (C, 9) or null
            int first, int count,
            const float* __restrict__ org,         // (R, 3)
            const float* __restrict__ dir,         // (R, 3)
            const float* __restrict__ tnear,
            const float* __restrict__ tfar, long long num_rays,
            float* __restrict__ t_out, int* __restrict__ slot_out,
            int* __restrict__ cluster_out,
            unsigned long long* __restrict__ stats,  // [5], STATS only
            int* __restrict__ node_touched,        // [all nodes], STATS only
            int* __restrict__ row_touched) {       // [all rows], STATS only
  extern __shared__ float smem[];
  float* srot = smem;                                     // count x 9
  int* sbase = reinterpret_cast<int*>(smem + 9 * count);  // count x 2
  for (int k = threadIdx.x; k < count; k += blockDim.x) {
    sbase[2 * k + 0] = bases[4 * (first + k) + 0];
    sbase[2 * k + 1] = bases[4 * (first + k) + 1];
    if (rots != nullptr) {
      for (int j = 0; j < 9; ++j) srot[9 * k + j] = rots[9 * (first + k) + j];
    }
  }
  __syncthreads();
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= num_rays) return;

  const float wx = org[3 * i + 0], wy = org[3 * i + 1], wz = org[3 * i + 2];
  const float vx = dir[3 * i + 0], vy = dir[3 * i + 1], vz = dir[3 * i + 2];
  const float tn = tnear[i];
  float t = tfar[i];
  int slot = -1, cluster = -1;
  Counters n;
  unsigned entered = 0;  // clusters this ray was rotated into and walked
  for (int k = 0; k < count; ++k) {
    if (OCCLUDED && t == -INFINITY) break;
    if (STATS) ++entered;
    Ray r;
    if (rots != nullptr) {
      const float* m = srot + 9 * k;
      set_ray(r, wx * m[0] + wy * m[3] + wz * m[6],
              wx * m[1] + wy * m[4] + wz * m[7],
              wx * m[2] + wy * m[5] + wz * m[8],
              vx * m[0] + vy * m[3] + vz * m[6],
              vx * m[1] + vy * m[4] + vz * m[7],
              vx * m[2] + vy * m[5] + vz * m[8], tn);
    } else {
      set_ray(r, wx, wy, wz, vx, vy, vz, tn);
    }
    const int nb = sbase[2 * k + 0], rb = sbase[2 * k + 1];
    int s = -1;
    walk<4, 3 * MAX_DEPTH + 1, OCCLUDED, STATS, LEAF>(
        RowNodes<4>{nodes + static_cast<size_t>(nb) * ROW},
        sdata + static_cast<size_t>(rb) * ROW, nullptr, -1, 0, r, t, s, n,
        STATS ? node_touched + nb : nullptr,
        STATS ? row_touched + rb : nullptr);
    if (s >= 0) {
      slot = s;
      cluster = first + k;
    }
  }
  t_out[i] = t;
  slot_out[i] = slot;
  cluster_out[i] = cluster;
  if (STATS) {
    add_stats(stats, n);
    atomicAdd(stats + 4, static_cast<unsigned long long>(entered));
  }
}

template <int W, int DEPTH, bool OCCLUDED, bool STATS>
cudaError_t launch(const float4* nodes, const float* tris,
                   const int* prim_mask, const int* ray_mask, int cull,
                   const float* org, const float* dir, const float* tnear,
                   const float* tfar, long long num_rays, float* t_out,
                   int* prim_out, unsigned long long* stats,
                   int* node_touched, int* row_touched, cudaStream_t stream) {
  const unsigned grid =
      static_cast<unsigned>((num_rays + THREADS - 1) / THREADS);
  packet_kernel<W, DEPTH, OCCLUDED, STATS><<<grid, THREADS, 0, stream>>>(
      nodes, tris, prim_mask, ray_mask, cull, org, dir, tnear, tfar,
      num_rays, t_out, prim_out, stats, node_touched, row_touched);
  return cudaGetLastError();
}

template <int W, int DEPTH>
cudaError_t launch_variant(int variant, const float4* nodes,
                           const float* tris, const int* prim_mask,
                           const int* ray_mask, int cull, const float* org,
                           const float* dir, const float* tnear,
                           const float* tfar, long long num_rays,
                           float* t_out, int* prim_out,
                           unsigned long long* stats, int* node_touched,
                           int* row_touched, cudaStream_t s) {
#define PACKET_CASE(V, O, S)                                                \
  case V:                                                                   \
    return launch<W, DEPTH, O, S>(nodes, tris, prim_mask, ray_mask, cull,   \
                                  org, dir, tnear, tfar, num_rays, t_out,   \
                                  prim_out, stats, node_touched,            \
                                  row_touched, s);
  switch (variant) {
    PACKET_CASE(0, false, false)
    PACKET_CASE(1, false, true)
    PACKET_CASE(2, true, false)
    PACKET_CASE(3, true, true)
  }
#undef PACKET_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// Launches kernel B2 on `stream` and returns cudaGetLastError() (0 =
// launched). Does not synchronise and allocates nothing. `nodes` (M, 8 *
// width) and `tris` (T, 12) are the compact form
// (traverse/packet_kernel.py::compact_scene), 16-byte aligned. `width` is
// 4 or 8, `depth` the tree's levels (at most 64). `prim_mask` and
// `ray_mask` are both null (no masks) or both device buffers. `stats`,
// `node_touched` and `row_touched` are all null (the main path) or all
// device buffers (the counting build).
extern "C" int packet_launch(const float* nodes, const float* tris,
                             int width, int depth, const int* prim_mask,
                             const int* ray_mask, const float* org,
                             const float* dir, const float* tnear,
                             const float* tfar, long long num_rays,
                             float* t_out, int* prim_out, int occluded,
                             int cull, unsigned long long* stats,
                             int* node_touched, int* row_touched,
                             void* stream) {
  if ((width != 4 && width != 8) || depth < 1 || depth > MAX_DEPTH)
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_rays <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int variant = (occluded ? 2 : 0) | (stats != nullptr ? 1 : 0);
  const float4* n4 = reinterpret_cast<const float4*>(nodes);
  const bool shallow = depth <= SHALLOW;
#define PACKET_ARGS                                                          \
  variant, n4, tris, prim_mask, ray_mask, cull, org, dir, tnear, tfar,       \
      num_rays, t_out, prim_out, stats, node_touched, row_touched, s
  cudaError_t err;
  if (width == 4)
    err = shallow ? launch_variant<4, SHALLOW>(PACKET_ARGS)
                  : launch_variant<4, MAX_DEPTH>(PACKET_ARGS);
  else
    err = shallow ? launch_variant<8, SHALLOW>(PACKET_ARGS)
                  : launch_variant<8, MAX_DEPTH>(PACKET_ARGS);
#undef PACKET_ARGS
  return static_cast<int>(err);
}

// Kernel B3 over clusters first .. first + count - 1 of a packed hair set
// (hair_kernel above): node rows as above, segment rows `sdata` (16 x
// [p0 p1 r0 r1] a row, one zero pad row a cluster), `bases` (C, 4) and
// `rots` (C, 9) or null. `flat` selects the ribbon leaf over the cone
// leaf. `slot_out` gets the winning segment's slot within its cluster and
// `cluster_out` that cluster (-1 on a miss and for any-hit rays).
// `count` is at most MAX_HAIR_CLUSTERS. Launches on `stream`, returns
// cudaGetLastError(); `stats` ([5]), `node_touched` and `row_touched`
// (over the set's rows) as for packet_launch (the counters are node
// visits, segment tests, dropped pushes, leaf visits, summed over the
// clusters, and the clusters entered: a ray's rotations).
extern "C" int hair_set_launch(const float* nodes, const float* sdata,
                               const int* bases, const float* rots,
                               int first, int count, const float* org,
                               const float* dir, const float* tnear,
                               const float* tfar, long long num_rays,
                               float* t_out, int* slot_out, int* cluster_out,
                               int flat, int occluded,
                               unsigned long long* stats, int* node_touched,
                               int* row_touched, void* stream) {
  if (count < 0 || count > MAX_HAIR_CLUSTERS || first < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_rays <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid =
      static_cast<unsigned>((num_rays + THREADS - 1) / THREADS);
  const size_t shmem = static_cast<size_t>(count) * 11 * sizeof(float);
  const int variant = (flat ? 4 : 0) | (occluded ? 2 : 0) |
                      (stats != nullptr ? 1 : 0);
#define HAIR_CASE(V, L, O, S)                                                \
  case V:                                                                    \
    hair_kernel<O, S, L><<<grid, THREADS, shmem, s>>>(                       \
        nodes, sdata, bases, rots, first, count, org, dir, tnear, tfar,      \
        num_rays, t_out, slot_out, cluster_out, stats, node_touched,         \
        row_touched);                                                        \
    break;
  switch (variant) {
    HAIR_CASE(0, CONE, false, false)
    HAIR_CASE(1, CONE, false, true)
    HAIR_CASE(2, CONE, true, false)
    HAIR_CASE(3, CONE, true, true)
    HAIR_CASE(4, RIBBON, false, false)
    HAIR_CASE(5, RIBBON, false, true)
    HAIR_CASE(6, RIBBON, true, false)
    HAIR_CASE(7, RIBBON, true, true)
  }
#undef HAIR_CASE
  return static_cast<int>(cudaGetLastError());
}

// The deepest tree (levels of nodes, the root being level 1) that the
// compiled stack serves without dropping a push.
extern "C" int packet_max_depth(void) { return MAX_DEPTH; }

extern "C" const char* packet_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
