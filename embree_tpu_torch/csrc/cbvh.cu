// Compressed-patch (cBVH) traversal, one thread per ray, over the compact
// accel of traverse/cbvh_kernel.py::pack_compact: top-level BVH4 node
// rows of 32 floats (128 bytes), and one contiguous record a tile (the 44
// header floats, the node words, then the leaf words or the grid
// vertices, each section 16-byte aligned).
//
//   cbvh_kernel           closest hit: t, tile-local u and v, tile
//   cbvh_occluded_kernel  conservative occlusion: a ray is occluded when
//                         it reaches any tile's top-level leaf box
//
// They replace the Pallas kernels embree_tpu/traverse/pallas_cbvh.py::
// _make_kernel(mode, cl, K) and ::_occl_kernel, and keep those kernels'
// function per ray, not their schedule. Per ray, closest hit:
//
//   top level: a private stack of (ref, entry distance), the root first;
//     a popped entry is skipped when its entry distance exceeds the ray's
//     current t; a node's four children are slab-tested in slot order
//     (robust slab test, entry scaled by 1 - 3*2^-23 and exit by
//     1 + 3*2^-23, entry clamped to tnear, accepted when tmin <= tmax and
//     tmin <= t) and the ones hit pushed far to near by the ray's own
//     entry distance, the lower slot on top among equal distances; a leaf
//     child is one tile, tile_of_leaf[child];
//   tile entry: origin and direction into the tile's sheared frame by the
//     3x3 `space`; a z slab and four 2-D line tests against the frustum
//     give near and far; a ray with near > far or no valid line leaves
//     the tile; both end points go through the homography `proj`, the
//     projected ray is normalized, and the 'tiny' and 'flat' cases of a
//     ray that is almost a point or almost parallel to the patch get
//     their own direction and distance rule;
//   quadtree: a private stack of (node, parent box); an inner node is one
//     32-bit word of eight 3-bit and two 2-bit table indices, decoded
//     against the popped parent box into four child boxes; the children
//     hit within the tile-local tfar are pushed far to near as above;
//   leaves: 'box' takes the reconstructed box as the surface; 'leaf'
//     intersects a bilinear slab of four 4-bit corner heights with a
//     shared extent; 'grid' tests two triangles of world-space vertices
//     against the world ray; each only ever lowers the tile-local tfar;
//   the hit distance goes back to world space through `iproj` (flat rays)
//     or the z factor.
//
// The shared stacks of a 1,024-ray packet, the K-wide pops with their row
// DMAs, the adaptive pop width, the tables in scalar memory and the two
// pops an iteration are how the TPU kernel copes with a machine that
// cannot load at a per-lane address and pays for every loop iteration;
// none of it exists here, and the order of visits depends on the ray
// alone. The iteration cap is gone too: a per-ray walk ends by
// construction.
//
// What bounds it on an H100: bytes for incoherent rays (a ray brings and
// takes 48 bytes and touches a few node rows and tiles), operations for a
// coherent frame whose tiles stay in L2. The kernel waits on dependent
// loads (pop -> node row -> tile header -> node word) and loses lanes to
// divergence between the top-level walk, tile entry and the quadtree. The
// design:
//
//   * a thread walks top-level nodes until it pops a tile (or its stack
//     empties), and only then enters the tile and walks its quadtree, so
//     the threads of a warp enter their tiles together instead of one
//     tile entry and quadtree walk at a time while the others wait;
//   * persistent threads: as many blocks as the card holds, a thread
//     whose ray is done taking the next one from the launch's counter, so
//     a warp does not wait for its longest ray;
//   * a node row is one 128-byte line read as eight float4s, and the rows
//     lie back to back (4 MB at 32,080 nodes), where the JAX package's
//     512-byte rows used a quarter of each;
//   * a tile is one record (400 bytes in 'leaf' mode at level 3, where
//     three 512-byte rows held 388 used bytes), so the leaf-mode tiles of
//     the 4M-cell scene fit the 50 MB L2; its header is read once, at
//     tile entry, as eleven float4s, and what the quadtree walk reuses
//     (iproj, extent) stays in registers;
//   * the top-level stack is sized from the tree: 3 * 16 + 1 entries for a
//     top level of at most 16 levels (main-c has 11), 3 * 64 + 1 above
//     (the wrapper checks 64);
//   * the quantization tables are staged in shared memory, which serves
//     a warp's different entries at once (__constant__ memory serves
//     different addresses one after another);
//   * the quadtree stack (3 * level + 1 entries of a node and its box)
//     lives in shared memory, laid out thread-minor, in the main and the
//     counting build alike (local memory measured 0-7 % slower on 2^21
//     incoherent rays, PERF.md).
//
// PERF.md has the measured times and the bounds.
//
// Build with -fmad=false: the plain PyTorch version rounds every product
// before it is added, and the two are held equal bit for bit.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NODE_VEC = 8;        // float4s of a top-level node row
constexpr int HDR_VEC = 11;        // float4s of a tile header (44 floats)
constexpr int MAX_DEPTH = 64;      // deepest top level the stack serves
constexpr int SHALLOW = 16;        // top levels the small stack serves
constexpr int MAX_LEVEL = 4;       // compression levels 1..4
constexpr int QWORDS = 7;          // a quadtree stack entry: node, box
constexpr int THREADS = 128;
constexpr int SENT = INT_MIN;      // "child not pushed"
constexpr unsigned FULL_MASK = 0xFFFFFFFFu;

constexpr int MODE_BOX = 0;
constexpr int MODE_LEAF = 1;
constexpr int MODE_GRID = 2;

constexpr float ROBUST_MIN = static_cast<float>(1.0 - 3.0 / 8388608.0);
constexpr float ROBUST_MAX = static_cast<float>(1.0 + 3.0 / 8388608.0);
constexpr float EPS = 1e-30f;
constexpr float G_EPS = 1e-4f;
constexpr float Z_HUGE = 3.4e38f;

// quantization tables (compressed_node.h:22-39)
__constant__ float TABLE_BORDER[8] = {0.0f, 0.005f, 0.01f, 0.05f,
                                      0.1f, 0.2f,   0.4f,  0.6f};
__constant__ float TABLE_MID[8] = {0.0f,  0.40f, 0.48f, 0.49f,
                                   0.50f, 0.51f, 0.52f, 0.60f};
__constant__ float TABLE_Z[4] = {0.0f, 0.25f, 0.5f, 0.75f};

// header floats: space 0, proj 9, iproj 18, frustum 27 (z0, z1, then the
// corners p00 p10 p01 p11), uv0 37, uvd 39, extent 41, geom 42, prim 43
constexpr int H_PROJ = 9, H_IPROJ = 18, H_Z0 = 27, H_Z1 = 28, H_P00 = 29,
              H_P10 = 31, H_P01 = 33, H_P11 = 35, H_EXTENT = 41;

__device__ __forceinline__ float rcp_safe(float a) {
  return (fabsf(a) < EPS) ? (a < 0.0f ? -1e30f : 1e30f) : 1.0f / a;
}

// min / max that return NaN when either argument is NaN, as the plain
// version's torch.minimum / maximum / clamp_min do (fminf / fmaxf drop
// it); one PTX instruction on the card, a portable form in a host
// compiler's pass
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

__device__ __forceinline__ float clamp_den(float a) {
  return fabsf(a) < EPS ? EPS : a;
}

__device__ __forceinline__ unsigned compact(unsigned x) {
  x = x & 0x55555555u;
  x = (x ^ (x >> 1)) & 0x33333333u;
  x = (x ^ (x >> 2)) & 0x0F0F0F0Fu;
  x = (x ^ (x >> 4)) & 0x00FF00FFu;
  return (x ^ (x >> 8)) & 0x0000FFFFu;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float rdx, rdy, rdz, orx, ory, orz;
  float tnear;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ org,
                                        const float* __restrict__ dir,
                                        const float* __restrict__ tnear,
                                        long long i) {
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
  return r;
}

// A top-level node row: 32 floats, one 128-byte line, eight float4s.
__device__ __forceinline__ void load_node(const float4* __restrict__ topnodes,
                                          int node, float* f) {
  const float4* row = topnodes + static_cast<size_t>(node) * NODE_VEC;
#pragma unroll
  for (int q = 0; q < NODE_VEC; ++q) {
    const float4 v = __ldg(row + q);
    f[4 * q + 0] = v.x;
    f[4 * q + 1] = v.y;
    f[4 * q + 2] = v.z;
    f[4 * q + 3] = v.w;
  }
}

// Robust slab test of child c of a node row against the world ray.
__device__ __forceinline__ void top_slab(const float* f, int c, const Ray& r,
                                         float& tmin, float& tmax) {
  const float tx0 = f[0 + c] * r.rdx - r.orx;
  const float tx1 = f[12 + c] * r.rdx - r.orx;
  const float ty0 = f[4 + c] * r.rdy - r.ory;
  const float ty1 = f[16 + c] * r.rdy - r.ory;
  const float tz0 = f[8 + c] * r.rdz - r.orz;
  const float tz1 = f[20 + c] * r.rdz - r.orz;
  tmin = maxp(maxp(minp(tx0, tx1), minp(ty0, ty1)), minp(tz0, tz1)) *
         ROBUST_MIN;
  tmax = minp(minp(maxp(tx0, tx1), maxp(ty0, ty1)), maxp(tz0, tz1)) *
         ROBUST_MAX;
  tmin = maxp(tmin, r.tnear);
}

// Stable bubble network over four (key, ref) pairs, far to near.
__device__ __forceinline__ void sort4(float* key, int* ref) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int b = 0; b < 3 - a; ++b) {
      if (key[b] < key[b + 1]) {
        const float kt = key[b];
        key[b] = key[b + 1];
        key[b + 1] = kt;
        const int rt = ref[b];
        ref[b] = ref[b + 1];
        ref[b + 1] = rt;
      }
    }
  }
}

// A ray inside one tile: the projected ray and what maps its distances
// back to world space.
struct TileRay {
  float lox, loy, loz;     // origin in the tile's frame
  float pox, poy, poz;     // projected origin
  float pdx, pdy, pdz;     // projected direction
  float prdx, prdy, prdz;  // its reciprocal
  float porx, pory, porz;  // projected origin * reciprocal direction
  float near, zf;
  bool flat;
};

__device__ __forceinline__ void tile_slab(const TileRay& q, float lx, float ly,
                                          float lz, float hx, float hy,
                                          float hz, float& tmin, float& tmax) {
  const float tx0 = lx * q.prdx - q.porx;
  const float tx1 = hx * q.prdx - q.porx;
  const float ty0 = ly * q.prdy - q.pory;
  const float ty1 = hy * q.prdy - q.pory;
  const float tz0 = lz * q.prdz - q.porz;
  const float tz1 = hz * q.prdz - q.porz;
  tmin = maxp(maxp(minp(tx0, tx1), minp(ty0, ty1)), minp(tz0, tz1)) *
         ROBUST_MIN;
  tmax = minp(minp(maxp(tx0, tx1), maxp(ty0, ty1)), maxp(tz0, tz1)) *
         ROBUST_MAX;
  tmin = maxp(tmin, 0.0f);
}

// Tile-local distance back to world distance; `ip` is the tile's iproj.
__device__ __forceinline__ float world_t(const float* ip, const TileRay& q,
                                         float th) {
  if (!q.flat) return th / q.zf + q.near;
  const float px = q.pox + th * q.pdx;
  const float py = q.poy + th * q.pdy;
  const float pz = q.poz + th * q.pdz;
  const float w = clamp_den(ip[6] * px + ip[7] * py + ip[8]);
  const float ux = (ip[0] * px + ip[1] * py + ip[2]) / w;
  const float uy = (ip[3] * px + ip[4] * py + ip[5]) / w;
  const float fx = ux - q.lox;
  const float fy = uy - q.loy;
  const float fz = pz - q.loz;
  return sqrtf(fx * fx + fy * fy + fz * fz);
}

// One 2-D edge line of the frustum (intersect_line, compressed_help.h:
// 93-106): the ray parameter where the local ray crosses the line through
// p2 and p3, valid when the crossing lies on the segment.
__device__ __forceinline__ bool iline(float p2x, float p2y, float p3x,
                                      float p3y, float lox, float loy,
                                      float ldx, float ldy, float& tt1) {
  const float vx = p2x - lox;
  const float vy = p2y - loy;
  const float lx = p3x - p2x;
  const float ly = p3y - p2y;
  const float den1 = clamp_den(ly * ldx - lx * ldy);
  tt1 = (ly * vx - lx * vy) / den1;
  const float tt2 = (ldx * vy - ldy * vx) / (-den1);
  return tt2 >= 0.0f && tt2 <= 1.0f;
}

// Moeller test of triangle (a, b, c) against the world ray within
// (tnear, t]; on a hit returns t and the barycentrics.
__device__ __forceinline__ bool moeller(const float* a, const float* b,
                                        const float* c, const Ray& r, float t,
                                        float& t_out, float& u_out,
                                        float& v_out) {
  const float e1x = a[0] - b[0], e1y = a[1] - b[1], e1z = a[2] - b[2];
  const float e2x = c[0] - a[0], e2y = c[1] - a[1], e2z = c[2] - a[2];
  const float ngx = e2y * e1z - e2z * e1y;
  const float ngy = e2z * e1x - e2x * e1z;
  const float ngz = e2x * e1y - e2y * e1x;
  const float cx = a[0] - r.ox, cy = a[1] - r.oy, cz = a[2] - r.oz;
  const float rx = cy * r.dz - cz * r.dy;
  const float ry = cz * r.dx - cx * r.dz;
  const float rz = cx * r.dy - cy * r.dx;
  const float den = ngx * r.dx + ngy * r.dy + ngz * r.dz;
  const float absden = fabsf(den);
  const float sgn = den >= 0.0f ? 1.0f : -1.0f;
  const float u_s = (rx * e2x + ry * e2y + rz * e2z) * sgn;
  const float v_s = (rx * e1x + ry * e1y + rz * e1z) * sgn;
  const float t_s = (ngx * cx + ngy * cy + ngz * cz) * sgn;
  const bool ok = (den != 0.0f) && (u_s >= 0.0f) && (v_s >= 0.0f) &&
                  (u_s + v_s <= absden) && (absden * r.tnear < t_s) &&
                  (t_s <= absden * t);
  const float rcp = 1.0f / maxp(absden, 1e-37f);
  t_out = t_s * rcp;
  u_out = u_s * rcp;
  v_out = v_s * rcp;
  return ok;
}

// The quadtree stack of one thread: entries of (node, box of 6 floats),
// in dynamic shared memory laid out thread-minor (word w of entry e of
// thread x at (e * QWORDS + w) * THREADS + x), so that a warp's accesses
// to one word fall in distinct banks.
struct QStack {
  float* base;
  __device__ __forceinline__ explicit QStack(float* smem)
      : base(smem + threadIdx.x) {}
  __device__ __forceinline__ void push(int e, int n, float lx, float ly,
                                       float lz, float hx, float hy,
                                       float hz) {
    float* p = base + e * QWORDS * THREADS;
    p[0] = __int_as_float(n);
    p[THREADS] = lx;
    p[2 * THREADS] = ly;
    p[3 * THREADS] = lz;
    p[4 * THREADS] = hx;
    p[5 * THREADS] = hy;
    p[6 * THREADS] = hz;
  }
  __device__ __forceinline__ int pop(int e, float* b) const {
    const float* p = base + e * QWORDS * THREADS;
#pragma unroll
    for (int k = 0; k < 6; ++k) b[k] = p[(k + 1) * THREADS];
    return __float_as_int(p[0]);
  }
};

template <int MODE, bool STATS, int DEPTH>
__global__ void __launch_bounds__(THREADS)
cbvh_kernel(const float4* __restrict__ topnodes,    // (M, 8) float4
            const float* __restrict__ tiles,        // (T, tile_words)
            const int* __restrict__ tile_of_leaf,   // (T,)
            int comp_level, int tile_words,
            const float* __restrict__ org,          // (R, 3)
            const float* __restrict__ dir,          // (R, 3)
            const float* __restrict__ tnear,
            const float* __restrict__ tfar, long long num_rays,
            float* __restrict__ t_out, float* __restrict__ u_out,
            float* __restrict__ v_out, int* __restrict__ tile_out,
            unsigned long long* __restrict__ next_ray,  // [1], zero
            unsigned long long* __restrict__ stats,  // [5], STATS only
            int* __restrict__ node_touched,          // [M], STATS only
            int* __restrict__ tile_touched) {        // [T], STATS only
  constexpr int STACK = 3 * DEPTH + 1;
  // the quadtree stacks: (3 * comp_level + 1) * QWORDS * THREADS floats
  extern __shared__ float qstacks[];
  // the quantization tables in shared memory: a warp's lanes look up
  // different entries, which __constant__ memory serves one at a time
  __shared__ float tables[8 + 8 + 4];
  for (int k = threadIdx.x; k < 20; k += blockDim.x)
    tables[k] = k < 8 ? TABLE_BORDER[k]
                      : (k < 16 ? TABLE_MID[k - 8] : TABLE_Z[k - 16]);
  __syncthreads();
  const float* __restrict__ t_border = tables;
  const float* __restrict__ t_mid = tables + 8;
  const float* __restrict__ t_z = tables + 16;
  const int lane = threadIdx.x & 31;
  const int g = 1 << comp_level;
  const int elems = ((1 << (2 * comp_level)) - 1) / 3;
  // sections of a tile record: header, node words, leaf words or grid
  const int node_ofs = HDR_VEC * 4;
  const int leaf_ofs = node_ofs + ((elems + 3) & ~3);
  const float rcp_edges = 1.0f / static_cast<float>(g);

  unsigned n_top = 0, n_tiles = 0, n_quad = 0, n_leaves = 0, n_drops = 0;
  QStack qs(qstacks);

  // the ray this thread walks: index, state, answer
  long long i = 0;
  bool have = false, exhausted = false;
  Ray r = {};
  float t = 0.0f, u = 0.0f, v = 0.0f;
  int tile = -1;
  int sref[STACK];
  float sdist[STACK];
  int sp = 0;

  // A tile: entry, then its quadtree (everything of a ray's walk below the
  // top level); it only ever lowers t.
  auto enter_tile = [&](int ti) {
    // ---- tile entry: the header once, as eleven float4s
    if (STATS) {
      n_tiles += 1;
      tile_touched[ti] = 1;
    }
    const float* __restrict__ rec =
        tiles + static_cast<size_t>(ti) * tile_words;
    float h[HDR_VEC * 4];
#pragma unroll
    for (int k = 0; k < HDR_VEC; ++k) {
      const float4 w = __ldg(reinterpret_cast<const float4*>(rec) + k);
      h[4 * k + 0] = w.x;
      h[4 * k + 1] = w.y;
      h[4 * k + 2] = w.z;
      h[4 * k + 3] = w.w;
    }
    TileRay q;
    float ldx, ldy, ldz;
    q.lox = h[0] * r.ox + h[1] * r.oy + h[2] * r.oz;
    q.loy = h[3] * r.ox + h[4] * r.oy + h[5] * r.oz;
    q.loz = h[6] * r.ox + h[7] * r.oy + h[8] * r.oz;
    ldx = h[0] * r.dx + h[1] * r.dy + h[2] * r.dz;
    ldy = h[3] * r.dx + h[4] * r.dy + h[5] * r.dz;
    ldz = h[6] * r.dx + h[7] * r.dy + h[8] * r.dz;
    const float z0 = h[H_Z0], z1 = h[H_Z1];
    float far;
    {
      // frustum entry (compressed_help.h:109-133)
      const float rdz_l = rcp_safe(ldz);
      const float t1z = z0 * rdz_l - q.loz * rdz_l;
      const float t2z = z1 * rdz_l - q.loz * rdz_l;
      const float p00x = h[H_P00], p00y = h[H_P00 + 1];
      const float p10x = h[H_P10], p10y = h[H_P10 + 1];
      const float p01x = h[H_P01], p01y = h[H_P01 + 1];
      const float p11x = h[H_P11], p11y = h[H_P11 + 1];
      float t1x, t2x, t1y, t2y;
      const bool v1x = iline(p00x, p00y, p01x, p01y, q.lox, q.loy, ldx, ldy, t1x);
      const bool v2x = iline(p10x, p10y, p11x, p11y, q.lox, q.loy, ldx, ldy, t2x);
      const bool v1y = iline(p00x, p00y, p10x, p10y, q.lox, q.loy, ldx, ldy, t1y);
      const bool v2y = iline(p01x, p01y, p11x, p11y, q.lox, q.loy, ldx, ldy, t2y);
      const float near1 =
          minp(minp(v1x ? t1x : INFINITY, v2x ? t2x : INFINITY),
                minp(v1y ? t1y : INFINITY, v2y ? t2y : INFINITY));
      const float far1 =
          maxp(maxp(v1x ? t1x : -INFINITY, v2x ? t2x : -INFINITY),
                maxp(v1y ? t1y : -INFINITY, v2y ? t2y : -INFINITY));
      q.near = maxp(maxp(minp(t1z, t2z), near1), r.tnear);
      far = minp(minp(maxp(t1z, t2z), far1), t);
      const bool alive = (q.near <= far) && (v1x || v2x || v1y || v2y);
      if (!alive) return;
    }
    float tloc;
    {
      // projected ray (compressed.h:464-505)
      const float* pj = h + H_PROJ;
      float e1x, e1y, e1z, e2x, e2y, e2z;
      {
        const float px = q.lox + q.near * ldx, py = q.loy + q.near * ldy;
        e1z = q.loz + q.near * ldz;
        const float w = clamp_den(pj[6] * px + pj[7] * py + pj[8]);
        e1x = (pj[0] * px + pj[1] * py + pj[2]) / w;
        e1y = (pj[3] * px + pj[4] * py + pj[5]) / w;
      }
      {
        const float px = q.lox + far * ldx, py = q.loy + far * ldy;
        e2z = q.loz + far * ldz;
        const float w = clamp_den(pj[6] * px + pj[7] * py + pj[8]);
        e2x = (pj[0] * px + pj[1] * py + pj[2]) / w;
        e2y = (pj[3] * px + pj[4] * py + pj[5]) / w;
      }
      const float dxx = e2x - e1x, dyy = e2y - e1y, dzz = e2z - e1z;
      const float az = fabsf(dzz);
      const bool tiny = (fabsf(dxx) < G_EPS) && (fabsf(dyy) < G_EPS) &&
                        (az < G_EPS);
      q.flat = !tiny && (az < G_EPS);
      const float dlen = sqrtf(dxx * dxx + dyy * dyy + dzz * dzz);
      const float inv = 1.0f / maxp(dlen, EPS);
      const float sgnz = ldz >= 0.0f ? 1.0f : -1.0f;
      q.pdx = tiny ? 0.0f : dxx * inv;
      q.pdy = tiny ? 0.0f : dyy * inv;
      q.pdz = tiny ? sgnz : dzz * inv;
      q.pox = e1x;
      q.poy = e1y;
      q.poz = tiny ? e1z - sgnz : e1z;
      q.zf = tiny ? Z_HUGE : ldz / clamp_den(q.pdz);
      tloc = tiny ? Z_HUGE : (q.flat ? dlen : (t - q.near) * q.zf);
      q.prdx = rcp_safe(q.pdx);
      q.prdy = rcp_safe(q.pdy);
      q.prdz = rcp_safe(q.pdz);
      q.porx = q.pox * q.prdx;
      q.pory = q.poy * q.prdy;
      q.porz = q.poz * q.prdz;
    }
    const float* ip = h + H_IPROJ;
    const float ext = h[H_EXTENT];
    const int* __restrict__ words = reinterpret_cast<const int*>(rec);

    // ---- quadtree walk; root box (-1, -1, z0) .. (1, 1, z1)
    int qsp = 1;
    qs.push(0, 0, -1.0f, -1.0f, z0, 1.0f, 1.0f, z1);
    while (qsp > 0) {
      --qsp;
      float bx[6];
      const int curr = qs.pop(qsp, bx);
      const float blx = bx[0], bly = bx[1], blz = bx[2];
      const float bhx = bx[3], bhy = bx[4], bhz = bx[5];

      if (curr < elems) {
        // ---- inner node: one word of table indices (getNode,
        // compressed_node.h:489-512)
        if (STATS) n_quad += 1;
        const unsigned word =
            static_cast<unsigned>(__ldg(words + node_ofs + curr));
        const unsigned xz = word & 0xFFu, x_ = (word >> 8) & 0xFFu;
        const unsigned yz = (word >> 16) & 0xFFu, y_ = (word >> 24) & 0xFFu;
        const float x1 = t_border[(xz >> 5) & 7];
        const float x2 = t_mid[(xz >> 2) & 7];
        const float x3 = t_mid[(x_ >> 5) & 7];
        const float x4 = t_border[(x_ >> 2) & 7];
        const float y1 = t_border[(yz >> 5) & 7];
        const float y2 = t_mid[(yz >> 2) & 7];
        const float y3 = t_mid[(y_ >> 5) & 7];
        const float y4 = t_border[(y_ >> 2) & 7];
        const float zq1 = t_z[xz & 3];
        const float zq2 = t_z[yz & 3];
        const float dimx = bhx - blx, dimy = bhy - bly, dimz = bhz - blz;
        const float lx[2] = {blx + x1 * dimx, blx + x2 * dimx};
        const float hx[2] = {blx + (1.0f - x3) * dimx, blx + (1.0f - x4) * dimx};
        const float ly[2] = {bly + y1 * dimy, bly + y2 * dimy};
        const float hy[2] = {bly + (1.0f - y3) * dimy, bly + (1.0f - y4) * dimy};
        const float lz = blz + zq1 * dimz;
        const float hz = blz + (1.0f - zq2) * dimz;
        // children in Morton order 0=(0,0) 1=(1,0) 2=(0,1) 3=(1,1),
        // candidates in descending slot order as at the top level
        float key[4];
        int cref[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float tmin, tmax;
          tile_slab(q, lx[c & 1], ly[c >> 1], lz, hx[c & 1], hy[c >> 1], hz,
                    tmin, tmax);
          const bool ok = (tmin <= tmax) && (tmin <= tloc);
          key[3 - c] = ok ? tmin : -INFINITY;
          cref[3 - c] = ok ? c : SENT;
        }
        sort4(key, cref);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int c = cref[k];
          if (c != SENT) {
            if (qsp < 3 * comp_level + 1) {
              qs.push(qsp, curr * 4 + 1 + c, lx[c & 1], ly[c >> 1], lz,
                      hx[c & 1], hy[c >> 1], hz);
              ++qsp;
            } else if (STATS) {
              // unreachable: a depth-first walk of comp_level levels holds
              // at most 3 * comp_level + 1 entries; counted all the same
              n_drops += 1;
            }
          }
        }
        continue;
      }

      // ---- leaf: cell idx of the tile, Morton order
      if (STATS) n_leaves += 1;
      const unsigned idx = static_cast<unsigned>(curr - elems);
      const unsigned imx = compact(idx), imy = compact(idx >> 1);
      const float mx = static_cast<float>(imx), my = static_cast<float>(imy);

      if (MODE == MODE_GRID) {
        // two triangles of WORLD-space vertices against the WORLD ray
        // (compressed.h:591-610)
        const float* __restrict__ gp = rec + leaf_ofs;
        float vv[4][3];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const unsigned base =
              3u * ((imx + (k & 1)) * (g + 1) + imy + (k >> 1));
          vv[k][0] = __ldg(gp + base + 0);
          vv[k][1] = __ldg(gp + base + 1);
          vv[k][2] = __ldg(gp + base + 2);
        }
        float t1, u1, v1, t2, u2, v2;
        const bool ok1 = moeller(vv[0], vv[1], vv[2], r, t, t1, u1, v1);
        const bool ok2 = moeller(vv[3], vv[2], vv[1], r, t, t2, u2, v2);
        if (ok1 || ok2) {
          const bool use2 = ok2 && (!ok1 || (t2 < t1));
          t = use2 ? t2 : t1;
          u = (use2 ? mx + 1.0f - u2 : mx + u1) * rcp_edges;
          v = (use2 ? my + 1.0f - v2 : my + v1) * rcp_edges;
          tile = ti;
          tloc = (t - q.near) * q.zf;
        }
        continue;
      }

      float tmin, tmax;
      tile_slab(q, blx, bly, blz, bhx, bhy, bhz, tmin, tmax);
      if (!((tmin <= tmax) && (tmin <= tloc))) continue;

      if (MODE == MODE_BOX) {
        // the reconstructed box is the surface (:614-656)
        const float dimx = maxp(bhx - blx, EPS);
        const float dimy = maxp(bhy - bly, EPS);
        u = ((q.pox + q.pdx * tmin - blx) / dimx + mx) * rcp_edges;
        v = ((q.poy + q.pdy * tmin - bly) / dimy + my) * rcp_edges;
        t = world_t(ip, q, tmin);
        tile = ti;
        tloc = tmin;
        continue;
      }

      // MODE_LEAF: pizza box (:541-590 + intersect_patch)
      const unsigned word =
          static_cast<unsigned>(__ldg(words + leaf_ofs + (idx >> 1)));
      const unsigned cw = (idx & 1u) == 0u ? (word & 0xFFFFu) : (word >> 16);
      const unsigned z12 = cw & 0xFFu, z34 = (cw >> 8) & 0xFFu;
      const float dimz = bhz - blz;
      const float rng = (1.0f + 2.0f * ext) * dimz;
      const float off = blz - dimz * ext;
      const float rf = rng * 0.0625f;
      const float c1 = off + rf * static_cast<float>((z12 >> 4) & 15u);
      const float c2 = off + rf * static_cast<float>(z12 & 15u);
      const float c3 = off + rf * static_cast<float>((z34 >> 4) & 15u);
      const float c4 = off + rf * static_cast<float>(z34 & 15u);
      const float dz = rf;
      const float p1x = q.pox + tmin * q.pdx, p1y = q.poy + tmin * q.pdy;
      const float p1z = q.poz + tmin * q.pdz;
      const float p2x = q.pox + tmax * q.pdx, p2y = q.poy + tmax * q.pdy;
      const float p2z = q.poz + tmax * q.pdz;
      const float lenx = 1.0f / maxp(bhx - blx, EPS);
      const float leny = 1.0f / maxp(bhy - bly, EPS);
      const float fx1 = (p1x - blx) * lenx, fy1 = (p1y - bly) * leny;
      const float fx2 = (p2x - blx) * lenx, fy2 = (p2y - bly) * leny;
      const bool degen = (tmax - tmin) < 1e-6f;
      const float za1 = c1 * (1.0f - fx1) * (1.0f - fy1) +
                        c2 * fx1 * (1.0f - fy1) + c3 * (1.0f - fx1) * fy1 +
                        c4 * fx1 * fy1;
      const float za2 = c1 * (1.0f - fx2) * (1.0f - fy2) +
                        c2 * fx2 * (1.0f - fy2) + c3 * (1.0f - fx2) * fy2 +
                        c4 * fx2 * fy2;
      const bool between = (p1z >= za1) && (p1z <= za1 + dz);
      const bool above = p1z > za1 + dz;
      const float z1s = above ? za1 + dz : za1;
      const float z2s = above ? za2 + dz : za2;
      const float alpha = p2z - z2s;
      const float beta = z1s - p1z;
      const float den = clamp_den(alpha + beta);
      const float tsec = (tmin * alpha + tmax * beta) / den;
      const float dfr = (tsec - tmin) / maxp(tmax - tmin, EPS);
      const bool sec_ok = (tsec < tloc) && (tsec >= tmin) && (tsec <= tmax);
      const bool first = degen || between;
      if (!(first || sec_ok)) continue;
      const float th = first ? tmin : tsec;
      const float fxh = first ? fx1 : fx1 + (fx2 - fx1) * dfr;
      const float fyh = first ? fy1 : fy1 + (fy2 - fy1) * dfr;
      u = (fxh + mx) * rcp_edges;
      v = (fyh + my) * rcp_edges;
      t = world_t(ip, q, th);
      tile = ti;
      tloc = th;
    }
  };

  // Persistent threads: a thread whose ray is done takes the next one from
  // the launch's ray counter (one atomic a warp a round), so a warp's
  // threads stay busy until the rays run out instead of waiting for the
  // warp's longest ray.
  while (true) {
    const bool need = !have && !exhausted;
    const unsigned want = __ballot_sync(FULL_MASK, need);
    if (want) {
      const int leader = __ffs(static_cast<int>(want)) - 1;
      unsigned long long first = 0;
      if (lane == leader)
        first = atomicAdd(next_ray, static_cast<unsigned long long>(
                                        __popc(want)));
      first = __shfl_sync(FULL_MASK, first, leader);
      if (need) {
        i = static_cast<long long>(first) +
            __popc(want & ((1u << lane) - 1u));
        if (i < num_rays) {
          have = true;
          r = load_ray(org, dir, tnear, i);
          t = tfar[i];
          u = 0.0f;
          v = 0.0f;
          tile = -1;
          sp = 1;
          sref[0] = 0;  // root
          sdist[0] = -INFINITY;
        } else {
          exhausted = true;
        }
      }
    }
    if (!__ballot_sync(FULL_MASK, have)) break;
    if (!have) continue;

    // ---- top-level nodes until the ray pops a tile or its stack empties:
    // the threads of a warp then enter their tiles together
    int ti = -1;
    while (sp > 0) {
      --sp;
      const int ref = sref[sp];
      if (sdist[sp] > t) continue;
      if (ref < 0) {
        ti = -ref - 1;
        break;
      }
      if (STATS) {
        n_top += 1;
        node_touched[ref] = 1;
      }
      float f[32];
      load_node(topnodes, ref, f);
      // candidates in DESCENDING slot order, so that the stable sort
      // leaves the higher slot first among equal distances and the lower
      // slot on top of the stack
      float key[4];
      int cref[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float tmin, tmax;
        top_slab(f, c, r, tmin, tmax);
        // child and count are exact small floats in the row
        const int cc = static_cast<int>(f[24 + c]);
        const int cnt = static_cast<int>(f[28 + c]);
        const bool ok = (tmin <= tmax) && (tmin <= t) && (cnt >= 0);
        key[3 - c] = ok ? tmin : -INFINITY;
        cref[3 - c] =
            ok ? (cnt > 0 ? -(__ldg(tile_of_leaf + cc) + 1) : cc) : SENT;
      }
      sort4(key, cref);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (cref[k] != SENT) {
          if (sp < STACK) {
            sref[sp] = cref[k];
            sdist[sp] = key[k];
            ++sp;
          } else if (STATS) {
            // unreachable for a top level of at most DEPTH levels, which
            // the launch checks; counted all the same
            n_drops += 1;
          }
        }
      }
    }
    if (ti >= 0) enter_tile(ti);
    if (sp == 0) {
      t_out[i] = t;
      u_out[i] = u;
      v_out[i] = v;
      tile_out[i] = tile;
      have = false;
    }
  }
  if (STATS) {
    atomicAdd(stats + 0, static_cast<unsigned long long>(n_top));
    atomicAdd(stats + 1, static_cast<unsigned long long>(n_tiles));
    atomicAdd(stats + 2, static_cast<unsigned long long>(n_quad));
    atomicAdd(stats + 3, static_cast<unsigned long long>(n_leaves));
    atomicAdd(stats + 4, static_cast<unsigned long long>(n_drops));
  }
}

template <bool STATS, int DEPTH>
__global__ void __launch_bounds__(THREADS)
cbvh_occluded_kernel(const float4* __restrict__ topnodes,  // (M, 8) float4
                     const float* __restrict__ org,
                     const float* __restrict__ dir,
                     const float* __restrict__ tnear,
                     const float* __restrict__ tfar, long long num_rays,
                     unsigned char* __restrict__ occ_out,  // 0 or 1
                     unsigned long long* __restrict__ stats,  // [5]
                     int* __restrict__ node_touched) {        // [M]
  constexpr int STACK = 3 * DEPTH + 1;
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= num_rays) return;
  const Ray r = load_ray(org, dir, tnear, i);
  const float t = tfar[i];
  unsigned n_top = 0, n_drops = 0;
  unsigned char occ = 0;

  int stack[STACK];
  int sp = 1;
  stack[0] = 0;
  while (sp > 0) {
    --sp;
    const int node = stack[sp];
    if (STATS) {
      n_top += 1;
      node_touched[node] = 1;
    }
    float f[32];
    load_node(topnodes, node, f);
    bool hit[4];
    bool found = false;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float tmin, tmax;
      top_slab(f, c, r, tmin, tmax);
      hit[c] = (tmin <= tmax) && (tmin <= t);
      found = found || (hit[c] && static_cast<int>(f[28 + c]) > 0);
    }
    if (found) {
      occ = 1;
      break;
    }
    // inner children that are reached, in slot order
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (hit[c] && static_cast<int>(f[28 + c]) == 0) {
        if (sp < STACK) {
          stack[sp++] = static_cast<int>(f[24 + c]);
        } else if (STATS) {
          n_drops += 1;
        }
      }
    }
  }
  occ_out[i] = occ;
  if (STATS) {
    atomicAdd(stats + 0, static_cast<unsigned long long>(n_top));
    atomicAdd(stats + 4, static_cast<unsigned long long>(n_drops));
  }
}

// The closest-hit kernel's threads are persistent: as many blocks as the
// card holds at once (fewer for a small batch), each thread taking rays
// until they run out.
template <int MODE, bool STATS, int DEPTH>
void launch(const float4* topnodes, const float* tiles,
            const int* tile_of_leaf, int comp_level, int tile_words,
            const float* org, const float* dir, const float* tnear,
            const float* tfar, long long num_rays, float* t_out,
            float* u_out, float* v_out, int* tile_out,
            unsigned long long* next_ray, unsigned long long* stats,
            int* node_touched, int* tile_touched, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(3 * comp_level + 1) * QWORDS *
                      THREADS * sizeof(float);
  auto kern = cbvh_kernel<MODE, STATS, DEPTH>;
  int per_sm = 0, device = 0, sms = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, smem);
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long blocks = (num_rays + THREADS - 1) / THREADS;
  const unsigned grid = static_cast<unsigned>(
      min(blocks, static_cast<long long>(max(per_sm, 1)) * max(sms, 1)));
  kern<<<grid, THREADS, smem, stream>>>(
      topnodes, tiles, tile_of_leaf, comp_level, tile_words, org, dir, tnear,
      tfar, num_rays, t_out, u_out, v_out, tile_out, next_ray, stats,
      node_touched, tile_touched);
}

template <bool STATS, int DEPTH>
void launch_occluded(const float4* topnodes, const float* org,
                     const float* dir, const float* tnear, const float* tfar,
                     long long num_rays, unsigned char* occ_out,
                     unsigned long long* stats, int* node_touched,
                     cudaStream_t stream) {
  const unsigned grid =
      static_cast<unsigned>((num_rays + THREADS - 1) / THREADS);
  cbvh_occluded_kernel<STATS, DEPTH><<<grid, THREADS, 0, stream>>>(
      topnodes, org, dir, tnear, tfar, num_rays, occ_out, stats,
      node_touched);
}

template <int MODE, int DEPTH>
void launch_depth(bool stats, const float4* topnodes, const float* tiles,
                  const int* tile_of_leaf, int comp_level, int tile_words,
                  const float* org, const float* dir, const float* tnear,
                  const float* tfar, long long num_rays, float* t_out,
                  float* u_out, float* v_out, int* tile_out,
                  unsigned long long* next_ray, unsigned long long* st,
                  int* node_touched, int* tile_touched, cudaStream_t s) {
#define CBVH_LAUNCH(S)                                                   \
  launch<MODE, S, DEPTH>(topnodes, tiles, tile_of_leaf, comp_level,      \
                         tile_words, org, dir, tnear, tfar, num_rays,    \
                         t_out, u_out, v_out, tile_out, next_ray, st,    \
                         node_touched, tile_touched, s)
  if (stats)
    CBVH_LAUNCH(true);
  else
    CBVH_LAUNCH(false);
#undef CBVH_LAUNCH
}

}  // namespace

// Launches the closest-hit kernel on `stream` and returns
// cudaGetLastError() (0 = launched). Does not synchronise and allocates
// nothing. `topnodes` is (M, 32) floats, `tiles` (T, tile_words) floats,
// both 16-byte aligned (as torch allocates); `mode` is 0 (box), 1 (leaf)
// or 2 (grid), `comp_level` 1..4, `top_depth` the levels of the top level
// (at most 64).
// `next_ray` is one zeroed device word, the launch's ray counter.
// `stats`, `node_touched` and `tile_touched` are all null (the main path)
// or all device buffers (the counting build).
extern "C" int cbvh_launch(const float* topnodes, const float* tiles,
                           const int* tile_of_leaf, int mode, int comp_level,
                           int tile_words, int top_depth,
                           const float* org, const float* dir,
                           const float* tnear, const float* tfar,
                           long long num_rays, float* t_out, float* u_out,
                           float* v_out, int* tile_out,
                           unsigned long long* next_ray,
                           unsigned long long* stats, int* node_touched,
                           int* tile_touched, void* stream) {
  if (mode < MODE_BOX || mode > MODE_GRID || comp_level < 1 ||
      comp_level > MAX_LEVEL || top_depth < 1 || top_depth > MAX_DEPTH ||
      tile_words % 4 != 0 || tile_words < HDR_VEC * 4 || next_ray == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_rays <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* top4 = reinterpret_cast<const float4*>(topnodes);
  const bool st = stats != nullptr;
#define CBVH_CASE(M)                                                          \
  case M:                                                                     \
    if (top_depth <= SHALLOW)                                                 \
      launch_depth<M, SHALLOW>(st, top4, tiles, tile_of_leaf, comp_level,     \
                               tile_words, org, dir, tnear, tfar, num_rays,   \
                               t_out, u_out, v_out, tile_out, next_ray,       \
                               stats, node_touched, tile_touched, s);         \
    else                                                                      \
      launch_depth<M, MAX_DEPTH>(st, top4, tiles, tile_of_leaf,               \
                                 comp_level, tile_words, org, dir, tnear,     \
                                 tfar, num_rays, t_out, u_out, v_out,         \
                                 tile_out, next_ray, stats, node_touched,     \
                                 tile_touched, s);                            \
    break;
  switch (mode) {
    CBVH_CASE(MODE_BOX)
    CBVH_CASE(MODE_LEAF)
    CBVH_CASE(MODE_GRID)
  }
#undef CBVH_CASE
  return static_cast<int>(cudaGetLastError());
}

// Launches the occlusion kernel; the same contract. `occ_out` is one byte
// a ray (0 or 1, the storage of a bool tensor). `stats` and `node_touched`
// are both null or both device buffers.
extern "C" int cbvh_occluded_launch(const float* topnodes, int top_depth,
                                    const float* org, const float* dir,
                                    const float* tnear, const float* tfar,
                                    long long num_rays,
                                    unsigned char* occ_out,
                                    unsigned long long* stats,
                                    int* node_touched, void* stream) {
  if (top_depth < 1 || top_depth > MAX_DEPTH)
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_rays <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* top4 = reinterpret_cast<const float4*>(topnodes);
  const bool shallow = top_depth <= SHALLOW;
  if (stats != nullptr) {
    if (shallow)
      launch_occluded<true, SHALLOW>(top4, org, dir, tnear, tfar, num_rays,
                                     occ_out, stats, node_touched, s);
    else
      launch_occluded<true, MAX_DEPTH>(top4, org, dir, tnear, tfar, num_rays,
                                       occ_out, stats, node_touched, s);
  } else {
    if (shallow)
      launch_occluded<false, SHALLOW>(top4, org, dir, tnear, tfar, num_rays,
                                      occ_out, stats, node_touched, s);
    else
      launch_occluded<false, MAX_DEPTH>(top4, org, dir, tnear, tfar,
                                        num_rays, occ_out, stats,
                                        node_touched, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cbvh_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
