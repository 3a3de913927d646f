// Exact, unquantised top-k nearest vertices, any k in 1..V, for Hopper
// (sm_90a), with the TPU kernel's exact AABB cull (k <= 32).
//
// Replaces: animnerf_tpu/ops/knn_pallas.py::_knn_kernel (knn_pallas with
// packed=False, or with a padded vertex cloud above the packed key's
// 8192-vertex index field, such as SMPL-X's 10475) at its default
// tile_v = 512, with and without its cull. Its all-far skip (far2 > 0) is
// knn_far.cu's pass over this file's tile boxes: the sweep reads its flags,
// and a block whose points lie in a skipped group returns at once (its
// points' outputs are the pass's).
//
// Contract (bit-identical to the plain version in ops/knn_kernel.py): for
// point p and vertex v,
//   d2 = ((vx-px)^2 + (vy-py)^2) + (vz-pz)^2
// with every subtraction, product and sum rounded on its own
// (__fsub_rn / __fmul_rn / __fadd_rn: nvcc would otherwise contract
// a*a + b into an FMA, which the TPU kernel does not). The K smallest d2
// come out ascending with their vertex indices and sqrtf (IEEE) of d2,
// chosen and ordered by the TPU kernel's rule (knn_slots.cuh: per
// 512-vertex tile in index order, replace the first slot holding the
// maximum, then its sorting network), which decides exact ties as the TPU
// does. Any V >= K: there is no index field. The output does not depend
// on cull.
//
// Bound on the H100: operations. Per swept (point, vertex) pair: 3 f32
// subtractions, 3 multiplies, 2 adds and a compare, none of them an FMA,
// so the card's non-FMA f32 rate (half its 67 TFLOP/s FMA peak) bounds
// it; bytes are negligible (12 B in and 8K B out per point; the vertices
// stay on chip). The design takes the rest off the per-pair path and,
// with cull, sweeps fewer pairs:
// - Vertex rows once per call. knn_exact_rows writes (B, Vp, 4) rows
//   (x, y, z, 0), Vp = V padded to whole 512-vertex tiles with rows at
//   +inf (d2 = +inf is never below a slot: as if not visited), and the
//   AABBs of every 512-vertex tile and of its eight 64-vertex sub-tiles.
// - Double-buffered staging. Each tile's rows and sub-tile boxes are
//   copied into shared memory by cp.async while the block sweeps the
//   previous tile.
// - P query points per thread (a template argument): 2 up to K = 4, 1
//   above. At P = 2 one broadcast float4 row load, the loop counter and a
//   warp vote serve two pairs, and the next row's d2 is computed ahead of
//   the vote (the compare waits on the inserts, the d2 does not); the
//   inserts run only on rows where some point of the warp takes one.
//   Above K = 4 the insert is long, and a vote over more points takes it
//   on more rows: each thread branches on its own point. On incoherent
//   (random-order) points a warp's points enter their lists on different
//   rows, and those inserts, not the 9 operations, set the time.
// - The cull (the TPU kernel's, knn_pallas.py:103-121, made per point and
//   finer). A point's d2 to any vertex of a box is at least lb2, the
//   squared distance from the point to the box. When the tile's turn
//   comes, a warp skips it if, for every live point of the warp, lb2 to
//   the tile's box exceeds that point's current slot maximum; inside a
//   tile it skips a 64-vertex sub-tile if lb2 to the sub-tile's box
//   exceeds every point's current K-th entry of the tile list (at most the
//   slot maximum: the tile list starts full of it). A pair above either
//   bound would replace no slot and enter no tile list, so every skipped
//   pair is one that changes nothing: the slot history, and with it the
//   output, ties included, is that of the full sweep. The block stages a
//   tile only if one of its warps may need it, judged by the same test on
//   the thresholds before the previous tile (they only fall, so every
//   tile a warp needs is staged). This skips a superset of what the TPU's
//   AABB-to-AABB test skips.
//
// Two traps, each of which would break the tie rule bit for bit:
// - Never change the order in which tiles are visited, and never skip
//   against a bound from elsewhere (a nearest tile first, as kernel 1's
//   tile skip does; a pre-pass bound; the final K-th distance). Such a
//   skip drops pairs that would have entered a slot and been evicted
//   later, which moves the slot a tied neighbour lands in, and so the
//   output order among exact ties (tests/test_torch_knn.py's tie cloud:
//   v520 evicts v3's slot and v7 survives).
// - lb2 must never exceed a rounded d2 of a vertex in the box. It is
//   computed with the same separately rounded operations in the same
//   association as d2, from the gap fmaxf(fmaxf(lo - p, p - hi), 0) per
//   axis: |fl(v - p)| >= gap and rounding is monotone, so lb2 <= d2.
//   knn_sweep.cuh's box_lb2 is written gx*gx + gy*gy + gz*gz, which nvcc
//   contracts into FMAs under -O3; kernel 1 survives that only through its
//   deflated, quantised bound.
//
// Above 16 neighbours. Every K in 17..32 has its own instantiation: the
// slot rule's order is not total, so the k-slot result is not the first k
// of a K-slot one. Counterexample (k = 2, K = 3, one vertex a tile, all
// else far): tile 0 gives d2 0 (z), 5 (m), 9 (w); tile 1 gives a at 1;
// tile 2 gives e at 1. Three slots: [z, m, w] -> a replaces w -> e
// replaces m -> [z, e, a] sorted, first two z, e. Two slots: [z, m] -> a
// replaces m -> e (1, not below the maximum 1) is not merged: z, a. Above
// 32, knn_exact_any takes k at run time: one thread a point keeps its k
// slots in its own column of the output ((d2, index) in out_d, out_i,
// coalesced across the warp's points), takes each tile's pairs in
// ascending (d2, index) order by extract-min passes over the staged tile
// (one pass a merged pair, and one that ends the tile: the merge stops at
// the first pair not below the slots' maximum), replaces the first slot
// holding the maximum as the rule does, runs the bubble network on the
// slots and takes sqrtf in place. The same rule and the same d2, so the
// same output; no cull (the output does not depend on it), no stats.
// Slow but exact; its time is in PERF.md.

#include <cuda_runtime.h>
#include <math.h>

#include "knn_slots.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int TILE = knn_slots::TILE;  // 512 rows: the top-k rule's tile
constexpr int SUB = 64;                // rows a sub-tile box bounds
constexpr int SUBS = TILE / SUB;
constexpr int MAX_K = 32;  // every K up to here has its instantiation
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int FAR_GROUP = 1024;  // the all-far skip's point group
static_assert(SUB == 64, "a sub-tile is two warps of the rows kernel");

// query points a thread at K slots
template <int K>
constexpr int points_per_thread() {
  return K <= 4 ? 2 : 1;
}

__device__ __forceinline__ float pair_d2(const float4 v, float px, float py,
                                         float pz) {
  const float ex = __fsub_rn(v.x, px);
  const float ey = __fsub_rn(v.y, py);
  const float ez = __fsub_rn(v.z, pz);
  return __fadd_rn(__fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)),
                   __fmul_rn(ez, ez));
}

// squared distance from p to the box [lo xyz, hi xyz], rounded as pair_d2
// rounds: never above pair_d2 of a vertex inside the box
__device__ __forceinline__ float rounded_lb2(const float* box, float px,
                                             float py, float pz) {
  const float gx =
      fmaxf(fmaxf(__fsub_rn(box[0], px), __fsub_rn(px, box[3])), 0.0f);
  const float gy =
      fmaxf(fmaxf(__fsub_rn(box[1], py), __fsub_rn(py, box[4])), 0.0f);
  const float gz =
      fmaxf(fmaxf(__fsub_rn(box[2], pz), __fsub_rn(pz, box[5])), 0.0f);
  return __fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)),
                   __fmul_rn(gz, gz));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// one tile's rows and sub-tile boxes into shared memory (not committed)
__device__ __forceinline__ void stage(float4* rows_s, float* box_s,
                                      const float4* rows, const float* box) {
  for (int r = threadIdx.x; r < TILE; r += THREADS)
    cp_async16(rows_s + r, rows + r);
  for (int r = threadIdx.x; r < SUBS * 2; r += THREADS)
    cp_async16(box_s + 4 * r, box + 4 * r);
}

// a thread's P points: coordinates, K slots and the current tile's list
template <int K, int P>
struct Points {
  float x[P], y[P], z[P];
  float sd[P][K], td[P][K];
  int si[P][K], ti[P][K];
  bool live[P];
};

// sweep SUB staged rows (vertex indices id0..): every point's d2 per row
// against its tile list's K-th entry, the insert where below. P = 1: each
// thread branches on its own point (the insert's own test). P > 1: one
// warp vote per row, the next row's d2 computed before it (the compare
// waits on the inserts, the d2 does not), the inserts only on rows where
// some point of the warp takes one.
template <int K, int P>
__device__ __forceinline__ void sweep_rows(const float4* __restrict__ rows,
                                           int id0, Points<K, P>& st) {
  if constexpr (P == 1) {
#pragma unroll 4
    for (int j = 0; j < SUB; ++j)
      knn_slots::insert<K>(st.td[0], st.ti[0],
                           pair_d2(rows[j], st.x[0], st.y[0], st.z[0]),
                           id0 + j);
  } else {
    float dn[P];
    {
      const float4 v = rows[0];
#pragma unroll
      for (int p = 0; p < P; ++p)
        dn[p] = pair_d2(v, st.x[p], st.y[p], st.z[p]);
    }
#pragma unroll 4
    for (int j = 0; j < SUB; ++j) {
      float d[P];
      bool hit = false;
      const float4 vn = rows[(j + 1) & (SUB - 1)];  // row 0 again at the end
#pragma unroll
      for (int p = 0; p < P; ++p) {
        d[p] = dn[p];
        dn[p] = pair_d2(vn, st.x[p], st.y[p], st.z[p]);
        hit |= d[p] < st.td[p][K - 1];
      }
      if (__any_sync(FULL, hit)) {
#pragma unroll
        for (int p = 0; p < P; ++p)
          knn_slots::insert<K>(st.td[p], st.ti[p], d[p], id0 + j);
      }
    }
  }
}

// Block: THREADS threads, THREADS * P points; lane l of warp w takes points
// w * 32P + 32p + l (p < P), so a warp's points are one run of 32P
// consecutive points (ray-ordered or Morton-ordered on the main paths).
// grid (ceil(N / (THREADS P)), B). stats: null, or two u64 counters the
// kernel adds the (point slot, vertex) pairs it swept and skipped to (a
// warp's 32P point slots times each tile's or sub-tile's real vertices).
// far: null, or knn_far.cu's flags (B, ceil(N / FAR_GROUP)); a block's
// points lie in one group, and a block of a skipped group returns at once.
template <int K, int P>
__global__ void __launch_bounds__(THREADS)
knn_exact_kernel(const float* __restrict__ points,  // (B, N, 3)
                 const float4* __restrict__ rows,   // (B, Vp, 4)
                 const float* __restrict__ sbox,    // (B, Vp / SUB, 8)
                 const float* __restrict__ tbox,    // (B, Vp / TILE, 8)
                 float* __restrict__ out_d,         // (B, K, N)
                 int* __restrict__ out_i,           // (B, K, N)
                 unsigned long long* __restrict__ stats,
                 const int* __restrict__ far, int N, int V, int Vp,
                 int cull) {
  static_assert(FAR_GROUP % (THREADS * P) == 0,
                "a block's points lie in one far-skip group");
  if (far != nullptr &&
      far[(size_t)blockIdx.y * ((N + FAR_GROUP - 1) / FAR_GROUP) +
          blockIdx.x * (THREADS * P) / FAR_GROUP])
    return;  // knn_far.cu wrote this group's outputs
  __shared__ __align__(16) float4 s_rows[2][TILE];
  __shared__ __align__(16) float s_box[2][SUBS * 8];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int first = blockIdx.x * (THREADS * P) + warp * (32 * P) + lane;
  const int n_tiles = Vp / TILE;

  Points<K, P> st;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int n = first + 32 * p;
    st.live[p] = n < N;
    const float* q = points + ((size_t)b * N + (st.live[p] ? n : N - 1)) * 3;
    st.x[p] = q[0];
    st.y[p] = q[1];
    st.z[p] = q[2];
    knn_slots::fill<K>(st.sd[p], st.si[p], INFINITY);
  }
  const float4* rb = rows + (size_t)b * Vp;
  const float* sb = sbox + (size_t)b * (Vp / SUB) * 8;
  const float* tb = tbox + (size_t)b * n_tiles * 8;
  unsigned long long swept = 0, skipped = 0;

  stage(s_rows[0], s_box[0], rb, sb);  // tile 0: every slot is empty
  cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    float smax[P];
#pragma unroll
    for (int p = 0; p < P; ++p) smax[p] = knn_slots::max_of<K>(st.sd[p]);
    // does this warp need tile t; may a warp of the block need tile t + 1
    bool mine = !cull, next = !cull;
    if (cull) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        if (!st.live[p]) continue;
        mine |= !(rounded_lb2(tb + 8 * t, st.x[p], st.y[p], st.z[p]) >
                  smax[p]);
        if (t + 1 < n_tiles)
          next |= !(rounded_lb2(tb + 8 * (t + 1), st.x[p], st.y[p],
                                st.z[p]) > smax[p]);
      }
    }
    const bool need = __any_sync(FULL, mine);
    // also the barrier after which buffer (t + 1) & 1 is free
    if (__syncthreads_or(next) && t + 1 < n_tiles)
      stage(s_rows[(t + 1) & 1], s_box[(t + 1) & 1], rb + (t + 1) * TILE,
            sb + (t + 1) * SUBS * 8);
    cp_async_commit();  // possibly empty: one group per tile
    cp_async_wait1();   // tile t's group has landed
    __syncthreads();
    const int rows_t = min(TILE, V - t * TILE);
    if (!need) {
      skipped += rows_t;
      continue;
    }
#pragma unroll
    for (int p = 0; p < P; ++p) knn_slots::fill<K>(st.td[p], st.ti[p], smax[p]);
    const float4* rs = s_rows[t & 1];
    const float* bs = s_box[t & 1];
    for (int s = 0; s * SUB < rows_t; ++s) {
      bool sub = !cull;
      if (cull) {
#pragma unroll
        for (int p = 0; p < P; ++p)
          sub |= st.live[p] &&
                 !(rounded_lb2(bs + 8 * s, st.x[p], st.y[p], st.z[p]) >
                   st.td[p][K - 1]);
      }
      const int rows_s = min(SUB, rows_t - s * SUB);
      if (__any_sync(FULL, sub)) {
        sweep_rows<K, P>(rs + s * SUB, t * TILE + s * SUB, st);
        swept += rows_s;
      } else {
        skipped += rows_s;
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p)
      knn_slots::merge<K>(st.sd[p], st.si[p], st.td[p], st.ti[p]);
  }
  if (stats != nullptr && lane == 0) {
    atomicAdd(stats, swept * (32ull * P));
    atomicAdd(stats + 1, skipped * (32ull * P));
  }

#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (!st.live[p]) continue;
    knn_slots::sort<K>(st.sd[p], st.si[p]);
    const int n = first + 32 * p;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const size_t o = ((size_t)b * K + s) * N + n;
      out_d[o] = sqrtf(st.sd[p][s]);
      out_i[o] = st.si[p][s];
    }
  }
}

constexpr int ANY_THREADS = 128;

// any k: the slot rule with the slots of point n in out_d[b, s, n] (d2)
// and out_i[b, s, n], s < k; each tile's pairs merged in ascending (d2,
// index) order, found by extract-min passes over the staged tile's real
// rows; every thread takes part in the staging, dead ones included
__global__ void __launch_bounds__(ANY_THREADS)
knn_exact_any(const float* __restrict__ points,  // (B, N, 3)
              const float4* __restrict__ rows,   // (B, Vp, 4)
              const int* __restrict__ far, float* __restrict__ out_d,
              int* __restrict__ out_i, int N, int V, int Vp, int k) {
  static_assert(FAR_GROUP % ANY_THREADS == 0,
                "a block's points lie in one far-skip group");
  const int b = blockIdx.y;
  if (far != nullptr &&
      far[(size_t)b * ((N + FAR_GROUP - 1) / FAR_GROUP) +
          blockIdx.x * ANY_THREADS / FAR_GROUP])
    return;  // knn_far.cu wrote this group's outputs
  __shared__ float4 s_rows[TILE];
  const int n = blockIdx.x * ANY_THREADS + threadIdx.x;
  const bool live = n < N;
  const float* q = points + ((size_t)b * N + (live ? n : N - 1)) * 3;
  const float px = q[0], py = q[1], pz = q[2];
  float* sd = out_d + (size_t)b * k * N + n;  // slot s at sd[s * N]
  int* si = out_i + (size_t)b * k * N + n;
  if (live)
    for (int s = 0; s < k; ++s) {
      sd[(size_t)s * N] = INFINITY;
      si[(size_t)s * N] = 0;
    }
  float smax = INFINITY;  // the slots' maximum, first held by slot am
  int am = 0;
  const float4* rb = rows + (size_t)b * Vp;
  for (int t = 0; t * TILE < Vp; ++t) {
    __syncthreads();  // the previous tile consumed
    for (int r = threadIdx.x; r < TILE; r += ANY_THREADS)
      s_rows[r] = rb[t * TILE + r];
    __syncthreads();
    if (!live) continue;
    const int rows_t = min(TILE, V - t * TILE);
    float pd = -INFINITY;  // the pair merged last (none: below every pair)
    int pi = -1;
    for (int s = 0; s < k; ++s) {
      float bd = INFINITY;
      int bi = -1;
      for (int j = 0; j < rows_t; ++j) {
        const float d = pair_d2(s_rows[j], px, py, pz);
        const int id = t * TILE + j;
        const bool after = d > pd || (d == pd && id > pi);
        const bool better = d < bd || (d == bd && bi < 0);
        if (after && better) {
          bd = d;
          bi = id;
        }
      }
      if (!(bd < smax)) break;  // the pairs ascend, the maximum only falls
      sd[(size_t)am * N] = bd;
      si[(size_t)am * N] = bi;
      pd = bd;
      pi = bi;
      smax = sd[0];
      am = 0;
      for (int u = 1; u < k; ++u) {
        const float v = sd[(size_t)u * N];
        if (v > smax) {
          smax = v;
          am = u;
        }
      }
    }
  }
  if (!live) return;
  // the bubble network, a swap only on a strictly larger d2, then sqrtf
  for (int end = k - 1; end > 0; --end)
    for (int a = 0; a < end; ++a) {
      const float da = sd[(size_t)a * N], db = sd[(size_t)(a + 1) * N];
      if (da > db) {
        const int ia = si[(size_t)a * N];
        sd[(size_t)a * N] = db;
        sd[(size_t)(a + 1) * N] = da;
        si[(size_t)a * N] = si[(size_t)(a + 1) * N];
        si[(size_t)(a + 1) * N] = ia;
      }
    }
  for (int s = 0; s < k; ++s) sd[(size_t)s * N] = sqrtf(sd[(size_t)s * N]);
}

// rows (B, Vp, 4): (x, y, z, 0) of vertex v < V, (+inf, +inf, +inf, 0)
// beyond; sbox (B, Vp / SUB, 8) and tbox (B, Vp / TILE, 8): [lo xyz, hi xyz,
// 0, 0] over the real vertices of each sub-tile and tile (lo +inf, hi -inf
// where it holds none). Block: one tile, TILE threads; grid (Vp / TILE, B).
__global__ void __launch_bounds__(TILE)
knn_exact_rows(const float* __restrict__ verts,  // (B, V, 3)
               float4* __restrict__ rows, float* __restrict__ sbox,
               float* __restrict__ tbox, int V, int Vp) {
  __shared__ float s_part[TILE / 32][6];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int v = blockIdx.x * TILE + threadIdx.x;
  const bool real = v < V;
  float c[3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
    c[a] = real ? verts[((size_t)b * V + v) * 3 + a] : INFINITY;
  rows[(size_t)b * Vp + v] = make_float4(c[0], c[1], c[2], 0.0f);
  float lo[3], hi[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    lo[a] = c[a];
    hi[a] = real ? c[a] : -INFINITY;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lo[a] = fminf(lo[a], __shfl_xor_sync(FULL, lo[a], o));
      hi[a] = fmaxf(hi[a], __shfl_xor_sync(FULL, hi[a], o));
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      s_part[warp][a] = lo[a];
      s_part[warp][3 + a] = hi[a];
    }
  }
  __syncthreads();
  // threads 0..SUBS-1: a sub-tile (two warps); thread SUBS: the tile
  const int t = threadIdx.x;
  if (t > SUBS) return;
  const int w0 = t < SUBS ? 2 * t : 0;
  const int w1 = t < SUBS ? 2 * t + 2 : TILE / 32;
  float box[8] = {INFINITY, INFINITY, INFINITY,
                  -INFINITY, -INFINITY, -INFINITY, 0.0f, 0.0f};
  for (int w = w0; w < w1; ++w) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      box[a] = fminf(box[a], s_part[w][a]);
      box[3 + a] = fmaxf(box[3 + a], s_part[w][3 + a]);
    }
  }
  float* out = t < SUBS
      ? sbox + ((size_t)b * (Vp / SUB) + blockIdx.x * SUBS + t) * 8
      : tbox + ((size_t)b * (Vp / TILE) + blockIdx.x) * 8;
#pragma unroll
  for (int a = 0; a < 8; ++a) out[a] = box[a];
}

// launch the instantiation for k (1..MAX_K)
template <int K>
void launch(int k, int B, cudaStream_t stream, const float* points,
            const float4* rows, const float* sbox, const float* tbox,
            int cull, unsigned long long* stats, const int* far,
            float* out_d, int* out_i, int N, int V, int Vp) {
  if (k == K) {
    constexpr int P = points_per_thread<K>();
    const dim3 grid((N + THREADS * P - 1) / (THREADS * P), B);
    knn_exact_kernel<K, P><<<grid, THREADS, 0, stream>>>(
        points, rows, sbox, tbox, out_d, out_i, stats, far, N, V, Vp, cull);
  } else if constexpr (K < MAX_K) {
    launch<K + 1>(k, B, stream, points, rows, sbox, tbox, cull, stats, far,
                  out_d, out_i, N, V, Vp);
  }
}

}  // namespace

// Vp = V rounded up to whole 512-vertex tiles
extern "C" int animnerf_knn_exact_rows(const void* verts, void* rows,
                                       void* sbox, void* tbox, int B, int V,
                                       int Vp, void* stream) {
  if (V < 1 || Vp < V || Vp % TILE != 0 || Vp - V >= TILE)
    return (int)cudaErrorInvalidValue;
  if (B > 0) {
    const dim3 grid(Vp / TILE, B);
    knn_exact_rows<<<grid, TILE, 0, (cudaStream_t)stream>>>(
        (const float*)verts, (float4*)rows, (float*)sbox, (float*)tbox, V,
        Vp);
  }
  return (int)cudaGetLastError();
}

// rows, sbox, tbox: animnerf_knn_exact_rows's for V vertices padded to Vp;
// cull: skip the tiles and sub-tiles that cannot change a point's slots
// (the output is the same either way); stats: null, or two u64 counters
// of (point slot, vertex) pairs [swept, skipped] that the kernel adds to;
// far: null, or the flags of animnerf_knn_far (which wrote the skipped
// groups' outputs).
extern "C" int animnerf_knn_exact(const void* points, const void* rows,
                                  const void* sbox, const void* tbox,
                                  int cull, void* stats, const void* far,
                                  void* out_d, void* out_i, int B, int N,
                                  int V, int Vp, int k, void* stream) {
  if (k < 1 || V < k || Vp < V || Vp % TILE != 0 || Vp - V >= TILE)
    return (int)cudaErrorInvalidValue;
  if (N > 0 && B > 0) {
    if (k <= MAX_K)
      launch<1>(k, B, (cudaStream_t)stream, (const float*)points,
                (const float4*)rows, (const float*)sbox, (const float*)tbox,
                cull, (unsigned long long*)stats, (const int*)far,
                (float*)out_d, (int*)out_i, N, V, Vp);
    else
      knn_exact_any<<<dim3((N + ANY_THREADS - 1) / ANY_THREADS, B),
                      ANY_THREADS, 0, (cudaStream_t)stream>>>(
          (const float*)points, (const float4*)rows, (const int*)far,
          (float*)out_d, (int*)out_i, N, V, Vp, k);
  }
  return (int)cudaGetLastError();
}
