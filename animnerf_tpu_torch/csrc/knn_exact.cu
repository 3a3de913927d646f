// Exact, unquantised top-k nearest vertices, any k in 1..V, for Hopper
// (sm_90a), with the TPU kernel's exact AABB cull.
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
// Every K up to 23 (ops/knn_kernel.py EXACT_WIDE_ABOVE) has its own
// instantiation of this sweep, not one K for several k: the slot rule's
// order is not total, so the k-slot result is not the first k
// of a K-slot one. Counterexample (k = 2, K = 3, one vertex a tile, all
// else far): tile 0 gives d2 0 (z), 5 (m), 9 (w); tile 1 gives a at 1;
// tile 2 gives e at 1. Three slots: [z, m, w] -> a replaces w -> e
// replaces m -> [z, e, a] sorted, first two z, e. Two slots: [z, m] -> a
// replaces m -> e (1, not below the maximum 1) is not merged: z, a.
//
// Above 23 (ops/knn_kernel.py EXACT_WIDE_ABOVE: on both shapes of
// chip_smoke.py's lines it was the faster at k = 24 and 32, where the
// instantiations K = 24..32 it replaced ran, not at 17 on Morton-ordered
// points, whose warps the per-K sweep's cull serves well; the entry
// animnerf_knn_exact_wide takes any k): knn_exact_wide, a warp
// a point on knn_wide.cuh, k a run-time bound, in two passes.
// - Why a first pass may ignore the slot rule. Merging a tile's k
//   smallest pairs into the slots by the rule leaves the k smallest d2 of
//   slots and tile as a multiset, so after the last tile the slots hold
//   the k smallest d2 of the cloud; the rule decides only which of
//   several vertices at one d2 are kept and in what order equal d2 come
//   out. A point whose k + 1 smallest d2 strictly ascend has neither
//   choice: its output is its k nearest vertices by d2, whatever order
//   they are found in.
// - The nearest-first pass (k + 1 <= 32R slots, at most 32 tiles). Lane t
//   bounds tile t by rounded_lb2 (5 low bits cleared: still below every
//   rounded d2 in it), one bitonic sort orders the tiles, and the warp
//   sweeps them nearest first, lane l taking rows l, l + 32, ... of the
//   tile from global memory (L1 and L2 hold the cloud), skipping the
//   sub-tiles whose bound exceeds the current (k+1)-th d2 and stopping at
//   the first tile whose bound does. The lanes whose pair's (d2 bits,
//   index) key is below the list's (k+1)-th vote it into the warp's
//   buffer; a buffer that would overflow, and the buffer at a tile's end,
//   is bitonic-sorted and folded into the point's sorted list of 32R
//   keys (R registers a lane). If the first k + 1 d2 of the list strictly
//   ascend, the first k are the output.
// - The slot rule, for the other points (ties at the k-th neighbour or
//   among the first k: the 1/64-grid tie clouds, coincident vertices) and
//   at the cap. The block's such points, WIDE_P a warp one after another,
//   sweep the staged tiles (the double-buffered staging above, one
//   barrier a tile) in index order, with the per-point cull: lanes 0..7
//   test the sub-tile boxes against the point's slot maximum when the
//   tile's turn comes (both traps above still hold: the tiles are visited
//   in index order and the bound is the slot history's own). Only a pair
//   below the slot maximum at the tile's start can be merged, and only
//   the tile's k smallest such pairs (after k merges every slot holds one
//   of them, and the next is not below their maximum); they reach the
//   tile list T through the same vote, buffer and folds, so T ends
//   ascending by (d2, index), the order the TPU kernel merges in. The
//   slots are kept as a list sorted by (d2 descending, slot ascending):
//   its element i is the slot maximum after i merges (the pairs merged
//   before are below it), so the i-th pair of T is merged iff it is below
//   element i's d2, and it takes element i's slot. One vote finds the
//   merged prefix, the pairs replace those elements in place and a
//   bitonic sort restores the order.
// - At the end a bitonic sort by (d2, slot) orders the slots: the bubble
//   network swaps only on a strictly larger d2, a stable sort by d2 over
//   slot order, so the output is the same, ties included; then sqrtf.
// stats counts each pass's real pairs swept and skipped per point.
// R = 1, 2, 4 (k + 1 <= 32, 64, 128); at k = knn_wide::CAP = 128 the slot
// rule alone on R = 4. Above the cap, knn_exact_any takes k at run time:
// one thread a point keeps its k slots in its own column of the output,
// takes each tile's pairs in ascending (d2, index) order by extract-min
// passes over the staged tile and replaces the first slot holding the
// maximum, then the network and sqrtf in place; no cull, every real pair
// counted swept. Slow but exact; its time is in PERF.md.

#include <cuda_runtime.h>
#include <math.h>

#include "knn_slots.cuh"
#include "knn_wide.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int TILE = knn_slots::TILE;  // 512 rows: the top-k rule's tile
constexpr int SUB = 64;                // rows a sub-tile box bounds
constexpr int SUBS = TILE / SUB;
constexpr int MAX_K = 23;  // every K up to here has its instantiation
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
// by a block of NT threads
template <int NT = THREADS>
__device__ __forceinline__ void stage(float4* rows_s, float* box_s,
                                      const float4* rows, const float* box) {
  for (int r = threadIdx.x; r < TILE; r += NT)
    cp_async16(rows_s + r, rows + r);
  for (int r = threadIdx.x; r < SUBS * 2; r += NT)
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

constexpr int WIDE_WARPS = 16;
constexpr int WIDE_THREADS = 32 * WIDE_WARPS;
constexpr int WIDE_P = 2;  // points a warp, swept one after another
constexpr int WIDE_POINTS = WIDE_WARPS * WIDE_P;  // a block's
typedef unsigned long long u64;
constexpr u64 NO_KEY = ~0ull;  // above every (d2 bits, index) key

// The slot list: element e is (key, vertex) with key = (~bits(d2) << 32) |
// slot, so that ascending keys are the order (d2 descending, slot
// ascending) and the head is the first slot holding the maximum; the
// elements past k are NO_KEY.
__device__ __forceinline__ u64 slot_key(float d2, unsigned slot) {
  return ((u64)~__float_as_uint(d2) << 32) | slot;
}

__device__ __forceinline__ float slot_d2(u64 key) {
  return __uint_as_float(~(unsigned)(key >> 32));
}

// merge the tile list T (ascending, NO_KEY after its pairs) into the slot
// list (h, hv): the i-th pair of T is merged iff it lies below the slot
// maximum after i merges, which is element i's d2 (the i pairs merged
// before it are no larger than it: were one equal to the maximum, the
// pair would not be below it); it takes that element's slot. So a vote
// finds the m merged pairs, they replace elements 0..m-1 in place, and a
// sort restores the list's order. Returns the new maximum.
template <int R>
__device__ __forceinline__ float merge_tile(u64 (&h)[R], int (&hv)[R],
                                            const u64 (&T)[R]) {
  bool any = false;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float cd = __uint_as_float((unsigned)(T[r] >> 32));
    if (h[r] != NO_KEY && cd < slot_d2(h[r])) {  // NO_KEY in T: NaN
      h[r] = slot_key(cd, (unsigned)h[r]);
      hv[r] = (int)(unsigned)T[r];
      any = true;
    }
  }
  if (__any_sync(knn_wide::FULL, any)) knn_wide::bitonic_sort<R, true>(h, hv);
  return slot_d2(knn_wide::element<R>(h, 0));
}

// fold the warp's buffer (cnt keys) into the tile list T; its k-th key
// (and that key's d2, +inf while T holds fewer than k) becomes the filter
template <int R>
__device__ __forceinline__ void fold_buffer(u64 (&T)[R], const u64* buf,
                                            int& cnt, u64& tk, float& tkd,
                                            int k) {
  u64 b[R];
  knn_wide::load_buffer<R>(b, buf, cnt, NO_KEY);
  knn_wide::sort_prefix<R>(b, cnt);
  knn_wide::fold<R>(T, b);
  tk = knn_wide::element<R>(T, k - 1);
  tkd = tk == NO_KEY ? INFINITY : __uint_as_float((unsigned)(tk >> 32));
  cnt = 0;
}

// the tile list of one point: the k smallest (d2, index) keys of the
// swept sub-tiles' pairs below smax, ascending in T (NO_KEY after them)
template <int R>
__device__ __forceinline__ void tile_list(u64 (&T)[R],
                                          const float4* __restrict__ rs,
                                          int id0, unsigned subs, float px,
                                          float py, float pz, float smax,
                                          int k, u64* buf) {
  constexpr int NS = 32 * R;
  const int lane = knn_wide::lane_id();
#pragma unroll
  for (int r = 0; r < R; ++r) T[r] = NO_KEY;
  u64 tk = NO_KEY;
  float tkd = INFINITY;
  int cnt = 0;
  for (int s = 0; s < SUBS; ++s) {
    if (!(subs >> s & 1u)) continue;
#pragma unroll
    for (int h = 0; h < SUB / 32; ++h) {
      const int j = s * SUB + h * 32 + lane;
      const float d2 = pair_d2(rs[j], px, py, pz);
      bool take = d2 < smax && d2 <= tkd;
      if (!__any_sync(knn_wide::FULL, take)) continue;
      const u64 key = ((u64)__float_as_uint(d2) << 32) | (unsigned)(id0 + j);
      take = take && key < tk;
      const unsigned m = __ballot_sync(knn_wide::FULL, take);
      if (m == 0) continue;
      if (cnt + __popc(m) > NS) {
        fold_buffer<R>(T, buf, cnt, tk, tkd, k);
        take = take && key < tk;
      }
      cnt = knn_wide::append(buf, cnt, take, key);
    }
  }
  if (cnt > 0) fold_buffer<R>(T, buf, cnt, tk, tkd, k);
}

// The nearest-first pass of one point (k + 1 <= 32R, at most 32 tiles):
// its k + 1 smallest (d2, index) keys ascending in L (NO_KEY after them).
// Lane t bounds tile t by its rounded box distance (5 low bits cleared:
// still below every d2 in it), one sort orders the tiles, and the warp
// sweeps them in that order, rows from global memory (L1 holds the
// cloud), until a tile's bound exceeds the (k+1)-th d2; inside a tile it
// skips the sub-tiles above it. Pairs below the (k+1)-th key go through
// the buffer and folds. Returns whether the first k + 1 d2 strictly
// ascend; swept gets the real pairs swept.
template <int R>
__device__ __forceinline__ bool nearest_pass(u64 (&L)[R],
                                             const float4* __restrict__ rb,
                                             const float* __restrict__ sb,
                                             const float* __restrict__ tb,
                                             int nt, int V, float px,
                                             float py, float pz, int k,
                                             u64* buf, u64& swept) {
  constexpr int NS = 32 * R;
  const int lane = knn_wide::lane_id();
  unsigned order[1] = {0xFFFFFFFFu};
  if (lane < nt)
    order[0] = (__float_as_uint(rounded_lb2(tb + 8 * lane, px, py, pz)) &
                ~31u) | (unsigned)lane;
  knn_wide::bitonic_sort<1>(order);
#pragma unroll
  for (int r = 0; r < R; ++r) L[r] = NO_KEY;
  u64 tk = NO_KEY;  // the (k+1)-th key, and its d2 (+inf while unknown)
  float tkd = INFINITY;
  int cnt = 0;
  for (int i = 0; i < nt; ++i) {
    const unsigned o = __shfl_sync(knn_wide::FULL, order[0], i);
    if (__uint_as_float(o & ~31u) > tkd) break;  // and every later tile
    const int t = (int)(o & 31u);
    const int rows_t = min(TILE, V - t * TILE);
    const int subs_t = (rows_t + SUB - 1) / SUB;
    const bool want =
        lane < subs_t &&
        !(rounded_lb2(sb + (t * SUBS + (lane < SUBS ? lane : 0)) * 8, px,
                      py, pz) > tkd);
    const unsigned subs = __ballot_sync(knn_wide::FULL, want);
    swept += __popc(subs) * SUB -
             (int)(subs >> (subs_t - 1) & 1u) * (subs_t * SUB - rows_t);
    for (int s = 0; s < SUBS; ++s) {
      if (!(subs >> s & 1u)) continue;
#pragma unroll
      for (int h = 0; h < SUB / 32; ++h) {
        const int j = t * TILE + s * SUB + h * 32 + lane;
        const float d2 = pair_d2(rb[j], px, py, pz);
        bool take = d2 <= tkd;
        if (!__any_sync(knn_wide::FULL, take)) continue;
        const u64 key = ((u64)__float_as_uint(d2) << 32) | (unsigned)j;
        take = take && key < tk;
        const unsigned m = __ballot_sync(knn_wide::FULL, take);
        if (m == 0) continue;
        if (cnt + __popc(m) > NS) {
          fold_buffer<R>(L, buf, cnt, tk, tkd, k + 1);
          take = take && key < tk;
        }
        cnt = knn_wide::append(buf, cnt, take, key);
      }
    }
    if (cnt > 0) fold_buffer<R>(L, buf, cnt, tk, tkd, k + 1);
  }
  // element e against e + 1 (lane 31 of register r: register r + 1's
  // lane 0), e < k: NO_KEY's NaN fails
  bool rise = true;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const u64 nx = __shfl_sync(knn_wide::FULL, L[r], (lane + 1) & 31);
    u64 nx2 = nx;
    if (r + 1 < R)
      nx2 = __shfl_sync(knn_wide::FULL, L[r + 1 < R ? r + 1 : r], 0);
    const u64 next = lane == 31 ? nx2 : nx;
    const float d = __uint_as_float((unsigned)(L[r] >> 32));
    const float dn = __uint_as_float((unsigned)(next >> 32));
    if (lane + 32 * r < k)
      rise = rise && L[r] != NO_KEY && next != NO_KEY && d < dn;
  }
  return __all_sync(knn_wide::FULL, rise);
}

// k <= 32R: the slot rule, a warp a point (see the note at the top).
// Block: WIDE_THREADS threads, WIDE_POINTS consecutive points; warp w
// takes points w * WIDE_P + p. grid (ceil(N / WIDE_POINTS), B). stats:
// null, or two u64 counters the kernel adds each live point's real
// (point, vertex) pairs swept and skipped to. far: as knn_exact_kernel's.
template <int R>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
knn_exact_wide(const float* __restrict__ points,  // (B, N, 3)
               const float4* __restrict__ rows,   // (B, Vp, 4)
               const float* __restrict__ sbox,    // (B, Vp / SUB, 8)
               const float* __restrict__ tbox,    // (B, Vp / TILE, 8)
               float* __restrict__ out_d,         // (B, k, N)
               int* __restrict__ out_i,           // (B, k, N)
               unsigned long long* __restrict__ stats,
               const int* __restrict__ far, int N, int V, int Vp, int k,
               int cull) {
  constexpr int P = WIDE_P;
  static_assert(FAR_GROUP % WIDE_POINTS == 0,
                "a block's points lie in one far-skip group");
  static_assert(SUBS <= 32, "a lane tests a sub-tile box");
  if (far != nullptr &&
      far[(size_t)blockIdx.y * ((N + FAR_GROUP - 1) / FAR_GROUP) +
          blockIdx.x * WIDE_POINTS / FAR_GROUP])
    return;  // knn_far.cu wrote this group's outputs
  __shared__ __align__(16) float4 s_rows[2][TILE];
  __shared__ __align__(16) float s_box[2][SUBS * 8];
  __shared__ u64 s_buf[WIDE_WARPS][32 * R];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int first = blockIdx.x * WIDE_POINTS + warp * P;
  const int n_tiles = Vp / TILE;

  float x[P], y[P], z[P], pmax[P];
  u64 ph[P][R];  // the slot lists (slot_key, vertex)
  int phv[P][R];
  bool live[P];  // the points the slot rule takes
#pragma unroll
  for (int p = 0; p < P; ++p) {
    live[p] = first + p < N;
    const float* q =
        points + ((size_t)b * N + (live[p] ? first + p : N - 1)) * 3;
    x[p] = q[0];
    y[p] = q[1];
    z[p] = q[2];
    pmax[p] = INFINITY;  // slots (+inf, 0); beyond k NO_KEY, after them all
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int e = lane + 32 * r;
      ph[p][r] = e < k ? slot_key(INFINITY, e) : NO_KEY;
      phv[p][r] = 0;
    }
  }
  const float4* rb = rows + (size_t)b * Vp;
  const float* sb = sbox + (size_t)b * (Vp / SUB) * 8;
  const float* tb = tbox + (size_t)b * n_tiles * 8;
  u64 swept = 0, skipped = 0;

  // the nearest-first pass: a point whose k + 1 smallest d2 strictly
  // ascend has the slot rule's output, its k nearest in order of d2
  if (k + 1 <= 32 * R && n_tiles <= 32) {
#pragma unroll 1
    for (int p = 0; p < P; ++p) {
      if (first + p >= N) break;
      u64 L[R], sw = 0;
      const bool done = nearest_pass<R>(
          L, rb, sb, tb, n_tiles, V, knn_wide::pick<P>(x, p),
          knn_wide::pick<P>(y, p), knn_wide::pick<P>(z, p), k, s_buf[warp],
          sw);
      swept += sw;
      skipped += V - sw;
      knn_wide::put<P>(live, p, !done);
      if (!done) continue;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int e = lane + 32 * r;
        if (e >= k) continue;
        const size_t o = ((size_t)b * k + e) * N + first + p;
        out_d[o] = sqrtf(__uint_as_float((unsigned)(L[r] >> 32)));
        out_i[o] = (int)(unsigned)L[r];
      }
    }
  }
  int n_live = 0;
#pragma unroll
  for (int p = 0; p < P; ++p) n_live += live[p];
  if (!__syncthreads_or(n_live > 0)) {  // no point of the block is left
    if (stats != nullptr && lane == 0) {
      atomicAdd(stats, swept);
      atomicAdd(stats + 1, skipped);
    }
    return;
  }

  stage<WIDE_THREADS>(s_rows[0], s_box[0], rb, sb);
  cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    // does this warp need tile t; may a warp of the block need tile t + 1
    bool mine = !cull, next = !cull;
    if (cull) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        if (!live[p]) continue;
        mine |= !(rounded_lb2(tb + 8 * t, x[p], y[p], z[p]) > pmax[p]);
        if (t + 1 < n_tiles)
          next |= !(rounded_lb2(tb + 8 * (t + 1), x[p], y[p], z[p]) >
                    pmax[p]);
      }
    }
    // also the barrier after which buffer (t + 1) & 1 is free
    if (__syncthreads_or(next) && t + 1 < n_tiles)
      stage<WIDE_THREADS>(s_rows[(t + 1) & 1], s_box[(t + 1) & 1],
                          rb + (t + 1) * TILE, sb + (t + 1) * SUBS * 8);
    cp_async_commit();  // possibly empty: one group per tile
    cp_async_wait1();   // tile t's group has landed
    __syncthreads();
    const int rows_t = min(TILE, V - t * TILE);
    if (!mine) {
      skipped += (u64)n_live * rows_t;
      continue;
    }
    const int subs_t = (rows_t + SUB - 1) / SUB;  // sub-tiles with a vertex
    const float4* rs = s_rows[t & 1];
    const float* bs = s_box[t & 1];
    // the warp's points one after another, each on working registers (a
    // runtime p: the tile's work exists once in the code)
#pragma unroll 1
    for (int p = 0; p < P; ++p) {
      if (!knn_wide::pick<P>(live, p)) continue;
      const float px = knn_wide::pick<P>(x, p), py = knn_wide::pick<P>(y, p),
                  pz = knn_wide::pick<P>(z, p);
      float smax = knn_wide::pick<P>(pmax, p);
      const bool want =
          lane < subs_t &&
          (!cull ||
           !(rounded_lb2(bs + 8 * (lane < SUBS ? lane : 0), px, py, pz) >
             smax));
      const unsigned subs = __ballot_sync(knn_wide::FULL, want);
      // real rows swept: whole sub-tiles, less the last one's padding
      const int rows_s =
          __popc(subs) * SUB -
          (int)(subs >> (subs_t - 1) & 1u) * (subs_t * SUB - rows_t);
      swept += rows_s;
      skipped += rows_t - rows_s;
      if (subs == 0) continue;
      u64 T[R];
      tile_list<R>(T, rs, t * TILE, subs, px, py, pz, smax, k, s_buf[warp]);
      if (!(__uint_as_float((unsigned)(knn_wide::element<R>(T, 0) >> 32)) <
            smax))
        continue;  // no pair below the maximum: nothing merges
      u64 h[R];
      int hv[R];
      knn_wide::pick_list<P, R>(h, ph, p);
      knn_wide::pick_list<P, R>(hv, phv, p);
      smax = merge_tile<R>(h, hv, T);
      knn_wide::put_list<P, R>(ph, p, h);
      knn_wide::put_list<P, R>(phv, p, hv);
      knn_wide::put<P>(pmax, p, smax);
    }
  }
  if (stats != nullptr && lane == 0) {
    atomicAdd(stats, swept);
    atomicAdd(stats + 1, skipped);
  }

#pragma unroll 1
  for (int p = 0; p < P; ++p) {
    if (!knn_wide::pick<P>(live, p)) continue;
    // stable by d2 over slot order: ascending (d2 bits, slot)
    u64 key[R];
    int vid[R];
    knn_wide::pick_list<P, R>(key, ph, p);
    knn_wide::pick_list<P, R>(vid, phv, p);
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (key[r] != NO_KEY)
        key[r] = ((u64)__float_as_uint(slot_d2(key[r])) << 32) |
                 (unsigned)key[r];
    knn_wide::bitonic_sort<R, true>(key, vid);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int e = lane + 32 * r;
      if (e >= k) continue;
      const size_t o = ((size_t)b * k + e) * N + first + p;
      out_d[o] = sqrtf(__uint_as_float((unsigned)(key[r] >> 32)));
      out_i[o] = vid[r];
    }
  }
}

template <int R>
int launch_wide(int B, cudaStream_t stream, const float* points,
                const float4* rows, const float* sbox, const float* tbox,
                int cull, unsigned long long* stats, const int* far,
                float* out_d, int* out_i, int N, int V, int Vp, int k) {
  const dim3 grid((N + WIDE_POINTS - 1) / WIDE_POINTS, B);
  knn_exact_wide<R><<<grid, WIDE_THREADS, 0, stream>>>(
      points, rows, sbox, tbox, out_d, out_i, stats, far, N, V, Vp, k, cull);
  return (int)cudaGetLastError();
}

constexpr int ANY_THREADS = 128;

// k above knn_wide::CAP: the slot rule with the slots of point n in
// out_d[b, s, n] (d2) and out_i[b, s, n], s < k; each tile's pairs merged
// in ascending (d2, index) order, found by extract-min passes over the
// staged tile's real rows; every thread takes part in the staging, dead
// ones included; stats: every real pair swept
__global__ void __launch_bounds__(ANY_THREADS)
knn_exact_any(const float* __restrict__ points,  // (B, N, 3)
              const float4* __restrict__ rows,   // (B, Vp, 4)
              const int* __restrict__ far,
              unsigned long long* __restrict__ stats,
              float* __restrict__ out_d, int* __restrict__ out_i, int N,
              int V, int Vp, int k) {
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
  const unsigned lives = __ballot_sync(FULL, live);  // every real pair swept
  if (stats != nullptr && (threadIdx.x & 31) == 0)
    atomicAdd(stats, (unsigned long long)__popc(lives) * V);
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
// of (point, vertex) pairs [swept, skipped] that the kernel adds to;
// far: null, or the flags of animnerf_knn_far (which wrote the skipped
// groups' outputs). Any k on the warp-per-point kernel (k <=
// knn_wide::CAP), above it on knn_exact_any.
extern "C" int animnerf_knn_exact_wide(const void* points, const void* rows,
                                       const void* sbox, const void* tbox,
                                       int cull, void* stats, const void* far,
                                       void* out_d, void* out_i, int B, int N,
                                       int V, int Vp, int k, void* stream) {
  if (k < 1 || V < k || Vp < V || Vp % TILE != 0 || Vp - V >= TILE)
    return (int)cudaErrorInvalidValue;
  if (N == 0 || B == 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  const float* p = (const float*)points;
  const float4* r = (const float4*)rows;
  const float* sb = (const float*)sbox;
  const float* tb = (const float*)tbox;
  unsigned long long* st = (unsigned long long*)stats;
  const int* fl = (const int*)far;
  float* od = (float*)out_d;
  int* oi = (int*)out_i;
  // k + 1 slots for the nearest-first pass (at the cap, the slot rule alone)
  const int slots = k < knn_wide::CAP ? k + 1 : k;
  if (slots <= 32)
    return launch_wide<1>(B, s, p, r, sb, tb, cull, st, fl, od, oi, N, V, Vp,
                          k);
  if (slots <= 64)
    return launch_wide<2>(B, s, p, r, sb, tb, cull, st, fl, od, oi, N, V, Vp,
                          k);
  if (k <= knn_wide::CAP)
    return launch_wide<4>(B, s, p, r, sb, tb, cull, st, fl, od, oi, N, V, Vp,
                          k);
  knn_exact_any<<<dim3((N + ANY_THREADS - 1) / ANY_THREADS, B), ANY_THREADS,
                  0, s>>>(p, r, fl, st, od, oi, N, V, Vp, k);
  return (int)cudaGetLastError();
}

// as animnerf_knn_exact_wide; k <= MAX_K on the per-K instantiations
extern "C" int animnerf_knn_exact(const void* points, const void* rows,
                                  const void* sbox, const void* tbox,
                                  int cull, void* stats, const void* far,
                                  void* out_d, void* out_i, int B, int N,
                                  int V, int Vp, int k, void* stream) {
  if (k < 1 || V < k || Vp < V || Vp % TILE != 0 || Vp - V >= TILE)
    return (int)cudaErrorInvalidValue;
  if (k > MAX_K)
    return animnerf_knn_exact_wide(points, rows, sbox, tbox, cull, stats, far,
                                   out_d, out_i, B, N, V, Vp, k, stream);
  if (N > 0 && B > 0)
    launch<1>(k, B, (cudaStream_t)stream, (const float*)points,
              (const float4*)rows, (const float*)sbox, (const float*)tbox,
              cull, (unsigned long long*)stats, (const int*)far,
              (float*)out_d, (int*)out_i, N, V, Vp);
  return (int)cudaGetLastError();
}
