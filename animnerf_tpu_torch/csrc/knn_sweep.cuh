// The packed-key sweep shared by knn.cu (kernel 1, top-4 with the optional
// tile skip) and knn_packed.cu (kernel 8, top-K for K in 1..16): one device
// loop over staged vertex rows, two selection policies (the kernels' own
// insert of a key into their ascending top-K).
//
// Keys are those of knn_keys.cuh, bit for bit; they are unique (index
// bits), so the top-K does not depend on the order the rows are visited in,
// and the sweep is free to choose that order.
//
// Bound on the H100: operations, the 3 multiplies and 3 adds of row_dot
// per (point, vertex) pair, none of which may be an FMA; the add of |p|^2,
// the clamp and the key are owed only by pairs that can enter a top-K. The
// design takes everything else off the per-pair path:
// - Vertex rows once per call. knn.cu's rows kernel writes (B, Vp, 4)
//   rows (m2x, m2y, m2z, vq) in visiting order and the (Vp,) vertex index
//   of each position; Vp pads V to whole TILEs with rows (0, 0, 0, +inf),
//   whose key 0x7F800000 | index sorts above every finite key (V >= K
//   gives K finite keys; Vp <= 8192 keeps the index in its 13 bits).
// - Double-buffered staging. Each TILE of rows and indices is copied into
//   shared memory with cp.async while the block sweeps the previous one.
// - P query points per thread (a template argument): one broadcast
//   float4 row load, the loop counter and the branch are paid once per P
//   pairs; the unrolled loop over a TILE has a bound known at compile time.
// - A filter in front of the key. Per point t bounds row_dot from below:
//   s = row_dot(row) >= t implies key > top[K-1] (filter_bound), so the
//   common path is 3 multiplies, 3 adds and one compare per pair, and one
//   warp vote per row. Only rows that some point of the warp may take go
//   on to the add, clamp, key and insert, whose compare against top[K-1]
//   decides exactly. t is refreshed once a tile, from the top-K at the
//   tile's end. The first tile, where the top-K is empty and most rows
//   enter it, takes every key with a branch-free insert instead.
// - Visiting order. The filter pays only once each point's top-K is tight.
//   Sweeping the Morton-sorted cloud in index order tightens it slowly
//   (~146 rows pass per point at V = 6890); a stratified order (position
//   j * n_tiles + t holds row bitrev(j) of tile t, so every staged tile
//   samples the whole cloud) lets ~33 pass. With the tile skip the tiles
//   stay the Morton tiles (their boxes bound them) and only the rows inside
//   a tile are bit-reversed; the block visits its nearest tile first.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "knn_keys.cuh"

namespace knn_sweep {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 256;  // rows per staged tile: 4 KB of float4 + 1 KB
constexpr int TILE_BITS = 8;
constexpr int MAX_TILES = knn_keys::MAX_VERTS / TILE;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int FAR_GROUP = 1024;  // the all-far skip's point group
static_assert((1 << TILE_BITS) == TILE, "TILE is 2^TILE_BITS");

// the vertex index at visiting position pos of a cloud padded to n_tiles
// TILEs (stratified: the tiles interleaved; else the tiles in index order),
// rows bit-reversed within a tile
__device__ __forceinline__ int visit_index(int pos, int n_tiles,
                                           bool stratified) {
  const int t = stratified ? pos % n_tiles : pos / TILE;
  const int j = stratified ? pos / n_tiles : pos % TILE;
  return t * TILE + (int)(__brev((unsigned)j) >> (32 - TILE_BITS));
}

// t such that row_dot s >= t implies key_of(pp, s, any index) > last: the
// next quantum's bits q = (last & KEY_MASK) + 0x2000, then one step above
// fl(q - pp), so that pp + s >= q exactly and fl(pp + s) >= q. NaN (every
// row passes) while last has no finite successor quantum (BIGKEY, +inf).
__device__ __forceinline__ float filter_bound(int last, float pp) {
  const unsigned q = (unsigned)(last & knn_keys::KEY_MASK) + 0x2000u;
  if (q >= 0x7F800000u) return __int_as_float(0x7FC00000);
  const int b = __float_as_int(__fsub_rn(__int_as_float((int)q), pp));
  return __int_as_float(b >= 0 ? b + 1 : b - 1);  // -0 gives NaN: loose
}

// squared distance from p to the AABB (lo, hi)
__device__ __forceinline__ float box_lb2(const float* box, float px, float py,
                                         float pz) {
  const float gx = fmaxf(fmaxf(box[0] - px, px - box[3]), 0.0f);
  const float gy = fmaxf(fmaxf(box[1] - py, py - box[4]), 0.0f);
  const float gz = fmaxf(fmaxf(box[2] - pz, pz - box[5]), 0.0f);
  return gx * gx + gy * gy + gz * gz;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a),
               "l"(gmem)
               : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// one TILE of rows and indices into shared memory, as one async group
__device__ __forceinline__ void stage(float4* rows_s, int* idx_s,
                                      const float4* rows, const int* idx) {
  for (int r = threadIdx.x; r < TILE; r += THREADS)
    cp_async16(rows_s + r, rows + r);
  for (int r = threadIdx.x; r < TILE / 4; r += THREADS)
    cp_async16(idx_s + 4 * r, idx + 4 * r);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// a thread's P points: coordinates, |p|^2, filter bounds and top-K keys
template <int K, int P>
struct Points {
  float x[P], y[P], z[P], pp[P], t[P];
  int top[P][K];
  bool live[P];
};

// the filter bounds from the current top-K (-inf for a dead point: it
// takes no row)
template <int K, int P>
__device__ __forceinline__ void refresh_bounds(Points<K, P>& st) {
#pragma unroll
  for (int p = 0; p < P; ++p)
    st.t[p] = st.live[p] ? filter_bound(st.top[p][K - 1], st.pp[p])
                         : -INFINITY;
}

// sweep the first staged tile: every row's key, inserted without a branch
// (top[s] = min(top[s], max(top[s-1], key)); a key above top[K-1] changes
// nothing). The top-K starts empty, so here most rows enter some point's
// list and a filter would only add a vote and a branch to every row.
template <int K, int P>
__device__ __forceinline__ void sweep_first_tile(
    const float4* __restrict__ rows, const int* __restrict__ idx,
    Points<K, P>& st) {
#pragma unroll 2
  for (int j = 0; j < TILE; ++j) {
    const float4 r = rows[j];
    const int v = idx[j];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int key = knn_keys::key_of(
          st.pp[p], knn_keys::row_dot(r, st.x[p], st.y[p], st.z[p]), v);
#pragma unroll
      for (int s = K - 1; s > 0; --s)
        st.top[p][s] = min(st.top[p][s], max(st.top[p][s - 1], key));
      st.top[p][0] = min(st.top[p][0], key);
    }
  }
}

// sweep a later staged tile against the bounds of its start (they only
// loosen the filter as the top-K tightens; the compare against top[K-1]
// decides). Insert::apply(top, key) inserts a key below top[K-1] into the
// ascending list.
template <int K, int P, class Insert>
__device__ __forceinline__ void sweep_tile(const float4* __restrict__ rows,
                                           const int* __restrict__ idx,
                                           Points<K, P>& st) {
#pragma unroll 4
  for (int j = 0; j < TILE; ++j) {
    const float4 r = rows[j];
    float s[P];
    bool hit = false;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      s[p] = knn_keys::row_dot(r, st.x[p], st.y[p], st.z[p]);
      hit |= !(s[p] >= st.t[p]);  // NaN s: take the exact path
    }
    if (__any_sync(FULL, hit)) {
      const int v = idx[j];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        if (!(s[p] >= st.t[p])) {
          const int key = knn_keys::key_of(st.pp[p], s[p], v);
          if (key < st.top[p][K - 1]) Insert::apply(st.top[p], key);
        }
      }
    }
  }
}

// The kernel. Block: THREADS threads, THREADS * P points; lane l of warp w
// takes points w * 32P + 32p + l (p < P), so the warp's points are one run
// of 32P consecutive points (a Morton run when the caller sorted them) and
// every load and store is coalesced. grid (ceil(N / (THREADS P)), B).
// rows (B, Vp, 4), idx (Vp,) from knn.cu's rows kernel (stratified unless
// SKIP). SKIP: vbox (B, Vp / TILE, 8) per-tile AABBs [lo xyz, hi xyz, 0, 0];
// stats null or two u64 counters of warp-tile visits [swept, skipped].
// far: null, or the all-far skip's flags (B, ceil(N / FAR_GROUP)) from
// knn_far.cu, which has written the outputs of the skipped groups' points:
// a block's points lie in one group, and a block of a skipped group
// returns before it sweeps or writes anything.
//
// The tile skip: a point's squared distance to any vertex of tile t is at
// least lb2(t), the squared distance to the tile's box. The deflated bound
// lb2 * (1 - 2^-8) - 1e-4, quantised like the keys, dominates the dot
// form's cancellation and the key quantisation (knn_pallas.py:423-427), so
// a tile whose bound key exceeds a point's current K-th key cannot change
// its top-K: skipping it is exact, and the output is bit-identical to
// SKIP = false. A warp sweeps a tile when any of its points needs it; the
// block visits the tiles in ascending order of the summed lb2 over its
// live points, so the K-th keys are tight before the first test.
template <int K, int P, bool SKIP, class Insert>
__global__ void __launch_bounds__(THREADS)
sweep_kernel(const float* __restrict__ points,  // (B, N, 3)
             const float4* __restrict__ rows,   // (B, Vp, 4)
             const int* __restrict__ index,     // (Vp,)
             const float* __restrict__ vbox,    // (B, Vp / TILE, 8) or null
             float* __restrict__ out_d,         // (B, K, N)
             int* __restrict__ out_i,           // (B, K, N)
             unsigned long long* __restrict__ stats,
             const int* __restrict__ far, int N, int Vp) {
  static_assert(FAR_GROUP % (THREADS * P) == 0,
                "a block's points lie in one far-skip group");
  if (far != nullptr &&
      far[(size_t)blockIdx.y * ((N + FAR_GROUP - 1) / FAR_GROUP) +
          blockIdx.x * (THREADS * P) / FAR_GROUP])
    return;  // knn_far.cu wrote this group's outputs
  __shared__ __align__(16) float4 s_rows[2][TILE];
  __shared__ __align__(16) int s_idx[2][TILE];
  __shared__ float s_box[SKIP ? MAX_TILES * 8 : 1];
  __shared__ float s_part[SKIP ? WARPS : 1][SKIP ? MAX_TILES : 1];
  __shared__ int s_order[SKIP ? MAX_TILES : 1];
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
    st.pp[p] = knn_keys::point_pp(st.x[p], st.y[p], st.z[p]);
#pragma unroll
    for (int s = 0; s < K; ++s) st.top[p][s] = knn_keys::BIGKEY;
  }

  if (SKIP) {
    // visiting order: ascending sum of lb2 over the block's live points
    for (int i = threadIdx.x; i < n_tiles * 8; i += THREADS)
      s_box[i] = vbox[(size_t)b * n_tiles * 8 + i];
    __syncthreads();
    for (int t = 0; t < n_tiles; ++t) {
      float v = 0.0f;
#pragma unroll
      for (int p = 0; p < P; ++p)
        if (st.live[p])
          v += box_lb2(s_box + 8 * t, st.x[p], st.y[p], st.z[p]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
      if (lane == 0) s_part[warp][t] = v;
    }
    __syncthreads();
    if (threadIdx.x < n_tiles) {  // rank of each tile, ties by index
      const int t = threadIdx.x;
      float mine = 0.0f;
      for (int w = 0; w < WARPS; ++w) mine += s_part[w][t];
      int rank = 0;
      for (int u = 0; u < n_tiles; ++u) {
        float other = 0.0f;
        for (int w = 0; w < WARPS; ++w) other += s_part[w][u];
        rank += other < mine || (other == mine && u < t);
      }
      s_order[rank] = t;
    }
    __syncthreads();
  }

  const float4* rb = rows + (size_t)b * Vp;
  int tile = SKIP ? s_order[0] : 0;
  stage(s_rows[0], s_idx[0], rb + tile * TILE, index + tile * TILE);
  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) {
      const int next = SKIP ? s_order[i + 1] : i + 1;
      stage(s_rows[(i + 1) & 1], s_idx[(i + 1) & 1], rb + next * TILE,
            index + next * TILE);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile i is in shared memory for every thread
    bool need = true;
    if (SKIP) {  // the first (nearest) tile is always swept
      bool mine = i == 0;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float lb2 = box_lb2(s_box + 8 * tile, st.x[p], st.y[p], st.z[p]);
        const float lb2s = fmaxf(lb2 * (1.0f - 0.00390625f) - 1e-4f, 0.0f);
        const int lb_key = __float_as_int(lb2s) & knn_keys::KEY_MASK;
        mine |= st.live[p] && lb_key <= st.top[p][K - 1];
      }
      need = __any_sync(FULL, mine);
      if (stats != nullptr && lane == 0)
        atomicAdd(stats + (need ? 0 : 1), 1ull);
    }
    if (need) {
      if (i == 0)
        sweep_first_tile<K, P>(s_rows[0], s_idx[0], st);
      else
        sweep_tile<K, P, Insert>(s_rows[i & 1], s_idx[i & 1], st);
      refresh_bounds<K, P>(st);
    }
    __syncthreads();  // tile i consumed before its buffer is refilled
    if (SKIP && i + 1 < n_tiles) tile = s_order[i + 1];
  }

#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (!st.live[p]) continue;
    const int n = first + 32 * p;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const size_t o = ((size_t)b * K + s) * N + n;
      out_d[o] = knn_keys::key_dist(st.top[p][s]);
      out_i[o] = knn_keys::key_index(st.top[p][s]);
    }
  }
}

// launch the sweep over rows staged by knn.cu's rows kernel for V
// vertices padded to Vp: V >= K keeps the padding rows, whose keys sort
// above every real one, out of the slots; far: null or knn_far.cu's flags
template <int K, int P, bool SKIP, class Insert>
int launch(const void* points, const void* rows, const void* index,
           const void* vbox, void* stats, const void* far, void* out_d,
           void* out_i, int B, int N, int V, int Vp, cudaStream_t stream) {
  if (V < K || Vp < V || Vp % TILE != 0 || Vp > knn_keys::MAX_VERTS ||
      (SKIP && vbox == nullptr))
    return (int)cudaErrorInvalidValue;
  if (N > 0 && B > 0) {
    const dim3 grid((N + THREADS * P - 1) / (THREADS * P), B);
    sweep_kernel<K, P, SKIP, Insert><<<grid, THREADS, 0, stream>>>(
        (const float*)points, (const float4*)rows, (const int*)index,
        (const float*)vbox, (float*)out_d, (int*)out_i,
        (unsigned long long*)stats, (const int*)far, N, Vp);
  }
  return (int)cudaGetLastError();
}

}  // namespace knn_sweep
