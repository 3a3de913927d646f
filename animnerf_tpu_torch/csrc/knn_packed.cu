// Top-k nearest vertices under packed int32 keys, any k in 1..V, for
// Hopper (sm_90a).
//
// Replaces: animnerf_tpu/ops/knn_pallas.py::_packed_knn_kernel (the packed
// path of knn_pallas when k != 4, or with tournament=False). Its all-far
// skip (far2 > 0) is knn_far.cu's pass, whose flags the sweep reads.
//
// Contract: the packed keys of knn_keys.cuh, bit-identical to the TPU
// kernel and to the plain version in ops/knn_kernel.py. The K smallest
// keys come out ascending as sqrt(bits(key & ~0x1FFF)) and key & 0x1FFF,
// V <= 8192. Keys are unique (index bits), so the TPU kernel's K
// extract-min passes per vertex tile and its bubble insert
// (knn_pallas.py:233-240) select the same K keys in the same order as any
// exact top-K; at K = 4 the output is bit-identical to knn.cu's.
//
// Bound on the H100: operations, the same as kernel 1's per (point,
// vertex) pair (6 non-FMA f32 operations); bytes are negligible (12 B per
// point in, 8K B out, the vertex rows stay on chip). Design: the shared
// sweep of knn_sweep.cuh over knn.cu's stratified rows (P points a thread,
// double-buffered staged rows, a filter in front of the key), with K a
// template argument (1..16, 24, 32) and the insert fully unrolled, so
// every index is a constant and nothing spills to local memory. No tile
// skip, as in the JAX package (its tile skip exists only on the k=4
// tournament path).
//
// Above 16 neighbours: k in 17..24 and 25..32 run the instantiations K =
// 24 and 32, which keep their K smallest keys and write the first k. That
// is exact because the keys are unique (index bits): the order on keys is
// total, so the k smallest keys are the first k of the K smallest, and
// the padding rows' keys (0x7F800000 | index) sort above every real one,
// so with V >= k the first k are real. Above 32, knn_packed_any takes k
// at run time: one thread a point sweeps every staged row and keeps its k
// smallest keys, ascending, in its own column of the output (out_i, (B,
// k, N), coalesced across the warp's points), inserting by a shift in
// global memory, then turns each key into its distance and index in
// place. Slow but exact; its time is in PERF.md.

#include <cuda_runtime.h>

#include "knn_sweep.cuh"

namespace {

constexpr int MAX_K = 16;     // every K up to here has its instantiation
constexpr int MAX_WIDE_K = 32;  // then K = 24 and 32; above, knn_packed_any
// query points per thread: P x K keys and the P points stay in registers
// (above K = 8, P = 4 doubles the registers and was slower than P = 2;
// above 16, one point a thread)
template <int K>
constexpr int points_per_thread() {
  return K <= 8 ? 4 : K <= 16 ? 2 : 1;
}

// insert key (< top[K-1]) into the ascending, unique list top[0..K-1].
// K <= 4: shift the larger keys down one slot and stop at key's place, as
// knn.cu's nested compares do; with few slots the early stop is the
// cheaper form. K > 4: top[s] = min(top[s], max(top[s-1], key)), two
// integer ops per slot and no branch, so that a long list costs no
// divergent shifting loop. (Both forms were timed on the H100 for K = 4,
// 8 and 16 while choosing.) Every slot index is a constant: an early
// break out of the shift puts the list in local memory.
template <int K>
struct PackedInsert {
  static __device__ __forceinline__ void apply(int (&top)[K], int key) {
    if constexpr (K <= 4) {
      bool moving = true;  // the slots above key's place move down
#pragma unroll
      for (int s = K - 1; s > 0; --s) {
        if (moving && key < top[s - 1]) {
          top[s] = top[s - 1];
        } else if (moving) {
          top[s] = key;
          moving = false;
        }
      }
      if (moving) top[0] = key;
    } else {
#pragma unroll
      for (int s = K - 1; s > 0; --s)
        top[s] = min(top[s], max(top[s - 1], key));
      top[0] = min(top[0], key);
    }
  }
};

// launch the instantiation for k (1..MAX_K each its own; 17..24 on K =
// 24, 25..32 on K = 32)
template <int K>
int launch(int k, const void* points, const void* rows, const void* index,
           const void* far, void* out_d, void* out_i, int B, int N, int V,
           int Vp, cudaStream_t stream) {
  if (K <= MAX_K ? k == K : k <= K)
    return knn_sweep::launch<K, points_per_thread<K>(), false,
                             PackedInsert<K>>(points, rows, index, nullptr,
                                              nullptr, far, out_d, out_i, B,
                                              N, V, Vp, stream, k);
  if constexpr (K < MAX_K)
    return launch<K + 1>(k, points, rows, index, far, out_d, out_i, B, N, V,
                         Vp, stream);
  else if constexpr (K < MAX_WIDE_K)
    return launch<K + 8>(k, points, rows, index, far, out_d, out_i, B, N, V,
                         Vp, stream);
  return (int)cudaErrorInvalidValue;
}

constexpr int ANY_THREADS = 128;

// any k: thread n keeps point n's k smallest keys ascending in out_i[b, s,
// n] (s < k), the k-th in a register; the block stages the rows a TILE at
// a time (every thread takes part in the staging, dead ones included)
__global__ void __launch_bounds__(ANY_THREADS)
knn_packed_any(const float* __restrict__ points,  // (B, N, 3)
               const float4* __restrict__ rows,   // (B, Vp, 4)
               const int* __restrict__ index,     // (Vp,)
               const int* __restrict__ far, float* __restrict__ out_d,
               int* __restrict__ out_i, int N, int Vp, int k) {
  static_assert(knn_sweep::FAR_GROUP % ANY_THREADS == 0,
                "a block's points lie in one far-skip group");
  const int b = blockIdx.y;
  if (far != nullptr &&
      far[(size_t)b * ((N + knn_sweep::FAR_GROUP - 1) /
                       knn_sweep::FAR_GROUP) +
          blockIdx.x * ANY_THREADS / knn_sweep::FAR_GROUP])
    return;  // knn_far.cu wrote this group's outputs
  __shared__ float4 s_rows[knn_sweep::TILE];
  __shared__ int s_idx[knn_sweep::TILE];
  const int n = blockIdx.x * ANY_THREADS + threadIdx.x;
  const bool live = n < N;
  const float* q = points + ((size_t)b * N + (live ? n : N - 1)) * 3;
  const float x = q[0], y = q[1], z = q[2];
  const float pp = knn_keys::point_pp(x, y, z);
  int* top = out_i + (size_t)b * k * N + n;  // slot s at top[s * N]
  if (live)
    for (int s = 0; s < k; ++s) top[(size_t)s * N] = knn_keys::BIGKEY;
  int kth = knn_keys::BIGKEY;
  const float4* rb = rows + (size_t)b * Vp;
  for (int t0 = 0; t0 < Vp; t0 += knn_sweep::TILE) {
    __syncthreads();  // the previous tile consumed
    for (int r = threadIdx.x; r < knn_sweep::TILE; r += ANY_THREADS) {
      s_rows[r] = rb[t0 + r];
      s_idx[r] = index[t0 + r];
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < knn_sweep::TILE; ++j) {
      const int key = knn_keys::key_of(
          pp, knn_keys::row_dot(s_rows[j], x, y, z), s_idx[j]);
      if (key >= kth) continue;
      int s = k - 1;  // shift the larger keys down one slot
      for (; s > 0; --s) {
        const int prev = top[(size_t)(s - 1) * N];
        if (prev < key) break;
        top[(size_t)s * N] = prev;
      }
      top[(size_t)s * N] = key;
      kth = top[(size_t)(k - 1) * N];
    }
  }
  if (!live) return;
  for (int s = 0; s < k; ++s) {
    const size_t o = ((size_t)b * k + s) * N + n;
    const int key = out_i[o];
    out_d[o] = knn_keys::key_dist(key);
    out_i[o] = knn_keys::key_index(key);
  }
}

}  // namespace

// rows, index: animnerf_knn_rows's for V vertices padded to Vp, stratified
// (knn.cu); 1 <= k <= V; far: null, or the flags of animnerf_knn_far
// (which wrote the skipped groups' outputs)
extern "C" int animnerf_knn_packed(const void* points, const void* rows,
                                   const void* index, const void* far,
                                   void* out_d, void* out_i, int B, int N,
                                   int V, int Vp, int k, void* stream) {
  if (k < 1 || k > V) return (int)cudaErrorInvalidValue;
  if (k <= MAX_WIDE_K)
    return launch<1>(k, points, rows, index, far, out_d, out_i, B, N, V, Vp,
                     (cudaStream_t)stream);
  if (Vp < V || Vp % knn_sweep::TILE != 0 || Vp > knn_keys::MAX_VERTS)
    return (int)cudaErrorInvalidValue;
  if (N > 0 && B > 0) {
    const dim3 grid((N + ANY_THREADS - 1) / ANY_THREADS, B);
    knn_packed_any<<<grid, ANY_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)points, (const float4*)rows, (const int*)index,
        (const int*)far, (float*)out_d, (int*)out_i, N, Vp, k);
  }
  return (int)cudaGetLastError();
}
