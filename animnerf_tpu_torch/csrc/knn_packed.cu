// Top-k nearest vertices under packed int32 keys, any k in 1..16, for
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
// template argument (1..16) and the insert fully unrolled, so every index
// is a constant and nothing spills to local memory. No tile skip, as in
// the JAX package (its tile skip exists only on the k=4 tournament path).

#include <cuda_runtime.h>

#include "knn_sweep.cuh"

namespace {

constexpr int MAX_K = 16;
// query points per thread: P x K keys and the P points stay in registers
// (above K = 8, P = 4 doubles the registers and was slower than P = 2)
template <int K>
constexpr int points_per_thread() {
  return K <= 8 ? 4 : 2;
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

// launch the instantiation for k (1..MAX_K)
template <int K>
int launch(int k, const void* points, const void* rows, const void* index,
           const void* far, void* out_d, void* out_i, int B, int N, int V,
           int Vp, cudaStream_t stream) {
  if (k == K)
    return knn_sweep::launch<K, points_per_thread<K>(), false,
                             PackedInsert<K>>(points, rows, index, nullptr,
                                              nullptr, far, out_d, out_i, B,
                                              N, V, Vp, stream);
  if constexpr (K < MAX_K)
    return launch<K + 1>(k, points, rows, index, far, out_d, out_i, B, N, V,
                         Vp, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// rows, index: animnerf_knn_rows's for V vertices padded to Vp, stratified
// (knn.cu); V >= k; far: null, or the flags of animnerf_knn_far (which
// wrote the skipped groups' outputs)
extern "C" int animnerf_knn_packed(const void* points, const void* rows,
                                   const void* index, const void* far,
                                   void* out_d, void* out_i, int B, int N,
                                   int V, int Vp, int k, void* stream) {
  if (k < 1 || k > MAX_K) return (int)cudaErrorInvalidValue;
  return launch<1>(k, points, rows, index, far, out_d, out_i, B, N, V, Vp,
                   (cudaStream_t)stream);
}
