// Top-k nearest vertices under packed int32 keys, any k in 1..16, for
// Hopper (sm_90a).
//
// Replaces: animnerf_tpu/ops/knn_pallas.py::_packed_knn_kernel (the packed
// path of knn_pallas when k != 4, or with tournament=False), with
// far2 = 0: the all-far skip (knn_far_skip) is not ported.
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
// vertex) pair (3 f32 multiplies, 4 adds, a max, two integer ops and a
// compare); bytes are negligible (12 B per point in, 8K B out, the
// vertices stay on chip). Design: one thread per query point, keeping its
// sorted K keys in registers: K is a template argument (1..16) and the
// insert is fully unrolled, so every index is a constant and nothing
// spills to local memory. The block stages the vertex rows as float4
// (-2vx, -2vy, -2vz, |v|^2) in shared memory, TILE_V at a time, so the
// sweep reads one broadcast float4 per pair. No tile skip, as in the JAX
// package (its tile skip exists only on the k=4 tournament path).

#include <cuda_runtime.h>

#include "knn_keys.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TILE_V = 1024;  // 16 KB of float4 per stage
constexpr int MAX_K = 16;

// insert key (< top[K-1]) into the ascending, unique list top[0..K-1].
// K <= 4: shift the larger keys down one slot and stop at key's place, as
// knn.cu's nested compares do; with few slots the early stop is the
// cheaper form. K > 4: top[s] = min(top[s], max(top[s-1], key)), two
// integer ops per slot and no branch, so that a long list costs no
// divergent shifting loop. (Both forms were timed on the H100 for K = 4,
// 8 and 16 while choosing; chip_smoke.py's kernel lines time the kernel
// as built.)
template <int K>
__device__ __forceinline__ void insert_key(int (&top)[K], int key) {
  if constexpr (K <= 4) {
#pragma unroll
    for (int s = K - 1; s >= 0; --s) {
      if (s > 0 && key < top[s - 1]) {
        top[s] = top[s - 1];
      } else {
        top[s] = key;
        break;
      }
    }
  } else {
#pragma unroll
    for (int s = K - 1; s > 0; --s)
      top[s] = min(top[s], max(top[s - 1], key));
    top[0] = min(top[0], key);
  }
}

template <int K>
__global__ void __launch_bounds__(THREADS)
knn_packed_kernel(const float* __restrict__ points,  // (B, N, 3)
                  const float* __restrict__ verts,   // (B, V, 3)
                  float* __restrict__ out_d,         // (B, K, N)
                  int* __restrict__ out_i,           // (B, K, N)
                  int N, int V) {
  __shared__ float4 sv[TILE_V];
  const int b = blockIdx.y;
  const int n = blockIdx.x * THREADS + threadIdx.x;
  const bool live = n < N;
  const float* p = points + ((size_t)b * N + (live ? n : 0)) * 3;
  const float px = p[0], py = p[1], pz = p[2];
  const float pp = knn_keys::point_pp(px, py, pz);
  int top[K];
#pragma unroll
  for (int s = 0; s < K; ++s) top[s] = knn_keys::BIGKEY;
  const float* vb = verts + (size_t)b * V * 3;

  for (int base = 0; base < V; base += TILE_V) {
    const int cnt = min(TILE_V, V - base);
    __syncthreads();  // the previous stage is fully consumed
    for (int j = threadIdx.x; j < cnt; j += THREADS)
      sv[j] = knn_keys::vertex_row(vb + (size_t)(base + j) * 3);
    __syncthreads();
    for (int j = 0; j < cnt; ++j) {
      const int key = knn_keys::packed_key(sv[j], px, py, pz, pp, base + j);
      if (key < top[K - 1]) insert_key<K>(top, key);
    }
  }
  if (!live) return;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const size_t o = ((size_t)b * K + s) * N + n;
    out_d[o] = knn_keys::key_dist(top[s]);
    out_i[o] = knn_keys::key_index(top[s]);
  }
}

// launch the instantiation for k (1..MAX_K)
template <int K>
void launch(int k, dim3 grid, cudaStream_t stream, const float* points,
            const float* verts, float* out_d, int* out_i, int N, int V) {
  if (k == K) {
    knn_packed_kernel<K><<<grid, THREADS, 0, stream>>>(points, verts, out_d,
                                                       out_i, N, V);
  } else if constexpr (K < MAX_K) {
    launch<K + 1>(k, grid, stream, points, verts, out_d, out_i, N, V);
  }
}

}  // namespace

extern "C" int animnerf_knn_packed(const void* points, const void* verts,
                                   void* out_d, void* out_i, int B, int N,
                                   int V, int k, void* stream) {
  if (k < 1 || k > MAX_K || V < k || V > knn_keys::MAX_VERTS)
    return (int)cudaErrorInvalidValue;
  if (N > 0 && B > 0) {
    dim3 grid((N + THREADS - 1) / THREADS, B);
    launch<1>(k, grid, (cudaStream_t)stream, (const float*)points,
              (const float*)verts, (float*)out_d, (int*)out_i, N, V);
  }
  return (int)cudaGetLastError();
}
