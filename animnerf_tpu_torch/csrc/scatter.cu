// Weighted row scatter (the warp-blend backward), for Hopper (sm_90a).
//
// Replaces: animnerf_tpu/ops/blend.py::_scatter_kernel (reached through
// weighted_scatter_rows_pallas with transposed_in=True, g_t=True).
//
//   out[b, idx[b, k, n], c] += w[b, k, n] * g[b, c, n]     c < 16, k < K
//
// idx / w (B, K, N) as the kNN and warp-blend kernels emit them (K =
// k_neigh, 1..16, a runtime argument: the loop over k is not unrolled), g
// (B, 16, N) rows-native cotangents, out (B, V, 16) f32, zeroed by the
// wrapper.
//
// Bound on the H100: bytes. Per point it reads K indices, K weights and
// 16 g values and the table is written once (V x 16 x 4 B = 441 KB per
// element for SMPL, which lives in the 50 MB L2). The TPU kernel keeps a
// VMEM-resident (Vp, 16) accumulator across a sequential point grid and
// scatters with masked MXU matmuls over candidate vertex tiles; blocks of
// a GPU run in parallel and in no order, and a block's 227 KB of shared
// memory cannot hold the table, so the sum goes to global memory with f32
// atomicAdd. Design: one thread per point, looping over its K neighbours.
// Morton order makes neighbouring points share neighbour vertices, so for
// each k the warp first groups the lanes with equal indices
// (__match_any_sync), sums the group's 16 contributions in lane order over
// shuffles, and only the group's first lane issues the atomics (zero
// sums are skipped: rows 12..15 of the warp-blend cotangent are zero).
//
// Determinism: the order in which atomics from different warps land
// varies from run to run, so the f32 sums vary in their last bits between
// runs (a relative error of a few f32 ulps of the largest contribution);
// the sums within a warp are taken in a fixed lane order.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_K = 16;
constexpr int F = 16;
constexpr unsigned FULL = 0xFFFFFFFFu;

__global__ void __launch_bounds__(THREADS)
weighted_scatter_kernel(const int* __restrict__ idx,   // (B, K, N)
                        const float* __restrict__ w,   // (B, K, N)
                        const float* __restrict__ g,   // (B, F, N)
                        float* __restrict__ out,       // (B, V, F)
                        int N, int V, int K) {
  const int b = blockIdx.y;
  const int n = blockIdx.x * THREADS + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool live = n < N;
  float gv[F];
#pragma unroll
  for (int c = 0; c < F; ++c)
    gv[c] = live ? g[((size_t)b * F + c) * N + n] : 0.0f;
  float* ob = out + (size_t)b * V * F;

#pragma unroll 1
  for (int k = 0; k < K; ++k) {
    // dead lanes get distinct negative keys so they group with nobody
    const int v = live ? idx[((size_t)b * K + k) * N + n] : -1 - lane;
    const float wk = live ? w[((size_t)b * K + k) * N + n] : 0.0f;
    const unsigned peers = __match_any_sync(FULL, v);
    const bool leader = (__ffs(peers) - 1) == lane;
#pragma unroll
    for (int c = 0; c < F; ++c) {
      const float x = wk * gv[c];
      float s = 0.0f;
#pragma unroll 8
      for (int src = 0; src < 32; ++src) {
        const float y = __shfl_sync(FULL, x, src);
        if ((peers >> src) & 1u) s += y;
      }
      if (leader && v >= 0 && s != 0.0f)
        atomicAdd(ob + (size_t)v * F + c, s);
    }
  }
}

}  // namespace

extern "C" int animnerf_weighted_scatter(const void* idx, const void* w,
                                         const void* g, void* out, int B,
                                         int N, int V, int k, void* stream) {
  if (k < 1 || k > MAX_K) return (int)cudaErrorInvalidValue;
  if (N > 0 && B > 0) {
    dim3 grid((N + THREADS - 1) / THREADS, B);
    weighted_scatter_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const int*)idx, (const float*)w, (const float*)g, (float*)out, N,
        V, k);
  }
  return (int)cudaGetLastError();
}
