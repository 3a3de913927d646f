// Matmul-form top-4 nearest vertices (the kNN benchmark tool's variant),
// for Hopper (sm_90a).
//
// Replaces: tools/bench_knn.py::_mxu_knn_kernel (reached through
// knn_mxu), k = 4, at precision HIGHEST or DEFAULT.
//
// Contract (bit-identical to the plain version in ops/knn_mxu.py): the
// wrapper centres the cloud and builds the augmented rows as the JAX tool
// does outside its kernel: points P (B, 8, N) = [x, y, z, |p|^2, 1, 0, 0,
// 0], vertices A (B, V, 8) = [-2x, -2y, -2z, 1, |v|^2, 0, 0, 0]. Here
//   d2 = A[v,0]*P[0,n] + A[v,1]*P[1,n] + ... + A[v,7]*P[7,n]
// summed left to right, every product and sum rounded on its own
// (__fmul_rn / __fadd_rn). BF16 (the TPU's single-pass DEFAULT product)
// rounds A and P to bf16 (round to nearest even) first; a bf16 x bf16
// product is exact in f32, so only the sums round. The top-4 follows the
// TPU kernel's rule (knn_slots.cuh, 512-vertex tiles, its K = 4 network),
// and the distances are sqrtf(max(d2, 0)): the matmul form can cancel
// below zero.
//
// Bound on the H100: operations. A matmul counts 16 flops per (point,
// vertex) pair (8 multiply-adds), which at the 67 TFLOP/s f32 FMA peak
// bounds it; one compare per pair at the non-FMA rate is below that.
// Design: a SIMT kernel, one thread per point with its 8 P values, 4
// slots and the current tile's 4 pairs in registers; the block stages the
// vertex rows as two float4 in shared memory, TILE_V at a time, and the
// sweep reads them as broadcasts. Separate roundings cost 15 instructions
// per pair where 8 FMAs would do; a tensor-core (mma) version is later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "knn_slots.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TILE_V = 1024;  // 32 KB: two float4 per vertex row
constexpr int K = 4;
constexpr int C = 8;  // augmented columns
static_assert(TILE_V % knn_slots::TILE == 0, "stages hold whole tiles");

template <bool BF16>
__device__ __forceinline__ float operand(float x) {
  return BF16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
knn_mxu_kernel(const float* __restrict__ P,  // (B, 8, N) point rows
               const float* __restrict__ A,  // (B, V, 8) vertex rows
               float* __restrict__ out_d,    // (B, 4, N)
               int* __restrict__ out_i,      // (B, 4, N)
               int N, int V) {
  __shared__ float4 sa[TILE_V * 2];
  const int b = blockIdx.y;
  const int n = blockIdx.x * THREADS + threadIdx.x;
  const bool live = n < N;
  float p[C];
#pragma unroll
  for (int c = 0; c < C; ++c)
    p[c] = operand<BF16>(P[((size_t)b * C + c) * N + (live ? n : 0)]);
  float sd[K], td[K];
  int si[K], ti[K];
  knn_slots::fill<K>(sd, si, INFINITY);
  const float* ab = A + (size_t)b * V * C;

  for (int base = 0; base < V; base += TILE_V) {
    const int cnt = min(TILE_V, V - base);
    __syncthreads();  // the previous stage is fully consumed
    for (int j = threadIdx.x; j < cnt * 2; j += THREADS) {
      const float* a = ab + (size_t)base * C + (size_t)j * 4;
      sa[j] = make_float4(operand<BF16>(a[0]), operand<BF16>(a[1]),
                          operand<BF16>(a[2]), operand<BF16>(a[3]));
    }
    __syncthreads();
    for (int t0 = 0; t0 < cnt; t0 += knn_slots::TILE) {
      const int t1 = min(t0 + knn_slots::TILE, cnt);
      knn_slots::fill<K>(td, ti, knn_slots::max_of<K>(sd));
#pragma unroll 2
      for (int j = t0; j < t1; ++j) {
        const float4 lo = sa[2 * j], hi = sa[2 * j + 1];
        float d = __fmul_rn(lo.x, p[0]);
        d = __fadd_rn(d, __fmul_rn(lo.y, p[1]));
        d = __fadd_rn(d, __fmul_rn(lo.z, p[2]));
        d = __fadd_rn(d, __fmul_rn(lo.w, p[3]));
        d = __fadd_rn(d, __fmul_rn(hi.x, p[4]));
        d = __fadd_rn(d, __fmul_rn(hi.y, p[5]));
        d = __fadd_rn(d, __fmul_rn(hi.z, p[6]));
        d = __fadd_rn(d, __fmul_rn(hi.w, p[7]));
        knn_slots::insert<K>(td, ti, d, base + j);
      }
      knn_slots::merge<K>(sd, si, td, ti);
    }
  }
  if (!live) return;
  knn_slots::sort<K>(sd, si);
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const size_t o = ((size_t)b * K + s) * N + n;
    out_d[o] = sqrtf(fmaxf(sd[s], 0.0f));
    out_i[o] = si[s];
  }
}

}  // namespace

// bf16 != 0: DEFAULT precision (bf16 operands), else HIGHEST (f32)
extern "C" int animnerf_knn_mxu(const void* P, const void* A, void* out_d,
                                void* out_i, int B, int N, int V, int bf16,
                                void* stream) {
  if (V < K) return (int)cudaErrorInvalidValue;
  if (N > 0 && B > 0) {
    dim3 grid((N + THREADS - 1) / THREADS, B);
    if (bf16)
      knn_mxu_kernel<true><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
          (const float*)P, (const float*)A, (float*)out_d, (int*)out_i, N, V);
    else
      knn_mxu_kernel<false><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
          (const float*)P, (const float*)A, (float*)out_d, (int*)out_i, N, V);
  }
  return (int)cudaGetLastError();
}
