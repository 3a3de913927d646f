// Weighted row scatter (the warp-blend backward), for Hopper (sm_90a).
//
// Replaces: animnerf_tpu/ops/blend.py::_scatter_kernel (reached through
// weighted_scatter_rows_pallas with transposed_in=True, g_t=True).
//
//   out[b, idx[b, k, n], c] += w[b, k, n] * g[b, c, n]     c < 16, k < K
//
// idx / w (B, K, N) as the kNN and warp-blend kernels emit them (K =
// k_neigh, 1..16), g (B, 16, N) rows-native cotangents, out (B, V, 16) f32.
//
// Bound on the H100: bytes. Per point it reads K indices, K weights and
// 16 g values and the table is written once (V x 16 x 4 B = 441 KB per
// element for SMPL). The TPU kernel keeps a VMEM-resident (Vp, 16)
// accumulator across a sequential point grid, so its sums are taken in a
// fixed order. Blocks of a GPU run in parallel and in no order, and f32
// atomics would land in a run-dependent order. Design: the wrapper makes
// the flattened keys b * V + idx of the entries e = (b * K + k) * N + n
// and orders them with a stable sort (data movement, as a compaction's
// nonzero is); entries that add an exact zero (weight 0, as gated-off
// neighbours have, or an all-zero cotangent column, as padded points have)
// are keyed past every row, so they lengthen no row's sum. Here 16 threads
// own one output row (b, v), one channel each, find the row's segment of
// the sorted keys by binary search and sum its entries in sorted order,
//   s = __fadd_rn(s, __fmul_rn(w[e], g[b, c, n])),
// 16 entries at a time: each lane loads one entry's index and weight, and
// all 16 g values of a lane's channel are in flight before its adds.
// Every row is written, zero rows included, and no atomics are used: the
// result is bit-equal from run to run, and to the plain version
// (ops/blend.py::weighted_scatter_rows_plain), which sums in the same order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_K = 16;
constexpr int F = 16;
constexpr int ROWS_PER_BLOCK = THREADS / F;

// first position in keys[0, n) whose key is >= x
__device__ __forceinline__ int lower_bound(const int* __restrict__ keys,
                                           int n, int x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (int)(((unsigned)lo + (unsigned)hi) >> 1);
    if (keys[mid] < x)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(THREADS)
weighted_scatter_kernel(const int* __restrict__ keys,      // sorted
                        const int64_t* __restrict__ perm,  // entry of each
                        const float* __restrict__ w,       // (B, K, N)
                        const float* __restrict__ g,       // (B, F, N)
                        float* __restrict__ out,           // (B, V, F)
                        int B, int N, int V, int n_keys) {
  const long long row = (long long)blockIdx.x * ROWS_PER_BLOCK +
                        threadIdx.x / F;
  const int c = threadIdx.x % F;
  if (row >= (long long)B * V) return;
  // the 16 lanes of this row (the warp's other half owns another row)
  const unsigned half = 0xFFFFu << (threadIdx.x & 16);
  const int begin = lower_bound(keys, n_keys, (int)row);
  const int end = lower_bound(keys, n_keys, (int)row + 1);
  const float* gb = g + ((size_t)(row / V) * F + c) * N;
  float s = 0.0f;
  // 16 entries at a time: lane j loads entry j's index and weight, every
  // lane its channel of the 16 g values, then the adds run in order
  for (int j0 = begin; j0 < end; j0 += F) {
    const int j = j0 + c;
    const int e = j < end ? (int)perm[j] : -1;
    const float we = j < end ? w[e] : 0.0f;
    float gv[F];
#pragma unroll
    for (int i = 0; i < F; ++i) {
      const int ei = __shfl_sync(half, e, i, F);
      gv[i] = ei >= 0 ? gb[ei % N] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < F; ++i) {
      const float wi = __shfl_sync(half, we, i, F);
      if (j0 + i < end) s = __fadd_rn(s, __fmul_rn(wi, gv[i]));
    }
  }
  out[row * F + c] = s;
}

}  // namespace

// keys: the stably sorted b * V + idx of the B * K * N entries (int32,
// those that contribute nothing keyed B * V, past every row); perm: the
// entry each sorted key came from (int64, torch.sort's indices).
extern "C" int animnerf_weighted_scatter(const void* keys, const void* perm,
                                         const void* w, const void* g,
                                         void* out, int B, int N, int V,
                                         int k, void* stream) {
  if (k < 1 || k > MAX_K) return (int)cudaErrorInvalidValue;
  const long long n_keys = (long long)B * k * N;
  if (n_keys >= (1LL << 31) || (long long)B * V >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * V;
  if (rows > 0) {
    const unsigned grid =
        (unsigned)((rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
    weighted_scatter_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const int*)keys, (const int64_t*)perm, (const float*)w,
        (const float*)g, (float*)out, B, N, V, (int)n_keys);
  }
  return (int)cudaGetLastError();
}
