// Exact, unquantised top-k nearest vertices, any k in 1..16, for Hopper
// (sm_90a).
//
// Replaces: animnerf_tpu/ops/knn_pallas.py::_knn_kernel (knn_pallas with
// packed=False, or with a padded vertex cloud above the packed key's
// 8192-vertex index field, such as SMPL-X's 10475) at its default
// tile_v = 512, with cull=False and far2=0: the only setting any caller
// uses. The AABB cull and the all-far skip are not ported.
//
// Contract (bit-identical to the plain version in ops/knn_kernel.py): for
// point p and vertex v,
//   d2 = ((vx-px)^2 + (vy-py)^2) + (vz-pz)^2
// with every subtraction, product and sum rounded on its own
// (__fsub_rn / __fmul_rn / __fadd_rn: nvcc would otherwise contract
// a*a + b into an FMA, which the TPU kernel does not). The K smallest d2
// come out ascending with their vertex indices and sqrtf (IEEE) of d2,
// chosen and ordered by the TPU kernel's rule (knn_slots.cuh: per
// 512-vertex tile, replace the first slot holding the maximum, then its
// sorting network), which decides exact ties as the TPU does. Any V >= K:
// there is no index field.
//
// Bound on the H100: operations. Per (point, vertex) pair: 3 f32
// subtractions, 3 multiplies, 2 adds and a compare, none of them an FMA,
// so the card's non-FMA f32 rate (half its 67 TFLOP/s FMA peak) bounds
// it; the per-tile merge adds ~3K^2 operations per 512 vertices (under 5%
// at K = 8); bytes are negligible (12 B in and 8K B out per point, the
// vertices stay on chip). Design: one thread per point, its K slots and
// the current 512-vertex tile's sorted K pairs in registers (K a template
// argument); the block stages the vertices as float4 (x, y, z, 0) in
// shared memory, TILE_V at a time (four of the TPU's tiles), so the sweep
// reads one broadcast float4 per pair.

#include <cuda_runtime.h>
#include <math.h>

#include "knn_slots.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TILE_V = 2048;  // 32 KB of float4 per stage
constexpr int MAX_K = 16;
static_assert(TILE_V % knn_slots::TILE == 0, "stages hold whole tiles");

template <int K>
__global__ void __launch_bounds__(THREADS)
knn_exact_kernel(const float* __restrict__ points,  // (B, N, 3)
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
  float sd[K], td[K];
  int si[K], ti[K];
  knn_slots::fill<K>(sd, si, INFINITY);
  const float* vb = verts + (size_t)b * V * 3;

  for (int base = 0; base < V; base += TILE_V) {
    const int cnt = min(TILE_V, V - base);
    __syncthreads();  // the previous stage is fully consumed
    for (int j = threadIdx.x; j < cnt; j += THREADS)
      sv[j] = make_float4(vb[(size_t)(base + j) * 3 + 0],
                          vb[(size_t)(base + j) * 3 + 1],
                          vb[(size_t)(base + j) * 3 + 2], 0.0f);
    __syncthreads();
    for (int t0 = 0; t0 < cnt; t0 += knn_slots::TILE) {
      const int t1 = min(t0 + knn_slots::TILE, cnt);
      knn_slots::fill<K>(td, ti, knn_slots::max_of<K>(sd));
#pragma unroll 4
      for (int j = t0; j < t1; ++j) {
        const float4 v = sv[j];
        const float ex = __fsub_rn(v.x, px);
        const float ey = __fsub_rn(v.y, py);
        const float ez = __fsub_rn(v.z, pz);
        const float d = __fadd_rn(
            __fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)),
            __fmul_rn(ez, ez));
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
    out_d[o] = sqrtf(sd[s]);
    out_i[o] = si[s];
  }
}

// launch the instantiation for k (1..MAX_K)
template <int K>
void launch(int k, dim3 grid, cudaStream_t stream, const float* points,
            const float* verts, float* out_d, int* out_i, int N, int V) {
  if (k == K) {
    knn_exact_kernel<K><<<grid, THREADS, 0, stream>>>(points, verts, out_d,
                                                      out_i, N, V);
  } else if constexpr (K < MAX_K) {
    launch<K + 1>(k, grid, stream, points, verts, out_d, out_i, N, V);
  }
}

}  // namespace

extern "C" int animnerf_knn_exact(const void* points, const void* verts,
                                  void* out_d, void* out_i, int B, int N,
                                  int V, int k, void* stream) {
  if (k < 1 || k > MAX_K || V < k) return (int)cudaErrorInvalidValue;
  if (N > 0 && B > 0) {
    dim3 grid((N + THREADS - 1) / THREADS, B);
    launch<1>(k, grid, (cudaStream_t)stream, (const float*)points,
              (const float*)verts, (float*)out_d, (int*)out_i, N, V);
  }
  return (int)cudaGetLastError();
}
