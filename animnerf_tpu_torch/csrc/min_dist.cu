// Exact nearest-vertex distance, for Hopper (sm_90a).
//
// Replaces: animnerf_tpu/ops/knn_pallas.py::_min_dist_kernel (reached
// through min_dist_pallas, the validity pre-pass of the compacted render
// with prepass="exact").
//
// Contract (bit-identical to ops/knn.py::min_vertex_distance_plain): for
// point p, out = sqrtf(min over vertices v of
//   ((vx-px)^2 + (vy-py)^2) + (vz-pz)^2)
// with every operation rounded on its own (__fsub_rn / __fmul_rn /
// __fadd_rn, no FMA contraction), as the TPU kernel computes it; the
// minimum does not depend on the visiting order. The TPU kernel writes its
// row to 8 sublanes ((B, 8, Np), row 0 used) only because a 1-sublane
// block is not a legal TPU block; here the output is (B, N).
//
// Bound on the H100: operations. Per (point, vertex) pair: 3 f32
// subtractions, 3 multiplies, 2 adds and a min, none of them an FMA (the
// card's non-FMA f32 rate is half its 67 TFLOP/s FMA peak); bytes are 12 B
// in and 4 B out per point. Design: one thread per point with its running
// minimum in a register; the block stages the vertices as float4 in shared
// memory, TILE_V at a time, and each thread sweeps them as broadcasts.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE_V = 2048;  // 32 KB of float4 per stage

__global__ void __launch_bounds__(THREADS)
min_dist_kernel(const float* __restrict__ points,  // (B, N, 3)
                const float* __restrict__ verts,   // (B, V, 3)
                float* __restrict__ out,           // (B, N)
                int N, int V) {
  __shared__ float4 sv[TILE_V];
  const int b = blockIdx.y;
  const int n = blockIdx.x * THREADS + threadIdx.x;
  const bool live = n < N;
  const float* p = points + ((size_t)b * N + (live ? n : 0)) * 3;
  const float px = p[0], py = p[1], pz = p[2];
  float best = INFINITY;
  const float* vb = verts + (size_t)b * V * 3;

  for (int base = 0; base < V; base += TILE_V) {
    const int cnt = min(TILE_V, V - base);
    __syncthreads();  // the previous stage is fully consumed
    for (int j = threadIdx.x; j < cnt; j += THREADS)
      sv[j] = make_float4(vb[(size_t)(base + j) * 3 + 0],
                          vb[(size_t)(base + j) * 3 + 1],
                          vb[(size_t)(base + j) * 3 + 2], 0.0f);
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < cnt; ++j) {
      const float4 v = sv[j];
      const float ex = __fsub_rn(v.x, px);
      const float ey = __fsub_rn(v.y, py);
      const float ez = __fsub_rn(v.z, pz);
      best = fminf(best, __fadd_rn(__fadd_rn(__fmul_rn(ex, ex),
                                             __fmul_rn(ey, ey)),
                                   __fmul_rn(ez, ez)));
    }
  }
  if (live) out[(size_t)b * N + n] = sqrtf(best);
}

}  // namespace

extern "C" int animnerf_min_dist(const void* points, const void* verts,
                                 void* out, int B, int N, int V,
                                 void* stream) {
  if (V < 1) return (int)cudaErrorInvalidValue;
  if (N > 0 && B > 0) {
    dim3 grid((N + THREADS - 1) / THREADS, B);
    min_dist_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)points, (const float*)verts, (float*)out, N, V);
  }
  return (int)cudaGetLastError();
}
