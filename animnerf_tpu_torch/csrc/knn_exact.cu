// Exact, unquantised top-4 nearest vertices, for Hopper (sm_90a).
//
// Replaces: animnerf_tpu/ops/knn_pallas.py::_knn_kernel (knn_pallas with
// packed=False, or with a padded vertex cloud above the packed key's
// 8192-vertex index field, such as SMPL-X's 10475), k=4, with cull=False
// and far2=0: the only setting any caller uses. The AABB cull and the
// all-far skip are not ported.
//
// Contract (bit-identical to the plain version in ops/knn_kernel.py): for
// point p and vertex v,
//   d2 = ((vx-px)^2 + (vy-py)^2) + (vz-pz)^2
// with every subtraction, product and sum rounded on its own
// (__fsub_rn / __fmul_rn / __fadd_rn: nvcc would otherwise contract
// a*a + b into an FMA, which the TPU kernel does not). The 4 smallest d2
// come out ascending with their vertex indices and sqrtf (IEEE) of d2. A
// vertex only enters the running top-4 with a strictly smaller d2, and the
// vertices are visited in index order, so an equal d2 goes to the smaller
// index. Any V: there is no index field.
//
// Bound on the H100: operations. Per (point, vertex) pair: 3 f32
// subtractions, 3 multiplies, 2 adds and a compare, none of them an FMA,
// so the card's non-FMA f32 rate (half its 67 TFLOP/s FMA peak) bounds
// it; bytes are negligible (12 B in and 32 B out per point, the vertices
// stay on chip). Design: one thread per point with its sorted top-4 (d2,
// index) in registers; the block stages the vertices as float4 (x, y, z,
// 0) in shared memory, TILE_V at a time, so the sweep reads one broadcast
// float4 per pair. The TPU kernel's k extract-min passes per vertex tile
// and its final sorting network exist for its lanes and are not carried
// over: an insert into a sorted register list gives the same top-4.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE_V = 2048;  // 32 KB of float4 per stage

__global__ void __launch_bounds__(THREADS)
knn_exact_kernel(const float* __restrict__ points,  // (B, N, 3)
                 const float* __restrict__ verts,   // (B, V, 3)
                 float* __restrict__ out_d,         // (B, 4, N)
                 int* __restrict__ out_i,           // (B, 4, N)
                 int N, int V) {
  __shared__ float4 sv[TILE_V];
  const int b = blockIdx.y;
  const int n = blockIdx.x * THREADS + threadIdx.x;
  const bool live = n < N;
  const float* p = points + ((size_t)b * N + (live ? n : 0)) * 3;
  const float px = p[0], py = p[1], pz = p[2];
  float d0 = INFINITY, d1 = INFINITY, d2 = INFINITY, d3 = INFINITY;
  int i0 = 0, i1 = 0, i2 = 0, i3 = 0;
  const float* vb = verts + (size_t)b * V * 3;

  for (int base = 0; base < V; base += TILE_V) {
    const int cnt = min(TILE_V, V - base);
    __syncthreads();  // the previous stage is fully consumed
    for (int j = threadIdx.x; j < cnt; j += THREADS)
      sv[j] = make_float4(vb[(size_t)(base + j) * 3 + 0],
                          vb[(size_t)(base + j) * 3 + 1],
                          vb[(size_t)(base + j) * 3 + 2], 0.0f);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < cnt; ++j) {
      const float4 v = sv[j];
      const float ex = __fsub_rn(v.x, px);
      const float ey = __fsub_rn(v.y, py);
      const float ez = __fsub_rn(v.z, pz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)),
                                __fmul_rn(ez, ez));
      if (d < d3) {  // sorted insert into d0 <= d1 <= d2 <= d3
        const int id = base + j;
        if (d < d2) {
          d3 = d2;
          i3 = i2;
          if (d < d1) {
            d2 = d1;
            i2 = i1;
            if (d < d0) {
              d1 = d0;
              i1 = i0;
              d0 = d;
              i0 = id;
            } else {
              d1 = d;
              i1 = id;
            }
          } else {
            d2 = d;
            i2 = id;
          }
        } else {
          d3 = d;
          i3 = id;
        }
      }
    }
  }
  if (!live) return;
  const float ds[4] = {d0, d1, d2, d3};
  const int is[4] = {i0, i1, i2, i3};
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const size_t o = ((size_t)b * 4 + s) * N + n;
    out_d[o] = sqrtf(ds[s]);
    out_i[o] = is[s];
  }
}

}  // namespace

extern "C" int animnerf_knn_exact(const void* points, const void* verts,
                                  void* out_d, void* out_i, int B, int N,
                                  int V, void* stream) {
  if (V < 4) return (int)cudaErrorInvalidValue;
  if (N > 0 && B > 0) {
    dim3 grid((N + THREADS - 1) / THREADS, B);
    knn_exact_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)points, (const float*)verts, (float*)out_d,
        (int*)out_i, N, V);
  }
  return (int)cudaGetLastError();
}
