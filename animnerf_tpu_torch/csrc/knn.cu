// Exact top-4 nearest vertices under packed int32 keys, for Hopper (sm_90a).
//
// Replaces: animnerf_tpu/ops/knn_pallas.py::_tournament_knn_kernel (the
// packed, k=4 path of knn_pallas), forward only.
//
// Contract (bit-identical keys to the TPU kernel and to the plain version
// in ops/knn_kernel.py): for point p and vertex v,
//   pp   = (px*px + py*py) + pz*pz
//   m2   = -(v + v),   vq = (vx*vx + vy*vy) + vz*vz
//   d2   = max(pp + (m2z*pz + (m2y*py + (m2x*px + vq))), 0)
//   key  = (bits(d2) & ~0x1FFF) | vertex_index        (V <= 8192)
// The 4 smallest keys are returned ascending as sqrt(bits(key & ~0x1FFF))
// and key & 0x1FFF. Keys are unique (index bits), so ties go to the
// smaller index and the top-4 does not depend on the visiting order.
// Every product and sum goes through __fmul_rn / __fadd_rn: nvcc would
// otherwise contract a*b+c into an FMA, which XLA does not, and a key
// differing in one bit can swap two neighbours.
//
// Bound on the H100: operations. Each (point, vertex) pair costs 3 f32
// multiplies, 4 f32 adds, a max, two integer ops and a compare; bytes are
// negligible (12 B per point in, 32 B out, the vertices stay on chip).
// Design: one thread per query point, keeping its sorted top-4 keys in
// registers. The block stages the vertex rows as float4 (-2vx, -2vy, -2vz,
// |v|^2) in shared memory, TILE_V at a time, so the sweep reads one
// broadcast float4 per pair. The TPU's lane tournament, tile skip and
// far skip are not carried over (the last two are off on the serving path).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE_V = 1024;  // 16 KB of float4 per stage
constexpr int KEY_MASK = ~0x1FFF;
constexpr int BIGKEY = 0x7FFFFFFF;

__global__ void __launch_bounds__(THREADS)
knn_top4_kernel(const float* __restrict__ points,  // (B, N, 3)
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
  const float pp = __fadd_rn(__fadd_rn(__fmul_rn(px, px), __fmul_rn(py, py)),
                             __fmul_rn(pz, pz));
  int k0 = BIGKEY, k1 = BIGKEY, k2 = BIGKEY, k3 = BIGKEY;
  const float* vb = verts + (size_t)b * V * 3;

  for (int base = 0; base < V; base += TILE_V) {
    const int cnt = min(TILE_V, V - base);
    __syncthreads();  // previous stage fully consumed
    for (int i = threadIdx.x; i < cnt; i += THREADS) {
      const float vx = vb[(size_t)(base + i) * 3 + 0];
      const float vy = vb[(size_t)(base + i) * 3 + 1];
      const float vz = vb[(size_t)(base + i) * 3 + 2];
      const float vq = __fadd_rn(
          __fadd_rn(__fmul_rn(vx, vx), __fmul_rn(vy, vy)), __fmul_rn(vz, vz));
      sv[i] = make_float4(-__fadd_rn(vx, vx), -__fadd_rn(vy, vy),
                          -__fadd_rn(vz, vz), vq);
    }
    __syncthreads();
    for (int i = 0; i < cnt; ++i) {
      const float4 v = sv[i];
      float d2 = __fadd_rn(
          pp, __fadd_rn(__fmul_rn(v.z, pz),
                        __fadd_rn(__fmul_rn(v.y, py),
                                  __fadd_rn(__fmul_rn(v.x, px), v.w))));
      d2 = fmaxf(d2, 0.0f);
      const int key = (__float_as_int(d2) & KEY_MASK) | (base + i);
      if (key < k3) {  // sorted insert into k0 < k1 < k2 < k3
        if (key < k2) {
          k3 = k2;
          if (key < k1) {
            k2 = k1;
            if (key < k0) {
              k1 = k0;
              k0 = key;
            } else {
              k1 = key;
            }
          } else {
            k2 = key;
          }
        } else {
          k3 = key;
        }
      }
    }
  }
  if (!live) return;
  const int ks[4] = {k0, k1, k2, k3};
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const size_t o = ((size_t)b * 4 + s) * N + n;
    out_d[o] = sqrtf(__int_as_float(ks[s] & KEY_MASK));
    out_i[o] = ks[s] & 0x1FFF;
  }
}

}  // namespace

extern "C" int animnerf_knn_top4(const void* points, const void* verts,
                                 void* out_d, void* out_i, int B, int N,
                                 int V, void* stream) {
  if (N > 0 && B > 0) {
    dim3 grid((N + THREADS - 1) / THREADS, B);
    knn_top4_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)points, (const float*)verts, (float*)out_d,
        (int*)out_i, N, V);
  }
  return (int)cudaGetLastError();
}
