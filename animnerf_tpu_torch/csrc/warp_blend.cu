// Neighbour gather + confidence-gated LBS blend + 4x4 warp, for Hopper.
//
// Replaces: animnerf_tpu/ops/warp_blend.py::_warp_blend_kernel (reached
// through warp_blend_fwd_pallas), forward only, warp_view=False.
//
// Per point n with its K neighbours (d_k, i_k), K = 1..16 as the kNN
// emits them, and table rows
// row_v = [lbs (num_lbs) | ober2cano 4x4 (16)]:
//   l1_k   = sum_j |lbs(i_k)[j] - lbs(i_0)[j]|
//   gate_k = exp(-l1_k / (2 std^2)) > conf_gate
//   w_k    = exp(-d_k) * gate_k / sum_k(...)
//   bd     = sum_k w_k d_k,   bf = sum_k w_k T(i_k)
//   out    = [bf[0:3]·xyz + bf[3] | bf[4:7]·xyz + bf[7] | bf[8:11]·xyz + bf[11]
//             | bd | 0 0 0 0],   w (K rows),   bf (16 rows)
// Every sum over k runs in order k = 0, 1, ..., K-1, as the TPU kernel
// (warp_blend.py:98-109) and the plain version take it. expf, not __expf:
// the gate is a hard threshold and a flipped gate turns a weight from
// zero to nonzero.
//
// Bound on the H100: bytes. Per point it reads 3 xyz floats, K distances
// and K indices and writes 8 + K + 16 floats; the gathered table rows
// (K x 160 B for SMPL) come from L2, since the 1.1 MB table is ~2% of the
// 50 MB L2. Design: one thread per point, the table read through the
// read-only path (__ldg), everything else in registers (K is a template
// argument, one instantiation per K, so the per-neighbour arrays stay
// there). The TPU kernel's
// 128-lane vertex chunks, candidate-chunk pruning and dynamic_gather
// exist only for the TPU's lanes and are not carried over.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_K = 16;

template <int K>
__global__ void __launch_bounds__(THREADS)
warp_blend_fwd_kernel(const float* __restrict__ xyz,    // (B, 8, N) rows
                      const float* __restrict__ dists,  // (B, K, N)
                      const int* __restrict__ idx,      // (B, K, N)
                      const float* __restrict__ table,  // (B, V, F)
                      float* __restrict__ out,          // (B, 8, N)
                      float* __restrict__ w_out,        // (B, K, N)
                      float* __restrict__ bf_out,       // (B, 16, N)
                      int N, int V, int F, int num_lbs,
                      float inv_two_std2, float conf_gate) {
  const int b = blockIdx.y;
  const int n = blockIdx.x * THREADS + threadIdx.x;
  if (n >= N) return;
  const float* tab = table + (size_t)b * V * F;

  int id[K];
  float d[K], w[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    id[k] = idx[((size_t)b * K + k) * N + n];
    d[k] = dists[((size_t)b * K + k) * N + n];
  }

  // confidence gate against neighbour 0 (reference anim_nerf.py:165-171)
  const float* row0 = tab + (size_t)id[0] * F;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float* rk = tab + (size_t)id[k] * F;
    float l1 = 0.0f;
    for (int j = 0; j < num_lbs; ++j)
      l1 += fabsf(__ldg(rk + j) - __ldg(row0 + j));
    const float conf = expf(-l1 * inv_two_std2);
    w[k] = expf(-d[k]) * (conf > conf_gate ? 1.0f : 0.0f);
  }
  float wsum = w[0];
#pragma unroll
  for (int k = 1; k < K; ++k) wsum += w[k];
  float bd = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    w[k] = w[k] / wsum;
    bd = (k == 0) ? w[k] * d[k] : bd + w[k] * d[k];
  }

  float bf[16];
#pragma unroll
  for (int c = 0; c < 16; ++c) bf[c] = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float* tk = tab + (size_t)id[k] * F + num_lbs;
#pragma unroll
    for (int c = 0; c < 16; ++c) bf[c] += w[k] * __ldg(tk + c);
  }

  const size_t xo = (size_t)b * 8 * N + n;
  const float x = xyz[xo], y = xyz[xo + N], z = xyz[xo + 2 * (size_t)N];
#pragma unroll
  for (int r = 0; r < 3; ++r)
    out[xo + r * (size_t)N] =
        bf[4 * r] * x + bf[4 * r + 1] * y + bf[4 * r + 2] * z + bf[4 * r + 3];
  out[xo + 3 * (size_t)N] = bd;
#pragma unroll
  for (int r = 4; r < 8; ++r) out[xo + r * (size_t)N] = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) w_out[((size_t)b * K + k) * N + n] = w[k];
#pragma unroll
  for (int c = 0; c < 16; ++c) bf_out[((size_t)b * 16 + c) * N + n] = bf[c];
}

// launch the instantiation for k (1..MAX_K)
template <int K>
void launch(int k, dim3 grid, cudaStream_t stream, const float* xyz,
            const float* dists, const int* idx, const float* table,
            float* out, float* w_out, float* bf_out, int N, int V, int F,
            int num_lbs, float inv_two_std2, float conf_gate) {
  if (k == K) {
    warp_blend_fwd_kernel<K><<<grid, THREADS, 0, stream>>>(
        xyz, dists, idx, table, out, w_out, bf_out, N, V, F, num_lbs,
        inv_two_std2, conf_gate);
  } else if constexpr (K < MAX_K) {
    launch<K + 1>(k, grid, stream, xyz, dists, idx, table, out, w_out,
                  bf_out, N, V, F, num_lbs, inv_two_std2, conf_gate);
  }
}

}  // namespace

extern "C" int animnerf_warp_blend_fwd(
    const void* xyz, const void* dists, const void* idx, const void* table,
    void* out, void* w_out, void* bf_out, int B, int N, int V, int F, int k,
    int num_lbs, float inv_two_std2, float conf_gate, void* stream) {
  if (k < 1 || k > MAX_K) return (int)cudaErrorInvalidValue;
  if (N > 0 && B > 0) {
    dim3 grid((N + THREADS - 1) / THREADS, B);
    launch<1>(k, grid, (cudaStream_t)stream, (const float*)xyz,
              (const float*)dists, (const int*)idx, (const float*)table,
              (float*)out, (float*)w_out, (float*)bf_out, N, V, F, num_lbs,
              inv_two_std2, conf_gate);
  }
  return (int)cudaGetLastError();
}
