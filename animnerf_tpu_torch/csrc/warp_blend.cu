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
// Every sum over k runs in order k = 0, 1, ..., K-1, and l1_k in order
// j = 0, 1, ..., as the TPU kernel (warp_blend.py:98-109) and the plain
// version take them. expf, not __expf: the gate is a hard threshold and a
// flipped gate turns a weight from zero to nonzero. w and bf are the
// backward's residuals; with w_out null (the no-grad callers: every view,
// dense view and eval frame) only out is written.
//
// Bound on the H100: bytes. Per point it reads 3 xyz floats, K distances
// and K indices and writes 8 (+ K + 16 with the residuals) floats. The
// gathered table rows (K x F x 4 B a point, F = num_lbs + 16: 40 for
// SMPL, 71 for SMPL-X) come from L1 and L2: the tables are 1-3 MB and
// neighbouring points share rows. What costs is the number of load
// instructions: each is a warp-wide gather from 32 different rows. One
// thread a point reading its rows a float at a time, row 0's LBS values
// once per neighbour, spent K (2 num_lbs + 16) of them a point (256 at
// SMPL, K = 4; 504 at SMPL-X). Staging a block's rows in shared memory
// first, a warp a row and a lane a float (cp.async, 4 B), measured slower
// still on the H100 (1.10 ms against 0.405 on a view's 2.19M points): one
// instruction then moves one row, K x ceil(F / 32) a point, before the
// shared reads. Design: 16-byte loads. Rows whose LBS part is a multiple
// of 4 floats (SMPL 24, SMPL-H 52, MANO 16) are read in place as float4s;
// for the others (SMPL-X 55, FLAME 5) warp_blend_pad_kernel first copies
// the table (1-3 MB) into rows [lbs | 0 pad to Lp | T (16)], Lp =
// 4 ceil(num_lbs / 4) (ops/warp_blend.py::warp_blend_row_layout mirrors
// it). One thread a point then reads row 0's LBS float4 once for all K
// neighbours and each neighbour's in turn (K Lp / 4 loads), and the 16
// transform values as 4 float4s a neighbour after the weights: K (Lp / 4
// + 4) loads a point, 40 at SMPL, 72 at SMPL-X (6.4x and 7x fewer). K is
// a template argument (one instantiation per K), so the per-neighbour
// arrays stay in registers. The TPU kernel's 128-lane vertex chunks,
// candidate-chunk pruning and dynamic_gather exist only for the TPU's
// lanes and are not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_K = 16;

// l1 += |r - v0| over the float4's first cnt components, in order
__device__ __forceinline__ void l1_add(float& l1, float4 r, float4 v0,
                                       int cnt) {
  l1 += fabsf(r.x - v0.x);
  if (cnt > 1) l1 += fabsf(r.y - v0.y);
  if (cnt > 2) l1 += fabsf(r.z - v0.z);
  if (cnt > 3) l1 += fabsf(r.w - v0.w);
}

// rows [lbs | 0 .. | T] of Lp + 16 floats from (B, V, num_lbs + 16)
__global__ void __launch_bounds__(THREADS)
warp_blend_pad_kernel(const float* __restrict__ table,
                      float* __restrict__ padded, long long rows,
                      int num_lbs, int Lp) {
  const int Fp = Lp + 16, F = num_lbs + 16;
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= rows * Fp) return;
  const long long r = i / Fp;
  const int c = (int)(i - r * Fp);
  const float* src = table + r * F;
  padded[i] = c < num_lbs ? src[c] : c < Lp ? 0.0f : src[num_lbs + c - Lp];
}

template <int K>
__global__ void __launch_bounds__(THREADS)
warp_blend_fwd_kernel(const float* __restrict__ xyz,    // (B, 8, N) rows
                      const float* __restrict__ dists,  // (B, K, N)
                      const int* __restrict__ idx,      // (B, K, N)
                      const float* __restrict__ table,  // (B, V, Lp + 16)
                      float* __restrict__ out,          // (B, 8, N)
                      float* __restrict__ w_out,        // (B, K, N) or null
                      float* __restrict__ bf_out,       // (B, 16, N) or null
                      int N, int V, int num_lbs, int Lp,
                      float inv_two_std2, float conf_gate) {
  const int b = blockIdx.y;
  const int n = blockIdx.x * THREADS + threadIdx.x;
  if (n >= N) return;
  const int F4 = Lp / 4 + 4, L4 = Lp / 4;
  const float4* tab =
      reinterpret_cast<const float4*>(table) + (size_t)b * V * F4;

  const float4* row[K];
  float d[K], w[K], l1[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    row[k] = tab + (size_t)idx[((size_t)b * K + k) * N + n] * F4;
    d[k] = dists[((size_t)b * K + k) * N + n];
    l1[k] = 0.0f;
  }

  // confidence gate against neighbour 0 (reference anim_nerf.py:165-171)
  for (int q = 0; q < L4; ++q) {
    const int cnt = min(4, num_lbs - 4 * q);
    const float4 v0 = __ldg(row[0] + q);
    float4 r[K];
#pragma unroll
    for (int k = 1; k < K; ++k) r[k] = __ldg(row[k] + q);
    l1_add(l1[0], v0, v0, cnt);
#pragma unroll
    for (int k = 1; k < K; ++k) l1_add(l1[k], r[k], v0, cnt);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float conf = expf(-l1[k] * inv_two_std2);
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
    float t[16];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 v = __ldg(row[k] + L4 + q);
      t[4 * q] = v.x;
      t[4 * q + 1] = v.y;
      t[4 * q + 2] = v.z;
      t[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int c = 0; c < 16; ++c) bf[c] += w[k] * t[c];
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
  if (w_out == nullptr) return;
#pragma unroll
  for (int k = 0; k < K; ++k) w_out[((size_t)b * K + k) * N + n] = w[k];
#pragma unroll
  for (int c = 0; c < 16; ++c) bf_out[((size_t)b * 16 + c) * N + n] = bf[c];
}

// launch the instantiation for k (1..MAX_K)
template <int K>
void launch(int k, dim3 grid, cudaStream_t stream, const float* xyz,
            const float* dists, const int* idx, const float* table,
            float* out, float* w_out, float* bf_out, int N, int V,
            int num_lbs, int Lp, float inv_two_std2, float conf_gate) {
  if (k == K) {
    warp_blend_fwd_kernel<K><<<grid, THREADS, 0, stream>>>(
        xyz, dists, idx, table, out, w_out, bf_out, N, V, num_lbs, Lp,
        inv_two_std2, conf_gate);
  } else if constexpr (K < MAX_K) {
    launch<K + 1>(k, grid, stream, xyz, dists, idx, table, out, w_out,
                  bf_out, N, V, num_lbs, Lp, inv_two_std2, conf_gate);
  }
}

}  // namespace

// table (B, V, num_lbs + 16); padded: null when num_lbs is a multiple of
// 4 and table is 16-byte aligned (its rows are then read in place), else
// scratch for B V (Lp + 16) floats, 16-byte aligned, that the pad kernel
// fills first; w_out and bf_out both null for the residual-free mode.
extern "C" int animnerf_warp_blend_fwd(
    const void* xyz, const void* dists, const void* idx, const void* table,
    void* padded, void* out, void* w_out, void* bf_out, int B, int N, int V,
    int k, int num_lbs, float inv_two_std2, float conf_gate, void* stream) {
  const int Lp = (num_lbs + 3) / 4 * 4;
  if (k < 1 || k > MAX_K || num_lbs < 1 ||
      (w_out == nullptr) != (bf_out == nullptr) ||
      (padded == nullptr &&
       (Lp != num_lbs || (uintptr_t)table % 16 != 0)) ||
      (uintptr_t)padded % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (N > 0 && B > 0) {
    const float* rows = (const float*)table;
    if (padded != nullptr) {
      const long long n = (long long)B * V * (Lp + 16);
      warp_blend_pad_kernel<<<(unsigned)((n + THREADS - 1) / THREADS),
                              THREADS, 0, s>>>(
          (const float*)table, (float*)padded, (long long)B * V, num_lbs, Lp);
      rows = (const float*)padded;
    }
    dim3 grid((N + THREADS - 1) / THREADS, B);
    launch<1>(k, grid, s, (const float*)xyz, (const float*)dists,
              (const int*)idx, rows, (float*)out, (float*)w_out,
              (float*)bf_out, N, V, num_lbs, Lp, inv_two_std2, conf_gate);
  }
  return (int)cudaGetLastError();
}
