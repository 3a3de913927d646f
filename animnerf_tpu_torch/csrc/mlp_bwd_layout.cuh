// The MLP backward's scratch and gradient layouts, shared by its main
// kernel (fused_mlp_bwd.cu) and its weight-gradient pass (mlp_wgrad.cu).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace mlpb {

constexpr int WIDTH = 256;
constexpr int DIR_W = 128;
constexpr int N_W = 13;
constexpr int SPLITS = 44;  // point splits of the weight-gradient sums
constexpr int HEAD_COLS = 4;  // d_rgb_raw[0..2], d_sigma (f32)

// Two encoding widths. EC, the encoding block's columns in the scratch and
// in shared memory: enc_cols(n_freqs), 64 for n_freqs 0..10 and 128 for
// 11..20 (ops/fused_mlp.py::bwd_layout), the columns from 3 + 6 n_freqs
// zero; a template argument of the kernels. ER, the rows of the encoding
// in pack_params' weights: enc_rows(n_freqs), 8..128, a multiple of 8,
// the columns of dW_0 and dW_8 in the flat gradients; a runtime value.
constexpr int EC_MAX = 128;
__host__ __device__ __forceinline__ int enc_cols_of(int er) {
  return er <= 64 ? 64 : 128;
}

// ------------------------------------------------------- scratch layout
// H (layer inputs): 0 enc (EC) | 1..8 h0..h7 (256) | 9 hf (256) | 10 hd (128)
// G (layer output cotangents): 0..7 d0..d7 (256) | 8 d_hf (256) | 9 d_hd (128)
// Each array is a (chunk, width) point-major block of the scratch.
template <int EC>
__host__ __device__ __forceinline__ int h_col(int h) {
  return h == 0 ? 0 : EC + (h - 1) * WIDTH;
}
__host__ __device__ __forceinline__ int g_width(int g) {
  return g == 9 ? DIR_W : WIDTH;
}
__host__ __device__ __forceinline__ int g_col(int g) { return g * WIDTH; }
template <int EC>
constexpr int HW = EC + 9 * WIDTH + DIR_W;  // 2496 at EC = 64
constexpr int GW = 9 * WIDTH + DIR_W;      // 2432

// flat f32 gradient layout: dW_0..12 then db_0..12, pack_params' shapes
// (dW_0 and dW_8 have er columns)
struct GradLayout {
  size_t w[N_W], b[N_W], total;
  int wr[N_W], wc[N_W], br[N_W];
};
__host__ __device__ inline GradLayout grad_layout(int er) {
  GradLayout L;
  for (int i = 0; i < N_W; ++i) {
    L.wr[i] = WIDTH;
    L.wc[i] = WIDTH;
    L.br[i] = WIDTH;
  }
  L.wc[0] = er;
  L.wc[8] = er;
  L.wr[9] = 8;
  L.wr[11] = DIR_W;
  L.wr[12] = 8;
  L.wc[12] = DIR_W;
  L.br[9] = 8;
  L.br[11] = DIR_W;
  L.br[12] = 8;
  size_t o = 0;
  for (int i = 0; i < N_W; ++i) {
    L.w[i] = o;
    o += (size_t)L.wr[i] * L.wc[i];
  }
  for (int i = 0; i < N_W; ++i) {
    L.b[i] = o;
    o += (size_t)L.br[i];
  }
  L.total = (o + 63) / 64 * 64;  // keeps every split's partial 256 B aligned
  return L;
}

template <int EC>
__host__ __device__ __forceinline__ int h_width(int h) {
  return h == 0 ? EC : h == 10 ? DIR_W : WIDTH;
}

// grads = the sum of the SPLITS partials (one flat gradient each), in
// split order
static __global__ void __launch_bounds__(256)
reduce_splits(const float* __restrict__ part, size_t total,
              float* __restrict__ out) {
  const size_t e = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (e >= total) return;
  float acc = 0.0f;
  for (int s = 0; s < SPLITS; ++s) acc += part[(size_t)s * total + e];
  out[e] = acc;
}

}  // namespace mlpb

// mlp_wgrad.cu: the bf16 weight-gradient pass over rows [0, rows) of a
// chunk's scratch (encoding rows er) into the partials (stored when
// `first`, else added)
extern "C" int animnerf_mlp_wgrad_chunk(const void* scratch, void* heads,
                                        void* partials, int rows, int chunk,
                                        int er, int first, void* stream);
