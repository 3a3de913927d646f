// Fused positional encoding + canonical NeRF MLP forward, for Hopper.
//
// Replaces: animnerf_tpu/ops/fused_mlp.py::_fwd_kernel (reached through
// fused_nerf_fwd), forward only.
//
// Per point: enc = [x, y, z, sin(2^j x..z), cos(2^j x..z) for j < F]; an
// 8x256 ReLU trunk with the skip at layer 4 as a split product (the enc
// half accumulates into the same f32 accumulator); sigma head; xyz_final
// (no ReLU); dir_0 + ReLU; rgb + sigmoid. Output rows [r, g, b, sigma,
// 0, 0, 0, 0]. Rounding points of the bf16 path follow the TPU kernel
// (ops/fused_mlp.py:160-179) exactly:
//   enc (f32) -> bf16
//   trunk h   = relu(bf16(bf16(acc_f32) + bf16(b)))
//   sigma     = acc_f32 + b_f32
//   hf        = bf16(bf16(acc_f32) + bf16(b))          (no ReLU)
//   hd        = relu(bf16(bf16(acc_f32) + bf16(b)))
//   rgb       = sigmoid(acc_f32 + b_f32)
// The f32 path uses f32 operands and no rounding. sinf/cosf, not __sinf:
// at 2^9 the arguments reach hundreds of radians.
//
// Bound on the H100: operations (~1.19 MFLOP per point on the tensor
// cores; 12 B in and 32 B out per point). The 1.19 MB of bf16 weights do
// not fit the 227 KB of shared memory, so the design keeps the
// activations on chip instead: a block owns T=128 points and holds their
// bf16 activations (two 128x256 ping-pong buffers) and encoding in shared
// memory; each layer's weights stream from L2 straight into wmma
// fragments (bf16 operands, f32 accumulators, 16x16x16 tiles on the
// tensor cores). Each of the 8 warps owns 2 column tiles (32 outputs) for
// all 8 row tiles, so every weight element is read once per block. The
// epilogue stages one 16x16 accumulator tile per warp through shared
// memory to apply the bias, rounding and ReLU. The two small heads (sigma,
// rgb) run on the CUDA cores. No library GEMM is involved. The f32 path
// is a plain SIMT kernel (one output feature per thread, 32 points per
// block), reading the same (N, K) weights row by row. wgmma and TMA
// pipelining are left to a later revision.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int WIDTH = 256;
constexpr int DIR_W = 128;
constexpr int N_W = 13;  // packed operands, see ops/fused_mlp.py::pack_params
constexpr int SKIP = 4;

struct MlpWeights {
  const void* w[N_W];   // (N, K) row-major, bf16 or f32 (pack_params' layout)
  const float* b[N_W];  // f32 biases (N,)
};

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// ---------------------------------------------------------------- bf16 path

constexpr int T = 128;               // points per block
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int LDH = WIDTH + 8;       // activation row pitch (bf16 elements)
constexpr int RT = T / 16;           // row tiles per block

typedef __nv_bfloat16 bf16;

// out(T x N_OUT) = epilogue(in(T x K) @ W^T [+ in2(T x K2) @ W2^T] + b)
// W is (N_OUT, K) row-major, i.e. the col-major (K x N_OUT) B operand.
template <int N_OUT, bool RELU>
__device__ __forceinline__ void dense_bf16(
    const bf16* in, int ld_in, int K, const bf16* __restrict__ W,
    const bf16* in2, int ld_in2, int K2, const bf16* __restrict__ W2,
    const float* __restrict__ bias, bf16* out, float* scratch) {
  constexpr int CT = N_OUT / 16 / WARPS;  // column tiles per warp
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[RT][CT];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int c = 0; c < CT; ++c) wmma::fill_fragment(acc[r][c], 0.0f);

  for (int pass = 0; pass < 2; ++pass) {
    const bf16* A = pass == 0 ? in : in2;
    const bf16* Wp = pass == 0 ? W : W2;
    const int lda = pass == 0 ? ld_in : ld_in2;
    const int KK = pass == 0 ? K : K2;
    if (Wp == nullptr) break;
    for (int k0 = 0; k0 < KK; k0 += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr[CT];
#pragma unroll
      for (int c = 0; c < CT; ++c)
        wmma::load_matrix_sync(
            bfr[c], Wp + (size_t)((warp * CT + c) * 16) * KK + k0, KK);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, A + r * 16 * lda + k0, lda);
#pragma unroll
        for (int c = 0; c < CT; ++c)
          wmma::mma_sync(acc[r][c], a, bfr[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RT; ++r) {
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      wmma::store_matrix_sync(scratch, acc[r][c], 16, wmma::mem_row_major);
      __syncwarp();
      const int n0 = (warp * CT + c) * 16;
      for (int e = lane; e < 256; e += 32) {
        const int n = n0 + (e & 15);
        const int t = r * 16 + (e >> 4);
        float v = bf16r(bf16r(scratch[e]) + bf16r(bias[n]));
        if (RELU) v = fmaxf(v, 0.0f);
        out[t * LDH + n] = __float2bfloat16_rn(v);
      }
      __syncwarp();
    }
  }
}

// f32 dot of one point's bf16 activation row with a bf16 weight row
__device__ __forceinline__ float dot_row_bf16(const bf16* h, const bf16* w,
                                              int K) {
  float acc = 0.0f;
  for (int k = 0; k < K; k += 2) {
    const float2 hv = __bfloat1622float2(*(const __nv_bfloat162*)(h + k));
    const float2 wv = __bfloat1622float2(*(const __nv_bfloat162*)(w + k));
    acc = fmaf(hv.x, wv.x, acc);
    acc = fmaf(hv.y, wv.y, acc);
  }
  return acc;
}

__global__ void __launch_bounds__(THREADS, 1)
fused_mlp_bf16_kernel(const float* __restrict__ xyz,  // (8, M) rows
                      MlpWeights p, float* __restrict__ out,  // (8, M)
                      int M, int n_freqs, int E) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* bufA = (bf16*)smem;
  bf16* bufB = bufA + T * LDH;
  const int LDE = E + 8;
  bf16* enc = bufB + T * LDH;
  float* scratch = (float*)(enc + T * LDE) + (threadIdx.x >> 5) * 256;
  const int m0 = blockIdx.x * T;

  // positional encoding: thread (t, half) computes point t's frequencies
  // j with j % 2 == half; half 0 also writes the identity and padding
  {
    const int t = threadIdx.x % T;
    const int half = threadIdx.x / T;
    const int m = m0 + t;
    const bool live = m < M;
    const float c3[3] = {live ? xyz[m] : 0.0f, live ? xyz[(size_t)M + m] : 0.0f,
                         live ? xyz[2 * (size_t)M + m] : 0.0f};
    bf16* row = enc + t * LDE;
    if (half == 0) {
      for (int c = 0; c < 3; ++c) row[c] = __float2bfloat16_rn(c3[c]);
      for (int e = 3 + 6 * n_freqs; e < E; ++e) row[e] = __float2bfloat16_rn(0.0f);
    }
    for (int j = half; j < n_freqs; j += 2) {
      const float f = (float)(1 << j);
      for (int c = 0; c < 3; ++c) {
        const float a = f * c3[c];
        row[3 + 6 * j + c] = __float2bfloat16_rn(sinf(a));
        row[3 + 6 * j + 3 + c] = __float2bfloat16_rn(cosf(a));
      }
    }
  }
  __syncthreads();

  const bf16* const* w = (const bf16* const*)p.w;
  dense_bf16<WIDTH, true>(enc, LDE, E, w[0], nullptr, 0, 0, nullptr, p.b[0],
                          bufA, scratch);
  __syncthreads();
  bf16* hin = bufA;
  bf16* hout = bufB;
  for (int i = 1; i < 8; ++i) {
    if (i == SKIP)
      dense_bf16<WIDTH, true>(hin, LDH, WIDTH, w[i], enc, LDE, E, w[8],
                              p.b[i], hout, scratch);
    else
      dense_bf16<WIDTH, true>(hin, LDH, WIDTH, w[i], nullptr, 0, 0, nullptr,
                              p.b[i], hout, scratch);
    __syncthreads();
    bf16* tmp = hin;
    hin = hout;
    hout = tmp;
  }
  // hin holds h7. sigma head (f32 accumulate, f32 bias, no rounding)
  if (threadIdx.x < T) {
    const int t = threadIdx.x;
    const int m = m0 + t;
    const float s = dot_row_bf16(hin + t * LDH, w[9], WIDTH) + p.b[9][0];
    if (m < M) {
      out[3 * (size_t)M + m] = s;
      for (int r = 4; r < 8; ++r) out[r * (size_t)M + m] = 0.0f;
    }
  }
  // xyz_final (no ReLU) into hout, then dir_0 + ReLU back into hin
  dense_bf16<WIDTH, false>(hin, LDH, WIDTH, w[10], nullptr, 0, 0, nullptr,
                           p.b[10], hout, scratch);
  __syncthreads();
  dense_bf16<DIR_W, true>(hout, LDH, WIDTH, w[11], nullptr, 0, 0, nullptr,
                          p.b[11], hin, scratch);
  __syncthreads();
  // rgb head: sigmoid(acc_f32 + b_f32)
  for (int task = threadIdx.x; task < 3 * T; task += THREADS) {
    const int c = task / T;
    const int t = task % T;
    const int m = m0 + t;
    const float v = dot_row_bf16(hin + t * LDH, w[12] + c * DIR_W, DIR_W);
    if (m < M) out[c * (size_t)M + m] = sigmoidf(v + p.b[12][c]);
  }
}

// ----------------------------------------------------------------- f32 path

constexpr int TF = 32;  // points per block

// out[n][t] = epilogue(sum_k in[k][t] * W[n][k] (+ in2 . W2) + b[n]);
// activations feature-major (K x TF) f32, W (N_OUT x K) row-major with K a
// multiple of 4: thread n reads its weight row four columns at a time.
template <int N_OUT, bool RELU>
__device__ __forceinline__ void dense_f32(const float* in, int K,
                                          const float* __restrict__ W,
                                          const float* in2, int K2,
                                          const float* __restrict__ W2,
                                          const float* __restrict__ bias,
                                          float* out) {
  const int n = threadIdx.x;
  if (n >= N_OUT) return;
  float acc[TF];
#pragma unroll
  for (int t = 0; t < TF; ++t) acc[t] = 0.0f;
  for (int pass = 0; pass < 2; ++pass) {
    const float* A = pass == 0 ? in : in2;
    const float* Wp = pass == 0 ? W : W2;
    const int KK = pass == 0 ? K : K2;
    if (Wp == nullptr) break;
    const float4* wrow = (const float4*)(Wp + (size_t)n * KK);
    for (int k4 = 0; k4 < KK / 4; ++k4) {
      const float4 w4 = __ldg(wrow + k4);
      const float wk[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const float wv = wk[s];
        const float4* h = (const float4*)(A + (4 * k4 + s) * TF);
#pragma unroll
        for (int q = 0; q < TF / 4; ++q) {
          const float4 hv = h[q];
          acc[4 * q + 0] = fmaf(hv.x, wv, acc[4 * q + 0]);
          acc[4 * q + 1] = fmaf(hv.y, wv, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(hv.z, wv, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(hv.w, wv, acc[4 * q + 3]);
        }
      }
    }
  }
  const float bn = bias[n];
#pragma unroll
  for (int t = 0; t < TF; ++t) {
    float v = acc[t] + bn;
    if (RELU) v = fmaxf(v, 0.0f);
    out[n * TF + t] = v;
  }
}

__global__ void __launch_bounds__(WIDTH)
fused_mlp_f32_kernel(const float* __restrict__ xyz, MlpWeights p,
                     float* __restrict__ out, int M, int n_freqs, int E) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* enc = (float*)smem;            // (E, TF)
  float* bufA = enc + E * TF;           // (WIDTH, TF)
  float* bufB = bufA + WIDTH * TF;
  const int m0 = blockIdx.x * TF;
  const float* const* w = (const float* const*)p.w;

  for (int task = threadIdx.x; task < TF * 2; task += WIDTH) {
    const int t = task % TF;
    const int half = task / TF;
    const int m = m0 + t;
    const bool live = m < M;
    const float c3[3] = {live ? xyz[m] : 0.0f, live ? xyz[(size_t)M + m] : 0.0f,
                         live ? xyz[2 * (size_t)M + m] : 0.0f};
    if (half == 0) {
      for (int c = 0; c < 3; ++c) enc[c * TF + t] = c3[c];
      for (int e = 3 + 6 * n_freqs; e < E; ++e) enc[e * TF + t] = 0.0f;
    }
    for (int j = half; j < n_freqs; j += 2) {
      const float f = (float)(1 << j);
      for (int c = 0; c < 3; ++c) {
        const float a = f * c3[c];
        enc[(3 + 6 * j + c) * TF + t] = sinf(a);
        enc[(3 + 6 * j + 3 + c) * TF + t] = cosf(a);
      }
    }
  }
  __syncthreads();
  dense_f32<WIDTH, true>(enc, E, w[0], nullptr, 0, nullptr, p.b[0], bufA);
  __syncthreads();
  float* hin = bufA;
  float* hout = bufB;
  for (int i = 1; i < 8; ++i) {
    if (i == SKIP)
      dense_f32<WIDTH, true>(hin, WIDTH, w[i], enc, E, w[8], p.b[i], hout);
    else
      dense_f32<WIDTH, true>(hin, WIDTH, w[i], nullptr, 0, nullptr, p.b[i],
                             hout);
    __syncthreads();
    float* tmp = hin;
    hin = hout;
    hout = tmp;
  }
  if (threadIdx.x < TF) {  // sigma head; W9 is (8, WIDTH), row 0 live
    const int t = threadIdx.x;
    float s = 0.0f;
    for (int k = 0; k < WIDTH; ++k) s = fmaf(hin[k * TF + t], w[9][k], s);
    const int m = m0 + t;
    if (m < M) {
      out[3 * (size_t)M + m] = s + p.b[9][0];
      for (int r = 4; r < 8; ++r) out[r * (size_t)M + m] = 0.0f;
    }
  }
  dense_f32<WIDTH, false>(hin, WIDTH, w[10], nullptr, 0, nullptr, p.b[10],
                          hout);
  __syncthreads();
  dense_f32<DIR_W, true>(hout, WIDTH, w[11], nullptr, 0, nullptr, p.b[11],
                         hin);
  __syncthreads();
  if (threadIdx.x < 3 * TF) {  // rgb head; W12 is (8, DIR_W)
    const int c = threadIdx.x / TF;
    const int t = threadIdx.x % TF;
    float v = 0.0f;
    for (int k = 0; k < DIR_W; ++k)
      v = fmaf(hin[k * TF + t], w[12][c * DIR_W + k], v);
    const int m = m0 + t;
    if (m < M) out[c * (size_t)M + m] = sigmoidf(v + p.b[12][c]);
  }
}

}  // namespace

// xyz, out: (8, M) f32 rows; w_ptrs / b_ptrs: host arrays of 13 device
// pointers (ops/fused_mlp.py::pack_params: weights (N, K) row-major,
// biases (N,)); dtype 0 = bf16, 1 = f32; E = the encoding block's padded
// width (enc_rows there), a multiple of 8, and of 16 for bf16.
extern "C" int animnerf_fused_mlp_fwd(const void* xyz, const void* w_ptrs,
                                      const void* b_ptrs, void* out, int M,
                                      int n_freqs, int E, int dtype,
                                      void* stream) {
  MlpWeights p;
  for (int i = 0; i < N_W; ++i) {
    p.w[i] = ((const void* const*)w_ptrs)[i];
    p.b[i] = ((const float* const*)b_ptrs)[i];
  }
  if (M <= 0) return (int)cudaGetLastError();
  if (dtype == 0) {
    if (E % 16 != 0) return (int)cudaErrorInvalidValue;
    const size_t bytes = (size_t)2 * T * LDH * sizeof(bf16) +
                         (size_t)T * (E + 8) * sizeof(bf16) +
                         (size_t)WARPS * 256 * sizeof(float);
    cudaFuncSetAttribute(fused_mlp_bf16_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
    fused_mlp_bf16_kernel<<<(M + T - 1) / T, THREADS, bytes,
                            (cudaStream_t)stream>>>(
        (const float*)xyz, p, (float*)out, M, n_freqs, E);
  } else {
    if (E % 4 != 0) return (int)cudaErrorInvalidValue;
    const size_t bytes = (size_t)(E + 2 * WIDTH) * TF * sizeof(float);
    cudaFuncSetAttribute(fused_mlp_f32_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
    fused_mlp_f32_kernel<<<(M + TF - 1) / TF, WIDTH, bytes,
                           (cudaStream_t)stream>>>(
        (const float*)xyz, p, (float*)out, M, n_freqs, E);
  }
  return (int)cudaGetLastError();
}
