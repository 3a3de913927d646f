// The fused NeRF MLP in float32 on Hopper's CUDA cores: kernel 3's f32
// forward and kernel 6's f32 backward (its main kernel and its weight-
// gradient pass), on the register-tiled layer routine of mlp_f32_tile.cuh.
//
// Replaces, in float32: animnerf_tpu/ops/fused_mlp.py::_fwd_kernel
// (through fused_nerf_fwd) and ::_bwd_kernel (through fused_nerf_bwd). In
// f32 nothing rounds: the plain versions are ops/fused_mlp.py's
// fused_nerf_fwd_plain and fused_nerf_bwd_plain with dtype float32.
//
// Bound on the H100: operations, FFMA over the f32 peak (67 TFLOP/s, no
// TF32: float32 keeps its 24-bit products). The forward is 1,179,904 flops
// a point at 10 frequencies (1.154 ms per 2^16 points); the backward 3x
// that (recomputed forward, dgrad, weight gradients). The weights (2.4 MB
// a direction in f32) stream past each block's 64 points from L2; the
// block keeps every activation of its points on chip.
//
// Forward (mlp_fwd_f32<EC>): the encoding into an EC x 64 block (EC =
// enc_cols: 64, 128 or 192, zero from 3 + 6 n_freqs), then 8 trunk layers,
// xyz_final and dir_0 as tile products between two 256 x 64 activation
// buffers (the skip layer's enc half into the same accumulators after its
// h half), bias and ReLU applied in registers; the sigma head (4 threads
// a point, partial sums combined in a fixed order) and the rgb head on
// the CUDA cores. Shared memory: 2 x 64 KB activations + EC x 256 B
// encoding + 1 KB head partials + the ring: 214,016 B at EC 64 (4
// stages), 230,400 B at 128 (4) and at 192 (3).
//
// Backward main kernel (mlp_bwd_main_f32<EC>, EC 64 or 128): the same
// encoding and forward (each layer's output also to the point-major H
// scratch from registers, its ReLU bits kept in shared memory, 64 bits a
// thread and layer), the heads' cotangents, d_hd on the CUDA cores (K =
// 3), then the dgrad chain as tile products over W_l slabs (the masks and
// d_sigma's W9 term applied in registers, each cotangent to the G
// scratch), d_enc = W8^T d_4 + W0^T d_0 in the spent encoding block and
// the encoding's chain rule. Shared memory: 2 x 64 KB + EC x 256 B + 18 KB
// masks + 1 KB heads + the ring: 232,448 B at EC 64 (4 stages) and at 128
// (3 stages), every byte a block may have.
//
// Weight gradients (mlp_wgrad_f32): dW_l = G_l^T H_l over each split's
// points, an SGEMM tile a block: 128 x 128 outputs (128 x 64 on a
// 64-column encoding), 8 x 8 a thread from float4 fragments, the points
// staged 16 at a time by cp.async into two buffers. The tiles at k0 = 0
// also sum their G rows (the bias gradients); three small tiles take the
// heads (dW9 = d_sigma^T h7, dW12 = d_rgb^T hd, their bias sums). Every
// (tile, split) block adds into its own split's partial, which only it
// writes; reduce_splits sums the splits in a fixed order. No atomics: two
// runs agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "mlp_bwd_layout.cuh"
#include "mlp_f32_tile.cuh"

namespace {

using namespace mlpf;
using mlpb::DIR_W;
using mlpb::HEAD_COLS;
using mlpb::SPLITS;
using mlpb::WIDTH;

constexpr int DEPTH = 8;
constexpr int SKIP = 4;

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// The positional encoding of the block's points into an (EC x 64)
// feature-major block: rows x, y, z, then sin(2^j x..z), cos(2^j x..z)
// for j < n_freqs, zero from 3 + 6 n_freqs. xyz: the block's first point
// of (8, ld) rows; points from `live` on read as 0. sinf / cosf, not
// __sinf: at 2^9 the arguments reach hundreds of radians.
__device__ __forceinline__ void encode_f32(float* enc, int EC,
                                           const float* __restrict__ xyz,
                                           size_t ld, int live,
                                           int n_freqs) {
  const int p = threadIdx.x & (P - 1);
  const int q = threadIdx.x >> 6;  // 4 threads a point
  float c3[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) c3[c] = p < live ? xyz[c * ld + p] : 0.0f;
  if (q == 0)
#pragma unroll
    for (int c = 0; c < 3; ++c) enc[c * P + p] = c3[c];
  for (int j = q; j < n_freqs; j += 4) {
    const float f = (float)(1 << j);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float a = f * c3[c];
      enc[(3 + 6 * j + c) * P + p] = sinf(a);
      enc[(3 + 6 * j + 3 + c) * P + p] = cosf(a);
    }
  }
  for (int e = 3 + 6 * n_freqs + q; e < EC; e += 4) enc[e * P + p] = 0.0f;
}

// bias (+ ReLU) in registers: v = acc + b[col] (max(v, 0))
template <int N, bool RELU>
__device__ __forceinline__ void bias_act(float (&acc)[N / 32][8],
                                         const float* __restrict__ b) {
#pragma unroll
  for (int i = 0; i < N / 32; ++i) {
    const float bn = __ldg(b + tile_col<N>(i));
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float v = acc[i][j] + bn;
      acc[i][j] = RELU ? fmaxf(v, 0.0f) : v;
    }
  }
}

// the forward's products, in the order both kernels consume them: layer 0
// (enc), 1-3, 4 (h half, then the enc half W8), 5-7, xyz_final, dir_0
template <int EC>
__device__ __forceinline__ int fwd_schedule(Product* sched,
                                            const MlpF32Params& p) {
  int n = 0;
  sched[n++] = {p.image + p.fwd[0], EC / KS, WIDTH};
  for (int i = 1; i < DEPTH; ++i) {
    sched[n++] = {p.image + p.fwd[i], WIDTH / KS, WIDTH};
    if (i == SKIP) sched[n++] = {p.image + p.fwd[8], EC / KS, WIDTH};
  }
  sched[n++] = {p.image + p.fwd[10], WIDTH / KS, WIDTH};
  sched[n++] = {p.image + p.fwd[11], WIDTH / KS, DIR_W};
  return n;
}

// The recomputed forward: layers 0-7, then xyz_final (no ReLU), with a
// hook after each layer's bias and activation (layer index 0-8, its tile).
// Returns the buffer holding h7 (the other holds hf).
template <int EC, int STAGES, class Hook>
__device__ __forceinline__ float* trunk(Stream<STAGES>& st, const float* enc,
                                        float* bufA, float* bufB,
                                        const MlpF32Params& p,
                                        float (&acc)[8][8],
                                        const Hook& hook) {
  tile_zero<WIDTH>(acc);
  tile_product<WIDTH>(acc, st, enc, EC / KS);
  bias_act<WIDTH, true>(acc, p.b[0]);
  store_act<WIDTH>(bufA, acc);
  hook(0, acc);
  float* hin = bufA;
  float* hout = bufB;
  for (int i = 1; i < DEPTH; ++i) {
    tile_zero<WIDTH>(acc);
    tile_product<WIDTH>(acc, st, hin, WIDTH / KS);
    if (i == SKIP) tile_product<WIDTH>(acc, st, enc, EC / KS);
    bias_act<WIDTH, true>(acc, p.b[i]);
    store_act<WIDTH>(hout, acc);
    hook(i, acc);
    float* t = hin;
    hin = hout;
    hout = t;
  }
  // hin = h7; xyz_final -> hf in hout (the products read h7 up to the
  // barriers of dir_0's first slab)
  tile_zero<WIDTH>(acc);
  tile_product<WIDTH>(acc, st, hin, WIDTH / KS);
  bias_act<WIDTH, false>(acc, p.b[10]);
  store_act<WIDTH>(hout, acc);
  hook(DEPTH, acc);
  return hin;
}

// ------------------------------------------------------------- forward

template <int EC>
struct FwdSmem {
  static constexpr int OFF_A = 0;                   // 256 x 64 f32
  static constexpr int OFF_B = ACT_BYTES;           // 256 x 64 f32
  static constexpr int OFF_ENC = 2 * ACT_BYTES;     // EC x 64 f32
  static constexpr int OFF_RED = OFF_ENC + EC * P * 4;  // 4 x 64 f32
  static constexpr int OFF_RING = OFF_RED + 4 * P * 4;
  static constexpr int STAGES = stages_after(OFF_RING);
  static constexpr int BYTES = OFF_RING + STAGES * SLAB_BYTES;
  static_assert(STAGES >= 3 && BYTES <= SMEM_MAX, "shared memory");
};
static_assert(FwdSmem<64>::BYTES == 214016 && FwdSmem<64>::STAGES == 4,
              "forward at EC 64: 214,016 B, 4 stages");
static_assert(FwdSmem<128>::BYTES == 230400 && FwdSmem<128>::STAGES == 4,
              "forward at EC 128: 230,400 B, 4 stages");
static_assert(FwdSmem<192>::BYTES == 230400 && FwdSmem<192>::STAGES == 3,
              "forward at EC 192: 230,400 B, 3 stages");

template <int EC>
__global__ void __launch_bounds__(THREADS, 1)
mlp_fwd_f32(const float* __restrict__ xyz,  // (8, M) rows
            const __grid_constant__ MlpF32Params p,
            float* __restrict__ out,  // (8, M) rows
            int M, int n_freqs) {
  using S = FwdSmem<EC>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* bufA = (float*)(smem + S::OFF_A);
  float* bufB = (float*)(smem + S::OFF_B);
  float* enc = (float*)(smem + S::OFF_ENC);
  float* red = (float*)(smem + S::OFF_RED);
  const int tid = threadIdx.x;
  const int mb = blockIdx.x * P;

  Product sched[12];
  const int n = fwd_schedule<EC>(sched, p);
  Stream<S::STAGES> st{(float*)(smem + S::OFF_RING), sched, n, 0, 0, 0, 0};
  stream_start(st);

  encode_f32(enc, EC, xyz + mb, (size_t)M, min(P, M - mb), n_freqs);

  float acc[8][8];
  float* h7 = trunk<EC>(st, enc, bufA, bufB, p, acc,
                        [](int, const float(&)[8][8]) {});
  float* hf = h7 == bufA ? bufB : bufA;
  // sigma head partials over h7 (complete since xyz_final's first
  // barrier; read before dir_0's first barrier lets hd overwrite it)
  {
    const int pp = tid & (P - 1);
    const int q = tid >> 6;
    float s = 0.0f;
    for (int k = q * 64; k < q * 64 + 64; ++k)
      s = fmaf(h7[k * P + pp], __ldg(p.w9 + k), s);
    red[q * P + pp] = s;
  }
  // dir_0 + ReLU -> hd (128 rows) in h7's buffer
  float a4[4][8];
  tile_zero<DIR_W>(a4);
  tile_product<DIR_W>(a4, st, hf, WIDTH / KS);
  bias_act<DIR_W, true>(a4, p.b[11]);
  store_act<DIR_W>(h7, a4);
  __syncthreads();  // hd and the sigma partials complete

  const int pp = tid & (P - 1);
  const int m = mb + pp;
  if (m >= M) return;
  if (tid < 3 * P) {  // rgb head: sigmoid(acc + b), thread (c, point)
    const int c = tid >> 6;
    float v = 0.0f;
    for (int k = 0; k < DIR_W; ++k)
      v = fmaf(h7[k * P + pp], __ldg(p.w12 + c * DIR_W + k), v);
    out[(size_t)c * M + m] = sigmoidf(v + __ldg(p.b[12] + c));
  } else {
    out[3 * (size_t)M + m] = ((red[pp] + red[P + pp]) + red[2 * P + pp]) +
                             red[3 * P + pp] + __ldg(p.b[9]);
    for (int r = 4; r < 8; ++r) out[(size_t)r * M + m] = 0.0f;
  }
}

// ------------------------------------------------------ backward, main

template <int EC>
struct BwdSmem {
  static constexpr int OFF_A = 0;                   // 256 x 64 f32
  static constexpr int OFF_B = ACT_BYTES;           // 256 x 64 f32
  // EC x 64 f32: the encoding; after the forward, d_enc
  static constexpr int OFF_ENC = 2 * ACT_BYTES;
  // ReLU bits: h0..h7 and hd, 8 B a thread and layer
  static constexpr int OFF_MASK = OFF_ENC + EC * P * 4;
  static constexpr int OFF_HEAD = OFF_MASK + 9 * THREADS * 8;  // 64 x 4 f32
  static constexpr int OFF_RING = OFF_HEAD + P * HEAD_COLS * 4;
  static constexpr int STAGES = stages_after(OFF_RING);
  static constexpr int BYTES = OFF_RING + STAGES * SLAB_BYTES;
  static_assert(STAGES >= 3 && BYTES <= SMEM_MAX, "shared memory");
};
static_assert(BwdSmem<64>::BYTES == 232448 && BwdSmem<64>::STAGES == 4,
              "backward at EC 64: 232,448 B, 4 stages");
static_assert(BwdSmem<128>::BYTES == 232448 && BwdSmem<128>::STAGES == 3,
              "backward at EC 128: 232,448 B, 3 stages");

template <int EC>
__global__ void __launch_bounds__(THREADS, 1)
mlp_bwd_main_f32(const float* __restrict__ xyz,   // (8, M) rows
                 const float* __restrict__ dout,  // (8, M) rows
                 float* __restrict__ dxyz,        // (8, M) rows
                 const __grid_constant__ MlpF32Params p,
                 float* __restrict__ hs,
                 float* __restrict__ gs, float* __restrict__ heads, int M,
                 int m_start, int Mc, int chunk, int n_freqs) {
  using S = BwdSmem<EC>;
  using mlpb::g_col;
  using mlpb::h_col;
  extern __shared__ __align__(16) unsigned char smem[];
  float* bufA = (float*)(smem + S::OFF_A);
  float* bufB = (float*)(smem + S::OFF_B);
  float* enc = (float*)(smem + S::OFF_ENC);  // later d_enc
  uint64_t* masks = (uint64_t*)(smem + S::OFF_MASK);
  float* hsm = (float*)(smem + S::OFF_HEAD);  // (64, 4): d_rgb_raw, d_sigma
  const int tid = threadIdx.x;
  const int mb = blockIdx.x * P;  // the block's first point in the chunk
  const int live = min(P, Mc - mb);
  // the block's first row of scratch array H(h) / G(g) (point-major)
  auto H = [&](int h) {
    return hs + (size_t)h_col<EC>(h) * chunk +
           (size_t)mb * mlpb::h_width<EC>(h);
  };
  auto G = [&](int g) {
    return gs + (size_t)g_col(g) * chunk + (size_t)mb * mlpb::g_width(g);
  };

  // the forward's products, then the dgrad's: W11 (d_hf), W10 (d_7), W7..W1
  // with W8 (d_enc's skip half) before W4, and W0 (d_enc)
  Product sched[24];
  int n = fwd_schedule<EC>(sched, p);
  auto B = [&](int l) { return p.image + p.bwd[l]; };
  sched[n++] = {B(11), DIR_W / KS, WIDTH};
  sched[n++] = {B(10), WIDTH / KS, WIDTH};
  for (int i = DEPTH - 1; i >= 1; --i) {
    if (i == SKIP) sched[n++] = {B(8), WIDTH / KS, EC};
    sched[n++] = {B(i), WIDTH / KS, WIDTH};
  }
  sched[n++] = {B(0), WIDTH / KS, EC};
  Stream<S::STAGES> st{(float*)(smem + S::OFF_RING), sched, n, 0, 0, 0, 0};
  stream_start(st);

  encode_f32(enc, EC, xyz + m_start + mb, (size_t)M, live, n_freqs);
  __syncthreads();
  {  // H(0): the encoding, point-major
    float* h0 = H(0);
    for (int i = tid; i < P * EC / 4; i += THREADS) {
      const int pp = i / (EC / 4);
      const int e = (i % (EC / 4)) * 4;
      __stcs((float4*)(h0 + (size_t)pp * EC + e),
             make_float4(enc[e * P + pp], enc[(e + 1) * P + pp],
                         enc[(e + 2) * P + pp], enc[(e + 3) * P + pp]));
    }
  }

  // ---- recomputed forward: layer i's output to H(i + 1) (xyz_final's,
  // hf, to H(9)), the trunk's ReLU bits to masks[i]
  float acc[8][8];
  float* h7 = trunk<EC>(st, enc, bufA, bufB, p, acc,
                        [&](int i, const float(&v)[8][8]) {
                          store_rows<WIDTH>(H(i + 1), v);
                          if (i < DEPTH) masks[i * THREADS + tid] =
                              tile_mask<WIDTH>(v);
                        });
  float* X = h7;                       // h7, then hd, then d_hf
  float* Y = h7 == bufA ? bufB : bufA;  // hf, then d_hd
  {  // dir_0 + ReLU -> hd in X, to H(10), its bits to masks[8]
    float a4[4][8];
    tile_zero<DIR_W>(a4);
    tile_product<DIR_W>(a4, st, Y, WIDTH / KS);
    bias_act<DIR_W, true>(a4, p.b[11]);
    store_act<DIR_W>(X, a4);
    store_rows<DIR_W>(H(10), a4);
    masks[DEPTH * THREADS + tid] = tile_mask<DIR_W>(a4);
  }
  __syncthreads();  // hd complete

  // ---- heads: d_rgb_raw = dout[c] s (1 - s), s = sigmoid(W12 hd + b12);
  // d_sigma = dout[3]; thread (c, point)
  {
    const int pp = tid & (P - 1);
    const int c = tid >> 6;
    const float d = pp < live
                        ? dout[(size_t)c * M + m_start + mb + pp]
                        : 0.0f;
    if (c < 3) {
      float v = 0.0f;
      for (int k = 0; k < DIR_W; ++k)
        v = fmaf(X[k * P + pp], __ldg(p.w12 + c * DIR_W + k), v);
      const float s = sigmoidf(v + __ldg(p.b[12] + c));
      hsm[pp * HEAD_COLS + c] = d * s * (1.0f - s);
    } else {
      hsm[pp * HEAD_COLS + 3] = d;
    }
  }
  __syncthreads();
  heads[(size_t)mb * HEAD_COLS + tid] = hsm[tid];  // 64 x 4 = 256 values

  // ---- d_hd = mask(hd) W12^T d_rgb_raw (K = 3) -> Y, G(9)
  {
    const uint64_t m = masks[DEPTH * THREADS + tid];
    float a4[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = tile_col<DIR_W>(i);
      float w[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) w[c] = __ldg(p.w12 + c * DIR_W + col);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float* hr = hsm + tile_pt(j) * HEAD_COLS;
        float v = 0.0f;
#pragma unroll
        for (int c = 0; c < 3; ++c) v = fmaf(w[c], hr[c], v);
        a4[i][j] = (m >> (8 * i + j)) & 1 ? v : 0.0f;
      }
    }
    store_act<DIR_W>(Y, a4);
    store_rows<DIR_W>(G(9), a4);
  }
  // ---- d_hf = W11^T d_hd -> X (hd is spent), G(8)
  tile_zero<WIDTH>(acc);
  tile_product<WIDTH>(acc, st, Y, DIR_W / KS);
  store_act<WIDTH>(X, acc);
  store_rows<WIDTH>(G(8), acc);
  // ---- d_7 = mask(h7) (W10^T d_hf + W9^T d_sigma) -> Y, G(7)
  tile_zero<WIDTH>(acc);
  tile_product<WIDTH>(acc, st, X, WIDTH / KS);
  {
    const uint64_t m = masks[(DEPTH - 1) * THREADS + tid];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float w9 = __ldg(p.w9 + tile_col<WIDTH>(i));
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float v = acc[i][j] + w9 * hsm[tile_pt(j) * HEAD_COLS + 3];
        acc[i][j] = (m >> (8 * i + j)) & 1 ? v : 0.0f;
      }
    }
  }
  store_act<WIDTH>(Y, acc);
  store_rows<WIDTH>(G(DEPTH - 1), acc);

  // ---- d_{i-1} = mask(h_{i-1}) W_i^T d_i, i = 7..1; at the skip layer
  // first W8^T d_4 (d_enc's skip half) into the spent encoding block
  float* cur = Y;
  float* nxt = X;
  for (int i = DEPTH - 1; i >= 1; --i) {
    if (i == SKIP) {
      float ae[EC / 32][8];
      tile_zero<EC>(ae);
      tile_product<EC>(ae, st, cur, WIDTH / KS);
      store_act<EC>(enc, ae);
    }
    tile_zero<WIDTH>(acc);
    tile_product<WIDTH>(acc, st, cur, WIDTH / KS);
    const uint64_t m = masks[(i - 1) * THREADS + tid];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (!((m >> (8 * a + j)) & 1)) acc[a][j] = 0.0f;
    store_act<WIDTH>(nxt, acc);
    store_rows<WIDTH>(G(i - 1), acc);
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  {  // d_enc = W8^T d_4 + W0^T d_0: the thread's own tile of the skip half
    float ae[EC / 32][8];
    tile_zero<EC>(ae);
    tile_product<EC>(ae, st, cur, WIDTH / KS);
    const int tp = tid & 7;
#pragma unroll
    for (int i = 0; i < EC / 32; ++i) {
      const float* row = enc + tile_col<EC>(i) * P + tp * 4;
#pragma unroll
      for (int j = 0; j < 8; ++j) ae[i][j] = row[(j >> 2) * 32 + (j & 3)] +
                                             ae[i][j];
    }
    store_act<EC>(enc, ae);
  }
  __syncthreads();

  // ---- the encoding's chain rule, thread (coordinate, point)
  const int pp = tid & (P - 1);
  if (pp >= live) return;
  const size_t gm = (size_t)m_start + mb + pp;
  const int c = tid >> 6;
  if (c < 3) {
    const float x = xyz[(size_t)c * M + gm];
    float d = enc[c * P + pp];
    for (int j = 0; j < n_freqs; ++j) {
      const float f = (float)(1 << j);
      const float a = f * x;
      d = d + f * (cosf(a) * enc[(3 + 6 * j + c) * P + pp] -
                   sinf(a) * enc[(3 + 6 * j + 3 + c) * P + pp]);
    }
    dxyz[(size_t)c * M + gm] = d;
  } else {
    for (int r = 3; r < 8; ++r) dxyz[(size_t)r * M + gm] = 0.0f;
  }
}

// ------------------------------------------------ backward, weights

constexpr int WG_PS = 16;    // points of a staged slab
constexpr int WG_TN = 128;   // output rows of a tile
constexpr int MAX_TILES = 48;

// One output tile of the weight gradients: G array columns [n0, n0 +
// 128) against H array columns [k0, k0 + kw); g < 0: a heads tile (G =
// the head cotangents, h 8 (h7: dW9) or 10 (hd: dW12)).
struct WTile {
  int g, h;          // scratch arrays
  int g_base, gw;    // G's first column (in units of chunk) and width
  int h_base, hw;    // H's first column and width
  int n0, k0, kw;    // the tile
  int ldo;           // columns of dW (its row stride)
  int w_off;         // dW's offset in the flat gradient
  int b_off;         // db's offset of row n0, or -1 (no bias sums here)
};
struct WTiles {
  WTile t[MAX_TILES];
  int b9, b12;  // the heads' bias offsets
};

template <int KW>
__device__ __forceinline__ void wgrad_tile(
    const WTile& tl, const float* __restrict__ G, const float* __restrict__ H,
    int r0, int nsl, float (*sg)[WG_PS][WG_TN], float (*sh)[WG_PS][WG_TN],
    float* __restrict__ out, float* __restrict__ bias_out) {
  const int tid = threadIdx.x;
  const int tn = tid >> 4;  // rows tn * 4 + {0..3}, 64 + tn * 4 + {0..3}
  const int tk = tid & 15;  // columns tk * 4 + {0..3} (+ 64 at KW 128)
  constexpr int KC = KW / 64;
  float acc[8][4 * KC];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4 * KC; ++j) acc[i][j] = 0.0f;
  float bsum = 0.0f;
  auto load = [&](int sl, int buf) {
    const size_t r = (size_t)r0 + sl * WG_PS;
    for (int c = tid; c < WG_PS * WG_TN / 4; c += THREADS) {
      const int pp = c / (WG_TN / 4);
      const int q = (c % (WG_TN / 4)) * 4;
      cp16(&sg[buf][pp][q], G + (r + pp) * tl.gw + tl.n0 + q);
    }
    for (int c = tid; c < WG_PS * KW / 4; c += THREADS) {
      const int pp = c / (KW / 4);
      const int q = (c % (KW / 4)) * 4;
      cp16(&sh[buf][pp][q], H + (r + pp) * tl.hw + tl.k0 + q);
    }
  };
  load(0, 0);
  cp_commit();
#pragma unroll 1
  for (int sl = 0; sl < nsl; ++sl) {
    if (sl + 1 < nsl) load(sl + 1, (sl + 1) & 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const int b = sl & 1;
#pragma unroll
    for (int pp = 0; pp < WG_PS; ++pp) {
      const float4 g0 = *(const float4*)&sg[b][pp][tn * 4];
      const float4 g1 = *(const float4*)&sg[b][pp][64 + tn * 4];
      const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
      float hv[4 * KC];
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        const float4 h = *(const float4*)&sh[b][pp][c * 64 + tk * 4];
        hv[4 * c + 0] = h.x;
        hv[4 * c + 1] = h.y;
        hv[4 * c + 2] = h.z;
        hv[4 * c + 3] = h.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4 * KC; ++j)
          acc[i][j] = fmaf(gv[i], hv[j], acc[i][j]);
    }
    if (bias_out != nullptr && tid < WG_TN)
#pragma unroll
      for (int pp = 0; pp < WG_PS; ++pp) bsum += sg[b][pp][tid];
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int nr = tl.n0 + (i >> 2) * 64 + tn * 4 + (i & 3);
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      const int k = tl.k0 + c * 64 + tk * 4;
      if (k < tl.ldo) {
        float4* o = (float4*)(out + (size_t)nr * tl.ldo + k);
        float4 v = *o;
        v.x += acc[i][4 * c + 0];
        v.y += acc[i][4 * c + 1];
        v.z += acc[i][4 * c + 2];
        v.w += acc[i][4 * c + 3];
        *o = v;
      }
    }
  }
  if (bias_out != nullptr && tid < WG_TN) bias_out[tid] += bsum;
}

// the heads' weight gradients over H columns [k0, k0 + 128), thread k <
// 128 one column: h8 (h7) -> dW9[0][k0 + k] = sum d_sigma h7; h10 (hd) ->
// dW12[c][k] = sum d_rgb_raw[c] hd; with `sums`, threads 128..131 the
// head bias sums (d_rgb_raw 0..2 -> b12, d_sigma -> b9)
__device__ __forceinline__ void heads_tile(
    const WTile& tl, const float* __restrict__ hc, const float* __restrict__ H,
    int r0, int nsl, float (*sg)[WG_PS][WG_TN], float (*sh)[WG_PS][WG_TN],
    float* __restrict__ part, int b9, int b12) {
  const int tid = threadIdx.x;
  const bool sums = tl.b_off >= 0;
  float a[3] = {0.0f, 0.0f, 0.0f};
  auto load = [&](int sl, int buf) {
    const size_t r = (size_t)r0 + sl * WG_PS;
    if (tid < WG_PS) cp16(&sg[buf][tid][0], hc + (r + tid) * HEAD_COLS);
    for (int c = tid; c < WG_PS * WG_TN / 4; c += THREADS) {
      const int pp = c / (WG_TN / 4);
      const int q = (c % (WG_TN / 4)) * 4;
      cp16(&sh[buf][pp][q], H + (r + pp) * tl.hw + tl.k0 + q);
    }
  };
  load(0, 0);
  cp_commit();
#pragma unroll 1
  for (int sl = 0; sl < nsl; ++sl) {
    if (sl + 1 < nsl) load(sl + 1, (sl + 1) & 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const int b = sl & 1;
    if (tid < WG_TN) {
      if (tl.h == 8) {
#pragma unroll
        for (int pp = 0; pp < WG_PS; ++pp)
          a[0] = fmaf(sg[b][pp][3], sh[b][pp][tid], a[0]);
      } else {
#pragma unroll
        for (int pp = 0; pp < WG_PS; ++pp)
#pragma unroll
          for (int c = 0; c < 3; ++c)
            a[c] = fmaf(sg[b][pp][c], sh[b][pp][tid], a[c]);
      }
    } else if (sums && tid < WG_TN + HEAD_COLS) {
#pragma unroll
      for (int pp = 0; pp < WG_PS; ++pp) a[0] += sg[b][pp][tid - WG_TN];
    }
    __syncthreads();
  }
  if (tid < WG_TN) {
    if (tl.h == 8) {
      part[tl.w_off + tl.k0 + tid] += a[0];
    } else {
      for (int c = 0; c < 3; ++c) part[tl.w_off + c * DIR_W + tid] += a[c];
    }
  } else if (sums && tid < WG_TN + HEAD_COLS) {
    const int c = tid - WG_TN;
    part[c < 3 ? b12 + c : b9] += a[0];
  }
}

// grid (tiles, SPLITS): block (t, s) adds tile t over split s's points
// [s rps, min(rows, s rps + rps)) into split s's partial
__global__ void __launch_bounds__(THREADS, 2)
mlp_wgrad_f32(const float* __restrict__ hs, const float* __restrict__ gs,
              const float* __restrict__ hc, int chunk, int rows, int rps,
              float* __restrict__ part, int total,
              const __grid_constant__ WTiles tiles) {
  __shared__ __align__(16) float sg[2][WG_PS][WG_TN];
  __shared__ __align__(16) float sh[2][WG_PS][WG_TN];
  const WTile& tl = tiles.t[blockIdx.x];
  const int s = blockIdx.y;
  const int r0 = s * rps;
  const int r1 = min(rows, r0 + rps);
  if (r0 >= r1) return;
  const int nsl = (r1 - r0) / WG_PS;
  float* mine = part + (size_t)s * total;
  const float* H = hs + (size_t)tl.h_base * chunk;
  if (tl.g < 0) {
    heads_tile(tl, hc, H, r0, nsl, sg, sh, mine, tiles.b9, tiles.b12);
    return;
  }
  const float* G = gs + (size_t)tl.g_base * chunk;
  float* bias_out = tl.b_off >= 0 ? mine + tl.b_off : nullptr;
  if (tl.kw == 128)
    wgrad_tile<128>(tl, G, H, r0, nsl, sg, sh, mine + tl.w_off, bias_out);
  else
    wgrad_tile<64>(tl, G, H, r0, nsl, sg, sh, mine + tl.w_off, bias_out);
}

// the tiles of every weight gradient at encoding block EC (er encoding
// rows in dW_0, dW_8), the bias sums on the k0 = 0 tiles of the layers
// whose bias a G array sums (all but 8), then the three heads tiles
template <int EC>
int wgrad_tiles(int er, WTiles* out) {
  using namespace mlpb;
  const GradLayout L = grad_layout(er);
  // (layer, G array, H array), as ops/fused_mlp.py::WGRAD_LAYERS
  constexpr int LAYERS[11][3] = {{0, 0, 0}, {1, 1, 1}, {2, 2, 2},
                                 {3, 3, 3}, {4, 4, 4}, {5, 5, 5},
                                 {6, 6, 6}, {7, 7, 7}, {8, 4, 0},
                                 {10, 8, 8}, {11, 9, 9}};
  int n = 0;
  for (const auto& lgh : LAYERS) {
    const int l = lgh[0], g = lgh[1], h = lgh[2];
    const int N = L.wr[l];
    const int K = h_width<EC>(h);
    for (int n0 = 0; n0 < N; n0 += WG_TN)
      for (int k0 = 0; k0 < K; k0 += 128) {
        if (n == MAX_TILES) return -1;
        const int kw = K - k0 < 128 ? K - k0 : 128;
        out->t[n++] = WTile{g, h, g_col(g), g_width(g), h_col<EC>(h),
                            h_width<EC>(h), n0, k0, kw, L.wc[l],
                            (int)L.w[l],
                            k0 == 0 && l != 8 ? (int)L.b[l] + n0 : -1};
      }
  }
  for (int k0 = 0; k0 < WIDTH; k0 += 128)  // dW9 over h7 (+ head sums)
    out->t[n++] = WTile{-1, 8, 0, 0, h_col<EC>(8), WIDTH, 0, k0, 128,
                        WIDTH, (int)L.w[9], k0 == 0 ? 0 : -1};
  out->t[n++] = WTile{-1, 10, 0, 0, h_col<EC>(10), DIR_W, 0, 0, 128, DIR_W,
                      (int)L.w[12], -1};  // dW12 over hd
  out->b9 = (int)L.b[9];
  out->b12 = (int)L.b[12];
  return n;
}

template <int EC>
int backward(const float* xyz, const float* dout, const MlpF32Params& p,
             float* dxyz, float* grads, float* scratch, float* heads,
             float* partials, int M, int chunk, int n_freqs, int er,
             cudaStream_t st) {
  const mlpb::GradLayout L = mlpb::grad_layout(er);
  WTiles tiles;
  const int n_tiles = wgrad_tiles<EC>(er, &tiles);
  if (n_tiles < 0) return (int)cudaErrorInvalidValue;
  if (cudaMemsetAsync(partials, 0, sizeof(float) * SPLITS * L.total, st) !=
      cudaSuccess)
    return (int)cudaGetLastError();
  using S = BwdSmem<EC>;
  cudaError_t err = cudaFuncSetAttribute(
      mlp_bwd_main_f32<EC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::BYTES);
  if (err != cudaSuccess) return (int)err;
  float* hs = scratch;
  float* gs = hs + (size_t)mlpb::HW<EC> * chunk;
  for (int m_start = 0; m_start < M; m_start += chunk) {
    const int Mc = min(chunk, M - m_start);
    const int rows = (Mc + P - 1) / P * P;
    mlp_bwd_main_f32<EC><<<rows / P, THREADS, S::BYTES, st>>>(
        xyz, dout, dxyz, p, hs, gs, heads, M, m_start, Mc, chunk, n_freqs);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int rps = ((rows + SPLITS - 1) / SPLITS + P - 1) / P * P;
    mlp_wgrad_f32<<<dim3(n_tiles, SPLITS), THREADS, 0, st>>>(
        hs, gs, heads, chunk, rows, rps, partials, (int)L.total, tiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  mlpb::reduce_splits<<<(unsigned)((L.total + 255) / 256), 256, 0, st>>>(
      partials, L.total, grads);
  return (int)cudaGetLastError();
}

// the parts the kernels stream (ops/fused_mlp.py::IMAGE_PARTS): present
// and 16-byte aligned for the cp.async copies
bool parts_ok(const int* offs) {
  for (int l : {0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 11})
    if (offs[l] < 0 || offs[l] % 4 != 0) return false;
  return true;
}

template <int EC>
int forward(const float* xyz, const MlpF32Params& p, float* out, int M,
            int n_freqs, cudaStream_t st) {
  using S = FwdSmem<EC>;
  const cudaError_t err = cudaFuncSetAttribute(
      mlp_fwd_f32<EC>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
  if (err != cudaSuccess) return (int)err;
  mlp_fwd_f32<EC><<<(M + P - 1) / P, THREADS, S::BYTES, st>>>(xyz, p, out, M,
                                                               n_freqs);
  return (int)cudaGetLastError();
}

}  // namespace

int mlp_f32_forward(const float* xyz, const MlpF32Params& p, float* out,
                    int M, int n_freqs, int EC, cudaStream_t st) {
  // 2^j as an int shift: n_freqs <= 31
  if (n_freqs < 0 || n_freqs > 31 || 3 + 6 * n_freqs > EC ||
      p.image == nullptr || !parts_ok(p.fwd))
    return (int)cudaErrorInvalidValue;
  if (M <= 0) return (int)cudaGetLastError();
  if (EC == 64) return forward<64>(xyz, p, out, M, n_freqs, st);
  if (EC == 128) return forward<128>(xyz, p, out, M, n_freqs, st);
  if (EC == 192) return forward<192>(xyz, p, out, M, n_freqs, st);
  return (int)cudaErrorInvalidValue;
}

int mlp_f32_backward(const float* xyz, const float* dout,
                     const MlpF32Params& p, float* dxyz, float* grads,
                     float* scratch, float* heads, float* partials, int M,
                     int chunk, int n_freqs, int er, cudaStream_t st) {
  if (p.image == nullptr || !parts_ok(p.fwd) || !parts_ok(p.bwd) ||
      chunk % P != 0)
    return (int)cudaErrorInvalidValue;
  if (mlpb::enc_cols_of(er) == 64)
    return backward<64>(xyz, dout, p, dxyz, grads, scratch, heads, partials,
                        M, chunk, n_freqs, er, st);
  return backward<128>(xyz, dout, p, dxyz, grads, scratch, heads, partials,
                       M, chunk, n_freqs, er, st);
}

// Shared memory of the f32 kernels' blocks at encoding block EC: kind 0
// the forward (EC 64, 128, 192), kind 1 the backward's main kernel (EC 64,
// 128); out[0] bytes, out[1] ring stages. ops/fused_mlp.py::f32_smem is
// its host-side restatement, which the CPU tests hold under 232,448 B.
extern "C" int animnerf_mlp_f32_smem(int EC, int kind, void* out) {
  long long* o = (long long*)out;
  if (kind == 0 && EC == 64) {
    o[0] = FwdSmem<64>::BYTES;
    o[1] = FwdSmem<64>::STAGES;
  } else if (kind == 0 && EC == 128) {
    o[0] = FwdSmem<128>::BYTES;
    o[1] = FwdSmem<128>::STAGES;
  } else if (kind == 0 && EC == 192) {
    o[0] = FwdSmem<192>::BYTES;
    o[1] = FwdSmem<192>::STAGES;
  } else if (kind == 1 && EC == 64) {
    o[0] = BwdSmem<64>::BYTES;
    o[1] = BwdSmem<64>::STAGES;
  } else if (kind == 1 && EC == 128) {
    o[0] = BwdSmem<128>::BYTES;
    o[1] = BwdSmem<128>::STAGES;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}
