// Fused positional encoding + canonical NeRF MLP backward, for Hopper.
//
// Replaces: animnerf_tpu/ops/fused_mlp.py::_bwd_kernel (reached through
// fused_nerf_bwd, the custom VJP of the fused forward).
//
// Given xyz rows (8, M) and the output cotangent dout (8, M) rows
// [d_r|d_g|d_b|d_sigma|..], it computes d_xyz rows (8, M) and the f32
// gradients of the 13 packed weights and biases (ops/fused_mlp.py::
// pack_params' layout, (N, K) row-major), with the TPU kernel's rounding
// points in bf16 (ops/fused_mlp.py:247-307 there):
//   d_rgb_raw = dout[0:3] * s * (1 - s)               (f32, s = sigmoid)
//   d_hd  = mask(hd)  bf16(W12^T bf16(d_rgb_raw))
//   d_hf  =           bf16(W11^T d_hd)                 (xyz_final: no ReLU)
//   d_7   = mask(h7)  bf16(W10^T d_hf + W9^T bf16(d_sigma))
//   d_i-1 = mask(h_i-1) bf16(W_i^T d_i),  i = 7..1
//   d_enc = W8^T d_4 (f32) + bf16(W0^T d_0)
//   d_xyz = d_enc[xyz] + sum_j 2^j (cos(2^j x) d_enc[sin] - sin(2^j x) d_enc[cos])
//   dW_l  = sum over points of (its output cotangent) x (its bf16 input)^T,
//   db_l  = sum over points of the output cotangent (f32 for the heads)
// ReLU masks compare the bf16 activation with 0. In f32 nothing rounds.
//
// Bound on the H100: operations, ~3x the forward's 1.19 MFLOP per point
// (recomputed forward, dgrad, wgrad): 3.57 MFLOP per point in bf16 on the
// tensor cores. The main kernel alone (recompute + dgrad): 2.36 MFLOP per
// point, or the 9,856 B of scratch it writes per point, the larger: 3.08
// ms per 2^20 points (bytes).
//
// What does not fit: the TPU kernel keeps all 8 trunk activations of a
// 512-point tile and every dW/db accumulator (2.4 MB in f32) in VMEM
// across a sequential grid. Here 8 x 256 bf16 activations are 4 KB per
// point and a block has 227 KB of shared memory; the dW set fits neither
// a block's shared memory nor its registers, and blocks run in parallel.
// Design, per chunk of up to `chunk` points:
//   1. main kernel (bf16), one block per 128 points: two consumer
//      warpgroups of 64 points each and a producer warp. The producer
//      streams the weights as 16 KB (or 8 KB) slabs with one cp.async.bulk
//      each into a three-stage mbarrier ring (mlp_wgmma.cuh); the wrapper
//      packs them once per call into exactly the slabs' shared-memory
//      byte image (ops/fused_mlp.py::weight_image), W_l for the forward
//      and W_l^T for the dgrad, so both directions read a K-major B
//      operand. The consumers recompute the encoding and the forward, then
//      run the dgrad chain backwards, each product a wgmma (m64n128k16,
//      m64n64k16 for d_enc) from two 128 x 256 bf16 activation buffers in
//      the 128-byte swizzled layout; the epilogues round, add the bias,
//      apply ReLU or the mask in registers (their operands loaded before
//      the products) and write bf16 into the other buffer. The skip
//      layer's enc half accumulates into the same registers; its dgrad
//      W8^T d_4 stays in f32 registers until d_enc = W8^T d_4 +
//      bf16(W0^T d_0) is formed and the encoding chain rule applied. Each
//      layer's input activation and output cotangent (the two bf16
//      operands of its weight gradient, exactly as the TPU kernel rounds
//      them) go to a point-major scratch in device memory (~9.9 KB per
//      point), with 16-byte streaming stores issued under the next layer's
//      first products; the trunk's ReLU bits stay in shared memory (16 KB
//      a warpgroup). Shared memory: 2 x 64 KB activations + 16 KB encoding
//      (later the heads) + 48 KB slab ring + 32 KB ReLU bits (later d_enc).
//      f32 (not on the main path): a SIMT block per 32 points.
//   2. weight gradients, dW_l = G_l^T H_l over the chunk's points: a
//      hand-written split-K wmma kernel (128x128 output tile per block,
//      operands staged in shared memory, 64 point splits); each block
//      adds its tile into its own split's f32
//      partial, which only that block writes. The sigma / rgb heads
//      (N = 1, 3) and the bias sums use a small SIMT kernel each, again
//      one partial per split.
//   3. after the last chunk, one kernel sums the splits' partials in a
//      fixed order.
// No atomics anywhere, and no sum crosses a block in the main kernel: the
// gradients are deterministic, bit for bit from run to run. The
// activations go through device memory once (written by 1, read by 2);
// keeping them on chip would need the dW accumulators spread over a
// cluster's shared memory, left to a later revision, as is wgmma for 2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "mlp_wgmma.cuh"

using namespace nvcuda;

namespace {

constexpr int WIDTH = 256;
constexpr int DIR_W = 128;
constexpr int DEPTH = 8;
constexpr int SKIP = 4;
constexpr int N_W = 13;
constexpr int E = 64;       // encoding block rows: enc_rows(n_freqs <= 10)
constexpr int SPLITS = 64;  // point splits of the weight-gradient sums
constexpr int HEAD_COLS = 4;  // d_rgb_raw[0..2], d_sigma (f32)

typedef __nv_bfloat16 bf16;

struct MlpWeights {
  const void* w[N_W];   // (N, K) row-major, bf16 or f32 (pack_params)
  const float* b[N_W];  // f32 biases (N,)
};

// ------------------------------------------------------- scratch layout
// H (layer inputs): 0 enc (E) | 1..8 h0..h7 (256) | 9 hf (256) | 10 hd (128)
// G (layer output cotangents): 0..7 d0..d7 (256) | 8 d_hf (256) | 9 d_hd (128)
// Each array is a (chunk, width) point-major block of the scratch.
__host__ __device__ __forceinline__ int h_col(int h) {
  return h == 0 ? 0 : E + (h - 1) * WIDTH;
}
__host__ __device__ __forceinline__ int g_width(int g) {
  return g == 9 ? DIR_W : WIDTH;
}
__host__ __device__ __forceinline__ int g_col(int g) { return g * WIDTH; }
constexpr int HW = E + 9 * WIDTH + DIR_W;  // 2496
constexpr int GW = 9 * WIDTH + DIR_W;      // 2432

// flat f32 gradient layout: dW_0..12 then db_0..12, pack_params' shapes
struct GradLayout {
  size_t w[N_W], b[N_W], total;
  int wr[N_W], wc[N_W], br[N_W];
};
__host__ __device__ inline GradLayout grad_layout() {
  GradLayout L;
  for (int i = 0; i < N_W; ++i) {
    L.wr[i] = WIDTH;
    L.wc[i] = WIDTH;
    L.br[i] = WIDTH;
  }
  L.wc[0] = E;
  L.wc[8] = E;
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

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// ================================================================ bf16 path

constexpr int T = mlpw::ROWS;  // points per block
constexpr int WARPS = 8;       // the weight-gradient kernel's block
constexpr int THREADS = WARPS * 32;
constexpr int CONSUMERS = 256;  // two warpgroups of 64 points each
constexpr int MAIN_THREADS = CONSUMERS + 32;  // + the producer warp
constexpr int WG_ROWS = 64;
constexpr int MASK_ROW = WIDTH / 8;  // bytes of one row's ReLU bits

// shared memory of the main kernel (bytes from a 1024-aligned base)
constexpr int OFF_A = 0;                               // 128 x 256 bf16
constexpr int OFF_B = OFF_A + T * WIDTH * 2;           // 128 x 256 bf16
// 128 x 64 bf16 encoding; after the forward, the heads (128 x 4 f32)
constexpr int OFF_ENC = OFF_B + T * WIDTH * 2;
constexpr int OFF_RING = OFF_ENC + T * E * 2;          // the slab ring
constexpr int OFF_MASK = OFF_RING + mlpw::STAGES * mlpw::SLAB_BYTES;
constexpr int MASK_WG = DEPTH * WG_ROWS * MASK_ROW;    // 16 KB a warpgroup
constexpr int OFF_BARS = OFF_MASK + 2 * MASK_WG;
constexpr size_t SMEM_BF16 = OFF_BARS + 2 * mlpw::STAGES * 8 + 1024;
static_assert(WG_ROWS * E * 4 <= MASK_WG, "d_enc reuses a mask region");
static_assert(T * HEAD_COLS * 4 <= T * E * 2, "the heads reuse the encoding");
static_assert(SMEM_BF16 <= 232448, "shared memory of one block");

// element offsets of the weight image's parts (ops/fused_mlp.py::
// weight_image): fwd[l] holds W_l (N x K) for out = in . W_l^T, bwd[l]
// holds W_l^T (K x N) for d_in = d_out . W_l; -1 where absent
struct ImageOffsets {
  int fwd[N_W];
  int bwd[N_W];
};

// two f32 values rounded to bf16 (nearest even) and packed, lo in the
// low half; and the f32 values of a packed pair's halves
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}
__device__ __forceinline__ float lo_f(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_f(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}
// bits 0, 1: the pair's halves > 0 (bf16 bit patterns of values that are
// not NaN: nonzero magnitude, clear sign)
__device__ __forceinline__ uint32_t positive2(uint32_t w) {
  const uint32_t pos = ~w & 0x80008000u;             // sign clear
  const uint32_t nz = (w & 0x7FFF7FFFu) + 0x7FFF7FFFu;  // magnitude != 0
  const uint32_t b = pos & nz;
  return ((b >> 15) & 1u) | ((b >> 30) & 2u);
}

// part `part` of `parts` of a warpgroup's 64 rows of a swizzled (T x
// WIDTH_T) buffer to the point-major scratch rows dst (chunk, WIDTH_T),
// 16 B a store; with `mask`, also the rows' ReLU bits (bit c % 8 of byte
// c / 8: activation > 0; the activations are ReLU outputs, never NaN).
// Spread over the next layer's first slabs, the stores run under its
// products. They are streaming stores (evict-first): the scratch is read
// back only by the weight-gradient kernels, and in L2 it would push out
// the weight slabs that every block re-reads.
template <int WIDTH_T>
__device__ __forceinline__ void copy_out(const unsigned char* buf,
                                         bf16* __restrict__ dst, int mb,
                                         int r0, unsigned char* mask,
                                         int part = 0, int parts = 1) {
  constexpr int CPR = WIDTH_T / 8;
  constexpr int ITERS = WG_ROWS * CPR / 128;
  const int wt = threadIdx.x & 127;
  const int k0 = part * ITERS / parts;
  const int k1 = (part + 1) * ITERS / parts;
#pragma unroll 2
  for (int k = k0; k < k1; ++k) {
    const int i = wt + k * 128;
    const int rl = i / CPR;
    const int ch = i % CPR;
    const uint4 v = *(const uint4*)(buf + mlpw::sw128(r0 + rl, ch * 8, T));
    __stcs((uint4*)(dst + (size_t)(mb + r0 + rl) * WIDTH_T + ch * 8), v);
    if (mask != nullptr)
      mask[rl * MASK_ROW + ch] =
          (unsigned char)(positive2(v.x) | positive2(v.y) << 2 |
                          positive2(v.z) << 4 | positive2(v.w) << 6);
  }
}

// forward layer of N outputs into Y: bf16(bf16(acc) + bf16(b)) [ReLU]
// (hook(part, parts): run under each slab of the first tile, after the
// slab before it is released: work there overlaps the products without
// holding back the slab ring). The epilogue's
// operands are loaded before the products, so their latency hides there.
template <bool RELU, class Hook>
__device__ __forceinline__ void fwd_layer(mlpw::Ring& ring, uint32_t a,
                                          int kb, uint32_t a2, int kb2,
                                          int N, unsigned char* Y,
                                          const float* __restrict__ bias,
                                          int r0, const Hook& hook) {
  for (int nt = 0; nt < N / 128; ++nt) {
    uint32_t bb[16];  // bf16(b) of the thread's column pairs
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const float2 b =
          *(const float2*)(bias + nt * 128 + 8 * q + mlpw::pair_col());
      bb[q] = pack_bf16x2(b.x, b.y);
    }
    float acc[64];
    mlpw::tile_mma<128>(acc, ring, a, kb, a2, kb2, [&](int s) {
      if (nt == 0) hook(s, kb + kb2);
    });
    mlpw::for_each_pair<128>(acc, r0, nt * 128, [&](int row, int c, int q,
                                                    int, float v0, float v1) {
      const uint32_t ab = pack_bf16x2(v0, v1);
      float x0 = lo_f(ab) + lo_f(bb[q]);
      float x1 = hi_f(ab) + hi_f(bb[q]);
      if (RELU) {
        x0 = fmaxf(x0, 0.0f);
        x1 = fmaxf(x1, 0.0f);
      }
      *(uint32_t*)(Y + mlpw::sw128(row, c, T)) = pack_bf16x2(x0, x1);
    });
  }
}

// dgrad layer of 256 outputs into Y: bf16(acc [+ xw[c] * bf16(d_sigma)]
// with SIGMA), zero where the mask bit (the warpgroup's rows) is clear
template <bool SIGMA, class Hook>
__device__ __forceinline__ void dgrad_layer(mlpw::Ring& ring, uint32_t a,
                                            int kb, unsigned char* Y,
                                            const unsigned char* mask,
                                            const bf16* __restrict__ xw,
                                            const float* hsm, int r0,
                                            const Hook& hook) {
  const int rl = mlpw::pair_row();
  float ds[2] = {0.0f, 0.0f};
  if (SIGMA) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      ds[h] = bf16r(hsm[(rl + 8 * h) * HEAD_COLS + 3]);
  }
  for (int nt = 0; nt < WIDTH / 128; ++nt) {
    // the thread's rows' mask bytes of this tile's 128 columns
    uint32_t mw[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mw[h][j] = mask == nullptr
                       ? 0xFFFFFFFFu
                       : *(const uint32_t*)(mask + (rl + 8 * h) * MASK_ROW +
                                            nt * 16 + 4 * j);
    uint32_t xv[16];
    if (SIGMA)
#pragma unroll
      for (int q = 0; q < 16; ++q)
        xv[q] = *(const uint32_t*)(xw + nt * 128 + 8 * q + mlpw::pair_col());
    float acc[64];
    mlpw::tile_mma<128>(acc, ring, a, kb, 0, 0, [&](int s) {
      if (nt == 0) hook(s, kb);
    });
    mlpw::for_each_pair<128>(acc, r0, nt * 128, [&](int row, int c, int q,
                                                    int h, float v0,
                                                    float v1) {
      if (SIGMA) {
        v0 = fmaf(lo_f(xv[q]), ds[h], v0);
        v1 = fmaf(hi_f(xv[q]), ds[h], v1);
      }
      const uint32_t bits = (mw[h][q >> 2] >> (8 * (q & 3) + (c & 7))) & 3u;
      const uint32_t keep =
          ((bits & 1u) ? 0x0000FFFFu : 0u) | ((bits & 2u) ? 0xFFFF0000u : 0u);
      *(uint32_t*)(Y + mlpw::sw128(row, c, T)) = pack_bf16x2(v0, v1) & keep;
    });
  }
}

// One block of 128 points: two consumer warpgroups own 64 points each
// (every sum stays inside its warpgroup), the producer warp streams the
// weight slabs of every product, in the consumers' order, through the
// ring. Per warpgroup: the encoding, the recomputed forward (each layer's
// output goes to the H scratch, the trunk's ReLU bits stay in shared
// memory), the heads, the dgrad chain (each cotangent to the G scratch),
// d_enc and the encoding chain rule.
__global__ void __launch_bounds__(MAIN_THREADS, 1)
mlp_bwd_main_bf16(const float* __restrict__ xyz,   // (8, M) rows
                  const float* __restrict__ dout,  // (8, M) rows
                  float* __restrict__ dxyz,        // (8, M) rows
                  MlpWeights p, const bf16* __restrict__ image,
                  ImageOffsets io, bf16* __restrict__ hs,
                  bf16* __restrict__ gs, float* __restrict__ heads, int M,
                  int m_start, int Mc, int chunk, int n_freqs) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      (unsigned char*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  const int mb = blockIdx.x * T;  // first point of the block, in chunk
  mlpw::Ring ring{mlpw::smem_u32(smem + OFF_RING),
                  mlpw::smem_u32(smem + OFF_BARS),
                  mlpw::smem_u32(smem + OFF_BARS + 8 * mlpw::STAGES), 0, 0u};
  if (threadIdx.x == 0) mlpw::ring_init(ring);
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // the producer warp
    if (threadIdx.x != CONSUMERS) return;
    auto F = [&](int l) { return image + io.fwd[l]; };
    auto B = [&](int l) { return image + io.bwd[l]; };
    mlpw::produce_product(ring, F(0), WIDTH, E, nullptr, 0);
    for (int i = 1; i < DEPTH; ++i)
      mlpw::produce_product(ring, F(i), WIDTH, WIDTH,
                            i == SKIP ? F(8) : nullptr, E);
    mlpw::produce_product(ring, F(10), WIDTH, WIDTH, nullptr, 0);
    mlpw::produce_product(ring, F(11), DIR_W, WIDTH, nullptr, 0);
    mlpw::produce_product(ring, B(11), WIDTH, DIR_W, nullptr, 0);
    mlpw::produce_product(ring, B(10), WIDTH, WIDTH, nullptr, 0);
    for (int i = DEPTH - 1; i >= 1; --i) {
      if (i == SKIP) mlpw::produce_product(ring, B(8), E, WIDTH, nullptr, 0);
      mlpw::produce_product(ring, B(i), WIDTH, WIDTH, nullptr, 0);
    }
    mlpw::produce_product(ring, B(0), E, WIDTH, nullptr, 0);
    return;
  }

  const int wg = threadIdx.x >> 7;
  const int wt = threadIdx.x & 127;
  const int r0 = wg * WG_ROWS;  // the warpgroup's first row
  unsigned char* bufA = smem + OFF_A;
  unsigned char* bufB = smem + OFF_B;
  unsigned char* enc = smem + OFF_ENC;
  unsigned char* masks = smem + OFF_MASK + wg * MASK_WG;
  float* hsm = (float*)(smem + OFF_ENC) + r0 * HEAD_COLS;
  const bf16* const* w = (const bf16* const*)p.w;
  auto H = [&](int h) { return hs + (size_t)h_col(h) * chunk; };
  auto G = [&](int g) { return gs + (size_t)g_col(g) * chunk; };
  auto rows_of = [&](const unsigned char* buf) {
    return mlpw::smem_u32(buf) + r0 * 128;  // A operand: the wg's rows
  };
  auto mask_of = [&](int layer) { return masks + layer * WG_ROWS * MASK_ROW; };
  auto publish = [&]() {  // epilogue stores -> the next products' reads
    mlpw::fence_proxy_async();
    mlpw::wg_sync(wg);
  };

  // positional encoding (as the forward kernel), two threads a point
  {
    const int rl = wt % WG_ROWS;
    const int half = wt / WG_ROWS;
    const int m = mb + r0 + rl;
    const bool live = m < Mc;
    const size_t gm = (size_t)m_start + m;
    const float c3[3] = {live ? xyz[gm] : 0.0f,
                         live ? xyz[(size_t)M + gm] : 0.0f,
                         live ? xyz[2 * (size_t)M + gm] : 0.0f};
    auto put = [&](int e, float v) {
      *(bf16*)(enc + mlpw::sw128(r0 + rl, e, T)) = __float2bfloat16_rn(v);
    };
    if (half == 0) {
      for (int c = 0; c < 3; ++c) put(c, c3[c]);
      for (int e = 3 + 6 * n_freqs; e < E; ++e) put(e, 0.0f);
    }
    for (int j = half; j < n_freqs; j += 2) {
      const float f = (float)(1 << j);
      for (int c = 0; c < 3; ++c) {
        const float a = f * c3[c];
        put(3 + 6 * j + c, sinf(a));
        put(3 + 6 * j + 3 + c, cosf(a));
      }
    }
  }
  publish();

  // ---- recomputed forward; every layer's output also goes to H, stored
  // while the next layer's first products run
  fwd_layer<true>(ring, rows_of(enc), 1, 0, 0, WIDTH, bufA, p.b[0], r0,
                  [&](int s, int n) {
                    copy_out<E>(enc, H(0), mb, r0, nullptr, s, n);
                  });
  publish();
  unsigned char* hin = bufA;
  unsigned char* hout = bufB;
  for (int i = 1; i < DEPTH; ++i) {
    fwd_layer<true>(ring, rows_of(hin), WIDTH / 64, rows_of(enc),
                    i == SKIP ? 1 : 0, WIDTH, hout, p.b[i], r0,
                    [&](int s, int n) {
                      copy_out<WIDTH>(hin, H(i), mb, r0, mask_of(i - 1), s, n);
                    });
    publish();
    unsigned char* tmp = hin;
    hin = hout;
    hout = tmp;
  }
  // hin = h7. xyz_final (no ReLU) -> hf in hout, dir_0 -> hd in hin
  fwd_layer<false>(ring, rows_of(hin), WIDTH / 64, 0, 0, WIDTH, hout,
                   p.b[10], r0, [&](int s, int n) {
    copy_out<WIDTH>(hin, H(DEPTH), mb, r0, mask_of(DEPTH - 1), s, n);
  });
  publish();
  fwd_layer<true>(ring, rows_of(hout), WIDTH / 64, 0, 0, DIR_W, hin,
                  p.b[11], r0,
                  [&](int s, int n) {
                    copy_out<WIDTH>(hout, H(9), mb, r0, nullptr, s, n);
                  });
  publish();
  copy_out<DIR_W>(hin, H(10), mb, r0, nullptr);
  unsigned char* hd = hin;
  unsigned char* spare = hout;  // hf, no longer needed on chip

  // ---- heads: d_rgb_raw (f32) and d_sigma, the warpgroup's 64 points
  for (int task = wt; task < 4 * WG_ROWS; task += 128) {
    const int c = task / WG_ROWS;
    const int rl = task % WG_ROWS;
    const int m = mb + r0 + rl;
    const float d = m < Mc ? dout[(size_t)c * M + m_start + m] : 0.0f;
    if (c < 3) {
      const bf16* wr = w[12] + c * DIR_W;
      float acc = 0.0f;
      for (int k = 0; k < DIR_W; k += 8) {
        const uint4 hv = *(const uint4*)(hd + mlpw::sw128(r0 + rl, k, T));
        const uint4 wv = *(const uint4*)(wr + k);
        const uint32_t hw[4] = {hv.x, hv.y, hv.z, hv.w};
        const uint32_t ww[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc = fmaf(lo_f(hw[j]), lo_f(ww[j]), acc);
          acc = fmaf(hi_f(hw[j]), hi_f(ww[j]), acc);
        }
      }
      const float s = sigmoidf(acc + p.b[12][c]);
      hsm[rl * HEAD_COLS + c] = d * s * (1.0f - s);
    } else {
      hsm[rl * HEAD_COLS + 3] = d;
    }
  }
  mlpw::wg_sync(wg);
  for (int i = wt; i < WG_ROWS * HEAD_COLS; i += 128)
    heads[(size_t)(mb + r0) * HEAD_COLS + i] = hsm[i];

  // ---- d_hd = mask(hd) bf16(W12^T bf16(d_rgb_raw))  (CUDA cores, K = 3)
  for (int i = wt; i < WG_ROWS * (DIR_W / 8); i += 128) {
    const int rl = i / (DIR_W / 8);
    const int n0 = (i % (DIR_W / 8)) * 8;
    const uint32_t off = mlpw::sw128(r0 + rl, n0, T);
    const uint4 hv = *(const uint4*)(hd + off);
    const uint32_t hw[4] = {hv.x, hv.y, hv.z, hv.w};
    float dr[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) dr[c] = bf16r(hsm[rl * HEAD_COLS + c]);
    uint32_t ow[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float acc[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        acc[h] = 0.0f;
#pragma unroll
        for (int c = 0; c < 3; ++c)
          acc[h] = fmaf(__bfloat162float(w[12][c * DIR_W + n0 + 2 * j + h]),
                        dr[c], acc[h]);
      }
      // hd is a ReLU output: zero the cotangent where it is not > 0
      const uint32_t keep = positive2(hw[j]);
      ow[j] = pack_bf16x2(acc[0], acc[1]) &
              (((keep & 1u) ? 0x0000FFFFu : 0u) |
               ((keep & 2u) ? 0xFFFF0000u : 0u));
    }
    const uint4 ov = make_uint4(ow[0], ow[1], ow[2], ow[3]);
    *(uint4*)(spare + off) = ov;
    __stcs((uint4*)(G(9) + (size_t)(mb + r0 + rl) * DIR_W + n0), ov);
  }
  publish();
  // d_hf = bf16(W11^T d_hd) -> hd's buffer
  dgrad_layer<false>(ring, rows_of(spare), DIR_W / 64, hd, nullptr, nullptr,
                     hsm, r0, [](int, int) {});
  publish();
  // d_7 = mask(h7) bf16(W10^T d_hf + W9^T bf16(d_sigma)) -> spare
  dgrad_layer<true>(ring, rows_of(hd), WIDTH / 64, spare, mask_of(DEPTH - 1),
                    w[9], hsm, r0, [&](int s, int n) {
                      copy_out<WIDTH>(hd, G(8), mb, r0, nullptr, s, n);
                    });
  publish();
  unsigned char* cur = spare;  // d_i, stored under the next products
  unsigned char* nxt = hd;
  float d_enc8[32];  // W8^T d_4 (f32, unrounded), the skip's enc half
  for (int i = DEPTH - 1; i >= 1; --i) {
    auto store = [&](int s, int n) {
      copy_out<WIDTH>(cur, G(i), mb, r0, nullptr, s, n);
    };
    if (i == SKIP) {
      mlpw::tile_mma<E>(d_enc8, ring, rows_of(cur), WIDTH / 64, 0, 0,
                        [&](int s) { store(s, WIDTH / 64); });
      dgrad_layer<false>(ring, rows_of(cur), WIDTH / 64, nxt, mask_of(i - 1),
                         nullptr, hsm, r0, [](int, int) {});
    } else {
      dgrad_layer<false>(ring, rows_of(cur), WIDTH / 64, nxt, mask_of(i - 1),
                         nullptr, hsm, r0, store);
    }
    publish();
    unsigned char* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  // d_enc = W8^T d_4 + bf16(W0^T d_0), f32, into the (spent) mask region
  {
    float acc[32];
    mlpw::tile_mma<E>(acc, ring, rows_of(cur), WIDTH / 64, 0, 0,
                      [&](int s) {
                        copy_out<WIDTH>(cur, G(0), mb, r0, nullptr, s,
                                        WIDTH / 64);
                      });
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = d_enc8[i] + bf16r(acc[i]);
    float* denc = (float*)masks;
    mlpw::for_each_pair<E>(acc, 0, 0, [&](int rl, int c, int, int, float v0,
                                          float v1) {
      denc[rl * E + (c ^ (rl & 31))] = v0;
      denc[rl * E + ((c + 1) ^ (rl & 31))] = v1;
    });
  }
  mlpw::wg_sync(wg);

  // ---- encoding chain rule, one thread a point
  if (wt < WG_ROWS) {
    const int rl = wt;
    const int m = mb + r0 + rl;
    if (m < Mc) {
      const size_t gm = (size_t)m_start + m;
      const float* de = (const float*)masks + rl * E;
      auto D = [&](int c) { return de[c ^ (rl & 31)]; };
      for (int c = 0; c < 3; ++c) {
        const float x = xyz[(size_t)c * M + gm];
        float d = D(c);
        for (int j = 0; j < n_freqs; ++j) {
          const float f = (float)(1 << j);
          const float a = f * x;
          d = d + f * (cosf(a) * D(3 + 6 * j + c) -
                       sinf(a) * D(3 + 6 * j + 3 + c));
        }
        dxyz[(size_t)c * M + gm] = d;
      }
      for (int r = 3; r < 8; ++r) dxyz[(size_t)r * M + gm] = 0.0f;
    }
  }
}

// dW (N x K) += G^T H over rows [s * rps, min(rows, (s + 1) * rps)) of
// the chunk, into split s's partial. A block owns a 128 x TK output tile
// (TK = 128, or 64 for the encoding's K = 64); its 8 warps form a 2 x 4
// grid of 64 x TK/4 sub-tiles. 32 points at a time, the G and H rows are
// staged in shared memory with 16-byte loads (the next 32 rows are loaded
// into registers while the current ones are multiplied), and each warp
// runs its wmma fragments from there.
constexpr int WG_TN = 128;
constexpr int WG_TT = 32;  // points per stage
constexpr int WG_PAD = 8;

// 32 rows of the G (128 columns from n0) and H (TK columns from k0)
// arrays into registers, 16 bytes a load
template <int TK, int GC, int HC>
__device__ __forceinline__ void wgrad_load(const bf16* __restrict__ g, int N,
                                           int n0, const bf16* __restrict__ h,
                                           int K, int k0, int t0,
                                           uint4 (&rg)[GC], uint4 (&rh)[HC]) {
#pragma unroll
  for (int q = 0; q < GC; ++q) {
    const int c = threadIdx.x + q * THREADS;  // 16 per row
    rg[q] = *(const uint4*)(g + (size_t)(t0 + c / 16) * N + n0 + (c % 16) * 8);
  }
#pragma unroll
  for (int q = 0; q < HC; ++q) {
    const int c = threadIdx.x + q * THREADS;  // TK / 8 per row
    rh[q] = *(const uint4*)(h + (size_t)(t0 + c / (TK / 8)) * K + k0 +
                            (c % (TK / 8)) * 8);
  }
}

template <int TK>
__global__ void __launch_bounds__(THREADS)
wgrad_bf16(const bf16* __restrict__ g, int N, const bf16* __restrict__ h,
           int K, int rows, int rps, float* __restrict__ part,
           size_t part_stride, size_t w_off) {
  constexpr int LG = WG_TN + WG_PAD;
  constexpr int LH = TK + WG_PAD;
  constexpr int FK = TK / 4 / 16;  // k fragments per warp
  constexpr int G_CHUNKS = WG_TT * WG_TN / 8 / THREADS;  // uint4 per thread
  constexpr int H_CHUNKS = WG_TT * TK / 8 / THREADS;
  __shared__ __align__(128) bf16 sg[WG_TT * LG];
  __shared__ __align__(128) bf16 sh[WG_TT * LH];
  const int tiles_k = K / TK;
  const int n0 = (blockIdx.x / tiles_k) * WG_TN;
  const int k0 = (blockIdx.x % tiles_k) * TK;
  const int s = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int wn = (warp & 1) * 64;
  const int wk = (warp >> 1) * (TK / 4);
  float* out = part + (size_t)s * part_stride + w_off;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][FK];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < FK; ++j)
      wmma::load_matrix_sync(
          acc[i][j], out + (size_t)(n0 + wn + 16 * i) * K + k0 + wk + 16 * j,
          K, wmma::mem_row_major);

  const int t_begin = s * rps;
  const int t_end = min(rows, (s + 1) * rps);
  uint4 rg[G_CHUNKS], rh[H_CHUNKS];
  if (t_begin < t_end)
    wgrad_load<TK>(g, N, n0, h, K, k0, t_begin, rg, rh);
  for (int t0 = t_begin; t0 < t_end; t0 += WG_TT) {
#pragma unroll
    for (int q = 0; q < G_CHUNKS; ++q) {
      const int c = threadIdx.x + q * THREADS;
      *(uint4*)(sg + (c / 16) * LG + (c % 16) * 8) = rg[q];
    }
#pragma unroll
    for (int q = 0; q < H_CHUNKS; ++q) {
      const int c = threadIdx.x + q * THREADS;
      *(uint4*)(sh + (c / (TK / 8)) * LH + (c % (TK / 8)) * 8) = rh[q];
    }
    __syncthreads();
    if (t0 + WG_TT < t_end)
      wgrad_load<TK>(g, N, n0, h, K, k0, t0 + WG_TT, rg, rh);
#pragma unroll
    for (int kk = 0; kk < WG_TT; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
          b[FK];
#pragma unroll
      for (int j = 0; j < FK; ++j)
        wmma::load_matrix_sync(b[j], sh + kk * LH + wk + 16 * j, LH);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
        wmma::load_matrix_sync(a, sg + kk * LG + wn + 16 * i, LG);
#pragma unroll
        for (int j = 0; j < FK; ++j) wmma::mma_sync(acc[i][j], a, b[j],
                                                    acc[i][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < FK; ++j)
      wmma::store_matrix_sync(
          out + (size_t)(n0 + wn + 16 * i) * K + k0 + wk + 16 * j, acc[i][j],
          K, wmma::mem_row_major);
}

// ================================================================= f32 path

constexpr int TF = 32;  // points per block

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// forward layer, thread n: out[n][t] = epi(sum_k in[k][t] W[n][k] (+ in2 .
// W2) + b[n]); activations feature-major (K x TF); also writes H rows
template <int N_OUT, bool RELU>
__device__ __forceinline__ void dense_f32(const float* in, int K,
                                          const float* __restrict__ W,
                                          const float* in2, int K2,
                                          const float* __restrict__ W2,
                                          const float* __restrict__ bias,
                                          float* out, float* h, int mb) {
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
        const float4* hv = (const float4*)(A + (4 * k4 + s) * TF);
#pragma unroll
        for (int q = 0; q < TF / 4; ++q) {
          const float4 x = hv[q];
          acc[4 * q + 0] = fmaf(x.x, wk[s], acc[4 * q + 0]);
          acc[4 * q + 1] = fmaf(x.y, wk[s], acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(x.z, wk[s], acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(x.w, wk[s], acc[4 * q + 3]);
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
    h[(size_t)(mb + t) * N_OUT + n] = v;
  }
}

// dgrad, thread k: acc[t] = sum_n W[n][k] d[n][t] (W is (N_IN, ldw))
__device__ __forceinline__ void dgrad_f32(const float* d, int n_in,
                                          const float* __restrict__ W,
                                          int ldw, int k, float (&acc)[TF]) {
#pragma unroll
  for (int t = 0; t < TF; ++t) acc[t] = 0.0f;
  for (int n = 0; n < n_in; ++n) {
    const float wv = __ldg(W + (size_t)n * ldw + k);
    const float4* dv = (const float4*)(d + n * TF);
#pragma unroll
    for (int q = 0; q < TF / 4; ++q) {
      const float4 x = dv[q];
      acc[4 * q + 0] = fmaf(x.x, wv, acc[4 * q + 0]);
      acc[4 * q + 1] = fmaf(x.y, wv, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(x.z, wv, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(x.w, wv, acc[4 * q + 3]);
    }
  }
}

constexpr size_t SMEM_F32 =
    (size_t)(2 * E + 2 * WIDTH + HEAD_COLS) * TF * sizeof(float);

__global__ void __launch_bounds__(WIDTH)
mlp_bwd_main_f32(const float* __restrict__ xyz, const float* __restrict__ dout,
                 float* __restrict__ dxyz, MlpWeights p,
                 float* __restrict__ hs, float* __restrict__ gs,
                 float* __restrict__ heads, int M, int m_start, int Mc,
                 int chunk, int n_freqs) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* enc = (float*)smem;         // (E, TF)
  float* bufA = enc + E * TF;        // (WIDTH, TF)
  float* bufB = bufA + WIDTH * TF;
  float* denc = bufB + WIDTH * TF;   // (E, TF)
  float* hsm = denc + E * TF;        // (HEAD_COLS, TF)
  const int mb = blockIdx.x * TF;
  const float* const* w = (const float* const*)p.w;
  const int tid = threadIdx.x;
  auto H = [&](int h) { return hs + (size_t)h_col(h) * chunk; };
  auto G = [&](int g) { return gs + (size_t)g_col(g) * chunk; };

  for (int task = tid; task < TF * 2; task += WIDTH) {
    const int t = task % TF;
    const int half = task / TF;
    const int m = mb + t;
    const bool live = m < Mc;
    const size_t gm = (size_t)m_start + m;
    const float c3[3] = {live ? xyz[gm] : 0.0f,
                         live ? xyz[(size_t)M + gm] : 0.0f,
                         live ? xyz[2 * (size_t)M + gm] : 0.0f};
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
  for (int i = tid; i < E * TF; i += WIDTH) denc[i] = 0.0f;
  __syncthreads();
  for (int i = tid; i < TF * E; i += WIDTH)
    H(0)[(size_t)(mb + i / E) * E + i % E] = enc[(i % E) * TF + i / E];

  dense_f32<WIDTH, true>(enc, E, w[0], nullptr, 0, nullptr, p.b[0], bufA,
                         H(1), mb);
  __syncthreads();
  float* hin = bufA;
  float* hout = bufB;
  for (int i = 1; i < DEPTH; ++i) {
    if (i == SKIP)
      dense_f32<WIDTH, true>(hin, WIDTH, w[i], enc, E, w[8], p.b[i], hout,
                             H(i + 1), mb);
    else
      dense_f32<WIDTH, true>(hin, WIDTH, w[i], nullptr, 0, nullptr, p.b[i],
                             hout, H(i + 1), mb);
    __syncthreads();
    float* tmp = hin;
    hin = hout;
    hout = tmp;
  }
  dense_f32<WIDTH, false>(hin, WIDTH, w[10], nullptr, 0, nullptr, p.b[10],
                          hout, H(9), mb);
  __syncthreads();
  dense_f32<DIR_W, true>(hout, WIDTH, w[11], nullptr, 0, nullptr, p.b[11],
                         hin, H(10), mb);
  __syncthreads();
  float* hd = hin;
  float* spare = hout;

  if (tid < 4 * TF) {
    const int c = tid / TF;
    const int t = tid % TF;
    const int m = mb + t;
    const float d = m < Mc ? dout[(size_t)c * M + m_start + m] : 0.0f;
    if (c < 3) {
      float v = 0.0f;
      for (int k = 0; k < DIR_W; ++k)
        v = fmaf(hd[k * TF + t], w[12][c * DIR_W + k], v);
      const float s = sigmoidf(v + p.b[12][c]);
      hsm[c * TF + t] = d * s * (1.0f - s);
    } else {
      hsm[3 * TF + t] = d;
    }
  }
  __syncthreads();
  if (tid < TF * HEAD_COLS)
    heads[(size_t)(mb + tid / HEAD_COLS) * HEAD_COLS + tid % HEAD_COLS] =
        hsm[(tid % HEAD_COLS) * TF + tid / HEAD_COLS];

  if (tid < DIR_W) {  // d_hd
    const int n = tid;
    for (int t = 0; t < TF; ++t) {
      float acc = 0.0f;
      for (int c = 0; c < 3; ++c)
        acc = fmaf(w[12][c * DIR_W + n], hsm[c * TF + t], acc);
      const float v = hd[n * TF + t] > 0.0f ? acc : 0.0f;
      spare[n * TF + t] = v;
      G(9)[(size_t)(mb + t) * DIR_W + n] = v;
    }
  }
  __syncthreads();
  float acc[TF];
  {  // d_hf = W11^T d_hd
    const int k = tid;
    dgrad_f32(spare, DIR_W, w[11], WIDTH, k, acc);
    for (int t = 0; t < TF; ++t) {
      hd[k * TF + t] = acc[t];
      G(8)[(size_t)(mb + t) * WIDTH + k] = acc[t];
    }
  }
  __syncthreads();
  {  // d_7 = mask(h7) (W10^T d_hf + W9^T d_sigma)
    const int k = tid;
    dgrad_f32(hd, WIDTH, w[10], WIDTH, k, acc);
    for (int t = 0; t < TF; ++t) {
      float v = acc[t] + w[9][k] * hsm[3 * TF + t];
      if (!(H(8)[(size_t)(mb + t) * WIDTH + k] > 0.0f)) v = 0.0f;
      spare[k * TF + t] = v;
      G(7)[(size_t)(mb + t) * WIDTH + k] = v;
    }
  }
  __syncthreads();
  float* cur = spare;
  float* nxt = hd;
  for (int i = DEPTH - 1; i >= 1; --i) {
    const int k = tid;
    if (i == SKIP && k < E) {
      dgrad_f32(cur, WIDTH, w[8], E, k, acc);
      for (int t = 0; t < TF; ++t) denc[k * TF + t] += acc[t];
    }
    dgrad_f32(cur, WIDTH, w[i], WIDTH, k, acc);
    for (int t = 0; t < TF; ++t) {
      float v = acc[t];
      if (!(H(i)[(size_t)(mb + t) * WIDTH + k] > 0.0f)) v = 0.0f;
      nxt[k * TF + t] = v;
      G(i - 1)[(size_t)(mb + t) * WIDTH + k] = v;
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  if (tid < E) {
    dgrad_f32(cur, WIDTH, w[0], E, tid, acc);
    for (int t = 0; t < TF; ++t) denc[tid * TF + t] += acc[t];
  }
  __syncthreads();

  if (tid < TF) {
    const int t = tid;
    const int m = mb + t;
    if (m < Mc) {
      const size_t gm = (size_t)m_start + m;
      for (int c = 0; c < 3; ++c) {
        const float x = xyz[(size_t)c * M + gm];
        float d = denc[c * TF + t];
        for (int j = 0; j < n_freqs; ++j) {
          const float f = (float)(1 << j);
          const float a = f * x;
          d = d + f * (cosf(a) * denc[(3 + 6 * j + c) * TF + t] -
                       sinf(a) * denc[(3 + 6 * j + 3 + c) * TF + t]);
        }
        dxyz[(size_t)c * M + gm] = d;
      }
      for (int r = 3; r < 8; ++r) dxyz[(size_t)r * M + gm] = 0.0f;
    }
  }
}

// dW (N x K) += G^T H, SIMT: 64x64 tile per block, 4x4 outputs a thread
__global__ void __launch_bounds__(256)
wgrad_f32(const float* __restrict__ g, int N, const float* __restrict__ h,
          int K, int rows, int rps, float* __restrict__ part,
          size_t part_stride, size_t w_off) {
  __shared__ float sg[16][64];
  __shared__ float sh[16][64];
  const int tiles_k = K / 64;
  const int n0 = (blockIdx.x / tiles_k) * 64;
  const int k0 = (blockIdx.x % tiles_k) * 64;
  const int s = blockIdx.y;
  const int tn = threadIdx.x / 16;
  const int tk = threadIdx.x % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  const int t_end = min(rows, (s + 1) * rps);
  for (int t0 = s * rps; t0 < t_end; t0 += 16) {
    for (int i = threadIdx.x; i < 16 * 64; i += 256) {
      const int tt = i / 64;
      const int cc = i % 64;
      sg[tt][cc] = g[(size_t)(t0 + tt) * N + n0 + cc];
      sh[tt][cc] = h[(size_t)(t0 + tt) * K + k0 + cc];
    }
    __syncthreads();
#pragma unroll
    for (int tt = 0; tt < 16; ++tt) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = sg[tt][tn * 4 + i];
        b[i] = sh[tt][tk * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = part + (size_t)s * part_stride + w_off;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[(size_t)(n0 + tn * 4 + i) * K + k0 + tk * 4 + j] += acc[i][j];
}

// ============================================================ both paths

// sigma / rgb head weight gradients over split s, by HEAD_GROUPS row
// groups of 256 threads combined in a fixed order; thread k: dW9[0][k]
// over h7 and, for k < 128, dW12[0..2][k] over hd. The cotangent is
// rounded to bf16 when RB (the TPU kernel's d_sig_b / d_rgb_b).
constexpr int HEAD_GROUPS = 4;

template <typename TT, bool RB>
__global__ void __launch_bounds__(WIDTH * HEAD_GROUPS)
wgrad_heads(const float* __restrict__ heads, const TT* __restrict__ h7,
            const TT* __restrict__ hd, int rows, int rps,
            float* __restrict__ part, size_t part_stride, size_t off9,
            size_t off12) {
  __shared__ float red[HEAD_GROUPS][4][WIDTH];
  const int s = blockIdx.x;
  const int k = threadIdx.x % WIDTH;
  const int grp = threadIdx.x / WIDTH;
  float a9 = 0.0f, a12[3] = {0.0f, 0.0f, 0.0f};
  const int t_end = min(rows, (s + 1) * rps);
  for (int t = s * rps + grp; t < t_end; t += HEAD_GROUPS) {
    float ds = heads[(size_t)t * HEAD_COLS + 3];
    if (RB) ds = bf16r(ds);
    a9 = fmaf(ds, to_f(h7[(size_t)t * WIDTH + k]), a9);
    if (k < DIR_W) {
      const float hv = to_f(hd[(size_t)t * DIR_W + k]);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float dr = heads[(size_t)t * HEAD_COLS + c];
        if (RB) dr = bf16r(dr);
        a12[c] = fmaf(dr, hv, a12[c]);
      }
    }
  }
  red[grp][0][k] = a9;
  for (int c = 0; c < 3; ++c) red[grp][1 + c][k] = a12[c];
  __syncthreads();
  if (grp != 0) return;
  for (int q = 1; q < HEAD_GROUPS; ++q) {
    a9 += red[q][0][k];
    for (int c = 0; c < 3; ++c) a12[c] += red[q][1 + c][k];
  }
  float* out = part + (size_t)s * part_stride;
  out[off9 + k] += a9;
  if (k < DIR_W)
    for (int c = 0; c < 3; ++c) out[off12 + (size_t)c * DIR_W + k] += a12[c];
}

struct BiasOffsets {
  size_t b[N_W];
};

// bias gradients: column j < GW of the G scratch, or one of the 4 head
// columns (f32, unrounded), summed in point order over split s
template <typename TT>
__global__ void __launch_bounds__(256)
bias_sums(const TT* __restrict__ gs, const float* __restrict__ heads,
          int chunk, int rows, int rps, float* __restrict__ part,
          size_t part_stride, BiasOffsets bo) {
  const int j = blockIdx.x * 256 + threadIdx.x;
  const int s = blockIdx.y;
  if (j >= GW + HEAD_COLS) return;
  const int t_end = min(rows, (s + 1) * rps);
  float acc = 0.0f;
  size_t dst;
  if (j < GW) {
    const int g = j < 9 * WIDTH ? j / WIDTH : 9;
    const int col = j - g_col(g);
    const int gw = g_width(g);
    const TT* src = gs + (size_t)g_col(g) * chunk + col;
    for (int t = s * rps; t < t_end; ++t) acc += to_f(src[(size_t)t * gw]);
    const int layer = g < 8 ? g : (g == 8 ? 10 : 11);
    dst = bo.b[layer] + col;
  } else {
    const int hc = j - GW;
    for (int t = s * rps; t < t_end; ++t)
      acc += heads[(size_t)t * HEAD_COLS + hc];
    dst = hc < 3 ? bo.b[12] + hc : bo.b[9];
  }
  part[(size_t)s * part_stride + dst] += acc;
}

__global__ void __launch_bounds__(256)
reduce_splits(const float* __restrict__ part, size_t total,
              float* __restrict__ out) {
  const size_t e = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (e >= total) return;
  float acc = 0.0f;
  for (int s = 0; s < SPLITS; ++s) acc += part[(size_t)s * total + e];
  out[e] = acc;
}

// (layer, G array, H array) of the weight gradients with N, K >= 64
struct WgradLayer {
  int layer, g, h;
};
constexpr WgradLayer WG_LAYERS[11] = {
    {0, 0, 0}, {1, 1, 1}, {2, 2, 2},  {3, 3, 3},  {4, 4, 4},  {5, 5, 5},
    {6, 6, 6}, {7, 7, 7}, {8, 4, 0},  {10, 8, 8}, {11, 9, 9}};

template <typename TT>
int run_wgrad(const TT* hs, const TT* gs, const float* heads, int chunk,
              int rows, float* part, const GradLayout& L,
              cudaStream_t stream) {
  // a multiple of 32 points: the bf16 kernel stages 32 rows at a time
  const int rps = ((rows + SPLITS - 1) / SPLITS + 31) / 32 * 32;
  for (const WgradLayer& wl : WG_LAYERS) {
    const int N = L.wr[wl.layer];
    const int K = L.wc[wl.layer];
    const TT* g = gs + (size_t)g_col(wl.g) * chunk;
    const TT* h = hs + (size_t)h_col(wl.h) * chunk;
    if (std::is_same<TT, bf16>::value && K % 128 == 0)
      wgrad_bf16<128><<<dim3((N / WG_TN) * (K / 128), SPLITS), THREADS, 0,
                         stream>>>((const bf16*)g, N, (const bf16*)h, K,
                                   rows, rps, part, L.total, L.w[wl.layer]);
    else if (std::is_same<TT, bf16>::value)
      wgrad_bf16<64><<<dim3((N / WG_TN) * (K / 64), SPLITS), THREADS, 0,
                        stream>>>((const bf16*)g, N, (const bf16*)h, K, rows,
                                  rps, part, L.total, L.w[wl.layer]);
    else
      wgrad_f32<<<dim3((N / 64) * (K / 64), SPLITS), 256, 0, stream>>>(
          (const float*)g, N, (const float*)h, K, rows, rps, part, L.total,
          L.w[wl.layer]);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  wgrad_heads<TT, std::is_same<TT, bf16>::value>
      <<<SPLITS, WIDTH * HEAD_GROUPS, 0, stream>>>(heads, hs + (size_t)h_col(8) * chunk,
                                     hs + (size_t)h_col(10) * chunk, rows,
                                     rps, part, L.total, L.w[9], L.w[12]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  BiasOffsets bo;
  for (int i = 0; i < N_W; ++i) bo.b[i] = L.b[i];
  bias_sums<TT><<<dim3((GW + HEAD_COLS + 255) / 256, SPLITS), 256, 0,
                  stream>>>(gs, heads, chunk, rows, rps, part, L.total, bo);
  err = cudaGetLastError();
  return (int)err;
}

}  // namespace

// The buffers animnerf_fused_mlp_bwd takes for a chunk of `chunk` points
// (a multiple of 128): sizes[0] scratch elements of the compute type (the
// H and G arrays), sizes[1] head floats, sizes[2] partial floats (one flat
// gradient per split, zeroed by the caller), sizes[3] gradient floats
// (dW_0..12 then db_0..12 in pack_params' shapes, padded to 64).
extern "C" int animnerf_fused_mlp_bwd_sizes(int chunk, void* sizes) {
  const GradLayout L = grad_layout();
  long long* out = (long long*)sizes;
  out[0] = (long long)chunk * (HW + GW);
  out[1] = (long long)chunk * HEAD_COLS;
  out[2] = (long long)SPLITS * L.total;
  out[3] = (long long)L.total;
  return 0;
}

// w_image: the bf16 weight image (ops/fused_mlp.py::weight_image), with
// image_offsets its 2 x 13 part offsets (host int array: fwd then bwd);
// both unused (may be null) in f32.
extern "C" int animnerf_fused_mlp_bwd(const void* xyz, const void* dout,
                                      const void* w_ptrs, const void* b_ptrs,
                                      const void* w_image,
                                      const void* image_offsets,
                                      void* dxyz, void* grads, void* scratch,
                                      void* heads, void* partials, int M,
                                      int chunk, int n_freqs, int E_in,
                                      int dtype, void* stream) {
  if (E_in != E || n_freqs < 0 || 3 + 6 * n_freqs > E || chunk % T != 0 ||
      chunk <= 0)
    return (int)cudaErrorInvalidValue;
  MlpWeights p;
  for (int i = 0; i < N_W; ++i) {
    p.w[i] = ((const void* const*)w_ptrs)[i];
    p.b[i] = ((const float* const*)b_ptrs)[i];
  }
  ImageOffsets io;
  if (dtype == 0) {
    if (w_image == nullptr || image_offsets == nullptr)
      return (int)cudaErrorInvalidValue;
    for (int i = 0; i < N_W; ++i) {
      io.fwd[i] = ((const int*)image_offsets)[i];
      io.bwd[i] = ((const int*)image_offsets)[N_W + i];
    }
    // the parts the main kernel streams (ops/fused_mlp.py::IMAGE_PARTS)
    for (int l : {0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 11})
      if (io.fwd[l] < 0 || io.bwd[l] < 0 || io.fwd[l] % 64 ||
          io.bwd[l] % 64)
        return (int)cudaErrorInvalidValue;
  }
  const GradLayout L = grad_layout();
  cudaStream_t st = (cudaStream_t)stream;
  for (int m_start = 0; m_start < M; m_start += chunk) {
    const int Mc = min(chunk, M - m_start);
    if (dtype == 0) {
      const int rows = (Mc + T - 1) / T * T;
      bf16* hs = (bf16*)scratch;
      bf16* gs = hs + (size_t)HW * chunk;
      cudaFuncSetAttribute(mlp_bwd_main_bf16,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)SMEM_BF16);
      mlp_bwd_main_bf16<<<rows / T, MAIN_THREADS, SMEM_BF16, st>>>(
          (const float*)xyz, (const float*)dout, (float*)dxyz, p,
          (const bf16*)w_image, io, hs, gs, (float*)heads, M, m_start, Mc,
          chunk, n_freqs);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      const int rc = run_wgrad<bf16>(hs, gs, (const float*)heads, chunk,
                                     rows, (float*)partials, L, st);
      if (rc != 0) return rc;
    } else {
      const int rows = (Mc + TF - 1) / TF * TF;
      float* hs = (float*)scratch;
      float* gs = hs + (size_t)HW * chunk;
      cudaFuncSetAttribute(mlp_bwd_main_f32,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)SMEM_F32);
      mlp_bwd_main_f32<<<rows / TF, WIDTH, SMEM_F32, st>>>(
          (const float*)xyz, (const float*)dout, (float*)dxyz, p, hs, gs,
          (float*)heads, M, m_start, Mc, chunk, n_freqs);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      const int rc = run_wgrad<float>(hs, gs, (const float*)heads, chunk,
                                      rows, (float*)partials, L, st);
      if (rc != 0) return rc;
    }
  }
  reduce_splits<<<(unsigned)((L.total + 255) / 256), 256, 0, st>>>(
      (const float*)partials, L.total, (float*)grads);
  return (int)cudaGetLastError();
}
