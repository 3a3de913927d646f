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
//      f32: csrc/mlp_f32.cu, 64 points a block on the CUDA cores.
//      Encoding width: the kernels are instantiated for an encoding block
//      of EC = 64 columns (n_freqs 0..10, the flagship's 10 among them)
//      and of 128 (n_freqs 11..20), every encoding use_fused_mlp admits;
//      the columns from 3 + 6 n_freqs are zero and contribute nothing
//      (the chain rule reads only the encoding's own columns, and the
//      weight gradients keep pack_params' enc_rows columns). At 128 the
//      encoding block takes 32 KB, so the ring keeps two slab stages
//      (230,432 B of shared memory, against 230,448 at 64 with three), and
//      d_enc (32 KB a warpgroup in f32) goes to the warpgroup's rows of
//      the activation buffer whose cotangent d_1 is spent, not the 16 KB
//      mask region.
//   2. weight gradients (bf16), dW_l = G_l^T H_l over the chunk's points,
//      the head weight gradients and every bias sum, in one pass that
//      reads each scratch byte from device memory once (a layer's two
//      output halves share their H read through L2): mlp_wgrad_prep, then
//      mlp_wgrad_bf16 on wgmma with MN-major operands staged by TMA
//      (csrc/mlp_wgrad.cu). Bound: one read of the scratch and the f32
//      head cotangents, 9,872 B a point: 3.09 ms per 2^20 points
//      (products 1.25). Every block stores (first chunk) or adds
//      its tiles into its own split's f32 partial, which only that block
//      writes. f32: mlp_f32.cu's SGEMM-tiled pass, heads and bias sums in
//      it.
//   3. after the last chunk, one kernel sums the splits' partials in a
//      fixed order.
// No atomics anywhere, and no sum crosses a block in the main kernel: the
// gradients are deterministic, bit for bit from run to run. The
// activations go through device memory once (written by 1, read by 2);
// keeping them on chip would need the dW accumulators spread over a
// cluster's shared memory, left to a later revision.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "mlp_bwd_layout.cuh"
#include "mlp_f32_tile.cuh"
#include "mlp_wgmma.cuh"

namespace {

constexpr int DEPTH = 8;
constexpr int SKIP = 4;

typedef __nv_bfloat16 bf16;
using namespace mlpb;

struct MlpWeights {
  const void* w[N_W];   // (N, K) row-major, bf16 or f32 (pack_params)
  const float* b[N_W];  // f32 biases (N,)
};

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// ================================================================ bf16 path

constexpr int T = mlpw::ROWS;  // points per block
constexpr int CONSUMERS = 256;  // two warpgroups of 64 points each
constexpr int MAIN_THREADS = CONSUMERS + 32;  // + the producer warp
constexpr int WG_ROWS = 64;
constexpr int MASK_ROW = WIDTH / 8;  // bytes of one row's ReLU bits

// shared memory of the main kernel (bytes from a 1024-aligned base)
constexpr int SMEM_MAX = 232448;  // a block's shared memory
constexpr int OFF_A = 0;                               // 128 x 256 bf16
constexpr int OFF_B = OFF_A + T * WIDTH * 2;           // 128 x 256 bf16
// 128 x EC bf16 encoding; after the forward, the heads (128 x 4 f32)
constexpr int OFF_ENC = OFF_B + T * WIDTH * 2;
constexpr int MASK_WG = DEPTH * WG_ROWS * MASK_ROW;    // 16 KB a warpgroup
template <int EC>
struct MainSmem {
  static constexpr int OFF_RING = OFF_ENC + T * EC * 2;  // the slab ring
  // as many stages as fit, up to mlpw::STAGES: 3 at EC = 64, 2 at 128
  static constexpr int FIT = (SMEM_MAX - 1024 - OFF_RING - 2 * MASK_WG -
                              2 * mlpw::STAGES * 8) / mlpw::SLAB_BYTES;
  static constexpr int STAGES = FIT < mlpw::STAGES ? FIT : mlpw::STAGES;
  static constexpr int OFF_MASK = OFF_RING + STAGES * mlpw::SLAB_BYTES;
  static constexpr int OFF_BARS = OFF_MASK + 2 * MASK_WG;
  static constexpr size_t BYTES = OFF_BARS + 2 * STAGES * 8 + 1024;
  static_assert(STAGES >= 2, "a slab ring of two stages at least");
  static_assert(EC != 64 || WG_ROWS * EC * 4 <= MASK_WG,
                "d_enc reuses a mask region at EC = 64");
  static_assert(EC != 128 || WG_ROWS * EC * 4 == 4 * WG_ROWS * 128,
                "d_enc fills the warpgroup's rows of a spent buffer at 128");
  static_assert(T * HEAD_COLS * 4 <= T * EC * 2,
                "the heads reuse the encoding");
  static_assert(BYTES <= SMEM_MAX, "shared memory of one block");
};

// element offsets of the weight image's parts (ops/fused_mlp.py::
// weight_image): fwd[l] holds W_l (N x K) for out = in . W_l^T, bwd[l]
// holds W_l^T (K x N) for d_in = d_out . W_l; -1 where absent
struct ImageOffsets {
  int fwd[N_W];
  int bwd[N_W];
};

// the recomputed forward is the forward kernel's own code (mlp_wgmma.cuh)
using mlpw::fwd_layer;
using mlpw::hi_f;
using mlpw::lo_f;
using mlpw::pack_bf16x2;

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
template <int EC>
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
  using S = MainSmem<EC>;
  constexpr int KB_ENC = EC / mlpw::KBLOCK;  // 64-column blocks of enc
  const int mb = blockIdx.x * T;  // first point of the block, in chunk
  mlpw::Ring ring{mlpw::smem_u32(smem + S::OFF_RING),
                  mlpw::smem_u32(smem + S::OFF_BARS),
                  mlpw::smem_u32(smem + S::OFF_BARS + 8 * S::STAGES), 0, 0u,
                  S::STAGES};
  if (threadIdx.x == 0) mlpw::ring_init(ring);
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // the producer warp
    if (threadIdx.x != CONSUMERS) return;
    auto F = [&](int l) { return image + io.fwd[l]; };
    auto B = [&](int l) { return image + io.bwd[l]; };
    mlpw::produce_product(ring, F(0), WIDTH, EC, nullptr, 0);
    for (int i = 1; i < DEPTH; ++i)
      mlpw::produce_product(ring, F(i), WIDTH, WIDTH,
                            i == SKIP ? F(8) : nullptr, EC);
    mlpw::produce_product(ring, F(10), WIDTH, WIDTH, nullptr, 0);
    mlpw::produce_product(ring, F(11), DIR_W, WIDTH, nullptr, 0);
    mlpw::produce_product(ring, B(11), WIDTH, DIR_W, nullptr, 0);
    mlpw::produce_product(ring, B(10), WIDTH, WIDTH, nullptr, 0);
    for (int i = DEPTH - 1; i >= 1; --i) {
      if (i == SKIP)
        mlpw::produce_product(ring, B(8), EC, WIDTH, nullptr, 0);
      mlpw::produce_product(ring, B(i), WIDTH, WIDTH, nullptr, 0);
    }
    mlpw::produce_product(ring, B(0), EC, WIDTH, nullptr, 0);
    return;
  }

  const int wg = threadIdx.x >> 7;
  const int wt = threadIdx.x & 127;
  const int r0 = wg * WG_ROWS;  // the warpgroup's first row
  unsigned char* bufA = smem + OFF_A;
  unsigned char* bufB = smem + OFF_B;
  unsigned char* enc = smem + OFF_ENC;
  unsigned char* masks = smem + S::OFF_MASK + wg * MASK_WG;
  float* hsm = (float*)(smem + OFF_ENC) + r0 * HEAD_COLS;
  const bf16* const* w = (const bf16* const*)p.w;
  auto H = [&](int h) { return hs + (size_t)h_col<EC>(h) * chunk; };
  auto G = [&](int g) { return gs + (size_t)g_col(g) * chunk; };
  auto rows_of = [&](const unsigned char* buf) {
    return mlpw::smem_u32(buf) + r0 * 128;  // A operand: the wg's rows
  };
  auto mask_of = [&](int layer) { return masks + layer * WG_ROWS * MASK_ROW; };
  auto publish = [&]() {  // epilogue stores -> the next products' reads
    mlpw::fence_proxy_async();
    mlpw::wg_sync(wg);
  };

  // positional encoding (the forward kernel's), two threads a point
  {
    const int rl = wt % WG_ROWS;
    const int m = mb + r0 + rl;
    const bool live = m < Mc;
    const size_t gm = (size_t)m_start + m;
    const float c3[3] = {live ? xyz[gm] : 0.0f,
                         live ? xyz[(size_t)M + gm] : 0.0f,
                         live ? xyz[2 * (size_t)M + gm] : 0.0f};
    mlpw::encode_row(enc, EC, r0 + rl, wt / WG_ROWS, c3, n_freqs);
  }
  publish();

  // ---- recomputed forward; every layer's output also goes to H, stored
  // while the next layer's first products run
  fwd_layer<WIDTH, true>(ring, rows_of(enc), KB_ENC, 0, 0, bufA, p.b[0], r0,
                         [&](int s, int n) {
                           copy_out<EC>(enc, H(0), mb, r0, nullptr, s, n);
                         });
  publish();
  unsigned char* hin = bufA;
  unsigned char* hout = bufB;
  for (int i = 1; i < DEPTH; ++i) {
    fwd_layer<WIDTH, true>(ring, rows_of(hin), WIDTH / 64, rows_of(enc),
                           i == SKIP ? KB_ENC : 0, hout, p.b[i], r0,
                           [&](int s, int n) {
                             copy_out<WIDTH>(hin, H(i), mb, r0,
                                             mask_of(i - 1), s, n);
                           });
    publish();
    unsigned char* tmp = hin;
    hin = hout;
    hout = tmp;
  }
  // hin = h7. xyz_final (no ReLU) -> hf in hout, dir_0 -> hd in hin
  fwd_layer<WIDTH, false>(ring, rows_of(hin), WIDTH / 64, 0, 0, hout,
                          p.b[10], r0, [&](int s, int n) {
    copy_out<WIDTH>(hin, H(DEPTH), mb, r0, mask_of(DEPTH - 1), s, n);
  });
  publish();
  fwd_layer<DIR_W, true>(ring, rows_of(hout), WIDTH / 64, 0, 0, hin,
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
      float acc[1] = {0.0f};
      mlpw::dot_rows<1>(hd, r0 + rl, w[12] + c * DIR_W, 0, 0, DIR_W, acc);
      const float s = sigmoidf(acc[0] + p.b[12][c]);
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
  float d_enc8[EC / 2];  // W8^T d_4 (f32, unrounded), the skip's enc half
  for (int i = DEPTH - 1; i >= 1; --i) {
    auto store = [&](int s, int n) {
      copy_out<WIDTH>(cur, G(i), mb, r0, nullptr, s, n);
    };
    if (i == SKIP) {
      mlpw::tile_mma<EC>(d_enc8, ring, rows_of(cur), WIDTH / 64, 0, 0,
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
  // d_enc = W8^T d_4 + bf16(W0^T d_0), f32, (rl, c) at float rl * EC + (c
  // ^ (rl & 31)) of a spent region: at EC = 64 the mask region; at 128 the
  // warpgroup's rows of nxt (d_1's buffer, stored and read by then), four
  // 8 KB pieces, one per 64-column block, 16 rows of d_enc each
  auto denc_at = [&](int i) -> float* {
    if constexpr (EC == 64)
      return (float*)masks + i;
    else
      return (float*)(nxt + (i >> 11) * mlpw::KB_BYTES + r0 * 128) +
             (i & 2047);
  };
  {
    float acc[EC / 2];
    mlpw::tile_mma<EC>(acc, ring, rows_of(cur), WIDTH / 64, 0, 0,
                       [&](int s) {
                         copy_out<WIDTH>(cur, G(0), mb, r0, nullptr, s,
                                         WIDTH / 64);
                       });
#pragma unroll
    for (int i = 0; i < EC / 2; ++i) acc[i] = d_enc8[i] + bf16r(acc[i]);
    mlpw::for_each_pair<EC>(acc, 0, 0, [&](int rl, int c, int, int,
                                           float v0, float v1) {
      *denc_at(rl * EC + (c ^ (rl & 31))) = v0;
      *denc_at(rl * EC + ((c + 1) ^ (rl & 31))) = v1;
    });
  }
  mlpw::wg_sync(wg);

  // ---- encoding chain rule, one thread a point
  if (wt < WG_ROWS) {
    const int rl = wt;
    const int m = mb + r0 + rl;
    if (m < Mc) {
      const size_t gm = (size_t)m_start + m;
      const float* de = denc_at(rl * EC);
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

// every chunk of M points through the main kernel and the weight
// gradients at encoding width EC, then the split reduction
template <int EC>
int run_bwd(const void* xyz, const void* dout, const MlpWeights& p,
            const void* w_image, const ImageOffsets& io, void* dxyz,
            void* grads, void* scratch, void* heads, void* partials, int M,
            int chunk, int n_freqs, int er, cudaStream_t st) {
  const GradLayout L = grad_layout(er);
  for (int m_start = 0; m_start < M; m_start += chunk) {
    const int Mc = min(chunk, M - m_start);
    const int rows = (Mc + T - 1) / T * T;
    bf16* hs = (bf16*)scratch;
    bf16* gs = hs + (size_t)HW<EC> * chunk;
    cudaFuncSetAttribute(mlp_bwd_main_bf16<EC>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)MainSmem<EC>::BYTES);
    mlp_bwd_main_bf16<EC><<<rows / T, MAIN_THREADS, MainSmem<EC>::BYTES,
                            st>>>(
        (const float*)xyz, (const float*)dout, (float*)dxyz, p,
        (const bf16*)w_image, io, hs, gs, (float*)heads, M, m_start, Mc,
        chunk, n_freqs);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int rc = animnerf_mlp_wgrad_chunk(hs, heads, partials, rows,
                                            chunk, er, m_start == 0, st);
    if (rc != 0) return rc;
  }
  reduce_splits<<<(unsigned)((L.total + 255) / 256), 256, 0, st>>>(
      (const float*)partials, L.total, (float*)grads);
  return (int)cudaGetLastError();
}

}  // namespace

// The buffers animnerf_fused_mlp_bwd takes for a chunk of `chunk` points
// (a multiple of 128) and er encoding rows (enc_rows(n_freqs): 8..128):
// sizes[0] scratch elements of the compute type (the H and G arrays, the
// encoding EC = enc_cols_of(er) wide), sizes[1] head floats (the (chunk, 4)
// f32 head cotangents, then the bf16 pass's head tiles, 16 B a point),
// sizes[2] partial floats (one flat gradient per split; the kernels set
// them, the caller need not), sizes[3] gradient floats (dW_0..12 then
// db_0..12 in pack_params' shapes, padded to 64).
extern "C" int animnerf_fused_mlp_bwd_sizes(int chunk, int er, void* sizes) {
  if (er < 8 || er > EC_MAX || er % 8 != 0) return (int)cudaErrorInvalidValue;
  const GradLayout L = grad_layout(er);
  long long* out = (long long*)sizes;
  out[0] = (long long)chunk *
           ((er <= 64 ? HW<64> : HW<128>) + GW);
  out[1] = (long long)chunk * 2 * HEAD_COLS;
  out[2] = (long long)SPLITS * L.total;
  out[3] = (long long)L.total;
  return 0;
}

// w_image: the kernels' weight image (ops/fused_mlp.py::kernel_image:
// weight_image in bf16, f32_image in f32), with image_offsets its 2 x 13
// part offsets (host int array: fwd then bwd). E_in: the encoding rows of
// the packed weights, enc_rows(n_freqs) (8..128, n_freqs 0..20).
extern "C" int animnerf_fused_mlp_bwd(const void* xyz, const void* dout,
                                      const void* w_ptrs, const void* b_ptrs,
                                      const void* w_image,
                                      const void* image_offsets,
                                      void* dxyz, void* grads, void* scratch,
                                      void* heads, void* partials, int M,
                                      int chunk, int n_freqs, int E_in,
                                      int dtype, void* stream) {
  if (E_in < 8 || E_in > EC_MAX || E_in % 8 != 0 || n_freqs < 0 ||
      3 + 6 * n_freqs > E_in || chunk % T != 0 || chunk <= 0)
    return (int)cudaErrorInvalidValue;
  MlpWeights p;
  for (int i = 0; i < N_W; ++i) {
    p.w[i] = ((const void* const*)w_ptrs)[i];
    p.b[i] = ((const float* const*)b_ptrs)[i];
  }
  if (w_image == nullptr || image_offsets == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype != 0) {  // f32: csrc/mlp_f32.cu
    MlpF32Params q;
    q.image = (const float*)w_image;
    for (int i = 0; i < N_W; ++i) {
      q.fwd[i] = ((const int*)image_offsets)[i];
      q.bwd[i] = ((const int*)image_offsets)[N_W + i];
      q.b[i] = p.b[i];
    }
    q.w9 = (const float*)p.w[9];
    q.w12 = (const float*)p.w[12];
    return mlp_f32_backward((const float*)xyz, (const float*)dout, q,
                            (float*)dxyz, (float*)grads, (float*)scratch,
                            (float*)heads, (float*)partials, M, chunk,
                            n_freqs, E_in, st);
  }
  ImageOffsets io;
  for (int i = 0; i < N_W; ++i) {
    io.fwd[i] = ((const int*)image_offsets)[i];
    io.bwd[i] = ((const int*)image_offsets)[N_W + i];
  }
  // the parts the main kernel streams (ops/fused_mlp.py::IMAGE_PARTS)
  for (int l : {0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 11})
    if (io.fwd[l] < 0 || io.bwd[l] < 0 || io.fwd[l] % 64 || io.bwd[l] % 64)
      return (int)cudaErrorInvalidValue;
  if (E_in <= 64)
    return run_bwd<64>(xyz, dout, p, w_image, io, dxyz, grads, scratch,
                       heads, partials, M, chunk, n_freqs, E_in, st);
  return run_bwd<128>(xyz, dout, p, w_image, io, dxyz, grads, scratch, heads,
                      partials, M, chunk, n_freqs, E_in, st);
}
