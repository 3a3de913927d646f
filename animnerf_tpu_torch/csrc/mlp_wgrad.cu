// The fused NeRF MLP backward's weight gradients on Hopper: one pass per
// chunk over the activation scratch that fused_mlp_bwd.cu's main kernel
// writes (csrc/mlp_bwd_layout.cuh), into per-split partials.
//
// Replaces: the weight and bias gradients of animnerf_tpu/ops/fused_mlp.py::
// _bwd_kernel (its dw_refs / db_refs sums, ops/fused_mlp.py:257-289 there).
//
// Bound on the H100: one read of the scratch and the f32 head cotangents,
// 9,872 B a point: 3.09 ms per 2^20 points (the products, 1.18 MFLOP a
// point in bf16, 1.25 ms).

#include <cuda.h>  // CUtensorMap (the encode comes through the runtime)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp_bwd_layout.cuh"
#include "mlp_wgmma.cuh"

namespace {

using namespace mlpb;
typedef __nv_bfloat16 bf16;

constexpr int CONSUMERS = 256;  // two consumer warpgroups

// ------------------------------------------- weight gradients (bf16)
// One pass per chunk over the H/G scratch: dW_l = G_l^T H_l for the 11
// layers with N, K >= 64, the heads dW9 = bf16(d_sigma) h7 and dW12 =
// bf16(d_rgb) hd, and the bias sums of every G array, each over the
// points of split s, into split s's partial, which only that block
// writes. A block (two consumer warpgroups, a producer warpgroup) runs one
// job of WG_JOBS: for every 64 points of its split the producer loads the
// job's boxes (64 features x 64 points, 8 KB, TMA in the 128-byte swizzle)
// into the next stage of a ring, and each warpgroup runs its products on
// wgmma with both operands MN-major: a 256-wide layer is two jobs, each a
// 128 x 256 output tile (m64n256 a warpgroup, 128 accumulators a thread),
// the halves of one layer a 2-block cluster, so that they run together
// and the second read of their shared H box hits L2. The products that
// share an operand run in one job: layer 4's G also feeds dW8 (x enc),
// layer 10's h7 also the sigma head, layer 11's job also loads hd for the
// rgb head. Bias sums: m64n8 products of each G box with a tile of ones;
// heads: m64n8 products of the h7 / hd boxes with the bf16 head cotangent
// tile that mlp_wgrad_prep writes (8 rows x 64 points a stage). The f32
// head bias sums and the entries no product writes are mlp_wgrad_prep's.
// The encoding width EC (64 or 128 columns, mlp_bwd_layout.cuh) is a
// template argument: the enc box of a stage becomes EC / 64 boxes, and the
// products with it (dW8 in the ENC4 jobs, dW0 in the ENC0 job) EC / 64
// m64n64 products a G box, of which the first er (enc_rows) columns are
// stored. At 128 an ENC4 consumer holds 128 + 4 + 64 accumulators.
constexpr int WP = 64;          // points per stage
constexpr int BOX = WP * 128;   // one 64-column box of WP points
constexpr int DN_BYTES = 8 * WP * 2;  // a stage's head cotangent tile
constexpr int WG_STAGES = 4;
// two consumer warpgroups and a producer warpgroup, one thread of which
// issues the loads: setmaxnreg moves the producer's registers to the
// consumers (232 a thread: 128 + 32 + 4 accumulators and no spill)
constexpr int WGRAD_THREADS = CONSUMERS + 128;
constexpr int N_MAPS = 21;      // tensor maps: H0..H10, then G0..G9
constexpr int N_JOBS = 18;
constexpr int WG_OFF_ONES = 0;  // the ones tile (8 x 64, row 0 ones)
constexpr int WG_OFF_BARS = 1024;
constexpr int WG_OFF_RING = 2048;
constexpr size_t SMEM_WGRAD = 232448 - 1024;  // + 1024 for the alignment
constexpr int WG_RING_BYTES = (int)SMEM_WGRAD - WG_OFF_RING;

enum JobKind { PAIR, ENC4, SIGMA, RGB, ENC0 };
struct WgradJob {
  int kind, layer, g, h, col0;
};
// the halves of a layer at 2j, 2j + 1 (one cluster); layer 11 and layer 0
// share the last cluster
__constant__ WgradJob WG_JOBS[N_JOBS] = {
    {PAIR, 1, 1, 1, 0},    {PAIR, 1, 1, 1, 128},  {PAIR, 2, 2, 2, 0},
    {PAIR, 2, 2, 2, 128},  {PAIR, 3, 3, 3, 0},    {PAIR, 3, 3, 3, 128},
    {ENC4, 4, 4, 4, 0},    {ENC4, 4, 4, 4, 128},  {PAIR, 5, 5, 5, 0},
    {PAIR, 5, 5, 5, 128},  {PAIR, 6, 6, 6, 0},    {PAIR, 6, 6, 6, 128},
    {PAIR, 7, 7, 7, 0},    {PAIR, 7, 7, 7, 128},  {SIGMA, 10, 8, 8, 0},
    {SIGMA, 10, 8, 8, 128}, {RGB, 11, 9, 9, 0},   {ENC0, 0, 0, 0, 0}};

// a job's stage: boxes (and the head tile) in this order
//   PAIR, ENC4, SIGMA, RGB: 0, 1 the warpgroups' G boxes; 2..5 H; ENC4:
//     6.. enc (EC / 64 boxes); RGB: 6, 7 hd; SIGMA: the head tile after
//     box 5, RGB after 7
//   ENC0: 0, 1 warpgroup 0's G0 boxes, 2, 3 warpgroup 1's; 4.. enc
template <int EC>
__device__ __forceinline__ int job_boxes(int kind) {
  return kind == ENC0 ? 4 + EC / 64
         : kind == ENC4 ? 6 + EC / 64
         : kind == RGB  ? 8
                        : 6;
}
__device__ __forceinline__ bool job_heads(int kind) {
  return kind == SIGMA || kind == RGB;
}

struct WgradMaps {
  CUtensorMap m[N_MAPS];
};

struct WRing {
  uint32_t base, full, empty;
  int bytes, stages, stage;
  uint32_t phase;
  __device__ __forceinline__ uint32_t slot() const {
    return base + stage * bytes;
  }
  __device__ __forceinline__ void advance() {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1u;
    }
  }
};

// partial entry: stored by the chunk's pass that comes first, added after
__device__ __forceinline__ void put(float* p, float v, bool first) {
  *p = first ? v : *p + v;
}
__device__ __forceinline__ void put2(float* p, float v0, float v1,
                                     bool first) {
  float2* q = (float2*)p;
  if (first) {
    *q = make_float2(v0, v1);
  } else {
    const float2 o = *q;
    *q = make_float2(o.x + v0, o.y + v1);
  }
}

// column 0 of an n8 bias accumulator: the sums of rows n0 + the thread's
// two rows
__device__ __forceinline__ void put_bias(const float (&b)[4], float* P,
                                         int n0, bool first) {
  if (mlpw::pair_col() != 0) return;
  const int r = n0 + mlpw::pair_row();
  put(P + r, b[0], first);
  put(P + r + 8, b[2], first);
}

// consumer warpgroup: for each of `steps` stages, products(s0) issues
// the stage's wgmma (s0: its shared address); a stage is released once
// the next one's products are issued and its own have completed
template <class Products>
__device__ __forceinline__ void consume_stages(WRing& ring, int steps,
                                               const Products& products) {
  int prev = -1;
  for (int t = 0; t < steps; ++t) {
    mlpw::mbar_wait(ring.full + 8 * ring.stage, ring.phase);
    mlpw::wgmma_fence();
    products(ring.slot());
    mlpw::wgmma_commit();
    if (prev >= 0) {
      mlpw::wgmma_wait<1>();
      if ((threadIdx.x & 31) == 0) mlpw::mbar_arrive(ring.empty + 8 * prev);
    }
    prev = ring.stage;
    ring.advance();
  }
  mlpw::wgmma_wait<0>();
  if (prev >= 0 && (threadIdx.x & 31) == 0)
    mlpw::mbar_arrive(ring.empty + 8 * prev);
}

// the products of a 256-wide job, one warpgroup (w), over `steps` stages
// of the ring, then its partial entries
template <int KIND, int EC>
__device__ __forceinline__ void wgrad_consume(WRing& ring, uint32_t ones,
                                              int w, int half, int steps,
                                              const WgradJob& job,
                                              float* P, const GradLayout& L,
                                              bool first) {
  // the third product's accumulators: ENC4 one m64n64 tile per enc box
  constexpr int NXB = KIND == ENC4 ? EC / 64 : 1;
  constexpr int NX = KIND == ENC4 ? 32 : 4;
  float acc[128], bacc[4], xacc[NXB][NX];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) bacc[i] = 0.0f;
#pragma unroll
  for (int b = 0; b < NXB; ++b)
#pragma unroll
    for (int i = 0; i < NX; ++i) xacc[b][i] = 0.0f;
  // the zeros stay ahead of the products (no move inside a wgmma stage)
  mlpw::fence_operand(acc);
  mlpw::fence_operand(bacc);
#pragma unroll
  for (int b = 0; b < NXB; ++b) mlpw::fence_operand(xacc[b]);
  consume_stages(ring, steps, [&](uint32_t s0) {
#pragma unroll
    for (int kk = 0; kk < WP / 16; ++kk) {
      const uint32_t o = kk * 2048;
      const uint64_t da = mlpw::desc_mn128(s0 + w * BOX + o, BOX);
      mlpw::wgmma_n256_mn(acc, da, mlpw::desc_mn128(s0 + 2 * BOX + o, BOX));
      mlpw::wgmma_n8_amn(bacc, da, mlpw::desc_sw128(ones + kk * 32));
      if constexpr (KIND == ENC4)  // G4 box . enc boxes
#pragma unroll
        for (int b = 0; b < NXB; ++b)
          mlpw::wgmma_n64_mn(xacc[b], da,
                             mlpw::desc_mn128(s0 + (6 + b) * BOX + o, BOX));
      if constexpr (KIND == SIGMA)  // h7 box 2 half + w . the head tile
        mlpw::wgmma_n8_amn(
            xacc[0], mlpw::desc_mn128(s0 + (2 + 2 * half + w) * BOX + o, BOX),
            mlpw::desc_sw128(s0 + 6 * BOX + kk * 32));
      if constexpr (KIND == RGB)  // hd box w . the head tile
        mlpw::wgmma_n8_amn(xacc[0],
                           mlpw::desc_mn128(s0 + (6 + w) * BOX + o, BOX),
                           mlpw::desc_sw128(s0 + 8 * BOX + kk * 32));
    }
  });
  mlpw::fence_operand(acc);
  mlpw::fence_operand(bacc);
#pragma unroll
  for (int b = 0; b < NXB; ++b) mlpw::fence_operand(xacc[b]);

  const int n0 = job.col0 + w * 64;  // the warpgroup's first G feature
  float* dw = P + L.w[job.layer];    // K = 256
  mlpw::for_each_pair<WIDTH>(acc, n0, 0, [&](int row, int c, int, int,
                                             float v0, float v1) {
    put2(dw + (size_t)row * WIDTH + c, v0, v1, first);
  });
  put_bias(bacc, P + L.b[job.layer], n0, first);
  const int r = mlpw::pair_row();
  const int c = mlpw::pair_col();
  if constexpr (KIND == ENC4) {  // dW8 = G4^T enc, its er columns
    const int er = L.wc[8];
#pragma unroll
    for (int b = 0; b < NXB; ++b)
      mlpw::for_each_pair<64>(xacc[b], n0, 64 * b,
                              [&](int row, int cc, int, int, float v0,
                                  float v1) {
                                if (cc < er)
                                  put2(P + L.w[8] + (size_t)row * er + cc, v0,
                                       v1, first);
                              });
  }
  if constexpr (KIND == SIGMA) {  // column 3: d_sigma
    if (c == 2) {
      const int f = (2 * half + w) * 64 + r;
      put(P + L.w[9] + f, xacc[0][1], first);
      put(P + L.w[9] + f + 8, xacc[0][3], first);
    }
  }
  if constexpr (KIND == RGB) {  // columns 0..2: d_rgb
    float* d12 = P + L.w[12] + w * 64 + r;
    if (c == 0) {
      put(d12, xacc[0][0], first);
      put(d12 + 8, xacc[0][2], first);
      put(d12 + DIR_W, xacc[0][1], first);
      put(d12 + DIR_W + 8, xacc[0][3], first);
    } else if (c == 2) {
      put(d12 + 2 * DIR_W, xacc[0][0], first);
      put(d12 + 2 * DIR_W + 8, xacc[0][2], first);
    }
  }
}

// dW0 = G0^T enc: warpgroup w owns G0 features 128 w .. 128 w + 127, two
// G0 tiles of 64, each EC / 64 m64n64 products (one an enc box); the
// first er (enc_rows) columns are stored
template <int EC>
__device__ __forceinline__ void wgrad_consume_enc0(WRing& ring,
                                                   uint32_t ones, int w,
                                                   int steps, float* P,
                                                   const GradLayout& L,
                                                   bool first) {
  constexpr int NB = EC / 64;
  float acc[2][NB][32], bacc[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int b = 0; b < NB; ++b) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[j][b][i] = 0.0f;
      mlpw::fence_operand(acc[j][b]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) bacc[j][i] = 0.0f;
    mlpw::fence_operand(bacc[j]);
  }
  consume_stages(ring, steps, [&](uint32_t s0) {
#pragma unroll
    for (int kk = 0; kk < WP / 16; ++kk) {
      const uint32_t o = kk * 2048;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const uint64_t da = mlpw::desc_mn128(s0 + (2 * w + j) * BOX + o, BOX);
#pragma unroll
        for (int b = 0; b < NB; ++b)
          mlpw::wgmma_n64_mn(acc[j][b], da,
                             mlpw::desc_mn128(s0 + (4 + b) * BOX + o, BOX));
        mlpw::wgmma_n8_amn(bacc[j], da, mlpw::desc_sw128(ones + kk * 32));
      }
    }
  });
  const int er = L.wc[0];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    mlpw::fence_operand(bacc[j]);
    const int n0 = 128 * w + 64 * j;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      mlpw::fence_operand(acc[j][b]);
      mlpw::for_each_pair<64>(acc[j][b], n0, 64 * b,
                              [&](int row, int c, int, int, float v0,
                                  float v1) {
                                if (c < er)
                                  put2(P + L.w[0] + (size_t)row * er + c, v0,
                                       v1, first);
                              });
    }
    put_bias(bacc[j], P + L.b[0], n0, first);
  }
}

// grid (N_JOBS, SPLITS), clusters of 2 along x: block (j, s) runs job j
// over the points [s rps, min(rows, (s + 1) rps)) of the chunk
template <int EC>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(WGRAD_THREADS, 1)
mlp_wgrad_bf16(const __grid_constant__ WgradMaps maps,
               const bf16* __restrict__ dn, int rows, int rps,
               float* __restrict__ part, GradLayout L, int first_) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      (unsigned char*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  const bool first = first_ != 0;
  const WgradJob job = WG_JOBS[blockIdx.x];
  const int s = blockIdx.y;
  const int t_begin = s * rps;
  const int t_end = min(rows, t_begin + rps);
  const int steps = t_end > t_begin ? (t_end - t_begin + WP - 1) / WP : 0;
  if (steps == 0 && !first) return;
  const int bytes = job_boxes<EC>(job.kind) * BOX +
                    (job_heads(job.kind) ? DN_BYTES : 0);
  WRing ring{mlpw::smem_u32(smem + WG_OFF_RING),
             mlpw::smem_u32(smem + WG_OFF_BARS),
             mlpw::smem_u32(smem + WG_OFF_BARS + 8 * WG_STAGES),
             bytes,
             min(WG_STAGES, WG_RING_BYTES / bytes),
             0,
             0u};
  const uint32_t ones = mlpw::smem_u32(smem + WG_OFF_ONES);
  if (threadIdx.x == 0) {
    for (int i = 0; i < ring.stages; ++i) {
      mlpw::mbar_init(ring.full + 8 * i, 1);
      mlpw::mbar_init(ring.empty + 8 * i, mlpw::CONSUMER_WARPS);
    }
    mlpw::mbar_init_fence();
  }
  // the ones tile: row 0 of an 8 x 64 K-major tile (bf16 1.0), rows 1..7 0
  for (int i = threadIdx.x; i < 1024 / 4; i += blockDim.x)
    ((uint32_t*)(smem + WG_OFF_ONES))[i] = i < 32 ? 0x3F803F80u : 0u;
  mlpw::fence_proxy_async();
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x != CONSUMERS) return;
    const CUtensorMap* H = maps.m;
    const CUtensorMap* G = maps.m + 11;
    for (int t = 0; t < steps; ++t) {
      const int p0 = t_begin + t * WP;
      mlpw::mbar_wait(ring.empty + 8 * ring.stage, ring.phase ^ 1u);
      const uint32_t bar = ring.full + 8 * ring.stage;
      mlpw::mbar_expect_tx(bar, bytes);
      const uint32_t d = ring.slot();
      // G boxes, hf and hd are read by this block alone; H boxes by the
      // two halves of a layer, enc by three blocks
      using mlpw::EVICT_FIRST;
      using mlpw::EVICT_NORMAL;
      if (job.kind == ENC0) {
        for (int j = 0; j < 4; ++j)
          mlpw::tma_load_2d(d + j * BOX, &G[0], 64 * j, p0, bar, EVICT_FIRST);
        for (int j = 0; j < EC / 64; ++j)
          mlpw::tma_load_2d(d + (4 + j) * BOX, &H[0], 64 * j, p0, bar,
                            EVICT_NORMAL);
      } else {
        for (int j = 0; j < 2; ++j)
          mlpw::tma_load_2d(d + j * BOX, &G[job.g], job.col0 + 64 * j, p0,
                            bar, EVICT_FIRST);
        for (int j = 0; j < 4; ++j)
          mlpw::tma_load_2d(d + (2 + j) * BOX, &H[job.h], 64 * j, p0, bar,
                            job.kind == RGB ? EVICT_FIRST : EVICT_NORMAL);
        if (job.kind == ENC4)
          for (int j = 0; j < EC / 64; ++j)
            mlpw::tma_load_2d(d + (6 + j) * BOX, &H[0], 64 * j, p0, bar,
                              EVICT_NORMAL);
        if (job.kind == RGB)
          for (int j = 0; j < 2; ++j)
            mlpw::tma_load_2d(d + (6 + j) * BOX, &H[10], 64 * j, p0, bar,
                              EVICT_FIRST);
        if (job_heads(job.kind))
          mlpw::bulk_copy(d + job_boxes<EC>(job.kind) * BOX,
                          dn + (size_t)(p0 / WP) * (DN_BYTES / 2), DN_BYTES,
                          bar);
      }
      ring.advance();
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int w = threadIdx.x >> 7;
  const int half = job.col0 / 128;
  float* P = part + (size_t)s * L.total;
  switch (job.kind) {
    case PAIR:
      wgrad_consume<PAIR, EC>(ring, ones, w, half, steps, job, P, L, first);
      break;
    case ENC4:
      wgrad_consume<ENC4, EC>(ring, ones, w, half, steps, job, P, L, first);
      break;
    case SIGMA:
      wgrad_consume<SIGMA, EC>(ring, ones, w, half, steps, job, P, L, first);
      break;
    case RGB:
      wgrad_consume<RGB, EC>(ring, ones, w, half, steps, job, P, L, first);
      break;
    default:
      wgrad_consume_enc0<EC>(ring, ones, w, steps, P, L, first);
  }
}

// Per split s: the head cotangent tiles of its points (an 8 x 64 K-major
// bf16 tile per 64 points, rows 0..2 bf16(d_rgb_raw), row 3 bf16(d_sigma),
// the rest 0, zero beyond `rows`; the TPU kernel's d_rgb_b / d_sig_b), the
// f32 head bias sums db12[0..2] and db9[0] in point order (64 lanes, then
// the lanes in order), and, from the first chunk, zeros in the entries no
// product writes (dW9 rows 1..7, dW12 rows 3..7, db8, db9 rows 1..7, db12
// rows 3..7, the padding).
__global__ void __launch_bounds__(256)
mlp_wgrad_prep(const float* __restrict__ heads, bf16* __restrict__ dn,
               int rows, int rps, float* __restrict__ part, GradLayout L,
               int first) {
  __shared__ float red[64][HEAD_COLS];
  const int s = blockIdx.x;
  const int t0 = s * rps;
  const int t1 = min(rows, t0 + rps);
  const int t1p = min((rows + WP - 1) / WP * WP, t0 + rps);
  for (int i = threadIdx.x; i < (t1p - t0) * 8; i += 256) {
    const int p = t0 + i / 8;
    const int n = i % 8;
    const int k = p % WP;
    const float v = n < HEAD_COLS && p < rows ? heads[(size_t)p * HEAD_COLS + n]
                                              : 0.0f;
    unsigned char* tile = (unsigned char*)dn + (size_t)(p / WP) * DN_BYTES;
    *(bf16*)(tile + n * 128 + ((((k >> 3) & 7) ^ n) << 4) + (k & 7) * 2) =
        __float2bfloat16_rn(v);
  }
  const int c = threadIdx.x % HEAD_COLS;
  const int lane = threadIdx.x / HEAD_COLS;
  float acc = 0.0f;
  for (int p = t0 + lane; p < t1; p += 64)
    acc += heads[(size_t)p * HEAD_COLS + c];
  red[lane][c] = acc;
  __syncthreads();
  float* P = part + (size_t)s * L.total;
  if (threadIdx.x < HEAD_COLS) {
    float v = 0.0f;
    for (int q = 0; q < 64; ++q) v += red[q][threadIdx.x];
    put(P + (threadIdx.x < 3 ? L.b[12] + threadIdx.x : L.b[9]), v,
        first != 0);
  }
  if (!first) return;
  auto zero = [&](size_t a, size_t b) {
    for (size_t e = a + threadIdx.x; e < b; e += 256) P[e] = 0.0f;
  };
  zero(L.w[9] + WIDTH, L.w[9] + 8 * WIDTH);
  zero(L.w[12] + 3 * DIR_W, L.w[12] + 8 * DIR_W);
  zero(L.b[8], L.b[8] + WIDTH);
  zero(L.b[9] + 1, L.b[9] + 8);
  zero(L.b[12] + 3, L.total);
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry
// point query (nothing new is linked)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = (EncodeTiled)f;
  }
  return fn;
}

// the bf16 pass over rows [0, rows) of a chunk's scratch: its tensor
// maps (the 21 arrays, rows x width, 64 x WP boxes in the 128-byte
// swizzle; rows past `rows` read as zeros), mlp_wgrad_prep, then
// mlp_wgrad_bf16; `first`: the chunk's partials are stored, not added
template <int EC>
int run_wgrad_bf16(const bf16* hs, const bf16* gs, float* heads, int chunk,
                   int rows, float* part, const GradLayout& L, bool first,
                   cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  WgradMaps maps;
  for (int i = 0; i < N_MAPS; ++i) {
    const int width = i < 11 ? h_width<EC>(i) : g_width(i - 11);
    const bf16* base = i < 11 ? hs + (size_t)h_col<EC>(i) * chunk
                              : gs + (size_t)g_col(i - 11) * chunk;
    const cuuint64_t dims[2] = {(cuuint64_t)width, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)width * 2};
    const cuuint32_t box[2] = {64, WP};
    const cuuint32_t step[2] = {1, 1};
    if (encode(&maps.m[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, (void*)base,
               dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
  }
  // points per split: whole stages
  const int rps = ((rows + WP - 1) / WP + SPLITS - 1) / SPLITS * WP;
  bf16* dn = (bf16*)(heads + (size_t)chunk * HEAD_COLS);
  mlp_wgrad_prep<<<SPLITS, 256, 0, stream>>>(heads, dn, rows, rps, part, L,
                                             first ? 1 : 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cudaFuncSetAttribute(mlp_wgrad_bf16<EC>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)SMEM_WGRAD + 1024);
  mlp_wgrad_bf16<EC><<<dim3(N_JOBS, SPLITS), WGRAD_THREADS,
                       SMEM_WGRAD + 1024, stream>>>(maps, dn, rows, rps, part,
                                                    L, first ? 1 : 0);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int animnerf_mlp_wgrad_chunk(const void* scratch, void* heads,
                                        void* partials, int rows, int chunk,
                                        int er, int first, void* stream) {
  const bf16* hs = (const bf16*)scratch;
  const GradLayout L = grad_layout(er);
  if (enc_cols_of(er) == 64)
    return run_wgrad_bf16<64>(hs, hs + (size_t)HW<64> * chunk, (float*)heads,
                              chunk, rows, (float*)partials, L, first != 0,
                              (cudaStream_t)stream);
  return run_wgrad_bf16<128>(hs, hs + (size_t)HW<128> * chunk,
                             (float*)heads, chunk, rows, (float*)partials, L,
                             first != 0, (cudaStream_t)stream);
}

// The bf16 weight-gradient pass alone, on rows [0, rows) of a chunk's
// scratch (H and G arrays as animnerf_fused_mlp_bwd leaves them, bf16, for
// er = enc_rows(n_freqs) encoding rows) and head cotangents (buffers as
// animnerf_fused_mlp_bwd_sizes gives them): grads = the flat gradients of
// those points.
extern "C" int animnerf_mlp_wgrad(const void* scratch, void* heads,
                                  void* partials, void* grads, int rows,
                                  int chunk, int er, void* stream) {
  if (chunk <= 0 || chunk % 128 != 0 || rows <= 0 || rows > chunk ||
      er < 8 || er > EC_MAX || er % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const GradLayout L = grad_layout(er);
  cudaStream_t st = (cudaStream_t)stream;
  const int rc = animnerf_mlp_wgrad_chunk(scratch, heads, partials, rows,
                                          chunk, er, 1, st);
  if (rc != 0) return rc;
  reduce_splits<<<(unsigned)((L.total + 255) / 256), 256, 0, st>>>(
      (const float*)partials, L.total, (float*)grads);
  return (int)cudaGetLastError();
}
