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
// The f32 path uses f32 operands and no rounding. sinf/cosf (sincosf in
// bf16), not __sinf: at 2^9 the arguments reach hundreds of radians.
//
// Bound on the H100: operations (~1.19 MFLOP per point on the tensor
// cores; 12 B in and 32 B out per point). The 1.15 MB of bf16 weights the
// products read do not fit the 227 KB of shared memory, so a block keeps
// its points' activations on chip and streams the weights past them.
// bf16 design (mlp_wgmma.cuh, the layer product the MLP backward's main
// kernel runs too): one block per 128 points, two consumer warpgroups of
// 64 points and a producer warp. The producer stages the weights, in the
// consumers' order (layer 0, layers 1-7 with the skip layer's enc half
// after its h half, xyz_final, dir_0), as 16 KB slabs with one
// cp.async.bulk each into an mbarrier ring of as many stages as shared
// memory holds (5 at the flagship's E = 64); the wrapper packs them once
// into exactly the slabs' shared-memory byte image
// (ops/fused_mlp.py::weight_image, cached with the packed weights for
// serving). Each product is a wgmma (m64n128k16, f32 accumulators in
// registers) with both operands in shared memory in the 128-byte swizzled
// K-major layout: the activations in two 128 x 256 bf16 ping-pong
// buffers, the encoding in a 128 x E block (E = enc_rows(F) rounded up
// to 64 columns, zero-padded, at most 192). The epilogue rounds, adds the
// bias and applies ReLU in registers (one bf16x2 FMA a pair) and writes
// bf16 into the other buffer; encoding and epilogue are the backward's
// recompute code, one copy (mlp_wgmma.cuh). The two small heads (sigma,
// N = 1; rgb, N = 3) run on the CUDA cores with f32 accumulation, two
// threads a point: sigma under xyz_final's products, rgb at the end.
// Shared memory: 128 KB activations + E x 256 B encoding + the ring, one
// block per SM. No library GEMM is involved. (Tried and not kept, as
// they were no faster on the H100: a persistent grid, a 384-thread block
// with setmaxnreg, and a second accumulator set to run one tile's
// epilogue under the next tile's products; see PERF.md.)
// The f32 path (compute_dtype float32) is csrc/mlp_f32.cu's forward, on
// the register-tiled f32 layer routine it shares with the MLP backward's
// f32 recompute (mlp_f32_tile.cuh).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "mlp_f32_tile.cuh"
#include "mlp_wgmma.cuh"

namespace {

constexpr int WIDTH = 256;
constexpr int DIR_W = 128;
constexpr int N_W = 13;  // packed operands, see ops/fused_mlp.py::pack_params
constexpr int SKIP = 4;

struct MlpWeights {
  const void* w[N_W];   // (N, K) row-major, bf16 or f32 (pack_params' layout)
  const float* b[N_W];  // f32 biases (N,)
};

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// ---------------------------------------------------------------- bf16 path

typedef __nv_bfloat16 bf16;

constexpr int T = mlpw::ROWS;                 // points per block
constexpr int CONSUMERS = 256;                // two warpgroups
constexpr int FWD_THREADS = CONSUMERS + 32;   // + the producer warp
constexpr int WG_ROWS = 64;                   // points of a warpgroup
constexpr int MAX_E = 192;                    // encoding columns that fit

constexpr int MAX_STAGES = 5;                 // ring depth at E = 64
constexpr int SMEM_MAX = 232448;              // a block's shared memory

// shared memory (bytes from a 1024-aligned base): the activations, the
// barriers, the encoding block (T x E bf16), then as many ring stages as
// fit (5 at E = 64, 4 at 128, 3 at 192)
constexpr int OFF_A = 0;                                 // 128 x 256 bf16
constexpr int OFF_B = OFF_A + T * WIDTH * 2;             // 128 x 256 bf16
constexpr int OFF_BARS = OFF_B + T * WIDTH * 2;          // 2 x stages x 8 B
constexpr int OFF_ENC = OFF_BARS + 1024;                 // 1024-aligned
__host__ __device__ constexpr int off_ring(int E) { return OFF_ENC + T * E * 2; }
__host__ __device__ constexpr int fwd_stages(int E) {
  return (SMEM_MAX - 1024 - off_ring(E)) / mlpw::SLAB_BYTES < MAX_STAGES
             ? (SMEM_MAX - 1024 - off_ring(E)) / mlpw::SLAB_BYTES
             : MAX_STAGES;
}
__host__ __device__ constexpr size_t fwd_smem(int E) {  // + base alignment
  return (size_t)off_ring(E) + (size_t)fwd_stages(E) * mlpw::SLAB_BYTES +
         1024;
}
static_assert(fwd_stages(MAX_E) >= mlpw::STAGES &&
                  fwd_smem(MAX_E) <= SMEM_MAX && fwd_smem(64) <= SMEM_MAX,
              "shared memory of one block");

// element offsets of the weight image's forward parts (ops/fused_mlp.py::
// weight_image): W_l (N x K) for out = in . W_l^T, layers 0-8, 10, 11
struct FwdOffsets {
  int fwd[N_W];
};

// One block of 128 points: two consumer warpgroups own 64 points each
// (no sum crosses a warpgroup), the producer warp streams the weight
// slabs of every product through the ring in the consumers' order.
__global__ void __launch_bounds__(FWD_THREADS, 1)
mlp_fwd_bf16(const float* __restrict__ xyz,  // (8, M) rows
             MlpWeights p, const bf16* __restrict__ image, FwdOffsets io,
             float* __restrict__ out,  // (8, M) rows
             int M, int n_freqs, int E) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      (unsigned char*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  const int mb = blockIdx.x * T;  // the block's first point
  const int stages = fwd_stages(E);
  mlpw::Ring ring{mlpw::smem_u32(smem + off_ring(E)),
                  mlpw::smem_u32(smem + OFF_BARS),
                  mlpw::smem_u32(smem + OFF_BARS + 8 * stages), 0, 0u,
                  stages};
  if (threadIdx.x == 0) mlpw::ring_init(ring);
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // the producer warp
    if (threadIdx.x != CONSUMERS) return;
    auto F = [&](int l) { return image + io.fwd[l]; };
    mlpw::produce_product(ring, F(0), WIDTH, E, nullptr, 0);
    for (int i = 1; i < 8; ++i)
      mlpw::produce_product(ring, F(i), WIDTH, WIDTH,
                            i == SKIP ? F(8) : nullptr, E);
    mlpw::produce_product(ring, F(10), WIDTH, WIDTH, nullptr, 0);
    mlpw::produce_product(ring, F(11), DIR_W, WIDTH, nullptr, 0);
    return;
  }

  const int wg = threadIdx.x >> 7;
  const int wt = threadIdx.x & 127;
  const int r0 = wg * WG_ROWS;  // the warpgroup's first row
  const int rl = wt % WG_ROWS;  // the thread's point (two threads a point)
  const int half = wt / WG_ROWS;
  const int m = mb + r0 + rl;
  unsigned char* bufA = smem + OFF_A;
  unsigned char* bufB = smem + OFF_B;
  unsigned char* enc = smem + OFF_ENC;
  const bf16* const* w = (const bf16* const*)p.w;
  const int kb_enc = E / mlpw::KBLOCK;
  auto rows_of = [&](const unsigned char* buf) {
    return mlpw::smem_u32(buf) + r0 * 128;  // A operand: the wg's rows
  };
  auto publish = [&]() {  // epilogue stores -> the next products' reads
    mlpw::fence_proxy_async();
    mlpw::wg_sync(wg);
  };
  auto no_hook = [](int, int) {};

  {  // positional encoding
    const bool live = m < M;
    const float c3[3] = {live ? xyz[m] : 0.0f,
                         live ? xyz[(size_t)M + m] : 0.0f,
                         live ? xyz[2 * (size_t)M + m] : 0.0f};
    mlpw::encode_row(enc, E, r0 + rl, half, c3, n_freqs);
  }
  publish();

  mlpw::fwd_layer<WIDTH, true>(ring, rows_of(enc), kb_enc, 0, 0, bufA,
                               p.b[0], r0, no_hook);
  publish();
  unsigned char* hin = bufA;
  unsigned char* hout = bufB;
  for (int i = 1; i < 8; ++i) {
    mlpw::fwd_layer<WIDTH, true>(ring, rows_of(hin), WIDTH / 64,
                                 rows_of(enc), i == SKIP ? kb_enc : 0, hout,
                                 p.b[i], r0, no_hook);
    publish();
    unsigned char* tmp = hin;
    hin = hout;
    hout = tmp;
  }

  // The heads: half h of a point's two threads takes half the columns;
  // the halves' f32 sums meet in the warpgroup's rows of the encoding
  // block (spent after the skip layer): hsum[rl] sigma, hsum[64 + 3 rl +
  // c] rgb.
  float* hsum = (float*)(enc + r0 * 128);
  // hin = h7. xyz_final (no ReLU) -> hf in hout; under its four slabs'
  // products, the sigma head (W9's row 0, 32 columns a slab and thread)
  // reads h7, which the products read too
  float sigma[1] = {0.0f};
  mlpw::fwd_layer<WIDTH, false>(
      ring, rows_of(hin), WIDTH / 64, 0, 0, hout, p.b[10], r0,
      [&](int s, int) {
        const int k0 = 64 * s + 32 * half;
        mlpw::dot_rows<1>(hin, r0 + rl, w[9], 0, k0, k0 + 32, sigma);
      });
  if (half) hsum[rl] = sigma[0];
  publish();
  if (!half && m < M) {
    out[3 * (size_t)M + m] = sigma[0] + hsum[rl] + p.b[9][0];
    for (int r = 4; r < 8; ++r) out[r * (size_t)M + m] = 0.0f;
  }
  // dir_0 + ReLU -> hd in hin (h7 is spent: the sigma head is done)
  mlpw::fwd_layer<DIR_W, true>(ring, rows_of(hout), WIDTH / 64, 0, 0, hin,
                               p.b[11], r0, no_hook);
  mlpw::wg_sync(wg);
  // rgb head: sigmoid(acc_f32 + b_f32)
  float rgb[3] = {0.0f, 0.0f, 0.0f};
  mlpw::dot_rows<3>(hin, r0 + rl, w[12], DIR_W, 64 * half, 64 * half + 64,
                    rgb);
  if (half)
    for (int c = 0; c < 3; ++c) hsum[64 + 3 * rl + c] = rgb[c];
  mlpw::wg_sync(wg);
  if (!half && m < M)
    for (int c = 0; c < 3; ++c)
      out[c * (size_t)M + m] =
          sigmoidf(rgb[c] + hsum[64 + 3 * rl + c] + p.b[12][c]);
}

}  // namespace

// xyz, out: (8, M) f32 rows; w_ptrs / b_ptrs: host arrays of 13 device
// pointers (ops/fused_mlp.py::pack_params: weights (N, K) row-major,
// biases (N,)); dtype 0 = bf16, 1 = f32. w_image is the kernels' weight
// image (ops/fused_mlp.py::kernel_image: weight_image in bf16, f32_image
// in f32) and image_offsets its host int array of part offsets (forward
// parts first), E the encoding block's columns (enc_cols there: a
// multiple of 64, at most 192, covering 3 + 6 n_freqs); the heads
// (layers 9, 12) are read from w_ptrs.
extern "C" int animnerf_fused_mlp_fwd(const void* xyz, const void* w_ptrs,
                                      const void* b_ptrs, const void* w_image,
                                      const void* image_offsets, void* out,
                                      int M, int n_freqs, int E, int dtype,
                                      void* stream) {
  MlpWeights p;
  for (int i = 0; i < N_W; ++i) {
    p.w[i] = ((const void* const*)w_ptrs)[i];
    p.b[i] = ((const float* const*)b_ptrs)[i];
  }
  if (M <= 0) return (int)cudaGetLastError();
  cudaError_t err;
  if (dtype == 0) {
    // 2^j as an int shift: n_freqs <= 31
    if (n_freqs < 0 || n_freqs > 31 || 3 + 6 * n_freqs > E ||
        E % mlpw::KBLOCK != 0 || E > MAX_E || w_image == nullptr ||
        image_offsets == nullptr)
      return (int)cudaErrorInvalidValue;
    FwdOffsets io;
    for (int i = 0; i < N_W; ++i) io.fwd[i] = ((const int*)image_offsets)[i];
    // the parts the producer streams, 128-byte aligned for the bulk copies
    for (int l : {0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 11})
      if (io.fwd[l] < 0 || io.fwd[l] % 64 != 0)
        return (int)cudaErrorInvalidValue;
    const size_t bytes = fwd_smem(E);
    err = cudaFuncSetAttribute(mlp_fwd_bf16,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
    mlp_fwd_bf16<<<(M + T - 1) / T, FWD_THREADS, bytes,
                   (cudaStream_t)stream>>>((const float*)xyz, p,
                                           (const bf16*)w_image, io,
                                           (float*)out, M, n_freqs, E);
  } else {
    if (w_image == nullptr || image_offsets == nullptr)
      return (int)cudaErrorInvalidValue;
    MlpF32Params q;
    q.image = (const float*)w_image;
    for (int i = 0; i < N_W; ++i) {
      q.fwd[i] = ((const int*)image_offsets)[i];
      q.bwd[i] = -1;
      q.b[i] = p.b[i];
    }
    q.w9 = (const float*)p.w[9];
    q.w12 = (const float*)p.w[12];
    return mlp_f32_forward((const float*)xyz, q, (float*)out, M, n_freqs, E,
                           (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}
