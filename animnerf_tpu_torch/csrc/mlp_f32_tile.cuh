// The register-tiled float32 layer routine of the fused NeRF MLP kernels
// (csrc/mlp_f32.cu: kernel 3's f32 forward, and kernel 6's f32 main
// kernel, whose recomputed forward is the same code, so the two sum every
// layer in one order and a ReLU cannot fall on opposite sides in them).
//
// f32 stays f32: FFMA on the CUDA cores (67 TFLOP/s on an H100 SXM), no
// TF32. A block holds P = 64 points and 256 threads; a product
// out (N x 64) += W (N x K) . act (K x 64) keeps its outputs in registers,
// thread (to = tid / 8, tp = tid % 8) an (N / 32) x 8 tile: output columns
// to * 4 + {0..3} (+ 128 for N = 256; to * 2 + {0, 1} for N = 64) by
// points tp * 4 + {0..3} and 32 + tp * 4 + {0..3}. Activations sit in
// shared memory feature-major (row k: the 64 points' values, 256 B), so
// per reduction step a thread reads its 8 points as two float4 and its
// outputs' weights as one or two float4: 4 LDS.128 per 64 FFMA at N =
// 256, each a single shared-memory wavefront for the warp (its 4 output
// groups read 64 contiguous bytes, its 8 point groups 128): FMA-bound.
//
// The weights (2.4 MB for the forward in f32) cannot stay resident. They
// stream through shared memory as slabs of KS = 16 reduction rows (16 KB
// at N = 256) in a ring of 3-4 cp.async stages: every thread issues its
// 16-byte copies of the slab STAGES - 1 ahead, waits for its own copies of
// the current slab (cp.async.wait_group), then a barrier makes all of them
// visible and frees the stage consumed before, which the next copy
// overwrites. The products of a kernel form one stream (Product: a slab
// count and a row width each), so the next layer's first slabs load under
// the current layer's last products and its epilogue. The host packs each
// weight reduction-major, in the order the slabs are read
// (ops/fused_mlp.py::f32_image): W_l^T (K x N) for the forward, W_l (N x
// K) for the dgrad, each slab KS whole rows.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mlpf {

constexpr int P = 64;          // points of a block
constexpr int THREADS = 256;   // 32 output groups x 8 point groups
constexpr int KS = 16;         // reduction rows of a weight slab
constexpr int MAX_N = 256;     // output columns of a product, at most
constexpr int SLAB_FLOATS = KS * MAX_N;
constexpr int SLAB_BYTES = SLAB_FLOATS * 4;  // 16 KB
constexpr int ACT_BYTES = MAX_N * P * 4;     // 64 KB: 256 rows of 64 points
constexpr int MAX_STAGES = 4;
constexpr int SMEM_MAX = 232448;  // a block's shared memory on the H100

// How many ring stages fit after `fixed` bytes of shared memory (at most
// MAX_STAGES), and the block's total.
__host__ __device__ constexpr int stages_after(int fixed) {
  return (SMEM_MAX - fixed) / SLAB_BYTES < MAX_STAGES
             ? (SMEM_MAX - fixed) / SLAB_BYTES
             : MAX_STAGES;
}

// ------------------------------------------------------------ cp.async
__device__ __forceinline__ void cp16(float* dst, const float* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------------- weight stream
struct Product {
  const float* w;  // R x cols, row-major: slab s is rows [s KS, s KS + KS)
  int slabs;       // R / KS
  int cols;        // output columns: 64, 128 or 256
};

// The block's weight slabs, product after product, through a ring of
// STAGES slabs. Every thread holds the same cursor; every thread copies.
template <int STAGES>
struct Stream {
  float* ring;           // STAGES x SLAB_FLOATS, 16-byte aligned
  const Product* sched;  // the products in the order they are consumed
  int n;                 // products
  int ip, is;            // the next slab to copy: product ip, its slab is
  int issued, used;      // slabs copied (or past the end) and consumed
};

// Copy the next slab (if any) into its stage; one commit group a call,
// empty past the end, so that group g always holds slab g.
template <int STAGES>
__device__ __forceinline__ void issue(Stream<STAGES>& s) {
  if (s.ip < s.n) {
    const Product p = s.sched[s.ip];
    const float* src = p.w + (size_t)s.is * KS * p.cols;
    float* dst = s.ring + (s.issued % STAGES) * SLAB_FLOATS;
    const int chunks = KS * p.cols / 4;
    for (int c = threadIdx.x; c < chunks; c += THREADS)
      cp16(dst + 4 * c, src + 4 * c);
    if (++s.is == p.slabs) {
      s.is = 0;
      ++s.ip;
    }
  }
  ++s.issued;
  cp_commit();
}

template <int STAGES>
__device__ __forceinline__ void stream_start(Stream<STAGES>& s) {
  static_assert(STAGES >= 2, "a ring of two stages at least");
#pragma unroll 1
  for (int i = 0; i < STAGES - 1; ++i) issue(s);
}

// The next slab, once every thread's copies of it have landed; the stage
// consumed before it (every thread is past its products, by the barrier)
// takes the slab STAGES - 1 ahead. A block barrier: all threads call it.
template <int STAGES>
__device__ __forceinline__ const float* next_slab(Stream<STAGES>& s) {
  cp_wait<STAGES - 2>();
  __syncthreads();
  const float* slab = s.ring + (s.used % STAGES) * SLAB_FLOATS;
  ++s.used;
  issue(s);
  return slab;
}

// ---------------------------------------------------------- the tile
// column (output feature) of row i of the thread's tile at width N
template <int N>
__device__ __forceinline__ int tile_col(int i) {
  const int to = threadIdx.x >> 3;
  if constexpr (N >= 128)
    return (i >> 2) * 128 + to * 4 + (i & 3);
  else
    return to * 2 + i;
}
// point (of the block's 64) of column j of the thread's tile
__device__ __forceinline__ int tile_pt(int j) {
  return (j >> 2) * 32 + (threadIdx.x & 7) * 4 + (j & 3);
}

template <int N>
__device__ __forceinline__ void tile_zero(float (&acc)[N / 32][8]) {
#pragma unroll
  for (int i = 0; i < N / 32; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
}

// acc[i][j] += sum over the next `slabs` slabs' rows k of
// act[k][tile_pt(j)] * slab[k][tile_col(i)], k in order: act is a
// feature-major (rows x 64) block of shared memory, the slabs N columns
// wide. Every thread calls it (it holds the ring's barriers).
template <int N, int STAGES>
__device__ __forceinline__ void tile_product(float (&acc)[N / 32][8],
                                             Stream<STAGES>& s,
                                             const float* act, int slabs) {
  static_assert(N == 256 || N == 128 || N == 64, "product width");
  constexpr int RN = N / 32;
  const int to = threadIdx.x >> 3;
  const int tp = threadIdx.x & 7;
#pragma unroll 1
  for (int sl = 0; sl < slabs; ++sl) {
    const float* w = next_slab(s);
    const float* a = act + sl * KS * P + tp * 4;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      float wv[RN];
      if constexpr (RN >= 4) {
#pragma unroll
        for (int c = 0; c < RN / 4; ++c) {
          const float4 q = *(const float4*)(w + kk * N + c * 128 + to * 4);
          wv[4 * c + 0] = q.x;
          wv[4 * c + 1] = q.y;
          wv[4 * c + 2] = q.z;
          wv[4 * c + 3] = q.w;
        }
      } else {
        const float2 q = *(const float2*)(w + kk * N + to * 2);
        wv[0] = q.x;
        wv[1] = q.y;
      }
      const float4 a0 = *(const float4*)(a + kk * P);
      const float4 a1 = *(const float4*)(a + kk * P + 32);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int i = 0; i < RN; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[j], wv[i], acc[i][j]);
    }
  }
}

// the tile into a feature-major (N x 64) block of shared memory
template <int N>
__device__ __forceinline__ void store_act(float* buf,
                                          const float (&v)[N / 32][8]) {
  const int tp = threadIdx.x & 7;
#pragma unroll
  for (int i = 0; i < N / 32; ++i) {
    float* row = buf + tile_col<N>(i) * P + tp * 4;
    *(float4*)row = make_float4(v[i][0], v[i][1], v[i][2], v[i][3]);
    *(float4*)(row + 32) = make_float4(v[i][4], v[i][5], v[i][6], v[i][7]);
  }
}

// the tile into point-major rows of N floats (dst: the block's first
// point's row), 16 bytes (8 at N = 64) a store, streaming (evict-first:
// only the weight-gradient pass reads them back)
template <int N>
__device__ __forceinline__ void store_rows(float* __restrict__ dst,
                                           const float (&v)[N / 32][8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float* row = dst + (size_t)tile_pt(j) * N;
    if constexpr (N >= 128) {
#pragma unroll
      for (int c = 0; c < N / 128; ++c)
        __stcs((float4*)(row + tile_col<N>(4 * c)),
               make_float4(v[4 * c][j], v[4 * c + 1][j], v[4 * c + 2][j],
                           v[4 * c + 3][j]));
    } else {
      __stcs((float2*)(row + tile_col<N>(0)), make_float2(v[0][j], v[1][j]));
    }
  }
}

// bit 8 i + j: the tile's element (i, j) > 0 (a ReLU output's mask)
template <int N>
__device__ __forceinline__ uint64_t tile_mask(const float (&v)[N / 32][8]) {
  uint64_t m = 0;
#pragma unroll
  for (int i = 0; i < N / 32; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (v[i][j] > 0.0f) m |= 1ull << (8 * i + j);
  return m;
}

}  // namespace mlpf

// ---------------------------------------------------------------------
// The f32 kernels' host entries (csrc/mlp_f32.cu), called by the two MLP
// entry points (fused_mlp.cu, fused_mlp_bwd.cu) for dtype float32.

// the f32 weight image (ops/fused_mlp.py::f32_image), its part offsets
// (floats; fwd: W_l^T, bwd: W_l), the heads' packed weights and the biases
struct MlpF32Params {
  const float* image;
  int fwd[13];
  int bwd[13];
  const float* w9;   // sigma head (8, 256), row 0 live
  const float* w12;  // rgb head (8, 128), rows 0..2 live
  const float* b[13];
};

// kernel 3 in f32 over M points (xyz, out: (8, M) rows), encoding block EC
// (64, 128 or 192 columns, enc_cols(n_freqs))
int mlp_f32_forward(const float* xyz, const MlpF32Params& p, float* out,
                    int M, int n_freqs, int EC, cudaStream_t st);

// kernel 6 in f32: every chunk of M points through the main kernel and the
// weight-gradient pass into the zeroed per-split partials, then their sum
// into grads (the scratch, heads and partials as for bf16, in f32; er:
// enc_rows(n_freqs), the encoding block enc_cols_of(er))
int mlp_f32_backward(const float* xyz, const float* dout,
                     const MlpF32Params& p, float* dxyz, float* grads,
                     float* scratch, float* heads, float* partials, int M,
                     int chunk, int n_freqs, int er, cudaStream_t st);
