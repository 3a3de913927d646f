// The layer product of the fused NeRF MLP kernels on Hopper's wgmma.
//
// out (64 rows x N) += A (64 x K) . B^T, per consumer warpgroup, with both
// operands in shared memory and f32 accumulators in registers:
//   - A: the block's activations (or cotangents), ROWS = 128 rows, in the
//     canonical K-major layout with the 128-byte swizzle: 64-column blocks
//     of ROWS x 128 B, each 8-row group a 1024-B atom whose 16-byte chunks
//     are XOR-ed with the row (sw128). A warpgroup reads its 64 rows.
//   - B: a weight slab, NT (128 or 64) rows of the output by 64 columns of
//     the reduction, in the same layout (NT x 128 B). The host packs every
//     weight the kernel reads into exactly the byte image of its slabs
//     (ops/fused_mlp.py::image_offset), in order [row tile][64-column
//     block], so one 1-D cp.async.bulk stages a slab: no tensor map.
//   - a ring of STAGES slabs, each guarded by a "full" mbarrier (the bulk
//     copy's transaction bytes) and an "empty" one (one arrival per
//     consumer warp once its wgmma reads of the slab are done). One
//     producer thread walks the slabs in the order the consumers use them.
//   - an epilogue hook, for_each_pair, that hands each pair of accumulator
//     elements (columns c, c + 1 of one row) to a functor with its row and
//     column.
// Descriptors: start address >> 4, leading byte offset 16 B (unused by a
// swizzled K-major operand whose 16-column step fits in the 128-B row),
// stride byte offset 1024 B (8-row groups), swizzle mode 1 (128 B). A step
// of 16 columns inside a 64-column block adds 32 B to the start address;
// buffers are 1024-B aligned, so the swizzle phase (address bits 7..9)
// matches the layout.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mlpw {

constexpr int ROWS = 128;                   // activation rows of a block
constexpr int KBLOCK = 64;                  // columns of one swizzle row
constexpr int KB_BYTES = ROWS * 128;        // a 64-column block of A
constexpr int SLAB_BYTES = 128 * 128;       // the largest slab (NT = 128)
constexpr int STAGES = 3;
constexpr int CONSUMER_WARPS = 8;           // two consumer warpgroups

// byte offset of element (row, col) of a bf16 tile with `rows` rows
__host__ __device__ __forceinline__ uint32_t sw128(int row, int col,
                                                   int rows) {
  return (uint32_t)((col >> 6) * rows * 128 + row * 128 +
                    ((((col >> 3) & 7) ^ (row & 7)) << 4) + ((col & 7) << 1));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// ------------------------------------------------------------ barriers
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// generic-proxy shared-memory writes made visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier of one warpgroup (named barrier 1 + wg; 0 is __syncthreads)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// -------------------------------------------------------------- wgmma
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator accesses across a wait
template <int R>
__device__ __forceinline__ void fence_operand(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t da,
                                      uint64_t db) {
  if constexpr (N == 128)
    wgmma_n128(d, da, db);
  else
    wgmma_n64(d, da, db);
}

// ------------------------------------------------------------ the ring
struct Ring {
  uint32_t slabs;  // shared address of stage 0's slab
  uint32_t full;   // full[0]; full[s] at + 8 s
  uint32_t empty;  // empty[0]
  int stage;
  uint32_t phase;
  __device__ __forceinline__ uint32_t slab() const {
    return slabs + stage * SLAB_BYTES;
  }
  __device__ __forceinline__ void advance() {
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1u;
    }
  }
};

// thread 0: full[s] expects one arrival (the producer's, with the bytes),
// empty[s] one per consumer warp
__device__ __forceinline__ void ring_init(const Ring& r) {
#pragma unroll
  for (int s = 0; s < STAGES; ++s) {
    mbar_init(r.full + 8 * s, 1);
    mbar_init(r.empty + 8 * s, CONSUMER_WARPS);
  }
  mbar_init_fence();
}

// producer: stage `bytes` of device memory into the next slab
__device__ __forceinline__ void produce(Ring& r, const void* src,
                                        uint32_t bytes) {
  mbar_wait(r.empty + 8 * r.stage, r.phase ^ 1u);
  mbar_expect_tx(r.full + 8 * r.stage, bytes);
  bulk_copy(r.slab(), src, bytes, r.full + 8 * r.stage);
  r.advance();
}

// producer: the slabs of one (R x C) weight image, row tiles of NT =
// min(R, 128) rows; with img2 (an (R x C2) image) each row tile's slabs of
// img2 follow its own (a split product into the same accumulators)
__device__ __forceinline__ void produce_product(Ring& r,
                                                const __nv_bfloat16* img,
                                                int R, int C,
                                                const __nv_bfloat16* img2,
                                                int C2) {
  const int NT = R < 128 ? R : 128;
  for (int nt = 0; nt < R / NT; ++nt) {
    for (int kb = 0; kb < C / KBLOCK; ++kb)
      produce(r, img + ((size_t)nt * (C / KBLOCK) + kb) * NT * KBLOCK,
              NT * 128);
    if (img2 != nullptr)
      for (int kb = 0; kb < C2 / KBLOCK; ++kb)
        produce(r, img2 + ((size_t)nt * (C2 / KBLOCK) + kb) * NT * KBLOCK,
                NT * 128);
  }
}

__device__ __forceinline__ void release(const Ring& r, int stage) {
  if ((threadIdx.x & 31) == 0) mbar_arrive(r.empty + 8 * stage);
}

// consumer warpgroup: acc (64 x N) = A . slab^T over kb 64-column blocks
// of A at shared address a (the warpgroup's first row, blocks KB_BYTES
// apart), then kb2 blocks of a2, one slab each. The next slab's products
// are issued before the previous one's are awaited and released. hook(s)
// runs after slab s's products are issued and the slab before released,
// while they are in flight (work that needs no tensor core, e.g. storing a
// part of the previous layer's output).
template <int N, class Hook>
__device__ __forceinline__ void tile_mma(float (&acc)[N / 2], Ring& r,
                                         uint32_t a, int kb, uint32_t a2,
                                         int kb2, const Hook& hook) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
  fence_operand(acc);
  int prev = -1;
  for (int s = 0; s < kb + kb2; ++s) {
    const uint32_t ab = s < kb ? a + s * KB_BYTES : a2 + (s - kb) * KB_BYTES;
    mbar_wait(r.full + 8 * r.stage, r.phase);
    const uint32_t b = r.slab();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KBLOCK / 16; ++kk)
      wgmma<N>(acc, desc_sw128(ab + kk * 32), desc_sw128(b + kk * 32));
    wgmma_commit();
    if (prev >= 0) {
      wgmma_wait<1>();
      release(r, prev);
    }
    hook(s);
    prev = r.stage;
    r.advance();
  }
  wgmma_wait<0>();
  fence_operand(acc);
  release(r, prev);
}

// the thread's accumulator rows: pair_row() and pair_row() + 8 (from the
// warpgroup's first row); its columns: 8 q + pair_col() for q < N / 8
__device__ __forceinline__ int pair_row() {
  return ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2);
}
__device__ __forceinline__ int pair_col() { return (threadIdx.x & 3) * 2; }

// epilogue hook: f(row, col, q, h, acc[row][col], acc[row][col + 1]) for
// every even column of the thread's two rows (h = 0, 1: row pair_row() +
// 8 h); rows from row0 (the warpgroup's first), columns from col0; q (the
// 8-column group) and h are compile-time after unrolling, so values the
// epilogue loaded beforehand can be indexed by them
template <int N, class F>
__device__ __forceinline__ void for_each_pair(const float (&acc)[N / 2],
                                              int row0, int col0, F&& f) {
  const int r = row0 + pair_row();
#pragma unroll
  for (int q = 0; q < N / 8; ++q) {
    const int c = col0 + 8 * q + pair_col();
    f(r, c, q, 0, acc[4 * q], acc[4 * q + 1]);
    f(r + 8, c, q, 1, acc[4 * q + 2], acc[4 * q + 3]);
  }
}

}  // namespace mlpw
