// The all-far skip of the kNN kernels (far2 > 0), for Hopper (sm_90a): the
// far pass that decides which groups of query points skip the sweep and
// writes their outputs.
//
// Replaces: the far2 > 0 branches of animnerf_tpu/ops/knn_pallas.py's
// _knn_kernel (:69-81, :126-135), _packed_knn_kernel (:206-216, :246-257)
// and _tournament_knn_kernel (:336-345, :437-445), at knn_pallas's default
// tile_n = 1024 and tile_v = 512.
//
// Contract (bit-identical to far_groups_plain and the plain kNN versions
// in ops/knn_kernel.py, and to the TPU kernels' separately rounded bound):
// - groups: point n of batch element b belongs to group n / 1024; the last
//   group is padded to 1024 points with points at (0, 0, 0), which take
//   part in its minimum, as knn_pallas's zero padding of N does;
// - boxes: [lo xyz, hi xyz] of the real vertices of each 512-vertex tile
//   (knn_exact.cu's rows kernel writes them: tbox);
// - per point and tile, per axis gap = max(max(lo - p, p - hi), 0) and
//   lb2 = ((0 + gx*gx) + gy*gy) + gz*gz, every operation rounded on its
//   own; g_lb2 = the minimum of lb2 over the tiles;
// - a group skips when the minimum of g_lb2 over its 1024 points exceeds
//   far2 (float32(thr^2), rounded once from the double square);
// - a skipped point's outputs: exact (kernel 9), sqrt(g_lb2) in every slot;
//   packed (kernels 1 and 8), sqrt of the key ((bits(g_lb2) & ~0x1FFF) +
//   0x2000) & ~0x1FFF read as a float (the bound rounded up one key
//   quantum); index 0 everywhere.
// The sweeps (knn_sweep.cuh, knn_exact.cu) read the flags this pass writes
// and return at once from a block whose points lie in a skipped group:
// their blocks hold 128 to 512 points, which divide 1024, so a block (and
// so a warp) never straddles two groups.
//
// Bound on the H100: operations, 18 non-FMA f32 operations per (point,
// tile) pair (two subtractions, two maxima and a clamp a gap, three
// multiplies, two adds and the minimum); bytes: 12 B a point in, the flags,
// and a skipped point's k slots out. Design: one block a group (256
// threads, 4 points a thread, coalesced), the tile boxes staged in shared
// memory in chunks, a block minimum by warp shuffles, then the skipped
// group's outputs from the same block.

#include <cuda_runtime.h>
#include <math.h>

#include "knn_keys.cuh"

namespace {

constexpr int GROUP = 1024;  // knn_pallas's tile_n
constexpr int THREADS = 256;
constexpr int PTS = GROUP / THREADS;
constexpr int BOX_CHUNK = 256;  // tile boxes staged at a time (6 KB)
constexpr unsigned FULL = 0xFFFFFFFFu;

// squared distance from p to the box [lo xyz, hi xyz] as the TPU kernels
// round it: every subtraction, product and sum on its own
__device__ __forceinline__ float far_lb2(const float* box, float px,
                                         float py, float pz) {
  const float gx =
      fmaxf(fmaxf(__fsub_rn(box[0], px), __fsub_rn(px, box[3])), 0.0f);
  const float gy =
      fmaxf(fmaxf(__fsub_rn(box[1], py), __fsub_rn(py, box[4])), 0.0f);
  const float gz =
      fmaxf(fmaxf(__fsub_rn(box[2], pz), __fsub_rn(pz, box[5])), 0.0f);
  return __fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)),
                   __fmul_rn(gz, gz));
}

// grid (G, B), THREADS threads: group g of batch element b
__global__ void __launch_bounds__(THREADS)
knn_far_kernel(const float* __restrict__ points,  // (B, N, 3)
               const float* __restrict__ tbox,    // (B, n_tiles, 8)
               float* __restrict__ out_d,         // (B, k, N)
               int* __restrict__ out_i,           // (B, k, N)
               int* __restrict__ flags,           // (B, G)
               unsigned long long* __restrict__ stats, int N, int n_tiles,
               float far2, int k, int packed) {
  __shared__ float s_box[BOX_CHUNK * 6];
  __shared__ float s_min[THREADS / 32];
  __shared__ int s_skip;
  const int b = blockIdx.y;
  const int g = blockIdx.x;
  const int G = gridDim.x;
  float px[PTS], py[PTS], pz[PTS], lb[PTS];
#pragma unroll
  for (int j = 0; j < PTS; ++j) {
    const int n = g * GROUP + j * THREADS + threadIdx.x;
    const bool real = n < N;
    const float* q = points + ((size_t)b * N + (real ? n : 0)) * 3;
    px[j] = real ? q[0] : 0.0f;  // knn_pallas pads N with zero points
    py[j] = real ? q[1] : 0.0f;
    pz[j] = real ? q[2] : 0.0f;
    lb[j] = INFINITY;
  }
  const float* tb = tbox + (size_t)b * n_tiles * 8;
  for (int c0 = 0; c0 < n_tiles; c0 += BOX_CHUNK) {
    const int nc = min(BOX_CHUNK, n_tiles - c0);
    __syncthreads();  // the previous chunk is consumed
    for (int i = threadIdx.x; i < nc * 6; i += THREADS)
      s_box[i] = tb[(size_t)(c0 + i / 6) * 8 + i % 6];
    __syncthreads();
    for (int t = 0; t < nc; ++t) {
#pragma unroll
      for (int j = 0; j < PTS; ++j)
        lb[j] = fminf(lb[j], far_lb2(s_box + 6 * t, px[j], py[j], pz[j]));
    }
  }
  float m = lb[0];
#pragma unroll
  for (int j = 1; j < PTS; ++j) m = fminf(m, lb[j]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fminf(m, __shfl_xor_sync(FULL, m, o));
  if ((threadIdx.x & 31) == 0) s_min[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float gm = s_min[0];
    for (int w = 1; w < THREADS / 32; ++w) gm = fminf(gm, s_min[w]);
    const int skip = gm > far2;
    flags[(size_t)b * G + g] = skip;
    s_skip = skip;
    if (stats != nullptr) {
      atomicAdd(stats, 1ull);
      if (skip) atomicAdd(stats + 1, 1ull);
    }
  }
  __syncthreads();
  if (!s_skip) return;
#pragma unroll
  for (int j = 0; j < PTS; ++j) {
    const int n = g * GROUP + j * THREADS + threadIdx.x;
    if (n >= N) continue;
    float d;
    if (packed) {
      const int key = ((__float_as_int(lb[j]) & knn_keys::KEY_MASK) + 0x2000) &
                      knn_keys::KEY_MASK;
      d = knn_keys::key_dist(key);
    } else {
      d = sqrtf(lb[j]);
    }
    for (int s = 0; s < k; ++s) {
      const size_t o = ((size_t)b * k + s) * N + n;
      out_d[o] = d;
      out_i[o] = 0;
    }
  }
}

}  // namespace

// points (B, N, 3); tbox (B, n_tiles, 8) from animnerf_knn_exact_rows;
// far2 > 0; k the output slots; packed: the packed kernels' outputs (else
// the exact kernel's). Writes flags (B, ceil(N / 1024)) int32 (1: the
// group skips) and, for the points of skipped groups only, out_d / out_i
// (B, k, N); stats: null, or two u64 counters [groups, skipped] it adds to.
extern "C" int animnerf_knn_far(const void* points, const void* tbox,
                                void* flags, void* stats, void* out_d,
                                void* out_i, int B, int N, int n_tiles,
                                float far2, int k, int packed, void* stream) {
  if (n_tiles < 1 || k < 1 || !(far2 > 0.0f))
    return (int)cudaErrorInvalidValue;
  if (N > 0 && B > 0) {
    const dim3 grid((N + GROUP - 1) / GROUP, B);
    knn_far_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)points, (const float*)tbox, (float*)out_d, (int*)out_i,
        (int*)flags, (unsigned long long*)stats, N, n_tiles, far2, k,
        packed);
  }
  return (int)cudaGetLastError();
}
