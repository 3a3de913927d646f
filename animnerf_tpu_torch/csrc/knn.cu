// Exact top-4 nearest vertices under packed int32 keys, for Hopper (sm_90a).
//
// Replaces: animnerf_tpu/ops/knn_pallas.py::_tournament_knn_kernel (the
// packed, k=4 path of knn_pallas), with its optional tile_skip.
//
// Contract: the packed keys of knn_keys.cuh (bit-identical to the TPU
// kernel and to the plain version in ops/knn_kernel.py). The 4 smallest
// keys are returned ascending as sqrt(bits(key & ~0x1FFF)) and key &
// 0x1FFF. Keys are unique (index bits), so ties go to the smaller index
// and the top-4 does not depend on the visiting order.
//
// Bound on the H100: operations. Each (point, vertex) pair costs 3 f32
// multiplies, 4 f32 adds, a max, two integer ops and a compare; bytes are
// negligible (12 B per point in, 32 B out, the vertices stay on chip).
// Design: one thread per query point, keeping its sorted top-4 keys in
// registers. The block stages the vertex rows as float4 (-2vx, -2vy, -2vz,
// |v|^2) in shared memory, TILE_V at a time, so the sweep reads one
// broadcast float4 per pair. The TPU's lane tournament and far skip are
// not carried over (the far skip is off on every path of the port).
//
// tile_skip (the Morton-compacted training step sets it): a point's
// squared distance to any vertex of tile t is at least lb2(t), the squared
// distance to the tile's AABB (vbox, from the Morton-sorted cloud). The
// deflated bound lb2 * (1 - 2^-8) - 1e-4, quantised like the keys,
// dominates the dot form's cancellation and the key quantisation (the
// bound of knn_pallas.py:423-427), so a tile whose bound key exceeds the
// point's current 4th-best key cannot change its top-4: skipping it is
// exact, and the output is bit-identical to tile_skip = 0. The test is
// per warp (__any_sync over "my bound <= my 4th best"): a warp sweeps a
// tile when any of its points still needs it, and the block stages a
// tile only when some warp needs it (__syncthreads_or). The block visits
// its nearest tile first (smallest summed lb2 over its points), as the
// TPU kernel does, so the 4th-best keys are tight before the first test.
// It pays only when a block's 256 points are spatially coherent, which is
// what the Morton compaction provides.

#include <cuda_runtime.h>
#include <stdint.h>

#include "knn_keys.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE_V = 1024;  // 16 KB of float4 per stage
constexpr int MAX_TILES = knn_keys::MAX_VERTS / TILE_V;
using knn_keys::BIGKEY;
using knn_keys::KEY_MASK;
constexpr unsigned FULL = 0xFFFFFFFFu;

// squared distance from p to the AABB (lo, hi)
__device__ __forceinline__ float box_lb2(const float* box, float px, float py,
                                         float pz) {
  const float gx = fmaxf(fmaxf(box[0] - px, px - box[3]), 0.0f);
  const float gy = fmaxf(fmaxf(box[1] - py, py - box[4]), 0.0f);
  const float gz = fmaxf(fmaxf(box[2] - pz, pz - box[5]), 0.0f);
  return gx * gx + gy * gy + gz * gz;
}

// TILE_SKIP is a template argument so that the plain sweep compiles to
// the same loop as without the option
template <bool TILE_SKIP>
__global__ void __launch_bounds__(THREADS)
knn_top4_kernel(const float* __restrict__ points,  // (B, N, 3)
                const float* __restrict__ verts,   // (B, V, 3)
                const float* __restrict__ vbox,    // (B, n_tiles, 8) or null
                float* __restrict__ out_d,         // (B, 4, N)
                int* __restrict__ out_i,           // (B, 4, N)
                unsigned long long* __restrict__ stats,  // [swept, skipped]
                int N, int V) {
  __shared__ float4 sv[TILE_V];
  __shared__ float s_box[MAX_TILES * 8];
  __shared__ float s_part[WARPS][MAX_TILES];
  __shared__ int s_order[MAX_TILES];
  const int b = blockIdx.y;
  const int n = blockIdx.x * THREADS + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool live = n < N;
  const float* p = points + ((size_t)b * N + (live ? n : 0)) * 3;
  const float px = p[0], py = p[1], pz = p[2];
  const float pp = knn_keys::point_pp(px, py, pz);
  int k0 = BIGKEY, k1 = BIGKEY, k2 = BIGKEY, k3 = BIGKEY;
  const float* vb = verts + (size_t)b * V * 3;
  const int n_tiles = (V + TILE_V - 1) / TILE_V;

  if (TILE_SKIP) {
    // visit order: ascending sum over the block's live points of lb2
    for (int i = threadIdx.x; i < n_tiles * 8; i += THREADS)
      s_box[i] = vbox[(size_t)b * n_tiles * 8 + i];
    __syncthreads();
    for (int t = 0; t < n_tiles; ++t) {
      float v = live ? box_lb2(s_box + 8 * t, px, py, pz) : 0.0f;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
      if (lane == 0) s_part[warp][t] = v;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float score[MAX_TILES];
      for (int t = 0; t < n_tiles; ++t) {
        float s = 0.0f;
        for (int q = 0; q < WARPS; ++q) s += s_part[q][t];
        score[t] = s;
      }
      bool taken[MAX_TILES];
      for (int t = 0; t < n_tiles; ++t) taken[t] = false;
      for (int i = 0; i < n_tiles; ++i) {  // selection sort, ties by index
        int best = -1;
        for (int t = 0; t < n_tiles; ++t)
          if (!taken[t] && (best < 0 || score[t] < score[best])) best = t;
        s_order[i] = best;
        taken[best] = true;
      }
    }
    __syncthreads();
  }

  for (int i = 0; i < n_tiles; ++i) {
    const int t = TILE_SKIP ? s_order[i] : i;
    const int base = t * TILE_V;
    const int cnt = min(TILE_V, V - base);
    bool warp_need = true;
    if (TILE_SKIP) {
      bool need = true;
      if (i > 0) {
        const float lb2 = box_lb2(s_box + 8 * t, px, py, pz);
        const float lb2s = fmaxf(lb2 * (1.0f - 0.00390625f) - 1e-4f, 0.0f);
        const int lb_key = __float_as_int(lb2s) & KEY_MASK;
        need = live && lb_key <= k3;
      }
      warp_need = __any_sync(FULL, need);
      if (stats != nullptr && lane == 0)
        atomicAdd(stats + (warp_need ? 0 : 1), 1ull);
    }
    // a barrier: the previous stage is fully consumed past this point
    if (TILE_SKIP) {
      if (!__syncthreads_or(warp_need)) continue;
    } else {
      __syncthreads();
    }
    for (int j = threadIdx.x; j < cnt; j += THREADS)
      sv[j] = knn_keys::vertex_row(vb + (size_t)(base + j) * 3);
    __syncthreads();
    if (!warp_need) continue;
    for (int j = 0; j < cnt; ++j) {
      const int key = knn_keys::packed_key(sv[j], px, py, pz, pp, base + j);
      if (key < k3) {  // sorted insert into k0 < k1 < k2 < k3
        if (key < k2) {
          k3 = k2;
          if (key < k1) {
            k2 = k1;
            if (key < k0) {
              k1 = k0;
              k0 = key;
            } else {
              k1 = key;
            }
          } else {
            k2 = key;
          }
        } else {
          k3 = key;
        }
      }
    }
  }
  if (!live) return;
  const int ks[4] = {k0, k1, k2, k3};
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const size_t o = ((size_t)b * 4 + s) * N + n;
    out_d[o] = knn_keys::key_dist(ks[s]);
    out_i[o] = knn_keys::key_index(ks[s]);
  }
}

}  // namespace

// vbox: (B, ceil(V / 1024), 8) f32 per-tile [lo xyz, hi xyz, 0, 0], read
// only when tile_skip != 0; stats: null, or two u64 counters of warp-tile
// visits [swept, skipped] that the kernel adds to.
extern "C" int animnerf_knn_top4(const void* points, const void* verts,
                                 const void* vbox, int tile_skip,
                                 void* stats, void* out_d, void* out_i,
                                 int B, int N, int V, void* stream) {
  if (V > MAX_TILES * TILE_V || (tile_skip && vbox == nullptr))
    return (int)cudaErrorInvalidValue;
  if (N > 0 && B > 0) {
    dim3 grid((N + THREADS - 1) / THREADS, B);
    if (tile_skip)
      knn_top4_kernel<true><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
          (const float*)points, (const float*)verts, (const float*)vbox,
          (float*)out_d, (int*)out_i, (unsigned long long*)stats, N, V);
    else
      knn_top4_kernel<false><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
          (const float*)points, (const float*)verts, nullptr, (float*)out_d,
          (int*)out_i, nullptr, N, V);
  }
  return (int)cudaGetLastError();
}
