// Top-k nearest vertices under packed int32 keys, any k in 1..V, for
// Hopper (sm_90a).
//
// Replaces: animnerf_tpu/ops/knn_pallas.py::_packed_knn_kernel (the packed
// path of knn_pallas when k != 4, or with tournament=False). Its all-far
// skip (far2 > 0) is knn_far.cu's pass, whose flags the sweep reads.
//
// Contract: the packed keys of knn_keys.cuh, bit-identical to the TPU
// kernel and to the plain version in ops/knn_kernel.py. The K smallest
// keys come out ascending as sqrt(bits(key & ~0x1FFF)) and key & 0x1FFF,
// V <= 8192. Keys are unique (index bits), so the TPU kernel's K
// extract-min passes per vertex tile and its bubble insert
// (knn_pallas.py:233-240) select the same K keys in the same order as any
// exact top-K; at K = 4 the output is bit-identical to knn.cu's.
//
// Bound on the H100: operations, the same as kernel 1's per (point,
// vertex) pair (6 non-FMA f32 operations); bytes are negligible (12 B per
// point in, 8K B out, the vertex rows stay on chip). Design: the shared
// sweep of knn_sweep.cuh over knn.cu's stratified rows (P points a thread,
// double-buffered staged rows, a filter in front of the key), with K a
// template argument (1..16) and the insert fully unrolled, so
// every index is a constant and nothing spills to local memory. No tile
// skip, as in the JAX package (its tile skip exists only on the k=4
// tournament path).
//
// Above 16 (ops/knn_kernel.py PACKED_WIDE_ABOVE; it was the faster on
// both shapes of chip_smoke.py's lines at k = 17, 24 and 32, where the
// instantiations K = 24 and 32 it replaced ran; the entry
// animnerf_knn_packed_wide takes any k, animnerf_knn_packed up to 16):
// knn_packed_wide, a warp a point on
// knn_wide.cuh. Since the keys are unique, any visiting order gives the
// same k smallest keys, and the kernel picks the one that tightens the
// k-th key at once:
// - Rows resident. V <= 8192, so a block stages every row of its batch
//   element (knn.cu's Morton tiles, rows bit-reversed inside a tile: 16 B
//   a row, 108 KB at V = 6890) and the tiles' boxes once and keeps them:
//   no barrier after the staging, one pass over L2 a block. Its warps take
//   points grid-stride (a point's far-skip flag is its group's).
// - Nearest tiles first. Lane t bounds the keys of tile t from below
//   (box_key_bound: the box distance less the dot form's rounding, which
//   is rigorous for any coordinates), one bitonic sort orders the tiles,
//   and the warp sweeps them in that order until a tile's bound exceeds
//   the point's k-th key: that tile and all after it hold no key below it.
// - Per pair, lane l taking rows l, l + 32, ... of the tile: row_dot and
//   one compare against filter_bound of the k-th key; a row-step where a
//   lane passes computes the key, and the lanes whose key is below the
//   k-th vote it into the warp's buffer (32R keys in shared memory). A
//   buffer that would overflow, and the buffer at a tile's end, is
//   bitonic-sorted and folded into the point's sorted list of 32R >= k
//   keys (R registers a lane), whose k-th key becomes the filter.
// The output is the plain version's, bit for bit: the keys are the same
// and the selection is exact (tests/test_torch_knn_wide.py holds the
// networks, the order, the bound and the skip against a model of them).
// R = 1, 2, 4 (k <= 32, 64, 128 = knn_wide::CAP); above the cap
// knn_packed_any takes k at run time: one thread a point, its k keys in
// its own column of the output, inserting by a shift in global memory
// (slow but exact; its time is in PERF.md).

#include <cuda_runtime.h>

#include "knn_sweep.cuh"
#include "knn_wide.cuh"

namespace {

constexpr int MAX_K = 16;  // every K up to here has its instantiation
// query points per thread: P x K keys and the P points stay in registers
// (above K = 8, P = 4 doubles the registers and was slower than P = 2)
template <int K>
constexpr int points_per_thread() {
  return K <= 8 ? 4 : 2;
}

// insert key (< top[K-1]) into the ascending, unique list top[0..K-1].
// K <= 4: shift the larger keys down one slot and stop at key's place, as
// knn.cu's nested compares do; with few slots the early stop is the
// cheaper form. K > 4: top[s] = min(top[s], max(top[s-1], key)), two
// integer ops per slot and no branch, so that a long list costs no
// divergent shifting loop. (Both forms were timed on the H100 for K = 4,
// 8 and 16 while choosing.) Every slot index is a constant: an early
// break out of the shift puts the list in local memory.
template <int K>
struct PackedInsert {
  static __device__ __forceinline__ void apply(int (&top)[K], int key) {
    if constexpr (K <= 4) {
      bool moving = true;  // the slots above key's place move down
#pragma unroll
      for (int s = K - 1; s > 0; --s) {
        if (moving && key < top[s - 1]) {
          top[s] = top[s - 1];
        } else if (moving) {
          top[s] = key;
          moving = false;
        }
      }
      if (moving) top[0] = key;
    } else {
#pragma unroll
      for (int s = K - 1; s > 0; --s)
        top[s] = min(top[s], max(top[s - 1], key));
      top[0] = min(top[0], key);
    }
  }
};

// launch the instantiation for k (1..MAX_K)
template <int K>
int launch(int k, const void* points, const void* rows, const void* index,
           const void* far, void* out_d, void* out_i, int B, int N, int V,
           int Vp, cudaStream_t stream) {
  if (k == K)
    return knn_sweep::launch<K, points_per_thread<K>(), false,
                             PackedInsert<K>>(points, rows, index, nullptr,
                                              nullptr, far, out_d, out_i, B,
                                              N, V, Vp, stream);
  if constexpr (K < MAX_K)
    return launch<K + 1>(k, points, rows, index, far, out_d, out_i, B, N, V,
                         Vp, stream);
  return (int)cudaErrorInvalidValue;
}

constexpr int WIDE_WARPS = 32;  // one block an SM holds the rows once
constexpr int WIDE_THREADS = 32 * WIDE_WARPS;
static_assert(knn_keys::MAX_VERTS / knn_sweep::TILE <= 32,
              "a lane orders one tile");

// dynamic shared memory of knn_packed_wide<R>: rows, tile boxes, buffers
__host__ __device__ constexpr size_t wide_smem(int Vp, int R) {
  return (size_t)Vp * sizeof(float4) +
         (size_t)(Vp / knn_sweep::TILE) * 8 * sizeof(float) +
         (size_t)WIDE_WARPS * 32 * R * sizeof(int);
}

// A lower bound, in key space, of every dot-form key of the vertices in a
// box (lo xyz, hi xyz) for the point p (|p|^2 = pp). The dot form's
// rounding moves d2 by at most gamma_7 (|p|^2 + 2|v.p| + |v|^2) <= 4.2e-7
// (|p| + |v|)^2 (seven roundings on the longest path, u = 2^-24); the box
// bound lb2, rounded (and contracted into FMAs) on the way, is within 6u
// of the true distance to the box. So lb2 (1 - 2^-18) - 5e-7 (|p| +
// vmax)^2, with vmax the largest |v| of the box's corners and both norms
// rounded up, is below every pair's dot-form d2: a key below it cannot
// come from the box. 0 where the bound is not positive.
__device__ __forceinline__ int box_key_bound(const float* box, float px,
                                             float py, float pz, float pp) {
  const float lb2 = knn_sweep::box_lb2(box, px, py, pz);
  float vv = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a)
    vv += fmaxf(box[a] * box[a], box[3 + a] * box[3 + a]);
  const float r = (sqrtf(pp) + sqrtf(vv)) * (1.0f + 0x1p-18f);
  const float lb = lb2 * (1.0f - 0x1p-18f) - 5e-7f * r * r;
  return lb > 0.0f ? __float_as_int(lb) & knn_keys::KEY_MASK : 0;
}

// fold the warp's buffer (cnt keys) into the sorted list top; the list's
// k-th key and its filter bound become the point's filter
template <int R>
__device__ __forceinline__ void fold_buffer(int (&top)[R], const int* buf,
                                            int& cnt, int& kth, float& t,
                                            float pp, int k) {
  int b[R];
  knn_wide::load_buffer<R>(b, buf, cnt, knn_keys::BIGKEY);
  knn_wide::sort_prefix<R>(b, cnt);
  knn_wide::fold<R>(top, b);
  kth = knn_wide::element<R>(top, k - 1);
  t = knn_sweep::filter_bound(kth, pp);
  cnt = 0;
}

// k <= 32R: a warp a point, the rows of batch element b in shared memory
// (see the note at the top). rows (B, Vp, 4) in Morton tiles (rows bit-
// reversed inside a tile), vbox (B, Vp / TILE, 8) their boxes. stats:
// null, or two u64 counters of real (point, vertex) pairs [swept,
// skipped]. grid (<= one wave, B).
template <int R>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
knn_packed_wide(const float* __restrict__ points,  // (B, N, 3)
                const float4* __restrict__ rows,   // (B, Vp, 4)
                const float* __restrict__ vbox,    // (B, Vp / TILE, 8)
                unsigned long long* __restrict__ stats,
                const int* __restrict__ far, float* __restrict__ out_d,
                int* __restrict__ out_i, int N, int V, int Vp, int k) {
  constexpr int NS = 32 * R;
  constexpr int TILE = knn_sweep::TILE;
  extern __shared__ __align__(16) float4 s_dyn[];
  const int nt = Vp / TILE;
  float4* s_rows = s_dyn;                   // (Vp,)
  float* s_box = (float*)(s_rows + Vp);     // (nt, 8)
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int* s_buf = (int*)(s_box + 8 * nt) + warp * NS;
  const int b = blockIdx.y;
  const float4* rb = rows + (size_t)b * Vp;
  for (int r = threadIdx.x; r < Vp; r += WIDE_THREADS)
    knn_sweep::cp_async16(s_rows + r, rb + r);
  for (int r = threadIdx.x; r < 2 * nt; r += WIDE_THREADS)
    knn_sweep::cp_async16(s_box + 4 * r, vbox + (size_t)b * nt * 8 + 4 * r);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  knn_sweep::cp_async_wait<0>();
  __syncthreads();

  const int groups = (N + knn_sweep::FAR_GROUP - 1) / knn_sweep::FAR_GROUP;
  unsigned long long swept = 0, skipped = 0;
  for (int n = blockIdx.x * WIDE_WARPS + warp; n < N;
       n += gridDim.x * WIDE_WARPS) {
    if (far != nullptr && far[(size_t)b * groups + n / knn_sweep::FAR_GROUP])
      continue;  // knn_far.cu wrote this group's outputs
    const float* q = points + ((size_t)b * N + n) * 3;
    const float x = q[0], y = q[1], z = q[2];
    const float pp = knn_keys::point_pp(x, y, z);
    // the tiles nearest first: lane t's key bound, ascending with the
    // tile in its low bits (the key's quantum is 2^13)
    int order = knn_keys::BIGKEY;
    if (lane < nt) order = box_key_bound(s_box + 8 * lane, x, y, z, pp) | lane;
    {
      int o[1] = {order};
      knn_wide::bitonic_sort<1>(o);
      order = o[0];
    }
    int top[R];
#pragma unroll
    for (int r = 0; r < R; ++r) top[r] = knn_keys::BIGKEY;
    int kth = knn_keys::BIGKEY, cnt = 0;
    float t = __int_as_float(0x7FC00000);  // NaN: every row passes
    int rows_swept = 0;
    for (int i = 0; i < nt; ++i) {
      const int o = __shfl_sync(knn_wide::FULL, order, i);
      // every key in this tile and the later ones exceeds the k-th
      if ((o & knn_keys::KEY_MASK) > kth) break;
      const int tile = o & 31;
      rows_swept += min(TILE, V - tile * TILE);
#pragma unroll 2
      for (int j = lane; j < TILE; j += 32) {
        const float s = knn_keys::row_dot(s_rows[tile * TILE + j], x, y, z);
        const bool c = !(s >= t);  // NaN s: take the exact path
        if (!__any_sync(knn_wide::FULL, c)) continue;
        const int key = knn_keys::key_of(
            pp, s, tile * TILE + (int)(__brev((unsigned)j) >> 24));
        bool take = c && key < kth;
        const unsigned m = __ballot_sync(knn_wide::FULL, take);
        if (m == 0) continue;
        if (cnt + __popc(m) > NS) {
          fold_buffer<R>(top, s_buf, cnt, kth, t, pp, k);
          take = take && key < kth;
        }
        cnt = knn_wide::append(s_buf, cnt, take, key);
      }
      if (cnt > 0) fold_buffer<R>(top, s_buf, cnt, kth, t, pp, k);
    }
    swept += rows_swept;
    skipped += V - rows_swept;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int e = lane + 32 * r;
      if (e >= k) continue;
      const size_t o = ((size_t)b * k + e) * N + n;
      out_d[o] = knn_keys::key_dist(top[r]);
      out_i[o] = knn_keys::key_index(top[r]);
    }
  }
  if (stats != nullptr && lane == 0) {
    atomicAdd(stats, swept);
    atomicAdd(stats + 1, skipped);
  }
}

template <int R>
int launch_wide(const void* points, const void* rows, const void* vbox,
                void* stats, const void* far, void* out_d, void* out_i, int B,
                int N, int V, int Vp, int k, cudaStream_t stream) {
  const size_t smem = wide_smem(Vp, R);
  cudaError_t err = cudaFuncSetAttribute(
      knn_packed_wide<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, knn_packed_wide<R>, WIDE_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  const int need = (N + WIDE_WARPS - 1) / WIDE_WARPS;
  const int wave = (sms * (per_sm > 0 ? per_sm : 1) + B - 1) / B;
  const dim3 grid(need < wave ? need : wave, B);
  knn_packed_wide<R><<<grid, WIDE_THREADS, smem, stream>>>(
      (const float*)points, (const float4*)rows, (const float*)vbox,
      (unsigned long long*)stats, (const int*)far, (float*)out_d,
      (int*)out_i, N, V, Vp, k);
  return (int)cudaGetLastError();
}

constexpr int ANY_THREADS = 128;

// any k: thread n keeps point n's k smallest keys ascending in out_i[b, s,
// n] (s < k), the k-th in a register; the block stages the rows a TILE at
// a time (every thread takes part in the staging, dead ones included)
__global__ void __launch_bounds__(ANY_THREADS)
knn_packed_any(const float* __restrict__ points,  // (B, N, 3)
               const float4* __restrict__ rows,   // (B, Vp, 4)
               const int* __restrict__ index,     // (Vp,)
               const int* __restrict__ far, float* __restrict__ out_d,
               int* __restrict__ out_i, int N, int Vp, int k) {
  static_assert(knn_sweep::FAR_GROUP % ANY_THREADS == 0,
                "a block's points lie in one far-skip group");
  const int b = blockIdx.y;
  if (far != nullptr &&
      far[(size_t)b * ((N + knn_sweep::FAR_GROUP - 1) /
                       knn_sweep::FAR_GROUP) +
          blockIdx.x * ANY_THREADS / knn_sweep::FAR_GROUP])
    return;  // knn_far.cu wrote this group's outputs
  __shared__ float4 s_rows[knn_sweep::TILE];
  __shared__ int s_idx[knn_sweep::TILE];
  const int n = blockIdx.x * ANY_THREADS + threadIdx.x;
  const bool live = n < N;
  const float* q = points + ((size_t)b * N + (live ? n : N - 1)) * 3;
  const float x = q[0], y = q[1], z = q[2];
  const float pp = knn_keys::point_pp(x, y, z);
  int* top = out_i + (size_t)b * k * N + n;  // slot s at top[s * N]
  if (live)
    for (int s = 0; s < k; ++s) top[(size_t)s * N] = knn_keys::BIGKEY;
  int kth = knn_keys::BIGKEY;
  const float4* rb = rows + (size_t)b * Vp;
  for (int t0 = 0; t0 < Vp; t0 += knn_sweep::TILE) {
    __syncthreads();  // the previous tile consumed
    for (int r = threadIdx.x; r < knn_sweep::TILE; r += ANY_THREADS) {
      s_rows[r] = rb[t0 + r];
      s_idx[r] = index[t0 + r];
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < knn_sweep::TILE; ++j) {
      const int key = knn_keys::key_of(
          pp, knn_keys::row_dot(s_rows[j], x, y, z), s_idx[j]);
      if (key >= kth) continue;
      int s = k - 1;  // shift the larger keys down one slot
      for (; s > 0; --s) {
        const int prev = top[(size_t)(s - 1) * N];
        if (prev < key) break;
        top[(size_t)s * N] = prev;
      }
      top[(size_t)s * N] = key;
      kth = top[(size_t)(k - 1) * N];
    }
  }
  if (!live) return;
  for (int s = 0; s < k; ++s) {
    const size_t o = ((size_t)b * k + s) * N + n;
    const int key = out_i[o];
    out_d[o] = knn_keys::key_dist(key);
    out_i[o] = knn_keys::key_index(key);
  }
}

}  // namespace

// rows, index: animnerf_knn_rows's for V vertices padded to Vp, in Morton
// tiles (stratified = 0) up to the cap, stratified above it (any order is
// exact; that one tightens knn_packed_any's k-th key early); vbox: the
// tiles' boxes (up to the cap); 1 <= k <= V; stats:
// null, or two u64 counters of real (point, vertex) pairs [swept,
// skipped] (k <= knn_wide::CAP); far: null, or the flags of
// animnerf_knn_far (which wrote the skipped groups' outputs). Any k on
// the warp-per-point kernel (k <= knn_wide::CAP), above it on
// knn_packed_any.
extern "C" int animnerf_knn_packed_wide(const void* points, const void* rows,
                                        const void* index, const void* vbox,
                                        void* stats, const void* far,
                                        void* out_d, void* out_i, int B,
                                        int N, int V, int Vp, int k,
                                        void* stream) {
  if (k < 1 || k > V || Vp < V || Vp % knn_sweep::TILE != 0 ||
      Vp > knn_keys::MAX_VERTS)
    return (int)cudaErrorInvalidValue;
  if (N == 0 || B == 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  if (k <= 32)
    return launch_wide<1>(points, rows, vbox, stats, far, out_d, out_i, B, N,
                          V, Vp, k, s);
  if (k <= 64)
    return launch_wide<2>(points, rows, vbox, stats, far, out_d, out_i, B, N,
                          V, Vp, k, s);
  if (k <= knn_wide::CAP)
    return launch_wide<4>(points, rows, vbox, stats, far, out_d, out_i, B, N,
                          V, Vp, k, s);
  const dim3 grid((N + ANY_THREADS - 1) / ANY_THREADS, B);
  knn_packed_any<<<grid, ANY_THREADS, 0, s>>>(
      (const float*)points, (const float4*)rows, (const int*)index,
      (const int*)far, (float*)out_d, (int*)out_i, N, Vp, k);
  return (int)cudaGetLastError();
}

// rows, index: animnerf_knn_rows's for V vertices padded to Vp, stratified
// (knn.cu); 1 <= k <= 16 (above: animnerf_knn_packed_wide); far: null, or
// the flags of animnerf_knn_far (which wrote the skipped groups' outputs)
extern "C" int animnerf_knn_packed(const void* points, const void* rows,
                                   const void* index, const void* far,
                                   void* out_d, void* out_i, int B, int N,
                                   int V, int Vp, int k, void* stream) {
  if (k < 1 || k > V || k > MAX_K) return (int)cudaErrorInvalidValue;
  return launch<1>(k, points, rows, index, far, out_d, out_i, B, N, V, Vp,
                   (cudaStream_t)stream);
}
