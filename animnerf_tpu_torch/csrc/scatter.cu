// Weighted row scatter (the warp-blend backward), for Hopper (sm_90a).
//
// Replaces: animnerf_tpu/ops/blend.py::_scatter_kernel (reached through
// weighted_scatter_rows_pallas with transposed_in=True, g_t=True).
//
//   out[b, idx[b, k, n], c] += w[b, k, n] * g[b, c, n]     c < 16, k < K
//
// idx / w (B, K, N) as the kNN and warp-blend kernels emit them (K =
// k_neigh, 1..16), g (B, 16, N) rows-native cotangents, out (B, V, 16) f32.
//
// Order of the sums. The TPU kernel keeps a VMEM-resident (Vp, 16)
// accumulator across a sequential point grid, so its sums are taken in a
// fixed order. Blocks of a GPU run in parallel and in no order, and f32
// atomics would land in a run-dependent order. So each row (b, v) is the
// in-order fold s = __fadd_rn(s, __fmul_rn(w, g)) over its live entries
// in (key, e) order, key = b * V + idx, e = (b * K + k) * N + n: the order
// a stable sort of the keys gives, which the plain version
// (ops/blend.py::weighted_scatter_rows_plain) also sums in. An entry whose
// weight is 0 (a gated-off neighbour) or whose point's cotangent column is
// all 0 (a padded point) adds an exact zero and is left out.
//
// Bound on the H100: bytes. idx, w and g are read once and the table is
// written once (0.017 ms at (16, 4, 32768) -> (16, 6890, 16)). Design,
// every step a kernel of this file, no float atomics, no library call:
//  1. scatter_prep_kernel, one thread a point, coalesced along N: reads
//     the point's 16 cotangents once, writes them as one 64 B line of
//     gT (B, N, 16), decides liveness and writes its K keys (-1 dead).
//  2. A stable LSD radix sort of the live keys over ceil(log2(B V) / 9)
//     digits of 9 bits (two passes up to B V = 2^18: 110,240 rows at
//     B = 16, V = 6890). A pass is three kernels over tiles of 4096
//     entries: scatter_hist_kernel (the tile's digit counts, shared
//     integer atomics: exact, order-free), scatter_digit_scan_kernel (a
//     block a digit: the exclusive scan of its counts over the tiles, the
//     digit's total) and scatter_place_kernel, which places each entry at
//     digit base + tile offset + its rank among the tile's earlier entries
//     of that digit: rounds of 256 entries in order, the rank within a
//     warp from __match_any_sync, across warps from per-warp counts in
//     shared memory. Positions are computed, never raced for, so the
//     order is the stable one whatever order blocks run in. (Staging the
//     tile grouped by digit, to write each digit's run coalesced, measured
//     faster on uniform keys and slower on a training step's clustered
//     ones, which the plain stores already write in runs.) The first pass
//     drops the dead entries and turns e into (n, w), 8 B an entry.
//  3. scatter_bounds_kernel: each row's [begin, end) from the sorted keys.
//  4. scatter_sum_kernel: a warp a row. The rows are long where many
//     points share a neighbour: in a training step the median live entry
//     lies in a row of ~240 entries, the longest rows hold 4,000-7,000,
//     and 67-80% of the rows are empty. The fold is serial, so the loads
//     must not be: a chunk of 128 entries is loaded by the whole warp
//     (each lane four entries' (n, w), 8 B, and their 64 B gT lines as
//     float4s), their products __fmul_rn(w, g) are staged in shared
//     memory, and lane c < 16 folds channel c in entry order while the
//     next chunk's loads are in flight. Every row is written, zero rows
//     included.
// The result is bit-equal from run to run and to the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int F = 16;
constexpr int MAX_K = 16;
constexpr int RADIX_BITS = 9;
constexpr int RADIX = 1 << RADIX_BITS;
constexpr int THREADS = 256;              // every kernel's block
constexpr int WARPS = THREADS / 32;
constexpr int ROUNDS = 16;                // rounds of THREADS entries a tile
constexpr int TILE = THREADS * ROUNDS;    // entries a radix tile
constexpr int SUM_THREADS = 256;          // a warp a row
constexpr int SUM_WARPS = SUM_THREADS / 32;
constexpr int SUM_PER_LANE = 2;           // entries a lane loads a chunk
constexpr int SUM_CHUNK = 32 * SUM_PER_LANE;
constexpr int SUM_STRIDE = F + 1;         // staged product row, padded
constexpr int SUM_FOLD = 16;              // staged products read at once
static_assert(SUM_CHUNK % SUM_FOLD == 0, "a fold batch stays in the chunk");
static_assert(RADIX == 2 * THREADS, "the digit-base scan takes 2 a thread");

struct Plan {
  long long M;      // entries B * K * N
  long long tiles;  // radix tiles ceil(M / TILE)
  long long rows;   // B * V
  int passes;       // 9-bit digits of the largest key
  // workspace offsets, in 4-byte words (each a multiple of 4: 16 B)
  long long keys0, keys, nw, gT, hist, dtot, live, bounds, words;
};

long long up4(long long x) { return (x + 3) & ~3LL; }

Plan make_plan(int B, int N, int V, int K) {
  Plan p;
  p.M = (long long)B * K * N;
  p.tiles = (p.M + TILE - 1) / TILE;
  p.rows = (long long)B * V;
  int bits = 0;
  while ((1LL << bits) < p.rows) ++bits;
  p.passes = bits <= RADIX_BITS ? 1 : (bits + RADIX_BITS - 1) / RADIX_BITS;
  long long o = 0;
  p.keys0 = o; o = up4(o + p.M);               // prep's keys, -1 dead
  p.keys = o;  o = up4(o + 2 * p.M);           // pass outputs (ping-pong)
  p.nw = o;    o = up4(o + 4 * p.M);           // (n, w) pairs, ping-pong
  p.gT = o;    o = up4(o + (long long)B * N * F);
  p.hist = o;  o = up4(o + RADIX * p.tiles);
  p.dtot = o;  o = up4(o + (long long)RADIX * p.passes);
  p.live = o;  o = up4(o + 1);               // live entries
  p.bounds = o; o = up4(o + 2 * p.rows);       // begin, end per row
  p.words = o;
  return p;
}

// exclusive scan of one int a thread over the block; *total gets the sum.
// Every thread of the block must call it.
__device__ __forceinline__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int s = lane < WARPS ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < WARPS; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += t;
    }
    if (lane < WARPS) warp_sums[lane] = s;
  }
  __syncthreads();
  const int before = warp > 0 ? warp_sums[warp - 1] : 0;
  *total = warp_sums[WARPS - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return before + incl - v;
}

// 1. one thread a point (b, n): gT line, liveness, the K keys
__global__ void __launch_bounds__(THREADS)
scatter_prep_kernel(const int* __restrict__ idx, const float* __restrict__ w,
                    const float* __restrict__ g, float* __restrict__ gT,
                    int* __restrict__ keys0, int N, int V, int K) {
  const int b = blockIdx.y;
  const int n = blockIdx.x * THREADS + threadIdx.x;
  if (n >= N) return;
  const float* gc = g + (size_t)b * F * N + n;
  float v[F];
  bool any = false;
#pragma unroll
  for (int c = 0; c < F; ++c) {
    v[c] = gc[(size_t)c * N];
    any |= v[c] != 0.0f;  // NaN counts as nonzero, as in the plain version
  }
  float4* dst = reinterpret_cast<float4*>(gT + ((size_t)b * N + n) * F);
#pragma unroll
  for (int q = 0; q < F / 4; ++q)
    dst[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  for (int k = 0; k < K; ++k) {
    const size_t e = ((size_t)b * K + k) * N + n;
    keys0[e] = any && w[e] != 0.0f ? b * V + idx[e] : -1;
  }
}

// entries a pass sorts: every entry in the first, the live ones after
__device__ __forceinline__ long long pass_count(int pass, long long M,
                                                const int* live) {
  return pass == 0 ? M : (long long)*live;
}

// 2a. the tile's digit counts -> hist[digit * tiles + tile]
__global__ void __launch_bounds__(THREADS)
scatter_hist_kernel(const int* __restrict__ keys, int* __restrict__ hist,
                    const int* __restrict__ live, long long M, int tiles,
                    int pass) {
  __shared__ int h[RADIX];
  for (int d = threadIdx.x; d < RADIX; d += THREADS) h[d] = 0;
  __syncthreads();
  const long long count = pass_count(pass, M, live);
  const long long base = (long long)blockIdx.x * TILE;
  const int shift = pass * RADIX_BITS;
#pragma unroll 4
  for (int r = 0; r < ROUNDS; ++r) {
    const long long i = base + r * THREADS + threadIdx.x;
    if (i < count) {
      const int key = keys[i];
      if (key >= 0) atomicAdd(&h[(key >> shift) & (RADIX - 1)], 1);
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < RADIX; d += THREADS)
    hist[(size_t)d * tiles + blockIdx.x] = h[d];
}

// 2b. a block a digit: exclusive scan of its tile counts, its total (the
// first pass's totals also sum to the live count)
__global__ void __launch_bounds__(THREADS)
scatter_digit_scan_kernel(int* __restrict__ hist, int* __restrict__ dtot,
                          int* __restrict__ live, int tiles, int pass) {
  int* row = hist + (size_t)blockIdx.x * tiles;
  int carry = 0;
  for (int t0 = 0; t0 < tiles; t0 += THREADS) {
    const int t = t0 + threadIdx.x;
    const int v = t < tiles ? row[t] : 0;
    int total;
    const int ex = block_exclusive_scan(v, &total);
    if (t < tiles) row[t] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) {
    dtot[blockIdx.x] = carry;
    if (pass == 0) atomicAdd(live, carry);
  }
}

// 2c. stable placement of the tile's entries (see the note at the top)
__global__ void __launch_bounds__(THREADS)
scatter_place_kernel(const int* __restrict__ keys_in,
                     const int2* __restrict__ nw_in,  // pass > 0
                     const float* __restrict__ w,     // pass 0
                     const int* __restrict__ hist,
                     const int* __restrict__ dtot,
                     const int* __restrict__ live, int* __restrict__ keys_out,
                     int2* __restrict__ nw_out, long long M, int tiles,
                     int pass, int N) {
  __shared__ int off[RADIX];
  __shared__ int whist[WARPS][RADIX];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the digit bases (exclusive scan of the pass's digit totals), plus the
  // tile's offset within each digit
  {
    const int d0 = 2 * tid;
    const int a = dtot[d0], c = dtot[d0 + 1];
    int total;
    const int ex = block_exclusive_scan(a + c, &total);
    off[d0] = ex + hist[(size_t)d0 * tiles + blockIdx.x];
    off[d0 + 1] = ex + a + hist[(size_t)(d0 + 1) * tiles + blockIdx.x];
  }
  for (int d = tid; d < WARPS * RADIX; d += THREADS) (&whist[0][0])[d] = 0;
  const long long count = pass_count(pass, M, live);
  const long long base = (long long)blockIdx.x * TILE;
  const int shift = pass * RADIX_BITS;
  const unsigned lt = (1u << lane) - 1u;
  // the tile's keys and (n, w) first, so that no round waits on memory
  int key[ROUNDS];
  int2 val[ROUNDS];
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const long long i = base + r * THREADS + tid;
    key[r] = i < count ? keys_in[i] : -1;
    if (pass == 0)
      val[r] = key[r] >= 0 ? make_int2((int)i % N, __float_as_int(w[i]))
                           : make_int2(0, 0);
    else
      val[r] = i < count ? nw_in[i] : make_int2(0, 0);
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    if (base + r * THREADS >= count) continue;  // uniform across the block
    const int d = key[r] >= 0 ? (key[r] >> shift) & (RADIX - 1) : RADIX;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int rank = __popc(peers & lt);
    if (d < RADIX && rank == 0) whist[warp][d] = __popc(peers);
    __syncthreads();
    int pos = 0;
    if (d < RADIX) {
      pos = off[d] + rank;
      for (int v = 0; v < warp; ++v) pos += whist[v][d];
    }
    __syncthreads();
    for (int dd = tid; dd < RADIX; dd += THREADS) {
      int s = 0;
#pragma unroll
      for (int v = 0; v < WARPS; ++v) {
        s += whist[v][dd];
        whist[v][dd] = 0;
      }
      off[dd] += s;
    }
    __syncthreads();
    if (d < RADIX) {
      keys_out[pos] = key[r];
      nw_out[pos] = val[r];
    }
  }
}

// 3. each row's [begin, end) among the sorted keys (rows without entries
// keep the zeros they were cleared to)
__global__ void __launch_bounds__(THREADS)
scatter_bounds_kernel(const int* __restrict__ keys,
                      const int* __restrict__ live, int* __restrict__ begin,
                      int* __restrict__ end) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long L = *live;
  if (i >= L) return;
  const int key = keys[i];
  if (i == 0 || keys[i - 1] != key) begin[key] = (int)i;
  if (i == L - 1 || keys[i + 1] != key) end[key] = (int)(i + 1);
}

// 4. a warp a row: chunks of SUM_CHUNK entries, each lane loading
// SUM_PER_LANE entries' (n, w) and gT lines and staging their products in
// shared memory; lane c < 16 then folds channel c in entry order while the
// next chunk's lines and the (n, w) of the one after are in flight
__global__ void __launch_bounds__(SUM_THREADS, 4)
scatter_sum_kernel(const int2* __restrict__ nw, const float* __restrict__ gT,
                   const int* __restrict__ begin,
                   const int* __restrict__ end, float* __restrict__ out,
                   long long rows, int N, int V) {
  __shared__ float prod[SUM_WARPS][SUM_CHUNK * SUM_STRIDE];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row = (long long)blockIdx.x * SUM_WARPS + warp;
  if (row >= rows) return;  // the whole warp
  const float* gb = gT + (size_t)(row / V) * N * F;
  float* sp = prod[warp];
  const int j0 = begin[row], j1 = end[row];
  // the chunk in flight: its entries' (n, w) and gT lines; and the (n, w)
  // of the chunk after it (no lambdas: arrays stay in registers)
  int2 e[SUM_PER_LANE], e_next[SUM_PER_LANE];
  float4 v[SUM_PER_LANE][F / 4];
#pragma unroll
  for (int h = 0; h < SUM_PER_LANE; ++h) {
    const int jj = j0 + h * 32 + lane, jn = jj + SUM_CHUNK;
    e[h] = jj < j1 ? nw[jj] : make_int2(0, 0);
    e_next[h] = jn < j1 ? nw[jn] : make_int2(0, 0);
  }
#pragma unroll
  for (int h = 0; h < SUM_PER_LANE; ++h) {
    const float4* src =
        reinterpret_cast<const float4*>(gb + (size_t)e[h].x * F);
#pragma unroll
    for (int q = 0; q < F / 4; ++q)
      v[h][q] = j0 < j1 ? src[q] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  float s = 0.0f;  // lane c < 16: channel c
  for (int j = j0; j < j1; j += SUM_CHUNK) {
#pragma unroll
    for (int h = 0; h < SUM_PER_LANE; ++h) {
      const float wv = __int_as_float(e[h].y);
      float* dst = sp + (h * 32 + lane) * SUM_STRIDE;
#pragma unroll
      for (int q = 0; q < F / 4; ++q) {
        dst[4 * q] = __fmul_rn(wv, v[h][q].x);
        dst[4 * q + 1] = __fmul_rn(wv, v[h][q].y);
        dst[4 * q + 2] = __fmul_rn(wv, v[h][q].z);
        dst[4 * q + 3] = __fmul_rn(wv, v[h][q].w);
      }
    }
    __syncwarp();
    if (j + SUM_CHUNK < j1) {
#pragma unroll
      for (int h = 0; h < SUM_PER_LANE; ++h) {
        e[h] = e_next[h];
        const int jn = j + 2 * SUM_CHUNK + h * 32 + lane;
        e_next[h] = jn < j1 ? nw[jn] : make_int2(0, 0);
        const float4* src =
            reinterpret_cast<const float4*>(gb + (size_t)e[h].x * F);
#pragma unroll
        for (int q = 0; q < F / 4; ++q) v[h][q] = src[q];
      }
    }
    if (lane < F) {
      const int cnt = min(SUM_CHUNK, j1 - j);
      for (int u0 = 0; u0 < cnt; u0 += SUM_FOLD) {
        float t[SUM_FOLD];  // loads first, then the adds in order
#pragma unroll
        for (int i = 0; i < SUM_FOLD; ++i)
          t[i] = sp[(u0 + i) * SUM_STRIDE + lane];
#pragma unroll
        for (int i = 0; i < SUM_FOLD; ++i)
          if (u0 + i < cnt) s = __fadd_rn(s, t[i]);
      }
    }
    __syncwarp();
  }
  if (lane < F) out[row * F + lane] = s;
}

}  // namespace

// idx (B, k, N) int32, w (B, k, N) f32, g (B, 16, N) f32 -> out (B, V, 16)
// f32; ws: scratch of ws_words 4-byte words, 16-byte aligned (the
// wrapper sizes it by ops/blend.py::scatter_workspace_words, which mirrors
// make_plan; a smaller one is refused).
extern "C" int animnerf_weighted_scatter(const void* idx, const void* w,
                                         const void* g, void* out, void* ws,
                                         int ws_words, int B, int N,
                                         int V, int k, void* stream) {
  if (k < 1 || k > MAX_K || B < 1 || N < 1 || V < 1)
    return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(B, N, V, k);
  if (p.M >= (1LL << 31) || p.rows >= (1LL << 31) ||
      (long long)ws_words < p.words)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int* wsi = (int*)ws;
  int* keys0 = wsi + p.keys0;
  int* keys[2] = {wsi + p.keys, wsi + p.keys + p.M};
  int2* nw[2] = {(int2*)(wsi + p.nw), (int2*)(wsi + p.nw) + p.M};
  float* gT = (float*)(wsi + p.gT);
  int* hist = wsi + p.hist;
  int* live = wsi + p.live;
  int* begin = wsi + p.bounds;
  int* end = begin + p.rows;
  cudaMemsetAsync(live, 0, sizeof(int), s);
  cudaMemsetAsync(begin, 0, 2 * p.rows * sizeof(int), s);
  scatter_prep_kernel<<<dim3((N + THREADS - 1) / THREADS, B), THREADS, 0,
                        s>>>((const int*)idx, (const float*)w,
                             (const float*)g, gT, keys0, N, V, k);
  const int tiles = (int)p.tiles;
  for (int pass = 0; pass < p.passes; ++pass) {
    const int* kin = pass == 0 ? keys0 : keys[(pass - 1) & 1];
    const int2* nwin = pass == 0 ? nullptr : nw[(pass - 1) & 1];
    int* dtot = wsi + p.dtot + (size_t)RADIX * pass;
    scatter_hist_kernel<<<tiles, THREADS, 0, s>>>(kin, hist, live, p.M,
                                                  tiles, pass);
    scatter_digit_scan_kernel<<<RADIX, THREADS, 0, s>>>(hist, dtot, live,
                                                        tiles, pass);
    scatter_place_kernel<<<tiles, THREADS, 0, s>>>(
        kin, nwin, (const float*)w, hist, dtot, live, keys[pass & 1],
        nw[pass & 1], p.M, tiles, pass, N);
  }
  const int last = (p.passes - 1) & 1;
  scatter_bounds_kernel<<<tiles * ROUNDS, THREADS, 0, s>>>(keys[last], live,
                                                           begin, end);
  scatter_sum_kernel<<<(unsigned)((p.rows + SUM_WARPS - 1) / SUM_WARPS),
                       SUM_THREADS, 0, s>>>(nw[last], gT, begin, end,
                                            (float*)out, p.rows, N, V);
  return (int)cudaGetLastError();
}
