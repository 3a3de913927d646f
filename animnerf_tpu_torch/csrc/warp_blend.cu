// Neighbour gather + confidence-gated LBS blend + 4x4 warp, for Hopper.
//
// Replaces: animnerf_tpu/ops/warp_blend.py::_warp_blend_kernel (reached
// through warp_blend_fwd_pallas), forward, warp_view off and on (the
// backward is ops/warp_blend.py's autograd over the weighted scatter).
//
// Per point n with its K neighbours (d_k, i_k), any K as the kNN emits
// them, and table rows
// row_v = [lbs (num_lbs) | ober2cano 4x4 (16)]:
//   l1_k   = sum_j |lbs(i_k)[j] - lbs(i_0)[j]|
//   gate_k = exp(-l1_k / (2 std^2)) > conf_gate
//   w_k    = exp(-d_k) * gate_k / sum_k(...)
//   bd     = sum_k w_k d_k,   bf = sum_k w_k T(i_k)
//   out    = [bf[0:3]·xyz + bf[3] | bf[4:7]·xyz + bf[7] | bf[8:11]·xyz + bf[11]
//             | bd | 0 0 0 0],   w (K rows),   bf (16 rows)
// With warp_view (a template flag: the off instantiation is the code
// without it) the view direction vd in input rows 4:7 is warped by the same
// blended 4x4, translation included as the reference does
// (warp_blend.py:124-133): out rows 4:7 = bf[4r:4r+3]·vd + bf[4r+3], r =
// 0..2, and row 7 = 0; the sums run in the TPU kernel's order.
// Every sum over k runs in order k = 0, 1, ..., K-1, and l1_k in order
// j = 0, 1, ..., as the TPU kernel (warp_blend.py:98-109) and the plain
// version take them. expf, not __expf: the gate is a hard threshold and a
// flipped gate turns a weight from zero to nonzero. w and bf are the
// backward's residuals; with w_out null (the no-grad callers: every view,
// dense view and eval frame) only out is written.
//
// Bound on the H100: bytes. Per point it reads 3 xyz floats (6 with
// warp_view: the view direction too), K distances and K indices and
// writes 8 (+ K + 16 with the residuals) floats. The gathered table
// rows (K x F x 4 B a point, F = num_lbs + 16: 40 for SMPL, 71 for
// SMPL-X) come from L1 and L2: the tables are 1-3 MB and
// neighbouring points share rows. What costs is the number of load
// instructions: each is a warp-wide gather from 32 different rows. One
// thread a point reading its rows a float at a time, row 0's LBS values
// once per neighbour, spent K (2 num_lbs + 16) of them a point (256 at
// SMPL, K = 4; 504 at SMPL-X). Staging a block's rows in shared memory
// first, a warp a row and a lane a float (cp.async, 4 B), measured slower
// still on the H100 (1.10 ms against 0.405 on a view's 2.19M points): one
// instruction then moves one row, K x ceil(F / 32) a point, before the
// shared reads. Design: 16-byte loads. Rows whose LBS part is a multiple
// of 4 floats (SMPL 24, SMPL-H 52, MANO 16) are read in place as float4s;
// for the others (SMPL-X 55, FLAME 5) warp_blend_pad_kernel first copies
// the table (1-3 MB) into rows [lbs | 0 pad to Lp | T (16)], Lp =
// 4 ceil(num_lbs / 4) (ops/warp_blend.py::warp_blend_row_layout mirrors
// it). One thread a point then reads row 0's LBS float4 once for all K
// neighbours and each neighbour's in turn (K Lp / 4 loads), and the 16
// transform values as 4 float4s a neighbour after the weights: K (Lp / 4
// + 4) loads a point, 40 at SMPL, 72 at SMPL-X (6.4x and 7x fewer). K is
// a template argument (one instantiation per K), so the per-neighbour
// arrays stay in registers. The TPU kernel's 128-lane vertex chunks,
// candidate-chunk pruning and dynamic_gather exist only for the TPU's
// lanes and are not carried over.
// Above WARP_GROUP_ABOVE = 16 neighbours (ops/warp_blend.py; the "group"
// route), up to the k where its block's shared memory ends (~290; above,
// the run-time-k thread kernel warp_blend_fwd_any):
// warp_blend_group_kernel, one kernel for every k, 32-34 registers a
// thread at any k. The thread kernels it replaced kept K weights,
// distances and row pointers in registers (231 at K = 24 / 32, about one
// block an SM; deleted) or, in warp_blend_fwd_any, re-read neighbour 0's
// row for every neighbour and formed every weight twice (~1,120 16-byte
// gathers a point at K = 40). At wide K what bounds kernel 2 is the
// gathered table bytes, K (Lp + 16) x 4 a point (6.4 KB at
// SMPL, K = 40; ~16 GB for a 512^2 view's coarse call), from L2. Design:
// G = 4 lanes a point (8 measured slower on a view's call, PERF.md §6),
// a block's P = 256 / G points consecutive:
//   - warp_blend_summary_kernel first writes each table row's largest LBS
//     weight and its column (8 bytes a row);
//   - the block reads its points' K distances and indices into shared
//     memory, a row of P consecutive values a load, and each group
//     neighbour 0's LBS float4s;
//   - lane r forms the gate weights of neighbours r, r + G, ... as the
//     thread kernels do (l1 in column order over 16-byte row loads, expf,
//     the threshold) into shared memory, except where the 8-byte summary
//     proves the gate closed: l1 is at least its term |amax - v0[jmax]|
//     (every term >= 0, every rounding monotone) and expf is within 2 ulp
//     of exp, so expf(-term c) <= conf_gate (1 - 2^-20) gives w = 0 as the
//     full sum would; at the main path's gate (l1 < 0.0021 to pass) most
//     neighbours of a smooth rig are decided so, unread;
//   - the ordered sums stay serial: every lane sums wsum over k = 0, 1,
//     ..., the lanes normalise their weights, every lane runs bd's chain
//     and lane r bf's over its 16 / G columns (a row's transform part is
//     one 64-byte segment for the group); a gated-out neighbour's
//     transform row is not read (w t = 0 leaves bf as fma(0, t, bf) leaves
//     it, up to the sign of a zero);
//   - the block writes its weights back, rows of P consecutive values.
// bd's rounding follows the thread kernel of that k: nvcc contracted
// bd + w d differently in the per-K kernels and in warp_blend_fwd_any
// (pair_first), and the group kernel's outputs equal the thread route's
// (torch.equal; -0 = +0).
// The threshold: chip_smoke.py's "warp_routes" line times both routes at
// K = 8, 12, 16, 17 on a 2^20-point random-order cloud and on a 512^2
// view's call in ray order (H100 80GB HBM3, PERF.md §6): the group
// kernel is faster on both from 17, at 16 on the random cloud only.
// The per-K kernels (k <= 16) and warp_blend_fwd_any (k above) below are
// the "thread" route: the default up to the threshold and above the group
// kernel's k, and wherever route="thread" asks for it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_K = 16;  // every K up to here has its instantiation
constexpr int G = 4;       // the group kernel's lanes a point

// l1 += |r - v0| over the float4's first cnt components, in order
__device__ __forceinline__ void l1_add(float& l1, float4 r, float4 v0,
                                       int cnt) {
  l1 += fabsf(r.x - v0.x);
  if (cnt > 1) l1 += fabsf(r.y - v0.y);
  if (cnt > 2) l1 += fabsf(r.z - v0.z);
  if (cnt > 3) l1 += fabsf(r.w - v0.w);
}

// rows [lbs | 0 .. | T] of Lp + 16 floats from (B, V, num_lbs + 16)
__global__ void __launch_bounds__(THREADS)
warp_blend_pad_kernel(const float* __restrict__ table,
                      float* __restrict__ padded, long long rows,
                      int num_lbs, int Lp) {
  const int Fp = Lp + 16, F = num_lbs + 16;
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= rows * Fp) return;
  const long long r = i / Fp;
  const int c = (int)(i - r * Fp);
  const float* src = table + r * F;
  padded[i] = c < num_lbs ? src[c] : c < Lp ? 0.0f : src[num_lbs + c - Lp];
}

// each row's largest LBS weight and its column (the first if tied), as
// float2 {amax, jmax's bits}: rows [lbs | 0 .. | T] of Lp + 16 floats
__global__ void __launch_bounds__(THREADS)
warp_blend_summary_kernel(const float* __restrict__ rows,
                          float2* __restrict__ summary, long long count,
                          int num_lbs, int Lp) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= count) return;
  const float* row = rows + i * (Lp + 16);
  float amax = row[0];
  int jmax = 0;
  for (int j = 1; j < num_lbs; ++j)
    if (row[j] > amax) {
      amax = row[j];
      jmax = j;
    }
  summary[i] = make_float2(amax, __int_as_float(jmax));
}

// the point's outputs from its blended dist bd and transform bf
template <bool WARP_VIEW>
__device__ __forceinline__ void write_out(const float* __restrict__ xyz,
                                          float* __restrict__ out,
                                          const float (&bf)[16], float bd,
                                          int b, int n, int N) {
  const size_t xo = (size_t)b * 8 * N + n;
  const float x = xyz[xo], y = xyz[xo + N], z = xyz[xo + 2 * (size_t)N];
#pragma unroll
  for (int r = 0; r < 3; ++r)
    out[xo + r * (size_t)N] =
        bf[4 * r] * x + bf[4 * r + 1] * y + bf[4 * r + 2] * z + bf[4 * r + 3];
  out[xo + 3 * (size_t)N] = bd;
  if constexpr (WARP_VIEW) {
    const float vx = xyz[xo + 4 * (size_t)N], vy = xyz[xo + 5 * (size_t)N],
                vz = xyz[xo + 6 * (size_t)N];
#pragma unroll
    for (int r = 0; r < 3; ++r)
      out[xo + (4 + r) * (size_t)N] = bf[4 * r] * vx + bf[4 * r + 1] * vy +
                                      bf[4 * r + 2] * vz + bf[4 * r + 3];
    out[xo + 7 * (size_t)N] = 0.0f;
  } else {
#pragma unroll
    for (int r = 4; r < 8; ++r) out[xo + r * (size_t)N] = 0.0f;
  }
}

// K neighbours, 1 <= K <= MAX_K
template <int K, bool WARP_VIEW>
__global__ void __launch_bounds__(THREADS)
warp_blend_fwd_kernel(const float* __restrict__ xyz,    // (B, 8, N) rows
                      const float* __restrict__ dists,  // (B, K, N)
                      const int* __restrict__ idx,      // (B, K, N)
                      const float* __restrict__ table,  // (B, V, Lp + 16)
                      float* __restrict__ out,          // (B, 8, N)
                      float* __restrict__ w_out,        // (B, K, N) or null
                      float* __restrict__ bf_out,       // (B, 16, N) or null
                      int N, int V, int num_lbs, int Lp,
                      float inv_two_std2, float conf_gate) {
  static_assert(K <= MAX_K, "per-K kernels up to MAX_K");
  const int b = blockIdx.y;
  const int n = blockIdx.x * THREADS + threadIdx.x;
  if (n >= N) return;
  const int F4 = Lp / 4 + 4, L4 = Lp / 4;
  const float4* tab =
      reinterpret_cast<const float4*>(table) + (size_t)b * V * F4;

  const float4* row[K];
  float d[K], w[K], l1[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    row[k] = tab + (size_t)idx[((size_t)b * K + k) * N + n] * F4;
    d[k] = dists[((size_t)b * K + k) * N + n];
    l1[k] = 0.0f;
  }

  // confidence gate against neighbour 0 (reference anim_nerf.py:165-171)
  for (int q = 0; q < L4; ++q) {
    const int cnt = min(4, num_lbs - 4 * q);
    const float4 v0 = __ldg(row[0] + q);
    float4 r[K];
#pragma unroll
    for (int k = 1; k < K; ++k) r[k] = __ldg(row[k] + q);
    l1_add(l1[0], v0, v0, cnt);
#pragma unroll
    for (int k = 1; k < K; ++k) l1_add(l1[k], r[k], v0, cnt);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float conf = expf(-l1[k] * inv_two_std2);
    w[k] = expf(-d[k]) * (conf > conf_gate ? 1.0f : 0.0f);
  }
  float wsum = w[0];
#pragma unroll
  for (int k = 1; k < K; ++k) wsum += w[k];
  float bd = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    w[k] = w[k] / wsum;
    bd = (k == 0) ? w[k] * d[k] : bd + w[k] * d[k];
  }

  float bf[16];
#pragma unroll
  for (int c = 0; c < 16; ++c) bf[c] = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float t[16];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 v = __ldg(row[k] + L4 + q);
      t[4 * q] = v.x;
      t[4 * q + 1] = v.y;
      t[4 * q + 2] = v.z;
      t[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int c = 0; c < 16; ++c) bf[c] += w[k] * t[c];
  }

  write_out<WARP_VIEW>(xyz, out, bf, bd, b, n, N);
  if (w_out == nullptr) return;
#pragma unroll
  for (int k = 0; k < K; ++k) w_out[((size_t)b * K + k) * N + n] = w[k];
#pragma unroll
  for (int c = 0; c < 16; ++c) bf_out[((size_t)b * 16 + c) * N + n] = bf[c];
}

// any k: the gate weight of neighbour k of point n, formed the same way
// in both passes of warp_blend_fwd_any (and as the kernels above form it)
__device__ __forceinline__ float gate_weight(const float4* row0,
                                             const float4* rowk, float d,
                                             int num_lbs, int L4,
                                             float inv_two_std2,
                                             float conf_gate) {
  float l1 = 0.0f;
  for (int q = 0; q < L4; ++q)
    l1_add(l1, __ldg(rowk + q), __ldg(row0 + q), min(4, num_lbs - 4 * q));
  const float conf = expf(-l1 * inv_two_std2);
  return expf(-d) * (conf > conf_gate ? 1.0f : 0.0f);
}

template <bool WARP_VIEW>
__global__ void __launch_bounds__(THREADS)
warp_blend_fwd_any(const float* __restrict__ xyz,
                   const float* __restrict__ dists,
                   const int* __restrict__ idx,
                   const float* __restrict__ table, float* __restrict__ out,
                   float* __restrict__ w_out, float* __restrict__ bf_out,
                   int N, int V, int num_lbs, int Lp, float inv_two_std2,
                   float conf_gate, int k) {
  const int b = blockIdx.y;
  const int n = blockIdx.x * THREADS + threadIdx.x;
  if (n >= N) return;
  const int F4 = Lp / 4 + 4, L4 = Lp / 4;
  const float4* tab =
      reinterpret_cast<const float4*>(table) + (size_t)b * V * F4;
  const size_t e0 = (size_t)b * k * N + n;  // entry (b, j, n) at e0 + j N
  const float4* row0 = tab + (size_t)idx[e0] * F4;
  float wsum = 0.0f;
  for (int j = 0; j < k; ++j) {
    const float4* rowj = tab + (size_t)idx[e0 + j * (size_t)N] * F4;
    const float wj = gate_weight(row0, rowj, dists[e0 + j * (size_t)N],
                                 num_lbs, L4, inv_two_std2, conf_gate);
    wsum = j == 0 ? wj : wsum + wj;
  }
  float bd = 0.0f, bf[16];
#pragma unroll
  for (int c = 0; c < 16; ++c) bf[c] = 0.0f;
  for (int j = 0; j < k; ++j) {
    const float4* rowj = tab + (size_t)idx[e0 + j * (size_t)N] * F4;
    const float dj = dists[e0 + j * (size_t)N];
    const float wj = gate_weight(row0, rowj, dj, num_lbs, L4, inv_two_std2,
                                 conf_gate) /
                     wsum;
    bd = (j == 0) ? wj * dj : bd + wj * dj;
    float t[16];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 v = __ldg(rowj + L4 + q);
      t[4 * q] = v.x;
      t[4 * q + 1] = v.y;
      t[4 * q + 2] = v.z;
      t[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int c = 0; c < 16; ++c) bf[c] += wj * t[c];
    if (w_out != nullptr) w_out[e0 + j * (size_t)N] = wj;
  }
  write_out<WARP_VIEW>(xyz, out, bf, bd, b, n, N);
  if (bf_out == nullptr) return;
#pragma unroll
  for (int c = 0; c < 16; ++c) bf_out[((size_t)b * 16 + c) * N + n] = bf[c];
}

// ---- the group kernel: G lanes a point (see the note above)

constexpr int SMEM_MAX = 232448;  // a block's shared memory on the H100

constexpr int P = THREADS / G;  // the group kernel's points a block

// the group kernel's dynamic shared memory: its P points' neighbour-0 LBS
// float4s (L4 a point), then the distance, index and weight of each
// (neighbour, point)
long long group_bytes(int K, int L4) { return 16LL * P * L4 + 12LL * K * P; }

// bd = sum_k w_k d_k rounds as in the thread kernel of that k (nvcc
// contracted each differently; holding the routes' outputs against each
// other tells which): pair_first (the per-K kernels, k <= MAX_K)
// fma(w0, d0, w1 d1) first, then fma(w_k, d_k, bd); else
// (warp_blend_fwd_any) bd + (w_k d_k), each rounded
template <bool WARP_VIEW>
__global__ void __launch_bounds__(THREADS)
warp_blend_group_kernel(const float* __restrict__ xyz,
                        const float* __restrict__ dists,
                        const int* __restrict__ idx,
                        const float* __restrict__ table,
                        const float2* __restrict__ summary,
                        float* __restrict__ out, float* __restrict__ w_out,
                        float* __restrict__ bf_out, int N, int V,
                        int num_lbs, int Lp, float inv_two_std2,
                        float conf_gate, int K, bool pair_first) {
  constexpr int CPL = 16 / G;  // a lane's columns of bf
  constexpr unsigned FULL = 0xffffffffu;
  extern __shared__ float4 smem[];
  const int F4 = Lp / 4 + 4, L4 = Lp / 4;
  float4* v0 = smem;  // point pp's LBS float4 q at [pp L4 + q]
  float* sd = reinterpret_cast<float*>(smem + P * L4);
  int* si = reinterpret_cast<int*>(sd + K * P);
  float* sw = sd + 2 * K * P;  // entry (k, point pp) at [k P + pp]
  const int b = blockIdx.y;
  const int p = threadIdx.x / G, r = threadIdx.x % G;
  const int n0 = blockIdx.x * P;
  const bool live = n0 + p < N;
  const int n = live ? n0 + p : N - 1;  // the tail computes, stores nothing
  const float4* tab =
      reinterpret_cast<const float4*>(table) + (size_t)b * V * F4;
  const size_t e0 = (size_t)b * K * N;  // entry (b, k, n) at e0 + k N + n

  // the block's distances and indices, a row of P consecutive floats a
  // load, and each point's neighbour-0 LBS columns
  for (int e = threadIdx.x; e < K * P; e += THREADS) {
    const int k = e / P, pp = e - k * P;
    const size_t o = e0 + (size_t)k * N + min(n0 + pp, N - 1);
    sd[e] = dists[o];
    si[e] = idx[o];
  }
  __syncthreads();
  for (int q = r; q < L4; q += G)
    v0[p * L4 + q] = __ldg(tab + (size_t)si[p] * F4 + q);
  __syncwarp();

  // pass 1: lane r's gate weights for neighbours r, r + G, ..., formed as
  // the thread kernels form them: l1 over the columns in order (16-byte
  // loads of the row, neighbour 0's from shared memory), expf, the
  // threshold
  // A neighbour whose gate provably closes is not read: l1 is at least
  // its term |amax - v0[jmax]| at the row's largest weight (every term
  // >= 0, every rounding monotone), and expf is within 2 ulp of exp, so
  // expf(-term c) <= conf_gate (1 - 2^-20) means conf <= conf_gate: w = 0
  // as the full sum gives it
  const float* v0f = reinterpret_cast<const float*>(v0 + p * L4);
  const float closed = conf_gate > 0.0f ? conf_gate * (1.0f - 0x1p-20f)
                                        : -1.0f;
  const float2* sb = summary + (size_t)b * V;
  for (int k = r; k < K; k += G) {
    const int ik = si[k * P + p];
    const float2 top = __ldg(sb + ik);
    const float lower = fabsf(top.x - v0f[__float_as_int(top.y)]);
    float w = 0.0f;
    if (expf(-lower * inv_two_std2) > closed) {
      const float4* row = tab + (size_t)ik * F4;
      float l1 = 0.0f;
      for (int q = 0; q < L4; ++q)
        l1_add(l1, __ldg(row + q), v0[p * L4 + q], min(4, num_lbs - 4 * q));
      const float conf = expf(-l1 * inv_two_std2);
      w = expf(-sd[k * P + p]) * (conf > conf_gate ? 1.0f : 0.0f);
    }
    sw[k * P + p] = w;
  }
  __syncwarp();
  // wsum = w_0 + w_1 + ... in order, then the weights normalised
  float wsum = sw[p];
  for (int k = 1; k < K; ++k) wsum = __fadd_rn(wsum, sw[k * P + p]);
  __syncwarp();
  for (int k = r; k < K; k += G) sw[k * P + p] = __fdiv_rn(sw[k * P + p], wsum);
  __syncwarp();

  // pass 2: bd (every lane) and bf (lane r its CPL columns) in order k =
  // 0, 1, ..., each row's 16 transform values one 64-byte segment
  float bd = __fmul_rn(sw[p], sd[p]), bf[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) bf[c] = 0.0f;
  for (int k0 = 0; k0 < K; k0 += 4) {
    float t[4][CPL];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      // a gated-out neighbour adds w t = 0 to bf: its row is not read
      const int k = min(k0 + u, K - 1);
      const float* tr = reinterpret_cast<const float*>(
                            tab + (size_t)si[k * P + p] * F4 + L4) +
                        r * CPL;
#pragma unroll
      for (int c = 0; c < CPL; ++c) t[u][c] = 0.0f;
      if (sw[k * P + p] == 0.0f) continue;
      const float4 v = __ldg(reinterpret_cast<const float4*>(tr));
      t[u][0] = v.x;
      t[u][1] = v.y;
      t[u][2] = v.z;
      t[u][3] = v.w;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = k0 + u;
      if (k >= K) break;
      const float w = sw[k * P + p];
      if (w == 0.0f) continue;  // bf and bd as the thread kernels leave them
#pragma unroll
      for (int c = 0; c < CPL; ++c) bf[c] = __fmaf_rn(w, t[u][c], bf[c]);
      if (k == 0) continue;
      const float d = sd[k * P + p];
      if (!pair_first)
        bd = __fadd_rn(bd, __fmul_rn(w, d));
      else if (k == 1)
        bd = __fmaf_rn(sw[p], sd[p], __fmul_rn(w, d));
      else
        bd = __fmaf_rn(w, d, bd);
    }
  }

  // the point's outputs: every lane gathers the 16 columns, lane 0 writes
  float full[16];
#pragma unroll
  for (int c = 0; c < 16; ++c)
    full[c] = __shfl_sync(FULL, bf[c % CPL], c / CPL, G);
  if (live && r == 0) write_out<WARP_VIEW>(xyz, out, full, bd, b, n, N);
  if (bf_out == nullptr) return;
  if (live) {
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      bf_out[((size_t)b * 16 + r * CPL + c) * N + n] = bf[c];
  }
  __syncthreads();  // every group's weights are normalised
  for (int e = threadIdx.x; e < K * P; e += THREADS) {
    const int k = e / P, pp = e - k * P;
    if (n0 + pp < N) w_out[e0 + (size_t)k * N + n0 + pp] = sw[e];
  }
}

template <bool WARP_VIEW>
int launch_group(dim3 grid, cudaStream_t stream, const float* xyz,
                 const float* dists, const int* idx, const float* table,
                 const float2* summary, float* out, float* w_out,
                 float* bf_out, int N, int V, int num_lbs, int Lp,
                 float inv_two_std2, float conf_gate, int k) {
  const long long bytes = group_bytes(k, Lp / 4);
  if (bytes > SMEM_MAX) return (int)cudaErrorInvalidValue;
  static bool raised = false;  // the dynamic shared memory limit
  if (bytes > 48 * 1024 && !raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        warp_blend_group_kernel<WARP_VIEW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    raised = true;
  }
  warp_blend_group_kernel<WARP_VIEW>
      <<<grid, THREADS, (size_t)bytes, stream>>>(
          xyz, dists, idx, table, summary, out, w_out, bf_out, N, V,
          num_lbs, Lp, inv_two_std2, conf_gate, k, k <= MAX_K);
  return 0;
}

// launch the thread kernel for k (1..MAX_K each its own instantiation;
// above, warp_blend_fwd_any)
template <int K, bool WARP_VIEW>
void launch(int k, dim3 grid, cudaStream_t stream, const float* xyz,
            const float* dists, const int* idx, const float* table,
            float* out, float* w_out, float* bf_out, int N, int V,
            int num_lbs, int Lp, float inv_two_std2, float conf_gate) {
  if (k == K) {
    warp_blend_fwd_kernel<K, WARP_VIEW><<<grid, THREADS, 0, stream>>>(
        xyz, dists, idx, table, out, w_out, bf_out, N, V, num_lbs, Lp,
        inv_two_std2, conf_gate);
  } else if constexpr (K < MAX_K) {
    launch<K + 1, WARP_VIEW>(k, grid, stream, xyz, dists, idx, table, out,
                             w_out, bf_out, N, V, num_lbs, Lp, inv_two_std2,
                             conf_gate);
  } else {
    warp_blend_fwd_any<WARP_VIEW><<<grid, THREADS, 0, stream>>>(
        xyz, dists, idx, table, out, w_out, bf_out, N, V, num_lbs, Lp,
        inv_two_std2, conf_gate, k);
  }
}

}  // namespace

// table (B, V, num_lbs + 16); padded: null when num_lbs is a multiple of
// 4 and table is 16-byte aligned (its rows are then read in place), else
// scratch for B V (Lp + 16) floats, 16-byte aligned, that the pad kernel
// fills first; w_out and bf_out both null for the residual-free mode;
// warp_view nonzero warps the view direction of xyz rows 4:7 too; group
// 0 runs the thread kernels, 1 the group kernel (for k up to where its
// shared memory ends, animnerf_warp_blend_group_max_k), which takes
// summary, scratch for B V float2 (8-byte aligned) that
// warp_blend_summary_kernel fills first.
extern "C" int animnerf_warp_blend_fwd(
    const void* xyz, const void* dists, const void* idx, const void* table,
    void* padded, void* summary, void* out, void* w_out, void* bf_out,
    int B, int N, int V, int k, int num_lbs, float inv_two_std2,
    float conf_gate, int warp_view, int group, void* stream) {
  const int Lp = (num_lbs + 3) / 4 * 4;
  if (k < 1 || num_lbs < 1 ||
      (w_out == nullptr) != (bf_out == nullptr) ||
      (padded == nullptr &&
       (Lp != num_lbs || (uintptr_t)table % 16 != 0)) ||
      (uintptr_t)padded % 16 != 0 ||
      (group != 0 && (summary == nullptr || (uintptr_t)summary % 8 != 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (N > 0 && B > 0) {
    const float* rows = (const float*)table;
    if (padded != nullptr) {
      const long long n = (long long)B * V * (Lp + 16);
      warp_blend_pad_kernel<<<(unsigned)((n + THREADS - 1) / THREADS),
                              THREADS, 0, s>>>(
          (const float*)table, (float*)padded, (long long)B * V, num_lbs, Lp);
      rows = (const float*)padded;
    }
    const float* x = (const float*)xyz;
    const float* d = (const float*)dists;
    const int* i = (const int*)idx;
    float *o = (float*)out, *w = (float*)w_out, *f = (float*)bf_out;
    int err = 0;
    if (group != 0) {
      const long long n = (long long)B * V;
      warp_blend_summary_kernel<<<(unsigned)((n + THREADS - 1) / THREADS),
                                  THREADS, 0, s>>>(rows, (float2*)summary, n,
                                                   num_lbs, Lp);
      const float2* sm = (const float2*)summary;
      dim3 grid((N + P - 1) / P, B);
      if (warp_view)
        err = launch_group<true>(grid, s, x, d, i, rows, sm, o, w, f, N, V,
                                 num_lbs, Lp, inv_two_std2, conf_gate, k);
      else
        err = launch_group<false>(grid, s, x, d, i, rows, sm, o, w, f, N, V,
                                  num_lbs, Lp, inv_two_std2, conf_gate, k);
    } else {
      dim3 grid((N + THREADS - 1) / THREADS, B);
      if (warp_view)
        launch<1, true>(k, grid, s, x, d, i, rows, o, w, f, N, V, num_lbs,
                        Lp, inv_two_std2, conf_gate);
      else
        launch<1, false>(k, grid, s, x, d, i, rows, o, w, f, N, V, num_lbs,
                         Lp, inv_two_std2, conf_gate);
    }
    if (err != 0) return err;
  }
  return (int)cudaGetLastError();
}

// out[0]: the largest k the group kernel takes at this num_lbs, its
// shared memory full; ops/warp_blend.py::group_max_k is its host-side
// restatement
extern "C" int animnerf_warp_blend_group_max_k(int num_lbs, void* out) {
  if (num_lbs < 1) return (int)cudaErrorInvalidValue;
  *(int*)out = (int)((SMEM_MAX - 16LL * P * ((num_lbs + 3) / 4)) / (12LL * P));
  return 0;
}
