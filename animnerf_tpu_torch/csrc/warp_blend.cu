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
// Above 16 neighbours: the instantiations K = 24 and 32 take k in 17..24
// and 25..32 at run time (their loops unrolled to K, each neighbour past k
// skipped, each sum still in order 0, 1, ..., k - 1; the gate's loads one
// neighbour at a time), and warp_blend_fwd_any takes any k above 32: one
// thread a point, no per-neighbour array, the weights formed in a first
// pass over the k neighbours (their sum) and formed again, bit for bit,
// in a second that normalises them and takes bd and bf. Slow but in the
// same order; its time is in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_K = 16;       // every K up to here has its instantiation
constexpr int MAX_WIDE_K = 32;  // then K = 24 and 32; above, the any-k kernel

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

// K: the instantiation's neighbours; kr, the neighbours read: kr == K up
// to MAX_K, 1 <= kr <= K above (neighbours kr.. skipped)
template <int K, bool WARP_VIEW>
__global__ void __launch_bounds__(THREADS)
warp_blend_fwd_kernel(const float* __restrict__ xyz,    // (B, 8, N) rows
                      const float* __restrict__ dists,  // (B, kr, N)
                      const int* __restrict__ idx,      // (B, kr, N)
                      const float* __restrict__ table,  // (B, V, Lp + 16)
                      float* __restrict__ out,          // (B, 8, N)
                      float* __restrict__ w_out,        // (B, kr, N) or null
                      float* __restrict__ bf_out,       // (B, 16, N) or null
                      int N, int V, int num_lbs, int Lp,
                      float inv_two_std2, float conf_gate, int kr) {
  constexpr bool EXACT = K <= MAX_K;
  const int KS = EXACT ? K : kr;  // the rows of dists, idx and w_out
  auto on = [&](int k) { return EXACT || k < kr; };
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
    row[k] = on(k) ? tab + (size_t)idx[((size_t)b * KS + k) * N + n] * F4
                   : tab;
    d[k] = on(k) ? dists[((size_t)b * KS + k) * N + n] : 0.0f;
    l1[k] = 0.0f;
  }

  // confidence gate against neighbour 0 (reference anim_nerf.py:165-171)
  for (int q = 0; q < L4; ++q) {
    const int cnt = min(4, num_lbs - 4 * q);
    const float4 v0 = __ldg(row[0] + q);
    if constexpr (EXACT) {
      float4 r[K];
#pragma unroll
      for (int k = 1; k < K; ++k) r[k] = __ldg(row[k] + q);
      l1_add(l1[0], v0, v0, cnt);
#pragma unroll
      for (int k = 1; k < K; ++k) l1_add(l1[k], r[k], v0, cnt);
    } else {
      l1_add(l1[0], v0, v0, cnt);
#pragma unroll
      for (int k = 1; k < K; ++k)
        if (on(k)) l1_add(l1[k], __ldg(row[k] + q), v0, cnt);
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float conf = expf(-l1[k] * inv_two_std2);
    w[k] = on(k) ? expf(-d[k]) * (conf > conf_gate ? 1.0f : 0.0f) : 0.0f;
  }
  float wsum = w[0];
#pragma unroll
  for (int k = 1; k < K; ++k)
    if (on(k)) wsum += w[k];
  float bd = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (!on(k)) continue;
    w[k] = w[k] / wsum;
    bd = (k == 0) ? w[k] * d[k] : bd + w[k] * d[k];
  }

  float bf[16];
#pragma unroll
  for (int c = 0; c < 16; ++c) bf[c] = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (!on(k)) continue;
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
  for (int k = 0; k < K; ++k)
    if (on(k)) w_out[((size_t)b * KS + k) * N + n] = w[k];
#pragma unroll
  for (int c = 0; c < 16; ++c) bf_out[((size_t)b * 16 + c) * N + n] = bf[c];
}

// any k: the gate weight of neighbour k of point n, formed the same way
// in both passes of warp_blend_fwd_any (and as the kernel above forms it)
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

// launch the instantiation for k (1..MAX_K each its own; 17..24 on K =
// 24, 25..32 on K = 32; above, warp_blend_fwd_any)
template <int K, bool WARP_VIEW>
void launch(int k, dim3 grid, cudaStream_t stream, const float* xyz,
            const float* dists, const int* idx, const float* table,
            float* out, float* w_out, float* bf_out, int N, int V,
            int num_lbs, int Lp, float inv_two_std2, float conf_gate) {
  if (K <= MAX_K ? k == K : k <= K) {
    warp_blend_fwd_kernel<K, WARP_VIEW><<<grid, THREADS, 0, stream>>>(
        xyz, dists, idx, table, out, w_out, bf_out, N, V, num_lbs, Lp,
        inv_two_std2, conf_gate, k);
  } else if constexpr (K < MAX_K) {
    launch<K + 1, WARP_VIEW>(k, grid, stream, xyz, dists, idx, table, out,
                             w_out, bf_out, N, V, num_lbs, Lp, inv_two_std2,
                             conf_gate);
  } else if constexpr (K < MAX_WIDE_K) {
    launch<K + 8, WARP_VIEW>(k, grid, stream, xyz, dists, idx, table, out,
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
// warp_view nonzero warps the view direction of xyz rows 4:7 too.
extern "C" int animnerf_warp_blend_fwd(
    const void* xyz, const void* dists, const void* idx, const void* table,
    void* padded, void* out, void* w_out, void* bf_out, int B, int N, int V,
    int k, int num_lbs, float inv_two_std2, float conf_gate, int warp_view,
    void* stream) {
  const int Lp = (num_lbs + 3) / 4 * 4;
  if (k < 1 || num_lbs < 1 ||
      (w_out == nullptr) != (bf_out == nullptr) ||
      (padded == nullptr &&
       (Lp != num_lbs || (uintptr_t)table % 16 != 0)) ||
      (uintptr_t)padded % 16 != 0)
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
    dim3 grid((N + THREADS - 1) / THREADS, B);
    if (warp_view)
      launch<1, true>(k, grid, s, (const float*)xyz, (const float*)dists,
                      (const int*)idx, rows, (float*)out, (float*)w_out,
                      (float*)bf_out, N, V, num_lbs, Lp, inv_two_std2,
                      conf_gate);
    else
      launch<1, false>(k, grid, s, (const float*)xyz, (const float*)dists,
                       (const int*)idx, rows, (float*)out, (float*)w_out,
                       (float*)bf_out, N, V, num_lbs, Lp, inv_two_std2,
                       conf_gate);
  }
  return (int)cudaGetLastError();
}
