// Matmul-form top-4 nearest vertices (the kNN benchmark tool's variant),
// for Hopper (sm_90a), on the tensor cores.
//
// Replaces: tools/bench_knn.py::_mxu_knn_kernel (reached through
// knn_mxu), k = 4, at precision HIGHEST or DEFAULT.
//
// What it computes: d2 = |p|^2 + |v|^2 - 2 p.v as one product of
// augmented rows, points and vertices centred on the vertices' mean, then
// the top 4 by (d2, input index) and sqrtf(fmaxf(d2, 0)) (the matmul form
// can cancel below zero). Only 5 of the TPU kernel's 8 columns are live:
// x, y, z, |p|^2, 1 against -2x, -2y, -2z, 1, |v|^2, as bf16 operands:
//   - "default": the 5 columns rounded to bf16, a depth of 16 (KC = 1):
//     the TPU's single-pass product;
//   - "highest": each f32 value split into bf16 hi + mid + lo and the six
//     cross products a TPU takes for HIGHEST (hi.hi, hi.mid, mid.hi,
//     hi.lo, mid.mid, lo.hi): 30 columns in a depth of 32 (KC = 2).
// The tensor core sums exact bf16 products in its own order, so the
// result is not the plain version's left-to-right f32 sum: it is held to
// the plain version of the same precision within eps = 2^-19 (|p| +
// |v|max)^2 a point on d2 (ops/knn_mxu.py derives it); an index may
// differ only between candidates whose plain d2s lie within 2 eps.
//
// Bound on the H100: the live products, 2 x 5 flops a pair at "default"
// and 2 x 30 at "highest", at the 989 TFLOP/s bf16 rate (0.073 / 0.438 ms
// for the tool's 7.22e9 pairs; the padding to a depth of 16 / 32 is this
// kernel's choice, not the function's work), against one compare a pair
// at the non-FMA f32 rate (0.216 ms): 0.216 ms "default", 0.438
// "highest".
// The kernels:
//   - mxu_codes_kernel: the Morton code of every point and vertex (10
//     bits an axis, the box of both clouds); torch sorts them;
//   - mxu_pack_kernel: the rows in Morton order, as augmented_rows forms
//     them, split and written in the fragment order of mma.m16n8k16, the
//     input index of each position, and each block's first stage (where
//     its middle point's code falls among the vertices'); its plain
//     version is ops/knn_mxu.py::mxu_operands, bit for bit;
//   - knn_mxu_mma_kernel: mma.sync m16n8k16 (bf16 in, f32 accumulate), a
//     warp owning R = 4 tiles of 16 points whose A fragments stay in
//     registers, a block 256 Morton-consecutive points. The block's warps
//     share the vertices' B fragments and input indices, staged TV = 32
//     tiles of 8 at a time in shared memory by cp.async (two buffers),
//     from the block's first stage round; a lane loads one 8- or 16-byte
//     B fragment a tile. Two tiles a step, one warp vote.
// Selection: the accumulator gives a lane 2 points x 2 vertices a tile,
// so a point's 8 vertices lie on a quad of lanes. Each lane keeps a top-4
// of its share by (d2, index) for each of its 2R points and tests each
// value with one compare against a threshold (its list's 4th value,
// lowered after visits 0, 1, 3, 7, ..., 63 and every 64th to the 4th of
// the quad's union: two xor shuffles of values, bitonic); the vote skips
// the insert pass when no lane has a candidate. Visiting the stages
// nearest the block's points first, a lane's list is near its final
// value after one stage, and few steps take the insert pass (the stats
// output counts them). A lane compares (d2, input index), so its list is
// exact whatever the visiting order, and the quad's four lists merge
// exactly by two xor-shuffle rounds of a lexicographic bitonic merge. The
// last tile masks positions past V to +inf. Lane q then writes slot q of
// its point at the point's input position.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;  // a block's points (R tiles of 16 a warp)
// a warp's point tiles (ops/knn_mxu.py TILES); 2 measured slower (PERF.md
// §6)
constexpr int R = 4;
constexpr int THREADS = 256;  // the packing kernels' blocks
constexpr int TV = 32;        // tiles of 8 vertices a stage
constexpr int K = 4;
constexpr int MAX_KC = 2;
constexpr unsigned FULL = 0xffffffffu;
constexpr int NO_INDEX = 0x7fffffff;

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ bool lex_less(float a, int ia, float b, int ib) {
  return a < b || (a == b && ia < ib);
}

// (x, ix) < (d[3], id[3]) by (d2, index): it goes in before the first
// element it is below
__device__ __forceinline__ void insert(float (&d)[K], int (&id)[K], float x,
                                       int ix) {
  const bool p2 = lex_less(x, ix, d[2], id[2]);
  const bool p1 = lex_less(x, ix, d[1], id[1]);
  const bool p0 = lex_less(x, ix, d[0], id[0]);
  d[3] = p2 ? d[2] : x;
  id[3] = p2 ? id[2] : ix;
  d[2] = p1 ? d[1] : (p2 ? x : d[2]);
  id[2] = p1 ? id[1] : (p2 ? ix : id[2]);
  d[1] = p0 ? d[0] : (p1 ? x : d[1]);
  id[1] = p0 ? id[0] : (p1 ? ix : id[1]);
  d[0] = p0 ? x : d[0];
  id[0] = p0 ? ix : id[0];
}

// the 4th smallest of the quad's four sorted lists (values only)
__device__ __forceinline__ float quad_fourth(const float (&d)[K]) {
  float c[K], e[K];
#pragma unroll
  for (int j = 0; j < K; ++j) e[j] = __shfl_xor_sync(FULL, d[j], 1);
#pragma unroll
  for (int j = 0; j < K; ++j) c[j] = fminf(d[j], e[K - 1 - j]);
  // c is bitonic: sort it
  float lo0 = fminf(c[0], c[2]), hi0 = fmaxf(c[0], c[2]);
  float lo1 = fminf(c[1], c[3]), hi1 = fmaxf(c[1], c[3]);
  c[0] = fminf(lo0, lo1);
  c[1] = fmaxf(lo0, lo1);
  c[2] = fminf(hi0, hi1);
  c[3] = fmaxf(hi0, hi1);
#pragma unroll
  for (int j = 0; j < K; ++j) e[j] = __shfl_xor_sync(FULL, c[j], 2);
  float m = fminf(c[0], e[3]);
#pragma unroll
  for (int j = 1; j < K; ++j) m = fmaxf(m, fminf(c[j], e[K - 1 - j]));
  return m;
}

// after the v-th tile visited (from 0) the thresholds drop to the
// quad's 4th: v = 0, 1, 3, 7, ..., 63, then every 64th
__device__ __forceinline__ bool refreshes_after(int v) {
  return (v & (v + 1)) == 0 || (v & 63) == 63;
}

// (a, ia) <= (b, ib) after
__device__ __forceinline__ void lex_cmpx(float& a, int& ia, float& b,
                                         int& ib) {
  const bool s = lex_less(b, ib, a, ia);
  const float t = a;
  const int it = ia;
  a = s ? b : a;
  ia = s ? ib : ia;
  b = s ? t : b;
  ib = s ? it : ib;
}

// the top 4 by (d2, index) of this lane's list and the one at lane ^ mask
// (both lanes end with the same sorted list)
__device__ __forceinline__ void lex_merge(float (&d)[K], int (&id)[K],
                                          int mask) {
  float e[K];
  int ie[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    e[j] = __shfl_xor_sync(FULL, d[j], mask);
    ie[j] = __shfl_xor_sync(FULL, id[j], mask);
  }
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const bool s = lex_less(e[K - 1 - j], ie[K - 1 - j], d[j], id[j]);
    d[j] = s ? e[K - 1 - j] : d[j];
    id[j] = s ? ie[K - 1 - j] : id[j];
  }
  lex_cmpx(d[0], id[0], d[2], id[2]);
  lex_cmpx(d[1], id[1], d[3], id[3]);
  lex_cmpx(d[0], id[0], d[1], id[1]);
  lex_cmpx(d[2], id[2], d[3], id[3]);
}

// the stage's tile tt: its B fragments from shared memory, the products
// of the warp's R point tiles
template <int KC>
__device__ __forceinline__ void products(float (&acc)[R][4],
                                         const uint32_t (&a)[R][KC][4],
                                         const uint32_t* st, int tt,
                                         int lane) {
  constexpr int VW = 2 * KC;
  uint32_t bw[VW];
  if constexpr (KC == 2) {
    const uint4 v = *reinterpret_cast<const uint4*>(st + (tt * 32 + lane)
                                                     * VW);
    bw[0] = v.x;
    bw[1] = v.y;
    bw[2] = v.z;
    bw[3] = v.w;
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(st + (tt * 32 + lane)
                                                     * VW);
    bw[0] = v.x;
    bw[1] = v.y;
  }
#pragma unroll
  for (int m = 0; m < R; ++m) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.0f;
#pragma unroll
    for (int c = 0; c < KC; ++c)
      mma_bf16(acc[m], a[m][c], bw[2 * c], bw[2 * c + 1]);
  }
}

// R tiles of 16 points a warp, BLOCK / (16 R) warps a block
template <int KC>
__global__ void __launch_bounds__(BLOCK / R * 2)
knn_mxu_mma_kernel(const uint32_t* __restrict__ pfrag,  // (B, Mt, 32, 4 KC)
                   const uint32_t* __restrict__ vfrag,  // (B, T, 32, 2 KC)
                   const int* __restrict__ vidx,        // (B, 8 T)
                   const int* __restrict__ pidx,        // (B, 16 Mt)
                   const int* __restrict__ first,       // (B, blocks)
                   float* __restrict__ out_d,           // (B, 4, N)
                   int* __restrict__ out_i,             // (B, 4, N)
                   unsigned long long* __restrict__ stats,  // (3) or null
                   int N, int V, int Mt, int T) {
  constexpr int VW = 2 * KC;  // B-fragment words a lane a tile
  constexpr int WARPS = BLOCK / 16 / R, NT = WARPS * 32;
  __shared__ __align__(16) uint32_t sv[2][TV * 32 * 2 * MAX_KC];
  __shared__ __align__(16) int sx[2][TV * 8];  // the stage's input indices
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, q = lane & 3;
  const int mt0 = (blockIdx.x * WARPS + warp) * R;

  uint32_t a[R][KC][4];
#pragma unroll
  for (int m = 0; m < R; ++m) {
    const int mt = min(mt0 + m, Mt - 1);
    const uint4* src = reinterpret_cast<const uint4*>(
        pfrag + (((size_t)b * Mt + mt) * 32 + lane) * 4 * KC);
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      const uint4 v = __ldg(src + c);
      a[m][c][0] = v.x;
      a[m][c][1] = v.y;
      a[m][c][2] = v.z;
      a[m][c][3] = v.w;
    }
  }
  float ld[R][2][K], thr[R][2];
  int li[R][2][K];
#pragma unroll
  for (int m = 0; m < R; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      thr[m][h] = INFINITY;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        ld[m][h][j] = INFINITY;
        li[m][h][j] = NO_INDEX;
      }
    }

  const uint32_t* vb = vfrag + (size_t)b * T * 32 * VW;
  const int* vi = vidx + (size_t)b * T * 8;
  auto load_stage = [&](int s, int buf) {
    const int tiles = min(TV, T - s * TV);
    const uint32_t* src = vb + (size_t)s * TV * 32 * VW;
    for (int u = threadIdx.x; u < tiles * 8 * VW; u += NT)
      cp_async16(sv[buf] + 4 * u, src + 4 * u);
    for (int u = threadIdx.x; u < tiles * 2; u += NT)
      cp_async16(sx[buf] + 4 * u, vi + s * TV * 8 + 4 * u);
    asm volatile("cp.async.commit_group;\n" ::);
  };
  // the stages from the block's first (the one nearest its points), round
  const int S = (T + TV - 1) / TV;
  const int s0 = first[(size_t)b * gridDim.x + blockIdx.x];
  load_stage(s0, 0);
  int visited = 0;
  unsigned slow = 0, inserts = 0, refreshes = 0;  // for stats
  for (int i = 0; i < S; ++i) {
    const int ss = s0 + i < S ? s0 + i : s0 + i - S;
    if (i + 1 < S) {
      load_stage(ss + 1 < S ? ss + 1 : 0, (i + 1) & 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const uint32_t* st = sv[i & 1];
    const int tiles = min(TV, T - ss * TV);
    // two tiles a step: two independent chains of products, one vote
    for (int tt = 0; tt < tiles; tt += 2, visited += 2) {
      const int nt = min(2, tiles - tt);
      float acc[2][R][4];
      products<KC>(acc[0], a, st, tt, lane);
      products<KC>(acc[1], a, st, tt + nt - 1, lane);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int t = ss * TV + tt + u;
        const int base = 8 * t + 2 * q;  // the position of acc[u][.][0]
        if (u >= nt || t == T - 1) {  // no second tile; positions past V
#pragma unroll
          for (int m = 0; m < R; ++m)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (u >= nt || base + (j & 1) >= V) acc[u][m][j] = INFINITY;
        }
      }
      bool hit = false;
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int m = 0; m < R; ++m)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            hit |= acc[u][m][j] <= thr[m][j >> 1];
      if (__any_sync(FULL, hit)) {
        ++slow;
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int m = 0; m < R; ++m)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int h = j >> 1;
              if (acc[u][m][j] <= thr[m][h]) {
                const int ix = sx[i & 1][8 * (tt + u) + 2 * q + (j & 1)];
                if (lex_less(acc[u][m][j], ix, ld[m][h][K - 1],
                             li[m][h][K - 1])) {
                  insert(ld[m][h], li[m][h], acc[u][m][j], ix);
                  ++inserts;
                }
                thr[m][h] = fminf(thr[m][h], ld[m][h][K - 1]);
              }
            }
      }
      if (refreshes_after(visited) || refreshes_after(visited + 1)) {
        ++refreshes;
#pragma unroll
        for (int m = 0; m < R; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            thr[m][h] = fminf(thr[m][h], quad_fourth(ld[m][h]));
      }
    }
    __syncthreads();  // this buffer is read before the stage after fills it
  }

  if (stats != nullptr) {  // the warp's slow steps and refreshes, inserts
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      inserts += __shfl_xor_sync(FULL, inserts, o);
    if (lane == 0) {
      atomicAdd(stats, (unsigned long long)slow);
      atomicAdd(stats + 1, (unsigned long long)inserts);
      atomicAdd(stats + 2, (unsigned long long)refreshes);
    }
  }
  const int* pi = pidx + (size_t)b * Mt * 16;
#pragma unroll
  for (int m = 0; m < R; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lex_merge(ld[m][h], li[m][h], 1);
      lex_merge(ld[m][h], li[m][h], 2);
      const int ns = (mt0 + m) * 16 + h * 8 + g;  // the sorted position
      if (mt0 + m >= Mt || ns >= N) continue;
      // lane q writes slot q of the point at its input position
      const float dq = q == 0 ? ld[m][h][0] : q == 1 ? ld[m][h][1]
                     : q == 2 ? ld[m][h][2] : ld[m][h][3];
      const int iq = q == 0 ? li[m][h][0] : q == 1 ? li[m][h][1]
                   : q == 2 ? li[m][h][2] : li[m][h][3];
      const size_t o = ((size_t)b * K + q) * N + __ldg(pi + ns);
      out_d[o] = sqrtf(fmaxf(dq, 0.0f));
      out_i[o] = iq;
    }
}

// ---- the operands, packed on the card (ops/knn_mxu.py::mxu_operands is
// their plain version, bit for bit)

// 10-bit x -> its bits at every third position
__device__ __forceinline__ int spread10(int x) {
  x = (x | (x << 16)) & 0x030000FF;
  x = (x | (x << 8)) & 0x0300F00F;
  x = (x | (x << 4)) & 0x030C30C3;
  return (x | (x << 2)) & 0x09249249;
}

// Morton codes of the points (B, N, 3) and vertices (B, V, 3) in the box
// [lo, hi] (B, 3 each)
__global__ void __launch_bounds__(THREADS)
mxu_codes_kernel(const float* __restrict__ pts, const float* __restrict__ vts,
                 const float* __restrict__ lo, const float* __restrict__ hi,
                 int* __restrict__ pcode, int* __restrict__ vcode, int B,
                 int N, int V) {
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e >= (long long)B * (N + V)) return;
  const int b = (int)(e / (N + V)), j = (int)(e - (long long)b * (N + V));
  const float* x = j < N ? pts + ((size_t)b * N + j) * 3
                         : vts + ((size_t)b * V + j - N) * 3;
  int code = 0;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float l = lo[b * 3 + c], h = hi[b * 3 + c];
    const float u =
        fminf(fmaxf((x[c] - l) / (h - l + 1e-9f) * 1023.0f, 0.0f), 1023.0f);
    code |= spread10((int)u) << c;
  }
  if (j < N)
    pcode[(size_t)b * N + j] = code;
  else
    vcode[(size_t)b * V + j - N] = code;
}

// the bf16 parts of x a column takes: "default" x; "highest" the part
// the column's cross product takes (points hi hi mid hi mid lo, vertices
// hi mid hi lo mid hi, 5 columns each)
template <int KC>
__device__ __forceinline__ unsigned short part(float x, int j, bool point) {
  const __nv_bfloat16 h = __float2bfloat16_rn(x);
  if (KC == 1) return __bfloat16_as_ushort(h);
  const float r = x - __bfloat162float(h);
  const __nv_bfloat16 m = __float2bfloat16_rn(r);
  const __nv_bfloat16 l = __float2bfloat16_rn(r - __bfloat162float(m));
  const int which = point ? (j == 2 || j == 4 ? 1 : j == 5 ? 2 : 0)
                          : (j == 1 || j == 4 ? 1 : j == 3 ? 2 : 0);
  return __bfloat16_as_ushort(which == 0 ? h : which == 1 ? m : l);
}

// one thread a point position s < 16 Mt (then a vertex position < 8 T)
// in Morton order: its row of 16 KC bf16 columns into the fragment words,
// its input index, and at each block's first point the block's first
// stage (the stage where its middle point's code falls)
template <int KC>
__global__ void __launch_bounds__(THREADS)
mxu_pack_kernel(const float* __restrict__ pts, const float* __restrict__ vts,
                const float* __restrict__ centre,
                const long long* __restrict__ porder,
                const long long* __restrict__ vorder,
                const int* __restrict__ pcode, const int* __restrict__ vcode,
                uint32_t* __restrict__ pfrag, uint32_t* __restrict__ vfrag,
                int* __restrict__ pidx, int* __restrict__ vidx,
                int* __restrict__ first, int B, int N, int V, int Mt, int T) {
  constexpr int D = 16 * KC;
  const int per = Mt * 16 + T * 8;
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e >= (long long)B * per) return;
  const int b = (int)(e / per), s = (int)(e - (long long)b * per);
  const bool point = s < Mt * 16;
  const int pos = point ? s : s - Mt * 16;
  const int count = point ? N : V;
  const int src = pos < count
                      ? (int)(point ? porder : vorder)[(size_t)b * count + pos]
                      : -1;
  // the row of ops/knn_mxu.py::augmented_rows: centred, |x|^2 summed as
  // (x^2 + y^2) + z^2; points [x, y, z, |p|^2, 1], vertices [-2x, -2y,
  // -2z, 1, |v|^2]
  float x[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (src >= 0) {
    const float* r = point ? pts + ((size_t)b * N + src) * 3
                           : vts + ((size_t)b * V + src) * 3;
    float y[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) y[c] = __fsub_rn(r[c], centre[b * 3 + c]);
    const float n2 = __fadd_rn(__fadd_rn(__fmul_rn(y[0], y[0]),
                                         __fmul_rn(y[1], y[1])),
                               __fmul_rn(y[2], y[2]));
#pragma unroll
    for (int c = 0; c < 3; ++c) x[c] = point ? y[c] : -2.0f * y[c];
    x[3] = point ? n2 : 1.0f;
    x[4] = point ? 1.0f : n2;
  }
  unsigned short col[D];
#pragma unroll
  for (int c = 0; c < D; ++c)
    col[c] = c < (KC == 1 ? 5 : 30) ? part<KC>(x[c % 5], c / 5, point) : 0;
  if (point) {
    // A: row h 8 + g of tile pos / 16; column pair (2q, 2q + 1) + 8 ch +
    // 16 chunk is word chunk 4 + ch 2 + h of lane g 4 + q
    const int mt = pos / 16, g = pos % 8, h = (pos % 16) / 8;
#pragma unroll
    for (int c = 0; c < D; c += 2) {
      const int q = (c % 8) / 2, ch = (c % 16) / 8, chunk = c / 16;
      pfrag[(((size_t)b * Mt + mt) * 32 + g * 4 + q) * 4 * KC + chunk * 4 +
            ch * 2 + h] = col[c] | (uint32_t)col[c + 1] << 16;
    }
    pidx[(size_t)b * Mt * 16 + pos] = src < 0 ? 0 : src;
    if (pos % BLOCK == 0 && pos < N) {
      const int code = pcode[(size_t)b * N + min(pos + BLOCK / 2, N - 1)];
      const int* vc = vcode + (size_t)b * V;
      int a = 0, z = V;  // the first vertex code not below code
      while (a < z) {
        const int m = (a + z) / 2;
        if (vc[m] < code) a = m + 1; else z = m;
      }
      first[(size_t)b * ((Mt * 16 + BLOCK - 1) / BLOCK) + pos / BLOCK] =
          min(a / (TV * 8), (T + TV - 1) / TV - 1);
    }
  } else {
    // B: vertex g of tile pos / 8; rows (2q, 2q + 1) + 8 kh + 16 chunk are
    // word chunk 2 + kh of lane g 4 + q
    const int t = pos / 8, g = pos % 8;
#pragma unroll
    for (int c = 0; c < D; c += 2) {
      const int q = (c % 8) / 2, kh = (c % 16) / 8, chunk = c / 16;
      vfrag[(((size_t)b * T + t) * 32 + g * 4 + q) * 2 * KC + chunk * 2 +
            kh] = col[c] | (uint32_t)col[c + 1] << 16;
    }
    vidx[(size_t)b * T * 8 + pos] = src < 0 ? NO_INDEX : src;
  }
}

}  // namespace

// pfrag (B, Mt, 32, 4 kc) and vfrag (B, T, 32, 2 kc) 32-bit words of bf16
// pairs of the points and vertices in Morton order, vidx (B, 8 T) and pidx
// (B, 16 Mt) their input indices, first (B, ceil(Mt / 16)) each block's
// first stage (ops/knn_mxu.py::mxu_operands), Mt = ceil(N / 16), T =
// ceil(V / 8); kc 1 ("default") or 2 ("highest"); stats (3 uint64, zeroed
// by the caller) or null: the warps' steps with an insert pass, the values
// inserted, the threshold refreshes, summed over the warps
extern "C" int animnerf_knn_mxu(const void* pfrag, const void* vfrag,
                                const void* vidx, const void* pidx,
                                const void* first, void* out_d, void* out_i,
                                void* stats, int B, int N, int V, int kc,
                                void* stream) {
  if (V < K || (kc != 1 && kc != 2) ||
      (uintptr_t)pfrag % 16 != 0 || (uintptr_t)vfrag % 16 != 0 ||
      (uintptr_t)vidx % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (N > 0 && B > 0) {
    const int Mt = (N + 15) / 16, T = (V + 7) / 8;
    dim3 grid((Mt * 16 + BLOCK - 1) / BLOCK, B);
    cudaStream_t s = (cudaStream_t)stream;
    auto st = (unsigned long long*)stats;
    auto pf = (const uint32_t*)pfrag;
    auto vf = (const uint32_t*)vfrag;
    auto vx = (const int*)vidx;
    auto px = (const int*)pidx;
    auto fs = (const int*)first;
    if (kc == 2)
      knn_mxu_mma_kernel<2><<<grid, BLOCK / R * 2, 0, s>>>(
          pf, vf, vx, px, fs, (float*)out_d, (int*)out_i, st, N, V, Mt, T);
    else
      knn_mxu_mma_kernel<1><<<grid, BLOCK / R * 2, 0, s>>>(
          pf, vf, vx, px, fs, (float*)out_d, (int*)out_i, st, N, V, Mt, T);
  }
  return (int)cudaGetLastError();
}

// the Morton codes of points (B, N, 3) and vertices (B, V, 3) in the box
// lo, hi (B, 3): pcode (B, N), vcode (B, V)
extern "C" int animnerf_knn_mxu_codes(const void* pts, const void* vts,
                                      const void* lo, const void* hi,
                                      void* pcode, void* vcode, int B, int N,
                                      int V, void* stream) {
  const long long n = (long long)B * (N + V);
  if (n > 0)
    mxu_codes_kernel<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0,
                       (cudaStream_t)stream>>>(
        (const float*)pts, (const float*)vts, (const float*)lo,
        (const float*)hi, (int*)pcode, (int*)vcode, B, N, V);
  return (int)cudaGetLastError();
}

// the kernel's inputs from the points, vertices, their centre (B, 3), the
// Morton orders porder (B, N) and vorder (B, V) (int64) and the sorted
// codes: pfrag, vfrag, vidx, pidx, first as animnerf_knn_mxu takes them
extern "C" int animnerf_knn_mxu_pack(const void* pts, const void* vts,
                                     const void* centre, const void* porder,
                                     const void* vorder, const void* pcode,
                                     const void* vcode, void* pfrag,
                                     void* vfrag, void* pidx, void* vidx,
                                     void* first, int B, int N, int V, int kc,
                                     void* stream) {
  if (kc != 1 && kc != 2) return (int)cudaErrorInvalidValue;
  const int Mt = (N + 15) / 16, T = (V + 7) / 8;
  const long long n = (long long)B * (Mt * 16 + T * 8);
  if (n > 0 && N > 0) {
    const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
    cudaStream_t s = (cudaStream_t)stream;
    if (kc == 2)
      mxu_pack_kernel<2><<<blocks, THREADS, 0, s>>>(
          (const float*)pts, (const float*)vts, (const float*)centre,
          (const long long*)porder, (const long long*)vorder,
          (const int*)pcode, (const int*)vcode, (uint32_t*)pfrag,
          (uint32_t*)vfrag, (int*)pidx, (int*)vidx, (int*)first, B, N, V, Mt,
          T);
    else
      mxu_pack_kernel<1><<<blocks, THREADS, 0, s>>>(
          (const float*)pts, (const float*)vts, (const float*)centre,
          (const long long*)porder, (const long long*)vorder,
          (const int*)pcode, (const int*)vcode, (uint32_t*)pfrag,
          (uint32_t*)vfrag, (int*)pidx, (int*)vidx, (int*)first, B, N, V, Mt,
          T);
  }
  return (int)cudaGetLastError();
}
