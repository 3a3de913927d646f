// Exact top-4 nearest vertices under packed int32 keys, for Hopper (sm_90a),
// and the vertex rows kernels 1 and 8 sweep.
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
// Bound on the H100: operations, 6 non-FMA f32 operations per (point,
// vertex) pair (row_dot's 3 multiplies and 3 adds); bytes are negligible (12 B per point in, 32 B out, the
// vertex rows stay on chip). Design: the shared sweep of knn_sweep.cuh (P
// points a thread, double-buffered staged rows, a filter in front of the
// key) with kernel 1's nested 4-slot insert after the first tile; with
// tile_skip, its per-warp skip of Morton tiles and nearest-tile-first
// order. The TPU's lane tournament is not carried over (keys are unique, so
// any exact top-4 selects the same keys). Its all-far skip (far2) is
// knn_far.cu's pass, whose flags the sweep reads; with tile_skip, the
// all-far test comes first and the groups it keeps take the tile skip, as
// in the TPU kernel.

#include <cuda_runtime.h>
#include <math.h>

#include "knn_sweep.cuh"

namespace {

// query points per thread (knn_sweep.cuh); the tile skip tests a warp's
// 32 P points against each tile, and skips more tiles at P = 2
constexpr int P = 4;
constexpr int P_SKIP = 2;

// sorted insert of key (< k[3]) into k[0] < k[1] < k[2] < k[3]: the
// nested compares (key < k[2], then k[1], then k[0]) as selects, so the
// insert takes no branch and the keys stay in their registers (branches
// here put register moves on the sweep's common path)
struct Top4Insert {
  static __device__ __forceinline__ void apply(int (&k)[4], int key) {
    const bool c2 = key < k[2], c1 = key < k[1], c0 = key < k[0];
    k[3] = c2 ? k[2] : key;
    k[2] = c2 ? (c1 ? k[1] : key) : k[2];
    k[1] = c1 ? (c0 ? k[0] : key) : k[1];
    k[0] = c0 ? key : k[0];
  }
};

// rows (B, Vp, 4) in visiting order and index (Vp,): position pos holds
// the row (-2vx, -2vy, -2vz, |v|^2) of vertex visit_index(pos), or
// (0, 0, 0, +inf) where that index is >= V
__global__ void __launch_bounds__(256)
knn_rows_kernel(const float* __restrict__ verts,  // (B, V, 3)
                float4* __restrict__ rows, int* __restrict__ index, int V,
                int Vp, int stratified) {
  const int pos = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (pos >= Vp) return;
  const int v = knn_sweep::visit_index(pos, Vp / knn_sweep::TILE,
                                       stratified != 0);
  if (b == 0) index[pos] = v;
  rows[(size_t)b * Vp + pos] =
      v < V ? knn_keys::vertex_row(verts + ((size_t)b * V + v) * 3)
            : make_float4(0.0f, 0.0f, 0.0f, INFINITY);
}

}  // namespace

// Vp = V rounded up to whole knn_sweep::TILEs, <= 8192; stratified: the
// tiles interleaved (the sweep without tile skip), else Morton tiles.
extern "C" int animnerf_knn_rows(const void* verts, void* rows, void* index,
                                 int B, int V, int Vp, int stratified,
                                 void* stream) {
  if (V < 1 || Vp < V || Vp % knn_sweep::TILE != 0 ||
      Vp > knn_keys::MAX_VERTS)
    return (int)cudaErrorInvalidValue;
  if (B > 0) {
    dim3 grid((Vp + 255) / 256, B);
    knn_rows_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
        (const float*)verts, (float4*)rows, (int*)index, V, Vp, stratified);
  }
  return (int)cudaGetLastError();
}

// rows, index: animnerf_knn_rows's for V vertices padded to Vp
// (stratified iff tile_skip == 0); vbox:
// (B, Vp / TILE, 8) f32 per-tile [lo xyz, hi xyz, 0, 0], read only when
// tile_skip != 0; stats: null, or two u64 counters of warp-tile visits
// [swept, skipped] that the kernel adds to; far: null, or the flags of
// animnerf_knn_far (which wrote the skipped groups' outputs).
extern "C" int animnerf_knn_top4(const void* points, const void* rows,
                                 const void* index, const void* vbox,
                                 int tile_skip, void* stats, const void* far,
                                 void* out_d, void* out_i, int B, int N,
                                 int V, int Vp, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (tile_skip)
    return knn_sweep::launch<4, P_SKIP, true, Top4Insert>(
        points, rows, index, vbox, stats, far, out_d, out_i, B, N, V, Vp, s);
  return knn_sweep::launch<4, P, false, Top4Insert>(
      points, rows, index, nullptr, nullptr, far, out_d, out_i, B, N, V, Vp,
      s);
}
