// The warp-per-point selection shared by the run-time-k kNN kernels,
// knn_packed.cu's knn_packed_wide (kernel 8) and knn_exact.cu's
// knn_exact_wide (kernel 9): a warp owns one query point at a time and
// its lanes split every vertex tile it sweeps (lane l takes rows l, l +
// 32, ...), so each pair's key or d2 is computed once and no lane waits on
// another's insert. What both need beside their own policy (the order
// they visit tiles in, what they keep) lives here:
//
// - Lane-strided lists. A sorted list of n = 32R keys sits in R registers
//   of every lane: element e in lane e % 32, register e / 32. A compare-
//   exchange at stride j < 32 is one shuffle; at j >= 32 it pairs two
//   registers of the same lane. bitonic_sort sorts such a list ascending,
//   fold merges a sorted list of new keys into it (its n smallest stay):
//   C[e] = min(A[e], B[n-1-e]) holds the n smallest of A and B as a
//   bitonic sequence, and log2(n) merge stages sort it.
// - A per-warp buffer in shared memory. Lanes whose key passes the vote
//   append it at count + popc(ballot below them); when the next row would
//   overflow the buffer, it is sorted and folded into the list, and the
//   list's k-th key becomes the new filter.
//
// - pick / put: a warp that keeps several points' state in registers
//   works on one at a time through compare-selects on constant indices.
//
// The keys must be totally ordered for the selection to be exact: kernel
// 8's packed keys carry the vertex index, kernel 9's (d2 bits, index)
// 64-bit keys likewise; padding sentinels (all ones) sort above every key
// and are never output (V >= k). tests/test_torch_knn_wide.py models the
// networks element for element (ops/knn_wide.py).

#pragma once

#include <cuda_runtime.h>

namespace knn_wide {

constexpr unsigned FULL = 0xFFFFFFFFu;
// the most slots a warp keeps in registers (R = 4); above, the kernels'
// run-time-k global-memory versions take k
constexpr int CAP = 128;

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

__device__ __forceinline__ unsigned lanes_below() {
  return (1u << lane_id()) - 1u;
}

// element i of a lane-strided list, in every lane (i uniform)
template <int R, class T>
__device__ __forceinline__ T element(const T (&v)[R], int i) {
  T x = v[0];
#pragma unroll
  for (int r = 1; r < R; ++r)
    if (i >> 5 == r) x = v[r];
  return __shfl_sync(FULL, x, i & 31);
}

// a[p] and a[p] = x for a runtime p, by compare-selects over the constant
// indices: a warp keeps several points' state in registers and works on
// one at a time (indexing the arrays by p would put them in local memory)
template <int P, class T>
__device__ __forceinline__ T pick(const T (&a)[P], int p) {
  T x = a[0];
#pragma unroll
  for (int q = 1; q < P; ++q)
    if (q == p) x = a[q];
  return x;
}

template <int P, class T>
__device__ __forceinline__ void put(T (&a)[P], int p, T x) {
#pragma unroll
  for (int q = 0; q < P; ++q)
    if (q == p) a[q] = x;
}

template <int P, int R, class T>
__device__ __forceinline__ void pick_list(T (&w)[R], const T (&a)[P][R],
                                          int p) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    w[r] = a[0][r];
#pragma unroll
    for (int q = 1; q < P; ++q)
      if (q == p) w[r] = a[q][r];
  }
}

template <int P, int R, class T>
__device__ __forceinline__ void put_list(T (&a)[P][R], int p,
                                         const T (&w)[R]) {
#pragma unroll
  for (int q = 0; q < P; ++q)
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (q == p) a[q][r] = w[r];
}

// one compare-exchange stage of a bitonic network over n = 32R elements:
// element e is paired with e ^ STRIDE and the pair ascends where e & SIZE
// is 0 (SIZE = 2n: everywhere). With PAY the int payload p moves along.
// SIZE and STRIDE are template arguments so that every register index is
// a constant (a loop the compiler does not unroll puts the list in local
// memory).
template <int R, bool PAY, int SIZE, int STRIDE, class T>
__device__ __forceinline__ void stage(T (&v)[R], int (&p)[R]) {
  const int lane = lane_id();
  if constexpr (STRIDE >= 32) {
    constexpr int RS = STRIDE / 32;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r & RS) continue;
      const int r2 = r | RS;
      const bool up = ((lane + 32 * r) & SIZE) == 0;
      const bool swap = up ? v[r2] < v[r] : v[r] < v[r2];
      const T a = v[r], b = v[r2];
      v[r] = swap ? b : a;
      v[r2] = swap ? a : b;
      if constexpr (PAY) {
        const int pa = p[r], pb = p[r2];
        p[r] = swap ? pb : pa;
        p[r2] = swap ? pa : pb;
      }
    }
  } else {
    const bool lower = (lane & STRIDE) == 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const T o = __shfl_xor_sync(FULL, v[r], STRIDE);
      const bool up = ((lane + 32 * r) & SIZE) == 0;
      // the lower element of an ascending pair keeps the minimum
      const bool take = lower == up ? o < v[r] : v[r] < o;
      v[r] = take ? o : v[r];
      if constexpr (PAY) {
        const int po = __shfl_xor_sync(FULL, p[r], STRIDE);
        p[r] = take ? po : p[r];
      }
    }
  }
}

// the stages of one merge: strides STRIDE, STRIDE / 2, ..., 1
template <int R, bool PAY, int SIZE, int STRIDE, class T>
__device__ __forceinline__ void merge_stages(T (&v)[R], int (&p)[R]) {
  stage<R, PAY, SIZE, STRIDE>(v, p);
  if constexpr (STRIDE > 1) merge_stages<R, PAY, SIZE, STRIDE / 2>(v, p);
}

// the merges of a sort: sizes SIZE, 2 SIZE, ..., n
template <int R, bool PAY, int SIZE, class T>
__device__ __forceinline__ void sort_merges(T (&v)[R], int (&p)[R]) {
  merge_stages<R, PAY, SIZE, SIZE / 2>(v, p);
  if constexpr (SIZE < 32 * R) sort_merges<R, PAY, 2 * SIZE>(v, p);
}

// sort the lane-strided list ascending (with its payload)
template <int R, bool PAY, class T>
__device__ __forceinline__ void bitonic_sort(T (&v)[R], int (&p)[R]) {
  sort_merges<R, PAY, 2>(v, p);
}

template <int R, class T>
__device__ __forceinline__ void bitonic_sort(T (&v)[R]) {
  int p[R];
  sort_merges<R, false, 2>(v, p);
}

// sort a list whose elements from count on are all the same sentinel,
// the largest key: only its first registers, as a shorter list
template <int R, class T>
__device__ __forceinline__ void sort_prefix(T (&v)[R], int count) {
  if constexpr (R > 1) {
    if (count <= 16 * R) {
      T h[R / 2];
#pragma unroll
      for (int r = 0; r < R / 2; ++r) h[r] = v[r];
      sort_prefix<R / 2>(h, count);
#pragma unroll
      for (int r = 0; r < R / 2; ++r) v[r] = h[r];
      return;
    }
  }
  bitonic_sort<R>(v);
}

// a (ascending) := the n smallest of a and b (both ascending), ascending
template <int R, class T>
__device__ __forceinline__ void fold(T (&a)[R], const T (&b)[R]) {
  const int lane = lane_id();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const T o = __shfl_sync(FULL, b[R - 1 - r], 31 - lane);  // b[n-1-e]
    a[r] = o < a[r] ? o : a[r];
  }
  int p[R];
  merge_stages<R, false, 64 * R, 16 * R>(a, p);
}

// append this lane's key to the warp's buffer if take; returns the new
// count (uniform). The caller keeps count + 32 <= the buffer's size.
template <class T>
__device__ __forceinline__ int append(T* buf, int count, bool take, T key) {
  const unsigned m = __ballot_sync(FULL, take);
  if (take) buf[count + __popc(m & lanes_below())] = key;
  return count + __popc(m);
}

// the buffer's first count keys, the rest sentinel, as a lane-strided
// list (the warp's appends are visible: __syncwarp first)
template <int R, class T>
__device__ __forceinline__ void load_buffer(T (&b)[R], const T* buf,
                                            int count, T sentinel) {
  __syncwarp();
  const int lane = lane_id();
#pragma unroll
  for (int r = 0; r < R; ++r)
    b[r] = lane + 32 * r < count ? buf[lane + 32 * r] : sentinel;
  __syncwarp();  // read before the next append overwrites it
}

}  // namespace knn_wide
