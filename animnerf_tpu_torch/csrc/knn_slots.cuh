// The exact kNN's top-k rule, shared by knn_exact.cu (kernel 9) and
// knn_mxu.cu (kernel 10), so that the two cannot drift apart.
//
// The TPU kernels (knn_pallas.py::_knn_kernel, bench_knn.py::
// _mxu_knn_kernel) keep K unsorted slots (d2, index), initialised to
// (+inf, 0). For each 512-vertex tile, in index order, they extract the
// tile's K smallest (d2, index) pairs in ascending (d2, index) order and
// merge each in that order: the pair replaces the FIRST slot holding the
// slots' maximum, only if its d2 is strictly smaller. At the end a
// compare-swap network sorts the slots (K = 4: (0,1),(2,3),(0,2),(1,3),
// (1,2); otherwise a bubble network), swapping only when the first d2 is
// strictly larger. Where distinct vertices tie exactly, this decides which
// one is kept and where it lands; a sort by (d2, index) would not.
//
// Here a thread keeps its K slots and the current tile's ascending K pairs
// in registers (K is a template argument, every loop unrolled, so no
// array goes to local memory). A pair whose d2 is not below the slots'
// maximum at the start of its tile can never be merged (the maximum only
// falls), so the tile's list starts full of that maximum and only smaller
// pairs enter it: the result is the same, and once the slots are tight
// almost no vertex takes the insert path. The JAX kernels' padding
// vertices (at 1e9) lose to every real vertex and are not visited.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace knn_slots {

constexpr int TILE = 512;  // the TPU kernels' vertex tile (tile_v)

template <int K>
__device__ __forceinline__ void fill(float (&d)[K], int (&i)[K], float x) {
#pragma unroll
  for (int s = 0; s < K; ++s) {
    d[s] = x;
    i[s] = 0;
  }
}

template <int K>
__device__ __forceinline__ float max_of(const float (&d)[K]) {
  float mx = d[0];
#pragma unroll
  for (int t = 1; t < K; ++t) mx = d[t] > mx ? d[t] : mx;
  return mx;
}

// insert (x, id) into the ascending list (d, i); visited in index order,
// an equal d2 goes after the entries already there: ascending (d2, index)
template <int K>
__device__ __forceinline__ void insert(float (&d)[K], int (&i)[K], float x,
                                       int id) {
  if (!(x < d[K - 1])) return;
#pragma unroll
  for (int s = K - 1; s > 0; --s) {
    const bool up = x < d[s - 1];
    const bool here = x < d[s];
    d[s] = up ? d[s - 1] : (here ? x : d[s]);
    i[s] = up ? i[s - 1] : (here ? id : i[s]);
  }
  if (x < d[0]) {
    d[0] = x;
    i[0] = id;
  }
}

// merge a tile's ascending pairs (td, ti) into the slots (sd, si)
template <int K>
__device__ __forceinline__ void merge(float (&sd)[K], int (&si)[K],
                                      const float (&td)[K],
                                      const int (&ti)[K]) {
#pragma unroll
  for (int s = 0; s < K; ++s) {
    float mx = sd[0];
    int am = 0;
#pragma unroll
    for (int t = 1; t < K; ++t) {
      if (sd[t] > mx) {
        mx = sd[t];
        am = t;
      }
    }
    // the pairs ascend and the maximum only falls: none after this one
    // can replace either
    if (!(td[s] < mx)) break;
#pragma unroll
    for (int t = 0; t < K; ++t) {
      if (t == am) {
        sd[t] = td[s];
        si[t] = ti[s];
      }
    }
  }
}

template <int K>
__device__ __forceinline__ void cswap(float (&d)[K], int (&i)[K], int a,
                                      int b) {
  const bool swap = d[a] > d[b];
  const float da = d[a], db = d[b];
  const int ia = i[a], ib = i[b];
  d[a] = swap ? db : da;
  d[b] = swap ? da : db;
  i[a] = swap ? ib : ia;
  i[b] = swap ? ia : ib;
}

// the JAX kernels' final network
template <int K>
__device__ __forceinline__ void sort(float (&d)[K], int (&i)[K]) {
  if constexpr (K == 4) {
    cswap<K>(d, i, 0, 1);
    cswap<K>(d, i, 2, 3);
    cswap<K>(d, i, 0, 2);
    cswap<K>(d, i, 1, 3);
    cswap<K>(d, i, 1, 2);
  } else {
#pragma unroll
    for (int end = K - 1; end > 0; --end) {
#pragma unroll
      for (int a = 0; a < end; ++a) cswap<K>(d, i, a, a + 1);
    }
  }
}

}  // namespace knn_slots
