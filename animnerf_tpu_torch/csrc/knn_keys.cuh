// Packed kNN keys, shared by knn.cu (kernel 1, the tournament kernel's
// counterpart) and knn_packed.cu (kernel 8, the extract-min kernel's)
// through knn_sweep.cuh, so that the two cannot drift apart.
//
// Contract (bit-identical keys to the TPU kernels and to the plain version
// in ops/knn_kernel.py): for point p and vertex v,
//   pp   = (px*px + py*py) + pz*pz
//   m2   = -(v + v),   vq = (vx*vx + vy*vy) + vz*vz
//   d2   = max(pp + (m2z*pz + (m2y*py + (m2x*px + vq))), 0)
//   key  = (bits(d2) & ~0x1FFF) | vertex_index        (V <= 8192)
// Every product and sum goes through __fmul_rn / __fadd_rn: nvcc would
// otherwise contract a*b+c into an FMA, which XLA does not, and a key
// differing in one bit can swap two neighbours. Keys are unique (index
// bits), so the k smallest do not depend on the order they are visited in.

#pragma once

#include <cuda_runtime.h>

namespace knn_keys {

constexpr int KEY_MASK = ~0x1FFF;
constexpr int INDEX_MASK = 0x1FFF;
constexpr int BIGKEY = 0x7FFFFFFF;
constexpr int MAX_VERTS = 8192;

__device__ __forceinline__ float point_pp(float px, float py, float pz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(px, px), __fmul_rn(py, py)),
                   __fmul_rn(pz, pz));
}

// the staged vertex row (-2vx, -2vy, -2vz, |v|^2) of the vertex at v
__device__ __forceinline__ float4 vertex_row(const float* v) {
  const float vx = v[0], vy = v[1], vz = v[2];
  const float vq = __fadd_rn(__fadd_rn(__fmul_rn(vx, vx), __fmul_rn(vy, vy)),
                             __fmul_rn(vz, vz));
  return make_float4(-__fadd_rn(vx, vx), -__fadd_rn(vy, vy),
                     -__fadd_rn(vz, vz), vq);
}

// the dot form's sum below pp: m2z*pz + (m2y*py + (m2x*px + vq)), for the
// staged row v = (m2x, m2y, m2z, vq)
__device__ __forceinline__ float row_dot(float4 v, float px, float py,
                                         float pz) {
  return __fadd_rn(__fmul_rn(v.z, pz),
                   __fadd_rn(__fmul_rn(v.y, py),
                             __fadd_rn(__fmul_rn(v.x, px), v.w)));
}

// the key of the vertex at index, from pp and its row_dot s
__device__ __forceinline__ int key_of(float pp, float s, int index) {
  const float d2 = fmaxf(__fadd_rn(pp, s), 0.0f);
  return (__float_as_int(d2) & KEY_MASK) | index;
}

__device__ __forceinline__ float key_dist(int key) {
  return sqrtf(__int_as_float(key & KEY_MASK));
}

__device__ __forceinline__ int key_index(int key) { return key & INDEX_MASK; }

}  // namespace knn_keys
