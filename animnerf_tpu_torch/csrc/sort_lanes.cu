// Per-row lane gather / permutation of a channel-leading payload, for Hopper.
//
// Replaces: animnerf_tpu/ops/sort_lanes.py::_permute_kernel (reached through
// _permute_lanes_pallas from permute_lanes and gather_lanes).
//
//   out[b, c, r, j] = payload[b, c, r, idx[b, r, j]],   j < J, idx < L
//
// permute_lanes is the case L == J == 128 with idx a permutation (the
// fine pass's per-ray depth merge-sort); gather_lanes is any J <= 128
// lookups into L <= 128 lanes (sample_fine's two CDF-bound gathers).
//
// Bound on the H100: bytes (C*J + J floats read by index, C*J written per
// row; no arithmetic). Design: one warp per (b, r) row; lane l moves
// positions l, l+32, l+64, l+96 for every channel, so the index reads and
// the output writes are coalesced and the payload gathers stay inside
// one row's L*4 bytes.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;

__global__ void __launch_bounds__(WARPS * 32)
gather_lanes_kernel(const float* __restrict__ pay,  // (B, C, R, L)
                    const int* __restrict__ idx,    // (B, R, J)
                    float* __restrict__ out,        // (B, C, R, J)
                    int B, int C, int R, int L, int J) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= (long long)B * R) return;
  const int b = (int)(row / R);
  const int r = (int)(row % R);
  for (int j = lane; j < J; j += 32) {
    const int o = idx[row * J + j];
    for (int c = 0; c < C; ++c) {
      const size_t base = ((size_t)b * C + c) * R + r;
      out[base * J + j] = __ldg(pay + base * L + o);
    }
  }
}

}  // namespace

extern "C" int animnerf_gather_lanes(const void* pay, const void* idx,
                                     void* out, int B, int C, int R, int L,
                                     int J, void* stream) {
  const long long rows = (long long)B * R;
  if (rows > 0 && C > 0 && J > 0) {
    const unsigned blocks = (unsigned)((rows + WARPS - 1) / WARPS);
    gather_lanes_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const float*)pay, (const int*)idx, (float*)out, B, C, R, L, J);
  }
  return (int)cudaGetLastError();
}
