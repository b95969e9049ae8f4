// Fixed-order sum of per-block partial results, shared by the weight-gradient
// kernels (conv3d_dm_dw.cu, convt_dm_bwd.cu).
//
// Those kernels split their reduction over voxels across the grid: block p
// writes its partial sums to partial[p * m + o], o < m. This pass adds the
// partials of every block in block order, so a result does not change from
// run to run (atomics would add them in whatever order the blocks finish).

#pragma once

#include <cuda_runtime.h>

namespace cryovit {
namespace {  // internal linkage: every source that includes this gets its own copy

__global__ void sum_partials_kernel(const float* __restrict__ partial,
                                    float* __restrict__ out, int nparts,
                                    int m) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= m) return;
  float s = 0.f;
  for (int p = 0; p < nparts; ++p) s += partial[(long long)p * m + o];
  out[o] = s;
}

int sum_partials(const float* partial, float* out, int nparts, int m,
                 cudaStream_t stream) {
  sum_partials_kernel<<<(m + 255) / 256, 256, 0, stream>>>(partial, out,
                                                           nparts, m);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace cryovit
