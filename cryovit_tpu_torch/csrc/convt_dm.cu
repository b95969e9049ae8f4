// 2x lateral ConvTranspose (kernel (1, 2, 2), stride (1, 2, 2)) on
// depth-major activations, Hopper (sm_90a).
//
// Replaces: cryovit_tpu/ops/convt_dm.py:convt2x_dm (Pallas kernel
//   _fwd_kernel via _convt2x_single).
//
// What it computes: x (B, D, Ci, H, W) bf16 and per-parity weights
// Wp (2, 2, Ci, Co) (passed as f32; the wrapper takes the flax kernel and
// flips its taps, since flax's unflipped kernel puts tap (a, c) at output
// parity (1-a, 1-c)):
//   y[b, d, co, 2h + a, 2w + c] = sum_ci x[b, d, ci, h, w] * Wp[a, c, ci, co]
// i.e. four independent Ci -> Co products, one per output parity, with the
// 2x2 interleave done by where each result is stored. f32 accumulation,
// bf16 output (B, D, Co, 2H, 2W). Any H and W; Ci <= 64; Co in {1, 8, 16, 32}.
//
// What bounds it on the H100: Ci MACs per output value against one bf16
// store (and a quarter of an input voxel's Ci reads): 2 to 64 FLOP/byte at
// the decoder's shapes, below the ridge point, so it is memory bound and
// the output write (4x the input plane) dominates.
//
// What the design does about it: each thread owns one output pixel and all
// Co accumulators; a warp covers 32 consecutive output columns, so every
// store of one channel is a contiguous run (the interleave costs nothing),
// and the four threads that share an input voxel hit it in L1. All four
// parity weight matrices sit in shared memory. There is no bit-packing of
// column pairs: that existed only for the TPU's 32-bit lane shuffles.
// Not yet done (later work): vectorised 16-byte stores of both column
// parities from one thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileH = 8;   // output rows per block
constexpr int kTileW = 32;  // output columns per block
constexpr int kThreads = kTileH * kTileW;
constexpr int kMaxCi = 64;

template <int CO>
__global__ void __launch_bounds__(kThreads)
    convt2x_dm_kernel(const __nv_bfloat16* __restrict__ x,
                      const float* __restrict__ w,
                      __nv_bfloat16* __restrict__ y, int ci_total, int height,
                      int width) {
  __shared__ __align__(16) float sW[4 * kMaxCi * CO];
  for (int i = threadIdx.x; i < 4 * ci_total * CO; i += kThreads) sW[i] = w[i];
  __syncthreads();

  const int out_h = 2 * height, out_w = 2 * width;
  const int oh = blockIdx.y * kTileH + threadIdx.x / kTileW;
  const int ow = blockIdx.x * kTileW + threadIdx.x % kTileW;
  if (oh >= out_h || ow >= out_w) return;
  const int bd = blockIdx.z;  // b * depth + d
  const int parity = (oh & 1) * 2 + (ow & 1);
  const long long in_plane = (long long)height * width;
  const long long out_plane = (long long)out_h * out_w;
  const __nv_bfloat16* xp =
      x + (long long)bd * ci_total * in_plane + (long long)(oh >> 1) * width +
      (ow >> 1);
  const float* wp = sW + parity * ci_total * CO;

  float acc[CO];
#pragma unroll
  for (int co = 0; co < CO; ++co) acc[co] = 0.f;
  for (int c = 0; c < ci_total; ++c) {
    const float xv = __bfloat162float(xp[c * in_plane]);
#pragma unroll
    for (int co = 0; co < CO; ++co) acc[co] = fmaf(xv, wp[c * CO + co], acc[co]);
  }
  __nv_bfloat16* yp =
      y + (long long)bd * CO * out_plane + (long long)oh * out_w + ow;
#pragma unroll
  for (int co = 0; co < CO; ++co) yp[co * out_plane] = __float2bfloat16(acc[co]);
}

template <int CO>
int launch(const void* x, const float* w, void* y, int batch, int depth,
           int ci, int height, int width, cudaStream_t stream) {
  dim3 grid((2 * width + kTileW - 1) / kTileW,
            (2 * height + kTileH - 1) / kTileH, batch * depth);
  convt2x_dm_kernel<CO><<<grid, kThreads, 0, stream>>>(
      (const __nv_bfloat16*)x, w, (__nv_bfloat16*)y, ci, height, width);
  return (int)cudaGetLastError();
}

}  // namespace

// x: contiguous (batch, depth, ci, height, width) bf16; w: contiguous
// (2, 2, ci, co) f32 indexed by output parity (a, c); y: contiguous
// (batch, depth, co, 2*height, 2*width) bf16. Returns cudaGetLastError(),
// or cudaErrorInvalidValue for an unsupported ci or co.
extern "C" int cryovit_convt2x_dm(const void* x, const void* w, void* y,
                                  int batch, int depth, int ci, int co,
                                  int height, int width, void* stream) {
  if (ci < 1 || ci > kMaxCi) return (int)cudaErrorInvalidValue;
  const float* wf = (const float*)w;
  cudaStream_t s = (cudaStream_t)stream;
  switch (co) {
    case 1: return launch<1>(x, wf, y, batch, depth, ci, height, width, s);
    case 8: return launch<8>(x, wf, y, batch, depth, ci, height, width, s);
    case 16: return launch<16>(x, wf, y, batch, depth, ci, height, width, s);
    case 32: return launch<32>(x, wf, y, batch, depth, ci, height, width, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
