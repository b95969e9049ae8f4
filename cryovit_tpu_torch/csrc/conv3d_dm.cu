// SAME 3x3x3 convolution on depth-major activations, Hopper (sm_90a).
//
// Replaces: cryovit_tpu/ops/conv3d_dm.py:conv3d_dm (Pallas kernel
//   _conv_kernel via _conv3d_dm_single).
//
// What it computes: x (B, D, Ci, H, W) bf16, weights (3, 3, 3, Ci, Co) in
// the flax DHWIO tap order (passed as f32), dilation (dil, 1, 1):
//   y[b, d, co, h, w] = sum_{kd, kh, kw, ci} x[b, d + (kd-1)*dil, ci,
//                       h + kh - 1, w + kw - 1] * W[kd, kh, kw, ci, co]
// with every out-of-range tap counting as zero, accumulated in f32 and
// stored as bf16 (B, D, Co, H, W). Any H and W; Co in {1, 8, 16, 32}.
//
// What bounds it on the H100: the decoder tail's convs have few channels
// (Ci, Co <= 32) at a quarter to full voxel resolution: 27*Ci*Co MACs per
// output voxel against 2*(Ci + Co) bytes, so the arithmetic intensity is a
// few hundred FLOP/byte at 32 -> 32 and tens at 8 -> 8. The reuse that keeps
// it off the memory roof is each input voxel feeding 27 taps x Co outputs.
//
// What the design does about it: an implicit GEMM with K = 27*Ci gathered
// from shifted rows of the input, never materialised. One block of 256
// threads owns an 8 x 32 output tile of one (b, d) plane; each thread owns
// one output voxel and all Co accumulators in registers. For each depth tap
// whose plane is in range and each chunk of 8 input channels, the block
// stages a zero-padded (8 + 2) x (32 + 2) halo of the input and the chunk's
// 9 x 8 x Co weights in shared memory, then every thread runs its 72*Co
// FMAs out of shared memory (weights are read as broadcasts). Out-of-range
// depth taps are skipped whole; H and W edges come from the zero halo.
// Not yet done (later work): tensor-core MMA over the gathered K, and
// keeping several depth planes resident to reuse each staged input tile
// across the depth taps of neighbouring output planes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileH = 8;
constexpr int kTileW = 32;
constexpr int kThreads = kTileH * kTileW;
constexpr int kCiChunk = 8;

template <int CO>
__global__ void __launch_bounds__(kThreads)
    conv3d_dm_kernel(const __nv_bfloat16* __restrict__ x,
                     const float* __restrict__ w, __nv_bfloat16* __restrict__ y,
                     int depth, int ci_total, int height, int width, int dil) {
  __shared__ float sX[kCiChunk][kTileH + 2][kTileW + 2];
  __shared__ __align__(16) float sW[9][kCiChunk][CO];

  const int tx = threadIdx.x % kTileW;
  const int ty = threadIdx.x / kTileW;
  const int w0 = blockIdx.x * kTileW;
  const int h0 = blockIdx.y * kTileH;
  const int bd = blockIdx.z;  // b * depth + d
  const int d = bd % depth;
  const int b = bd / depth;
  const long long plane = (long long)height * width;

  float acc[CO];
#pragma unroll
  for (int co = 0; co < CO; ++co) acc[co] = 0.f;

  for (int kd = 0; kd < 3; ++kd) {
    const int dz = d + (kd - 1) * dil;
    if (dz < 0 || dz >= depth) continue;  // uniform across the block
    const __nv_bfloat16* xp = x + ((long long)b * depth + dz) * ci_total * plane;
    for (int c0 = 0; c0 < ci_total; c0 += kCiChunk) {
      __syncthreads();  // previous chunk consumed
      for (int i = threadIdx.x; i < kCiChunk * (kTileH + 2) * (kTileW + 2);
           i += kThreads) {
        const int c = i / ((kTileH + 2) * (kTileW + 2));
        const int rem = i % ((kTileH + 2) * (kTileW + 2));
        const int r = rem / (kTileW + 2);
        const int col = rem % (kTileW + 2);
        const int hh = h0 + r - 1;
        const int ww = w0 + col - 1;
        float val = 0.f;
        if (c0 + c < ci_total && hh >= 0 && hh < height && ww >= 0 &&
            ww < width) {
          val = __bfloat162float(xp[(c0 + c) * plane + (long long)hh * width + ww]);
        }
        sX[c][r][col] = val;
      }
      for (int i = threadIdx.x; i < 9 * kCiChunk * CO; i += kThreads) {
        const int tap = i / (kCiChunk * CO);
        const int c = (i / CO) % kCiChunk;
        const int co = i % CO;
        sW[tap][c][co] =
            c0 + c < ci_total
                ? w[((kd * 9 + tap) * ci_total + c0 + c) * CO + co]
                : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
#pragma unroll
          for (int c = 0; c < kCiChunk; ++c) {
            const float xv = sX[c][ty + kh][tx + kw];
#pragma unroll
            for (int co = 0; co < CO; ++co) {
              acc[co] = fmaf(xv, sW[kh * 3 + kw][c][co], acc[co]);
            }
          }
        }
      }
    }
  }

  const int h = h0 + ty;
  const int ww = w0 + tx;
  if (h < height && ww < width) {
    __nv_bfloat16* yp = y + (long long)bd * CO * plane + (long long)h * width + ww;
#pragma unroll
    for (int co = 0; co < CO; ++co) yp[co * plane] = __float2bfloat16(acc[co]);
  }
}

template <int CO>
int launch(const void* x, const float* w, void* y, int batch, int depth,
           int ci, int height, int width, int dil, cudaStream_t stream) {
  dim3 grid((width + kTileW - 1) / kTileW, (height + kTileH - 1) / kTileH,
            batch * depth);
  conv3d_dm_kernel<CO><<<grid, kThreads, 0, stream>>>(
      (const __nv_bfloat16*)x, w, (__nv_bfloat16*)y, depth, ci, height, width,
      dil);
  return (int)cudaGetLastError();
}

}  // namespace

// x: contiguous (batch, depth, ci, height, width) bf16; w: contiguous
// (3, 3, 3, ci, co) f32; y: contiguous (batch, depth, co, height, width)
// bf16. Returns cudaGetLastError(), or cudaErrorInvalidValue for an
// unsupported co.
extern "C" int cryovit_conv3d_dm(const void* x, const void* w, void* y,
                                 int batch, int depth, int ci, int co,
                                 int height, int width, int dil, void* stream) {
  const float* wf = (const float*)w;
  cudaStream_t s = (cudaStream_t)stream;
  switch (co) {
    case 1: return launch<1>(x, wf, y, batch, depth, ci, height, width, dil, s);
    case 8: return launch<8>(x, wf, y, batch, depth, ci, height, width, dil, s);
    case 16: return launch<16>(x, wf, y, batch, depth, ci, height, width, dil, s);
    case 32: return launch<32>(x, wf, y, batch, depth, ci, height, width, dil, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
