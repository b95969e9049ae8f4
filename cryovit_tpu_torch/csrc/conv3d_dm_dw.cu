// Weight gradient of the SAME 3x3x3 depth-major convolution, Hopper (sm_90a).
//
// Replaces: cryovit_tpu/ops/conv3d_dm.py:conv3d_dm_dw (Pallas kernel
//   _dw_kernel via _conv3d_dm_dw_single).
//
// What it computes: x (B, D, Ci, H, W) bf16 (the forward's input), g
// (B, D, Co, H, W) bf16 (the cotangent of its output), dilation (dil, 1, 1):
//   dW[kd, kh, kw, ci, co] = sum_{b, d, h, w} x[b, d + (kd-1)*dil, ci,
//                            h + kh - 1, w + kw - 1] * g[b, d, co, h, w]
// with every out-of-range tap counting as zero, as f32 (3, 3, 3, Ci, Co).
// Any H and W, any Ci; Co in {1, 8, 16, 32}.
//
// What bounds it on the H100: 27*Ci*Co MACs per voxel against 2*(Ci + Co)
// bytes read once, the same arithmetic as the forward conv: a few hundred
// FLOP/byte at 32 -> 32, tens at 8 -> 1, so the f32 FMA rate of the CUDA
// cores (no tensor cores here) bounds it, not the memory.
//
// What the design does about it: the TPU kernel carries dW in VMEM from one
// sequential grid step to the next. Hopper's blocks run in parallel and in
// no order, so the reduction over voxels is split in two passes:
// 1. A grid of about two blocks per SM; each block strides over work items
//    (b, d, 8 x 32 output tile) and owns its share of the sum. For each
//    depth tap kd and each chunk of 8 input channels, the block stages the
//    zero-padded (8 + 2) x (32 + 2) halo of the input plane d + (kd-1)*dil
//    and the g tile in shared memory. Each thread owns one (ci, co) pair and
//    its 9 lateral taps, 9 accumulators in registers; with fewer than 256
//    pairs, S lanes share a pair, each summing a segment of the tile, and a
//    warp shuffle adds the S lanes. Inner loop: runs of 8 voxels of a row,
//    3 rows x 10 input values and 8 g values in registers for 72 FMAs. The
//    g tile is stored with a skew (pitch 256 + S, one pad per segment) so
//    the lanes of a warp read 32 distinct banks.
//    Depth taps whose plane is out of range are skipped for the whole item,
//    taking them out of the sum (the TPU kernel clamps their plane and
//    multiplies by zero). H and W edges come from the zero halo and a zero g
//    outside the plane.
//    Each block writes one partial dW (27*Ci*Co floats): 264 blocks at
//    32 -> 32 is 29 MB of scratch, never one partial per tile.
// 2. block_sum.cuh adds the partials in block order: the result is the
//    same from run to run.
// Not yet done (later work): tensor-core MMA over the voxel dimension
// (x and g are bf16), and staging each g tile once for all kd and chunks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "block_sum.cuh"

namespace {

constexpr int kTileH = 8;
constexpr int kTileW = 32;
constexpr int kTile = kTileH * kTileW;
constexpr int kThreads = 256;
constexpr int kCiChunk = 8;
constexpr int kRun = 8;  // consecutive voxels of a row per inner step

template <int CO>
__global__ void __launch_bounds__(kThreads)
    conv3d_dm_dw_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ g,
                        float* __restrict__ partial, int batch, int depth,
                        int ci_total, int height, int width, int dil) {
  // lanes per (ci, co) pair and the tile segment each of them sums
  constexpr int S = kCiChunk * CO >= kThreads ? 1 : kThreads / (kCiChunk * CO);
  constexpr int SEG = kTile / S;
  constexpr int GP = kTile + S;  // g row pitch: one pad after each segment
  static_assert(SEG % kRun == 0 && kTileW % kRun == 0, "runs tile the rows");
  __shared__ float sX[kCiChunk][kTileH + 2][kTileW + 2];
  __shared__ float sG[CO * GP];

  const int pair = threadIdx.x / S;
  const int split = threadIdx.x % S;
  const int ci_l = pair / CO;
  const int co = pair % CO;
  const int tiles_w = (width + kTileW - 1) / kTileW;
  const int tiles_h = (height + kTileH - 1) / kTileH;
  const long long n_items = (long long)batch * depth * tiles_h * tiles_w;
  const long long plane = (long long)height * width;
  float* out = partial + (long long)blockIdx.x * 27 * ci_total * CO;

  for (int kd = 0; kd < 3; ++kd) {
    for (int c0 = 0; c0 < ci_total; c0 += kCiChunk) {
      float acc[9];
#pragma unroll
      for (int t = 0; t < 9; ++t) acc[t] = 0.f;

      for (long long item = blockIdx.x; item < n_items; item += gridDim.x) {
        const int tw = (int)(item % tiles_w);
        const long long rest = item / tiles_w;
        const int th = (int)(rest % tiles_h);
        const long long bd = rest / tiles_h;  // b * depth + d
        const int d = (int)(bd % depth);
        const int b = (int)(bd / depth);
        const int dz = d + (kd - 1) * dil;
        if (dz < 0 || dz >= depth) continue;  // uniform across the block
        const int h0 = th * kTileH;
        const int w0 = tw * kTileW;

        __syncthreads();  // previous item consumed
        const __nv_bfloat16* xp =
            x + ((long long)b * depth + dz) * ci_total * plane;
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
            val = __bfloat162float(
                xp[(c0 + c) * plane + (long long)hh * width + ww]);
          }
          sX[c][r][col] = val;
        }
        const __nv_bfloat16* gp = g + bd * CO * plane;
        for (int i = threadIdx.x; i < CO * kTile; i += kThreads) {
          const int c = i / kTile;
          const int v = i % kTile;
          const int hh = h0 + v / kTileW;
          const int ww = w0 + v % kTileW;
          float val = 0.f;
          if (hh < height && ww < width) {
            val = __bfloat162float(gp[c * plane + (long long)hh * width + ww]);
          }
          sG[c * GP + v + v / SEG] = val;
        }
        __syncthreads();

        const float* xs = &sX[ci_l][0][0];
        const float* gs = sG + co * GP + split * (SEG + 1);
        for (int run = 0; run < SEG / kRun; ++run) {
          const int v0 = split * SEG + run * kRun;
          const int r = v0 / kTileW;
          const int c = v0 % kTileW;
          float gv[kRun];
#pragma unroll
          for (int j = 0; j < kRun; ++j) gv[j] = gs[run * kRun + j];
#pragma unroll
          for (int kh = 0; kh < 3; ++kh) {
            float xv[kRun + 2];
#pragma unroll
            for (int j = 0; j < kRun + 2; ++j)
              xv[j] = xs[(r + kh) * (kTileW + 2) + c + j];
#pragma unroll
            for (int kw = 0; kw < 3; ++kw) {
#pragma unroll
              for (int j = 0; j < kRun; ++j)
                acc[kh * 3 + kw] = fmaf(xv[j + kw], gv[j], acc[kh * 3 + kw]);
            }
          }
        }
      }

      // the S lanes of a pair are consecutive lanes of one warp
#pragma unroll
      for (int t = 0; t < 9; ++t) {
#pragma unroll
        for (int off = S / 2; off > 0; off >>= 1)
          acc[t] += __shfl_down_sync(0xffffffffu, acc[t], off);
      }
      if (split == 0 && c0 + ci_l < ci_total) {
#pragma unroll
        for (int t = 0; t < 9; ++t)
          out[((kd * 9 + t) * ci_total + c0 + ci_l) * CO + co] = acc[t];
      }
    }
  }
}

template <int CO>
int launch(const void* x, const void* g, float* partial, float* dw, int batch,
           int depth, int ci, int height, int width, int dil, int nblocks,
           cudaStream_t stream) {
  conv3d_dm_dw_kernel<CO><<<nblocks, kThreads, 0, stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)g, partial, batch, depth,
      ci, height, width, dil);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  return cryovit::sum_partials(partial, dw, nblocks, 27 * ci * CO, stream);
}

}  // namespace

// x: contiguous (batch, depth, ci, height, width) bf16; g: contiguous
// (batch, depth, co, height, width) bf16; partial: nblocks * 27 * ci * co
// f32 scratch; dw: (3, 3, 3, ci, co) f32 output. Returns cudaGetLastError(),
// or cudaErrorInvalidValue for an unsupported co or grid.
extern "C" int cryovit_conv3d_dm_dw(const void* x, const void* g,
                                    void* partial, void* dw, int batch,
                                    int depth, int ci, int co, int height,
                                    int width, int dil, int nblocks,
                                    void* stream) {
  if (nblocks < 1 || ci < 1) return (int)cudaErrorInvalidValue;
  float* p = (float*)partial;
  float* out = (float*)dw;
  cudaStream_t s = (cudaStream_t)stream;
  switch (co) {
    case 1: return launch<1>(x, g, p, out, batch, depth, ci, height, width, dil, nblocks, s);
    case 8: return launch<8>(x, g, p, out, batch, depth, ci, height, width, dil, nblocks, s);
    case 16: return launch<16>(x, g, p, out, batch, depth, ci, height, width, dil, nblocks, s);
    case 32: return launch<32>(x, g, p, out, batch, depth, ci, height, width, dil, nblocks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
