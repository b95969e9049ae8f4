// Backward of the 2x lateral ConvTranspose (kernel (1, 2, 2), stride
// (1, 2, 2)) on depth-major activations, Hopper (sm_90a): dx and dW from one
// pass over g and x.
//
// Replaces: cryovit_tpu/ops/convt_dm.py:convt2x_dm_bwd (Pallas kernel
//   _bwd_kernel via _convt2x_bwd_single).
//
// What it computes: g (B, D, Co, 2H, 2W) bf16 (the cotangent of the
// forward's output), x (B, D, Ci, H, W) bf16 (its input) and the parity
// weights Wp (2, 2, Ci, Co) (f32; Wp[a, c] is the flax kernel's tap
// (1-a, 1-c), as in convt_dm.cu):
//   dx[b, d, ci, h, w] = sum_{a, c, co} Wp[a, c, ci, co] * g[b, d, co, 2h+a, 2w+c]
//   dWp[a, c, ci, co]  = sum_{b, d, h, w} x[b, d, ci, h, w] * g[b, d, co, 2h+a, 2w+c]
// dx in bf16, dWp in f32 (the wrapper maps parity (a, c) back to the flax
// tap (1-a, 1-c)). Any H and W; Ci and Co in {8, 16, 32}.
//
// What bounds it on the H100: 8*Ci*Co MACs per input pixel (4*Ci*Co for
// dx, as many for dW) against 2*(Ci + 4*Co) bytes read and 2*Ci written:
// 16 FLOP/byte at 16 -> 8 and 43 at 32 -> 32, around the f32 CUDA-core
// ridge (67 TFLOP/s over 3.35 TB/s = 20 FLOP/byte). Against the bf16
// tensor-core peak the work is memory bound at both shapes, which is the
// bound chip_smoke.py reports.
//
// What the design does about it: each block of 128 threads strides over
// work items (b, d, 4 x 32 input pixels); one thread per input pixel. The
// thread reads its pixel's Ci inputs and the 4*Co cotangent values of its
// 2 x 2 output block (the parity is just the load address: no column
// bit-packing, which existed only for the TPU's 32-bit lanes), sums dx for
// all Ci in registers from the weights in shared memory (read as
// broadcasts), stores dx, and leaves x and g in shared memory. Then each
// thread owns Ci/TPP of the 4*Ci*Co dW outputs (one parity, one co) and
// adds the tile's 128 pixels into register accumulators that live across
// all the block's items. The TPU kernel carries dW in VMEM across its
// sequential grid; here each block writes one partial (<= 4096 floats) and
// block_sum.cuh adds the partials in block order, so the result is the same
// from run to run.
// Not yet done (later work): tensor-core MMA for both products, and
// vectorised loads of the column pairs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "block_sum.cuh"

namespace {

constexpr int kTileH = 4;   // input rows per item
constexpr int kTileW = 32;  // input columns per item
constexpr int kThreads = kTileH * kTileW;
constexpr int kPitch = kThreads + 1;  // shared rows of 128 pixels, padded

template <int CI, int CO>
constexpr int smem_bytes() {
  return (4 * CI * CO + CI * kPitch + 4 * CO * kPitch) * (int)sizeof(float);
}

template <int CI, int CO>
__global__ void __launch_bounds__(kThreads)
    convt2x_dm_bwd_kernel(const __nv_bfloat16* __restrict__ g,
                          const __nv_bfloat16* __restrict__ x,
                          const float* __restrict__ w,
                          __nv_bfloat16* __restrict__ dx,
                          float* __restrict__ partial, int batch_depth,
                          int height, int width) {
  constexpr int TPP = kThreads / (4 * CO);  // threads per (parity, co)
  constexpr int NCI = CI / TPP;             // dW inputs per thread
  static_assert(TPP >= 1 && NCI >= 1 && NCI * TPP == CI, "Ci, Co in {8,16,32}");
  extern __shared__ float smem[];
  float* sW = smem;               // (4, CI, CO) parity weights
  float* sX = sW + 4 * CI * CO;   // (CI, kPitch) x of the item's pixels
  float* sG = sX + CI * kPitch;   // (4, CO, kPitch) g by parity

  for (int i = threadIdx.x; i < 4 * CI * CO; i += kThreads) sW[i] = w[i];

  const int pair = threadIdx.x / TPP;
  const int ac_w = pair / CO;
  const int co_w = pair % CO;
  const int ci_w = (threadIdx.x % TPP) * NCI;
  float accw[NCI];
#pragma unroll
  for (int k = 0; k < NCI; ++k) accw[k] = 0.f;

  const int tiles_w = (width + kTileW - 1) / kTileW;
  const int tiles_h = (height + kTileH - 1) / kTileH;
  const long long n_items = (long long)batch_depth * tiles_h * tiles_w;
  const long long plane = (long long)height * width;
  const int out_w = 2 * width;
  const long long out_plane = 4 * plane;

  for (long long item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int tw = (int)(item % tiles_w);
    const long long rest = item / tiles_w;
    const int th = (int)(rest % tiles_h);
    const long long bd = rest / tiles_h;
    const int h = th * kTileH + threadIdx.x / kTileW;
    const int ww = tw * kTileW + threadIdx.x % kTileW;
    const bool valid = h < height && ww < width;

    __syncthreads();  // weights staged; previous item's dW pass done
    const __nv_bfloat16* xp = x + bd * CI * plane + (long long)h * width + ww;
#pragma unroll 4
    for (int ci = 0; ci < CI; ++ci)
      sX[ci * kPitch + threadIdx.x] =
          valid ? __bfloat162float(xp[ci * plane]) : 0.f;

    float dxa[CI];
#pragma unroll
    for (int ci = 0; ci < CI; ++ci) dxa[ci] = 0.f;
    const __nv_bfloat16* gp =
        g + bd * CO * out_plane + (long long)(2 * h) * out_w + 2 * ww;
    for (int co = 0; co < CO; ++co) {
      float gv[4] = {0.f, 0.f, 0.f, 0.f};  // parity a * 2 + c
      if (valid) {
        const __nv_bfloat16* gq = gp + co * out_plane;
        gv[0] = __bfloat162float(gq[0]);
        gv[1] = __bfloat162float(gq[1]);
        gv[2] = __bfloat162float(gq[out_w]);
        gv[3] = __bfloat162float(gq[out_w + 1]);
      }
#pragma unroll
      for (int ac = 0; ac < 4; ++ac) {
        sG[(ac * CO + co) * kPitch + threadIdx.x] = gv[ac];
#pragma unroll
        for (int ci = 0; ci < CI; ++ci)
          dxa[ci] = fmaf(sW[(ac * CI + ci) * CO + co], gv[ac], dxa[ci]);
      }
    }
    if (valid) {
      __nv_bfloat16* dp = dx + bd * CI * plane + (long long)h * width + ww;
#pragma unroll
      for (int ci = 0; ci < CI; ++ci) dp[ci * plane] = __float2bfloat16(dxa[ci]);
    }
    __syncthreads();

    const float* gs = sG + (ac_w * CO + co_w) * kPitch;
    const float* xs = sX + ci_w * kPitch;
    for (int p = 0; p < kThreads; ++p) {
      const float gval = gs[p];
#pragma unroll
      for (int k = 0; k < NCI; ++k)
        accw[k] = fmaf(xs[k * kPitch + p], gval, accw[k]);
    }
  }

  float* out = partial + (long long)blockIdx.x * 4 * CI * CO;
#pragma unroll
  for (int k = 0; k < NCI; ++k)
    out[(ac_w * CI + ci_w + k) * CO + co_w] = accw[k];
}

template <int CI, int CO>
int launch(const void* g, const void* x, const float* w, void* dx,
           float* partial, float* dw, int batch_depth, int height, int width,
           int nblocks, cudaStream_t stream) {
  auto kernel = convt2x_dm_bwd_kernel<CI, CO>;
  constexpr int bytes = smem_bytes<CI, CO>();
  int rc = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc != 0) return rc;
  kernel<<<nblocks, kThreads, bytes, stream>>>(
      (const __nv_bfloat16*)g, (const __nv_bfloat16*)x, w,
      (__nv_bfloat16*)dx, partial, batch_depth, height, width);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  return cryovit::sum_partials(partial, dw, nblocks, 4 * CI * CO, stream);
}

template <int CI>
int launch_co(int co, const void* g, const void* x, const float* w, void* dx,
              float* partial, float* dw, int batch_depth, int height,
              int width, int nblocks, cudaStream_t stream) {
  switch (co) {
    case 8: return launch<CI, 8>(g, x, w, dx, partial, dw, batch_depth, height, width, nblocks, stream);
    case 16: return launch<CI, 16>(g, x, w, dx, partial, dw, batch_depth, height, width, nblocks, stream);
    case 32: return launch<CI, 32>(g, x, w, dx, partial, dw, batch_depth, height, width, nblocks, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// g: contiguous (batch, depth, co, 2*height, 2*width) bf16; x: contiguous
// (batch, depth, ci, height, width) bf16; w: contiguous (2, 2, ci, co) f32
// indexed by output parity; dx: (batch, depth, ci, height, width) bf16
// output; partial: nblocks * 4 * ci * co f32 scratch; dw: (2, 2, ci, co) f32
// output indexed by output parity. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for an unsupported ci, co or grid.
extern "C" int cryovit_convt2x_dm_bwd(const void* g, const void* x,
                                      const void* w, void* dx, void* partial,
                                      void* dw, int batch, int depth, int ci,
                                      int co, int height, int width,
                                      int nblocks, void* stream) {
  if (nblocks < 1) return (int)cudaErrorInvalidValue;
  const float* wf = (const float*)w;
  float* p = (float*)partial;
  float* out = (float*)dw;
  cudaStream_t s = (cudaStream_t)stream;
  const int bd = batch * depth;
  switch (ci) {
    case 8: return launch_co<8>(co, g, x, wf, dx, p, out, bd, height, width, nblocks, s);
    case 16: return launch_co<16>(co, g, x, wf, dx, p, out, bd, height, width, nblocks, s);
    case 32: return launch_co<32>(co, g, x, wf, dx, p, out, bd, height, width, nblocks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
