// Fused residual add + LayerScale + LayerNorm for DINOv2 on Hopper (sm_90a).
//
// Replaces: cryovit_tpu/ops/fused_norm.py:residual_layernorm
//   (Pallas kernel _residual_ln_kernel).
//
// What it computes, per row r of (rows, C):
//   x'[r] = x[r] + gamma * h[r]            (f32; gamma optional)
//   y[r]  = (x'[r] - mean) * rsqrt(var + eps) * scale + bias
// with mean and the centered variance taken over the f32 x' (not over the
// stored copy), x' stored in x's dtype (bf16 or f32) and y in bf16; gamma,
// scale and bias (bf16, as the model holds them) are upcast to f32, as the
// TPU kernel does.
//
// What bounds it on the H100: ~8 FLOPs per element against 8 bytes (bf16 x)
// or 12 bytes (f32 x) per element, so it is bound by device memory: read x
// and h once, write x' and y once.
//
// What the design does about it:
// - one warp per row; at C = 1536 each lane holds 48 values of x' in
//   registers (chunks of 8 channels, chunk c on lane c mod 32), so the row is
//   read once and both statistics come from registers (two warp reductions:
//   the mean, then the centered sum of squares);
// - every load and store is a 16-byte vector (bf16: 8 values; f32: two
//   vectors of 4), neighbouring lanes on neighbouring addresses;
// - templated on the (x, h) dtypes the model produces -- (bf16, bf16),
//   (f32, bf16) and (f32, f32) -- and on the presence of gamma.
// C must be a multiple of 8 and at most 32 * 8 * kMaxChunks = 2048.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;  // rows per block
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxChunks = 8;  // chunks of 8 channels per lane

union Vec8 {
  uint4 u;
  __nv_bfloat16 h[8];
};

// 8 consecutive values at p (16-byte aligned) as f32.
template <bool kF32>
__device__ __forceinline__ void load8(const void* p, float out[8]) {
  if (kF32) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    out[0] = a.x, out[1] = a.y, out[2] = a.z, out[3] = a.w;
    out[4] = b.x, out[5] = b.y, out[6] = b.z, out[7] = b.w;
  } else {
    Vec8 v;
    v.u = *reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int j = 0; j < 8; ++j) out[j] = __bfloat162float(v.h[j]);
  }
}

template <bool kF32>
__device__ __forceinline__ void store8(void* p, const float in[8]) {
  if (kF32) {
    reinterpret_cast<float4*>(p)[0] = make_float4(in[0], in[1], in[2], in[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(in[4], in[5], in[6], in[7]);
  } else {
    Vec8 v;
#pragma unroll
    for (int j = 0; j < 8; ++j) v.h[j] = __float2bfloat16(in[j]);
    *reinterpret_cast<uint4*>(p) = v.u;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffff, v, off);
  return v;
}

template <bool kXF32, bool kHF32, bool kGamma>
__global__ void __launch_bounds__(kThreads)
    residual_layernorm_kernel(const void* __restrict__ x,
                              const void* __restrict__ h,
                              const __nv_bfloat16* __restrict__ gamma,
                              const __nv_bfloat16* __restrict__ scale,
                              const __nv_bfloat16* __restrict__ bias,
                              void* __restrict__ x_out,
                              __nv_bfloat16* __restrict__ y_out, int rows,
                              int channels, float eps) {
  using XT = typename std::conditional<kXF32, float, __nv_bfloat16>::type;
  using HT = typename std::conditional<kHF32, float, __nv_bfloat16>::type;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const long long base = (long long)row * channels;
  const XT* xr = static_cast<const XT*>(x) + base;
  const HT* hr = static_cast<const HT*>(h) + base;
  XT* xo = static_cast<XT*>(x_out) + base;
  __nv_bfloat16* yo = y_out + base;

  // x' = x + gamma * h in f32, kept in registers; stored in x's dtype.
  float v[kMaxChunks][8];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxChunks; ++i) {
    const int c = (lane + 32 * i) * 8;
    if (c < channels) {
      float xv[8], hv[8];
      load8<kXF32>(xr + c, xv);
      load8<kHF32>(hr + c, hv);
      if (kGamma) {
        float g[8];
        load8<false>(gamma + c, g);
#pragma unroll
        for (int j = 0; j < 8; ++j) hv[j] = __fmul_rn(hv[j], g[j]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[i][j] = __fadd_rn(xv[j], hv[j]);
        sum += v[i][j];
      }
      store8<kXF32>(xo + c, v[i]);
    }
  }
  const float inv_c = 1.f / channels;
  const float mean = warp_sum(sum) * inv_c;

  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxChunks; ++i) {
    if ((lane + 32 * i) * 8 < channels) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[i][j] -= mean;
        sq += v[i][j] * v[i][j];
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) * inv_c + eps);

#pragma unroll
  for (int i = 0; i < kMaxChunks; ++i) {
    const int c = (lane + 32 * i) * 8;
    if (c < channels) {
      float s[8], b[8], y[8];
      load8<false>(scale + c, s);
      load8<false>(bias + c, b);
#pragma unroll
      for (int j = 0; j < 8; ++j) y[j] = v[i][j] * rstd * s[j] + b[j];
      store8<false>(yo + c, y);
    }
  }
}

template <bool kXF32, bool kHF32>
int launch(const void* x, const void* h, const void* gamma, const void* scale,
           const void* bias, void* x_out, void* y_out, int rows, int channels,
           float eps, cudaStream_t stream) {
  using BF = const __nv_bfloat16*;
  const int blocks = (rows + kWarps - 1) / kWarps;
  if (gamma != nullptr) {
    residual_layernorm_kernel<kXF32, kHF32, true><<<blocks, kThreads, 0, stream>>>(
        x, h, (BF)gamma, (BF)scale, (BF)bias, x_out, (__nv_bfloat16*)y_out, rows,
        channels, eps);
  } else {
    residual_layernorm_kernel<kXF32, kHF32, false><<<blocks, kThreads, 0, stream>>>(
        x, h, (BF)gamma, (BF)scale, (BF)bias, x_out, (__nv_bfloat16*)y_out, rows,
        channels, eps);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x, x_out: (rows, channels), f32 if x_f32 else bf16; h: (rows, channels),
// f32 if h_f32 else bf16 (an f32 h needs an f32 x); y_out: (rows, channels)
// bf16; gamma (may be null), scale, bias: (channels,) bf16. All contiguous
// and 16-byte aligned, channels a multiple of 8 and at most 2048. Returns
// cudaGetLastError().
extern "C" int cryovit_residual_layernorm(const void* x, const void* h,
                                          const void* gamma, const void* scale,
                                          const void* bias, void* x_out,
                                          void* y_out, int rows, int channels,
                                          int x_f32, int h_f32, float eps,
                                          void* stream) {
  if (channels % 8 != 0 || channels > 32 * 8 * kMaxChunks || (h_f32 && !x_f32)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (h_f32) {
    return launch<true, true>(x, h, gamma, scale, bias, x_out, y_out, rows,
                              channels, eps, s);
  }
  if (x_f32) {
    return launch<true, false>(x, h, gamma, scale, bias, x_out, y_out, rows,
                               channels, eps, s);
  }
  return launch<false, false>(x, h, gamma, scale, bias, x_out, y_out, rows,
                              channels, eps, s);
}
