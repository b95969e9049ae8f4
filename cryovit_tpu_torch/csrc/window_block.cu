// The Hiera trunk's fused window blocks on Hopper (sm_90a): LayerNorm-prologue
// bf16 matrix products with bias, exact-GELU and residual epilogues.
//
// Replaces:
// - cryovit_tpu/ops/window_attention.py:window_block_attention (Pallas kernel
//   _wkb_kernel): out = x + proj(MHA(qkv(LN1(x)))) per window, as three
//   launches: [LN1 -> qkv + bias] into a bf16 (rows, 3*H*D) scratch, the
//   attention of csrc/window_attention.cu on column views of it into a bf16
//   (rows, H*D) scratch, and [proj + bias + x];
// - window_block_mlp (_wmlp_kernel): out = x + fc2(GELU(fc1(LN2(x)))) per
//   token, as two launches: [LN2 -> fc1 + bias -> erf GELU] into a bf16
//   (rows, 4C) hidden scratch, and [fc2 + bias + x].
//
// What bounds it on the H100: the four products (at Hiera-L's stage 3,
// 65,536 tokens x 576 channels: qkv 130 GFLOP, proj 44, fc1 and fc2 174 each)
// are compute bound on the tensor cores; the one-pass bound of a block is
// x in and out (151 MB) and its weights.
//
// What the design does about it, and what it gives up against that bound:
// - the TPU kernel holds a whole window (256 x 576 bf16 = 295 KB) and its
//   f32 intermediates in VMEM; a Hopper block has 227 KB of shared memory and
//   a 256 x 576 f32 accumulator does not fit in registers. So each product is
//   its own launch, tiled 128 x 128 x 32 over (rows, output columns), and the
//   intermediates cross device memory in bf16, rounded exactly where the TPU
//   kernel rounds them: qkv (226 MB written and read back), the attention
//   output (75 MB each way) and the MLP hidden (302 MB each way);
// - the LayerNorm is the product's prologue: each block computes its 128
//   rows' f32 mean and E[x^2] - mean^2 once, and normalises every A tile as
//   it is staged into shared memory (rounded to bf16, as _ln_f32 does), so
//   the normalised activations never reach device memory;
// - bias, GELU (erff, f32) and the residual add are the epilogue, applied to
//   the f32 accumulators before the one bf16 rounding of the output;
// - products are mma.sync m16n8k16 bf16 with f32 accumulation; 8 warps each
//   own a 64 x 32 tile of the output; the next k-tile is loaded into
//   registers while the current one is multiplied (two shared buffers).
// Rows, output columns and the contraction are masked, so any row count and
// any multiple of 8 for C, 3*H*D and the hidden width is taken.
// Not yet done (later work): wgmma, TMA, a deeper cp.async pipeline,
// ldmatrix, and keeping a window's qkv in shared memory across the three
// launches of a block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

extern "C" int cryovit_window_attention(const void* q, const void* k,
                                        const void* v, void* out, int batch,
                                        int seq, int heads, int head_dim,
                                        long long row_stride,
                                        long long batch_stride, void* stream);

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 32;
constexpr int kThreads = 256;  // 8 warps: 2 along rows x 4 along columns
constexpr int kLds = kBK + 8;  // padded shared row: 80 bytes, conflict-free

enum Epilogue { kBias = 0, kBiasGelu = 1, kBiasResidual = 2 };

union Vec8 {
  uint4 u;
  __nv_bfloat16 h[8];
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_16816(float d[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[M, N] = epilogue(LN?(a)[M, K] . w[N, K]^T): a, res and c row-major
// (M, K) / (M, N) bf16, w a torch Linear weight (N, K) bf16, bias (N) bf16,
// ln_w / ln_b (K) f32. K and N are multiples of 8.
template <bool kLN, int kEpi>
__global__ void __launch_bounds__(kThreads)
    ln_gemm_kernel(const __nv_bfloat16* __restrict__ a,
                   const float* __restrict__ ln_w,
                   const float* __restrict__ ln_b,
                   const __nv_bfloat16* __restrict__ w,
                   const __nv_bfloat16* __restrict__ bias,
                   const __nv_bfloat16* __restrict__ res,
                   __nv_bfloat16* __restrict__ c, int M, int N, int K,
                   float eps) {
  __shared__ __align__(16) __nv_bfloat16 sA[2][kBM][kLds];
  __shared__ __align__(16) __nv_bfloat16 sB[2][kBN][kLds];
  __shared__ float s_mean[kBM];
  __shared__ float s_rstd[kBM];

  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = (warp >> 2) * 64;  // the warp's rows in the tile
  const int wn = (warp & 3) * 32;   // the warp's columns in the tile

  if (kLN) {  // f32 statistics of the block's rows, E[x^2] - mean^2
    for (int r = warp * 16; r < warp * 16 + 16; ++r) {
      const int row = m0 + r;
      float sum = 0.f, sq = 0.f;
      if (row < M) {
        const __nv_bfloat16* src = a + (long long)row * K;
        for (int col = lane * 8; col < K; col += 256) {
          Vec8 x;
          x.u = *reinterpret_cast<const uint4*>(src + col);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float f = __bfloat162float(x.h[j]);
            sum += f;
            sq += f * f;
          }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(0xffffffff, sum, off);
        sq += __shfl_xor_sync(0xffffffff, sq, off);
      }
      if (lane == 0) {
        const float mean = sum / K;
        const float var = sq / K - mean * mean;
        s_mean[r] = mean;
        s_rstd[r] = rsqrtf(fmaxf(var, 0.f) + eps);
      }
    }
    __syncthreads();
  }

  // Each thread stages two 16-byte chunks of A and two of W per k-tile.
  uint4 ra[2], rb[2];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx >> 2, kc = k0 + (idx & 3) * 8;
      const bool kin = kc < K;
      ra[i] = (m0 + r < M && kin)
                  ? *reinterpret_cast<const uint4*>(a + (long long)(m0 + r) * K + kc)
                  : make_uint4(0, 0, 0, 0);
      rb[i] = (n0 + r < N && kin)
                  ? *reinterpret_cast<const uint4*>(w + (long long)(n0 + r) * K + kc)
                  : make_uint4(0, 0, 0, 0);
    }
  };
  auto store = [&](int buf, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx >> 2, kcol = (idx & 3) * 8, kc = k0 + kcol;
      uint4 va = ra[i];
      if (kLN && m0 + r < M && kc < K) {
        Vec8 x;
        x.u = va;
        const float mean = s_mean[r], rs = s_rstd[r];
        const float4 g0 = *reinterpret_cast<const float4*>(ln_w + kc);
        const float4 g1 = *reinterpret_cast<const float4*>(ln_w + kc + 4);
        const float4 b0 = *reinterpret_cast<const float4*>(ln_b + kc);
        const float4 b1 = *reinterpret_cast<const float4*>(ln_b + kc + 4);
        const float gs[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
        const float bs[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float y = (__bfloat162float(x.h[j]) - mean) * rs * gs[j] + bs[j];
          x.h[j] = __float2bfloat16(y);
        }
        va = x.u;
      }
      *reinterpret_cast<uint4*>(&sA[buf][r][kcol]) = va;
      *reinterpret_cast<uint4*>(&sB[buf][r][kcol]) = rb[i];
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][ni][i] = 0.f;
    }
  }

  const int nk = (K + kBK - 1) / kBK;
  load(0);
  store(0, 0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) load((kt + 1) * kBK);  // in flight during the products
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      const int kk = ks * 16 + 2 * t;
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = wm + mi * 16 + g;
        af[mi][0] = ld32(&sA[buf][r][kk]);
        af[mi][1] = ld32(&sA[buf][r + 8][kk]);
        af[mi][2] = ld32(&sA[buf][r][kk + 8]);
        af[mi][3] = ld32(&sA[buf][r + 8][kk + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = wn + ni * 8 + g;
        bfr[ni][0] = ld32(&sB[buf][n][kk]);
        bfr[ni][1] = ld32(&sB[buf][n][kk + 8]);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_16816(acc[mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);
      }
    }
    if (kt + 1 < nk) store(buf ^ 1, (kt + 1) * kBK);
    __syncthreads();
  }

#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = n0 + wn + ni * 8 + 2 * t;
    if (col >= N) continue;  // N % 8 == 0, so col + 1 < N as well
    const float bias0 = __bfloat162float(bias[col]);
    const float bias1 = __bfloat162float(bias[col + 1]);
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm + mi * 16 + g + half * 8;
        if (row >= M) continue;
        float v0 = acc[mi][ni][2 * half] + bias0;
        float v1 = acc[mi][ni][2 * half + 1] + bias1;
        if (kEpi == kBiasGelu) {
          v0 = 0.5f * v0 * (1.f + erff(v0 * 0.70710678118654752f));
          v1 = 0.5f * v1 * (1.f + erff(v1 * 0.70710678118654752f));
        }
        const long long off = (long long)row * N + col;
        if (kEpi == kBiasResidual) {
          const __nv_bfloat162 r2 = *reinterpret_cast<const __nv_bfloat162*>(res + off);
          v0 += __bfloat162float(r2.x);
          v1 += __bfloat162float(r2.y);
        }
        *reinterpret_cast<uint32_t*>(c + off) = pack_bf16(v0, v1);
      }
    }
  }
}

template <bool kLN, int kEpi>
int gemm(const void* a, const float* ln_w, const float* ln_b, const void* w,
         const void* bias, const void* res, void* c, int M, int N, int K,
         float eps, cudaStream_t stream) {
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  ln_gemm_kernel<kLN, kEpi><<<grid, kThreads, 0, stream>>>(
      (const __nv_bfloat16*)a, ln_w, ln_b, (const __nv_bfloat16*)w,
      (const __nv_bfloat16*)bias, (const __nv_bfloat16*)res, (__nv_bfloat16*)c,
      M, N, K, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// out = x + proj(attention(qkv(LN(x)))) for `windows` windows of `tokens`
// tokens: x and out contiguous (windows*tokens, C) bf16; ln_w / ln_b (C) f32;
// w_qkv (3C, C), b_qkv (3C), w_proj (C, C), b_proj (C) bf16 (torch Linear
// layout), the q third of w_qkv and b_qkv pre-scaled by the softmax scale *
// log2(e); qkv (rows, 3C) and attn (rows, C) bf16 scratch. C = heads *
// head_dim. Returns the first non-zero cudaGetLastError() of its launches.
extern "C" int cryovit_window_block_attention(
    const void* x, const float* ln_w, const float* ln_b, const void* w_qkv,
    const void* b_qkv, const void* w_proj, const void* b_proj, void* qkv,
    void* attn, void* out, int windows, int tokens, int channels, int heads,
    float eps, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int rows = windows * tokens;
  const int head_dim = channels / heads;
  int rc = gemm<true, kBias>(x, ln_w, ln_b, w_qkv, b_qkv, nullptr, qkv, rows,
                             3 * channels, channels, eps, st);
  if (rc) return rc;
  const __nv_bfloat16* q = (const __nv_bfloat16*)qkv;
  rc = cryovit_window_attention(q, q + channels, q + 2 * channels, attn,
                                windows, tokens, heads, head_dim,
                                3LL * channels, 3LL * channels * tokens,
                                stream);
  if (rc) return rc;
  return gemm<false, kBiasResidual>(attn, nullptr, nullptr, w_proj, b_proj, x,
                                    out, rows, channels, channels, eps, st);
}

// out = x + fc2(GELU(fc1(LN(x)))) per token: x and out contiguous (rows, C)
// bf16; ln_w / ln_b (C) f32; w1 (F, C), b1 (F), w2 (C, F), b2 (C) bf16;
// hidden (rows, F) bf16 scratch. Returns the first non-zero
// cudaGetLastError() of its launches.
extern "C" int cryovit_window_block_mlp(const void* x, const float* ln_w,
                                        const float* ln_b, const void* w1,
                                        const void* b1, const void* w2,
                                        const void* b2, void* hidden, void* out,
                                        int rows, int channels, int hidden_dim,
                                        float eps, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int rc = gemm<true, kBiasGelu>(x, ln_w, ln_b, w1, b1, nullptr, hidden, rows,
                                 hidden_dim, channels, eps, st);
  if (rc) return rc;
  return gemm<false, kBiasResidual>(hidden, nullptr, nullptr, w2, b2, x, out,
                                    rows, channels, hidden_dim, eps, st);
}
