// Windowed / global multi-head attention for the Hiera trunk on Hopper (sm_90a).
//
// Replaces: cryovit_tpu/ops/window_attention.py:window_attention (Pallas
//   kernel _wk_kernel, the global 1024-token blocks) and the attention stage
//   of window_block_attention (_wkb_kernel, the 256-token windows; the
//   projections around it are csrc/window_block.cu).
//
// What it computes, per (window or image b, head h), with D the head width and
// q pre-scaled by the softmax scale * log2(e) (folded into the q projection
// weights before their cast to bf16, as the TPU kernel's callers do):
//   s_ij = q_i . k_j                                 (f32)
//   m_i  = max_j s_ij                                (exact, f32)
//   p_ij = bf16(exp2(bf16(s_ij - m_i)))              (bf16 probabilities)
//   out_i = (sum_j p_ij v_j) * (1 / sum_j p_ij)      (f32 sums, bf16 out)
// which is the TPU kernel's recipe with the denominator summed from the same
// bf16 probabilities instead of read from a ones column of v. q, k and v are
// read straight from the qkv projection's
// (B, T, 3*H*D) layout (any row stride, so they may be column views of one
// fused projection output); out is a contiguous (B, T, H*D).
//
// What bounds it on the H100: per (b, h) the two products are 4*T^2*D FLOPs
// against O(T*D) bytes, so it is compute bound on the tensor cores (at the
// global blocks, B = 64, T = 1024, 8 x 72: 155 GFLOP against 302 MB), and
// the T x T score matrix must never reach device memory.
//
// What the design does about it:
// - one block of 4 warps per (query tile of 64 rows, head, b); each warp owns
//   16 query rows and keeps their Q fragments, row max, row sum and the
//   16 x D f32 output accumulator in registers;
// - the exact row max needs every score before the first exponential, so
//   the keys stream through shared memory twice in tiles of 64: the first
//   pass computes Q.K^T and the row max only, the second recomputes the same
//   scores (the same mma.sync instructions on the same data give the same
//   bits), exponentiates and accumulates P.V. The second Q.K^T adds ~50 %
//   to the mma work of one pass; in return the recipe stays exact at any T,
//   with ~33 KB of shared memory and no online rescaling;
// - D = 72 is not a multiple of mma.sync's k = 16: Q and K are zero-filled
//   to 80 columns in shared memory for Q.K^T, while P.V produces the 72 real
//   output columns (9 n-tiles of 8);
// - both products are mma.sync m16n8k16 bf16 with f32 accumulation; the
//   score accumulators are re-packed in registers as the A operand of P.V;
// - keys and queries at or past T are masked (scores -inf, V rows zero, no
//   store), so T need not be a multiple of 64.
// Not yet done (later work): wgmma, TMA, a multi-stage cp.async pipeline,
// ldmatrix fragment loads, keeping K/V in shared memory across both passes
// for T <= 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;  // 4 warps x 16 query rows
constexpr int kBlockK = 64;
constexpr int kThreads = 128;
constexpr int kPad = 8;  // bf16 elements of row padding in shared memory

union Vec8 {
  uint4 u;
  __nv_bfloat16 h[8];
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D = A(16x16, row) * B(16x8, col) + D, bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma_16816(float d[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int D>
struct Shape {
  static constexpr int kDP = (D + 15) / 16 * 16;  // contraction width for Q.K^T
  static constexpr int kKSteps = kDP / 16;
  static constexpr int kChunks = kDP / 8;   // 16-byte chunks per padded row
  static constexpr int kReal = D / 8;       // chunks holding real columns
  static constexpr int kNTiles = D / 8;     // output n-tiles of P.V
};

// Stages rows [row0, row0 + 64) of one head (kDP columns, zero past D and
// past seq) into dst[64][kDP + kPad].
template <int D>
__device__ __forceinline__ void stage_rows(__nv_bfloat16 (*dst)[Shape<D>::kDP + kPad],
                                           const __nv_bfloat16* src, int row0,
                                           int seq, long long row_stride) {
  using S = Shape<D>;
  for (int c = threadIdx.x; c < 64 * S::kChunks; c += kThreads) {
    const int r = c / S::kChunks, col = (c % S::kChunks) * 8;
    const int row = row0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row < seq && col < D) {
      val = *reinterpret_cast<const uint4*>(src + row * row_stride + col);
    }
    *reinterpret_cast<uint4*>(&dst[r][col]) = val;
  }
}

// S = Q K^T (already in the log2 domain) for one warp's 16 rows against the
// 64 staged keys, keys at or past seq set to -inf.
template <int D>
__device__ __forceinline__ void scores(float s[8][4], uint32_t qa[][4],
                                       __nv_bfloat16 (*sK)[Shape<D>::kDP + kPad],
                                       int key0, int seq) {
  using S = Shape<D>;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < S::kKSteps; ++ks) {
      const __nv_bfloat16* kr = &sK[nt * 8 + g][ks * 16 + 2 * t];
      mma_16816(s[nt], qa[ks], ld32(kr), ld32(kr + 8));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = key0 + nt * 8 + 2 * t + (i & 1);
      if (key >= seq) s[nt][i] = -INFINITY;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    window_attention_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            __nv_bfloat16* __restrict__ out, int seq, int heads,
                            long long row_stride, long long batch_stride) {
  using S = Shape<D>;
  __shared__ __align__(16) __nv_bfloat16 sQ[kBlockQ][S::kDP + kPad];
  __shared__ __align__(16) __nv_bfloat16 sK[kBlockK][S::kDP + kPad];
  __shared__ __align__(16) __nv_bfloat16 sVt[D][kBlockK + kPad];

  const int q0 = blockIdx.x * kBlockQ;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group

  const long long in_base = (long long)b * batch_stride + head * D;
  const __nv_bfloat16* qh = q + in_base;
  const __nv_bfloat16* kh = k + in_base;
  const __nv_bfloat16* vh = v + in_base;

  stage_rows<D>(sQ, qh, q0, seq, row_stride);
  __syncthreads();
  const int wr = warp * 16;
  uint32_t qa[S::kKSteps][4];
#pragma unroll
  for (int ks = 0; ks < S::kKSteps; ++ks) {
    qa[ks][0] = ld32(&sQ[wr + g][ks * 16 + 2 * t]);
    qa[ks][1] = ld32(&sQ[wr + g + 8][ks * 16 + 2 * t]);
    qa[ks][2] = ld32(&sQ[wr + g][ks * 16 + 2 * t + 8]);
    qa[ks][3] = ld32(&sQ[wr + g + 8][ks * 16 + 2 * t + 8]);
  }

  const int num_kt = (seq + kBlockK - 1) / kBlockK;
  float s[8][4];

  // Pass 1: the exact row max of the scores.
  float m_row[2] = {-INFINITY, -INFINITY};
  for (int kt = 0; kt < num_kt; ++kt) {
    __syncthreads();  // previous tile fully consumed
    stage_rows<D>(sK, kh, kt * kBlockK, seq, row_stride);
    __syncthreads();
    scores<D>(s, qa, sK, kt * kBlockK, seq);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) m_row[i >> 1] = fmaxf(m_row[i >> 1], s[nt][i]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // the 4 threads of a row group hold its keys
    m_row[r] = fmaxf(m_row[r], __shfl_xor_sync(0xffffffff, m_row[r], 1));
    m_row[r] = fmaxf(m_row[r], __shfl_xor_sync(0xffffffff, m_row[r], 2));
  }

  // Pass 2: the same scores again, bf16 probabilities, their f32 row sum and
  // P.V.
  float l_row[2] = {0.f, 0.f};  // per-thread partial row sums
  float o[S::kNTiles][4];
#pragma unroll
  for (int dt = 0; dt < S::kNTiles; ++dt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) o[dt][i] = 0.f;
  }
  for (int kt = 0; kt < num_kt; ++kt) {
    const int key0 = kt * kBlockK;
    __syncthreads();
    stage_rows<D>(sK, kh, key0, seq, row_stride);
    for (int c = tid; c < kBlockK * S::kReal; c += kThreads) {
      const int r = c / S::kReal, col = (c % S::kReal) * 8;
      const int key = key0 + r;
      Vec8 vv;
      vv.u = key < seq ? *reinterpret_cast<const uint4*>(vh + key * row_stride + col)
                       : make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int j = 0; j < 8; ++j) sVt[col + j][r] = vv.h[j];
    }
    __syncthreads();
    scores<D>(s, qa, sK, key0, seq);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = round_bf16(exp2f(round_bf16(s[nt][i] - m_row[i >> 1])));
        s[nt][i] = p;
        l_row[i >> 1] += p;
      }
    }
    // O += P V: the score accumulators of n-tiles (2j, 2j+1) are exactly the
    // A fragment of the k-step over keys 16j..16j+15.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
      pa[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
      pa[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      pa[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
      for (int dt = 0; dt < S::kNTiles; ++dt) {
        const __nv_bfloat16* vr = &sVt[dt * 8 + g][j * 16 + 2 * t];
        mma_16816(o[dt], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_row[r];
    l += __shfl_xor_sync(0xffffffff, l, 1);
    l += __shfl_xor_sync(0xffffffff, l, 2);
    inv[r] = 1.f / l;
  }
  const int channels = heads * D;
  const int row0 = q0 + wr + g;
  const int row1 = row0 + 8;
  __nv_bfloat16* ob = out + (long long)b * seq * channels + head * D;
#pragma unroll
  for (int dt = 0; dt < S::kNTiles; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (row0 < seq) {
      *reinterpret_cast<uint32_t*>(ob + (long long)row0 * channels + col) =
          pack_bf16(o[dt][0] * inv[0], o[dt][1] * inv[0]);
    }
    if (row1 < seq) {
      *reinterpret_cast<uint32_t*>(ob + (long long)row1 * channels + col) =
          pack_bf16(o[dt][2] * inv[1], o[dt][3] * inv[1]);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int seq, int heads, long long row_stride, long long batch_stride,
           cudaStream_t stream) {
  dim3 grid((seq + kBlockQ - 1) / kBlockQ, heads, batch);
  window_attention_kernel<D><<<grid, kThreads, 0, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, seq, heads, row_stride,
      batch_stride);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: (batch, seq, heads*head_dim) bf16 with unit column stride and the
// given row and batch strides (in elements), q pre-scaled by the softmax
// scale * log2(e); out: contiguous (batch, seq, heads*head_dim) bf16.
// head_dim is 72 (every Hiera stage of sam2.1_hiera_l). Returns
// cudaGetLastError(), or cudaErrorInvalidValue for another head width.
extern "C" int cryovit_window_attention(const void* q, const void* k,
                                        const void* v, void* out, int batch,
                                        int seq, int heads, int head_dim,
                                        long long row_stride,
                                        long long batch_stride, void* stream) {
  if (head_dim != 72) return (int)cudaErrorInvalidValue;
  return launch<72>(q, k, v, out, batch, seq, heads, row_stride, batch_stride,
                    (cudaStream_t)stream);
}
