// Non-causal multi-head attention for DINOv2 on Hopper (sm_90a).
//
// Replaces: cryovit_tpu/ops/flash_attention.py:flash_attention_pairs
//   (Pallas kernel _flash_kernel_paired, channel_major=True path).
//
// What it computes, per (batch b, head h):
//   out[b, i, h*64:(h+1)*64] = softmax_j(scale * (q_i + bq) . (k_j + bk)) (v_j + bv)
// over keys j < kv_len, reading q/k/v straight from the qkv projection's
// natural (B, N, H*64) layout (any row stride, so q/k/v may be column views
// of one fused (B, N, 3*H*64) projection output) and writing (B, N, H*64):
// no transposes on either side.
//
// What bounds it on the H100: at ViT-g's 512^2 slices (N = 1029, d = 64) the
// two products Q.K^T and P.V are 4*N^2*d FLOPs per (batch, head) against
// O(N*d) bytes, so the kernel is compute bound on the tensor cores, and the
// N x N score matrix must never reach device memory.
//
// What the design does about it:
// - one block of 4 warps per (query tile of 64 rows, head, batch); each warp
//   owns 16 query rows and keeps their Q fragments, the running row max and
//   row sum and the 16 x 64 f32 output accumulator in registers;
// - keys stream through shared memory in tiles of 64 (K row-major, V stored
//   transposed so both products read 32-bit fragment pairs);
// - both products are mma.sync m16n8k16 bf16 with f32 accumulation; the
//   score accumulator is re-packed in registers as the A operand of P.V
//   (the FlashAttention-2 register layout), so scores never leave the SM;
// - an online softmax in the log2 domain: scores are multiplied by
//   scale*log2(e) and exponentiated with exp2f, with the row-max shift kept;
// - the q/k/v biases are added while the tiles are staged in shared memory
//   (rounded to bf16, as the TPU kernel adds them in bf16); keys at or past
//   kv_len are masked to -inf after the bias, and their V rows are zeroed,
//   so the ragged tail needs no padding by the caller;
// - the denominator is the row sum of the bf16-rounded probabilities, the
//   same values the P.V product consumes (the TPU kernel gets it from a
//   ones column appended to V).
// Not yet done (later work): wgmma, TMA, a multi-stage cp.async pipeline,
// ldmatrix fragment loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 64;
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

// Loads 8 consecutive bf16 of one row (zeros when the row is out of range)
// and adds 8 bias values, rounding the sum to bf16.
__device__ __forceinline__ Vec8 load_row8(const __nv_bfloat16* src, bool valid,
                                          const __nv_bfloat16* bias) {
  Vec8 in, out;
  in.u = valid ? *reinterpret_cast<const uint4*>(src) : make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    out.h[j] = __float2bfloat16(__bfloat162float(in.h[j]) +
                                __bfloat162float(bias[j]));
  }
  return out;
}

__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ bias,
                           __nv_bfloat16* __restrict__ out, int seq, int heads,
                           long long row_stride, long long batch_stride,
                           int kv_len, float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 sQ[kBlockQ][kHeadDim + kPad];
  __shared__ __align__(16) __nv_bfloat16 sK[kBlockK][kHeadDim + kPad];
  __shared__ __align__(16) __nv_bfloat16 sVt[kHeadDim][kBlockK + kPad];

  const int q0 = blockIdx.x * kBlockQ;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int channels = heads * kHeadDim;

  const long long in_base = (long long)b * batch_stride + head * kHeadDim;
  const __nv_bfloat16* qh = q + in_base;
  const __nv_bfloat16* kh = k + in_base;
  const __nv_bfloat16* vh = v + in_base;
  const __nv_bfloat16* bq = bias + head * kHeadDim;
  const __nv_bfloat16* bk = bias + channels + head * kHeadDim;
  const __nv_bfloat16* bv = bias + 2 * channels + head * kHeadDim;

  // Stage the query tile (+ q bias).
  for (int c = tid; c < kBlockQ * kHeadDim / 8; c += kThreads) {
    const int r = c >> 3, col = (c & 7) * 8;
    const int row = q0 + r;
    Vec8 val = load_row8(qh + row * row_stride + col, row < seq, bq + col);
    *reinterpret_cast<uint4*>(&sQ[r][col]) = val.u;
  }
  __syncthreads();

  const int wr = warp * 16;
  uint32_t qa[4][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    qa[ks][0] = ld32(&sQ[wr + g][ks * 16 + 2 * t]);
    qa[ks][1] = ld32(&sQ[wr + g + 8][ks * 16 + 2 * t]);
    qa[ks][2] = ld32(&sQ[wr + g][ks * 16 + 2 * t + 8]);
    qa[ks][3] = ld32(&sQ[wr + g + 8][ks * 16 + 2 * t + 8]);
  }

  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // per-thread partial row sums
  float o[8][4];
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) o[dt][i] = 0.f;
  }

  const int num_kt = (kv_len + kBlockK - 1) / kBlockK;
  for (int kt = 0; kt < num_kt; ++kt) {
    const int key0 = kt * kBlockK;
    __syncthreads();  // previous tile fully consumed
    for (int c = tid; c < kBlockK * kHeadDim / 8; c += kThreads) {
      const int r = c >> 3, col = (c & 7) * 8;
      const int key = key0 + r;
      const bool valid = key < kv_len;
      Vec8 kv = load_row8(kh + key * row_stride + col, valid, bk + col);
      *reinterpret_cast<uint4*>(&sK[r][col]) = kv.u;
      Vec8 vv = load_row8(vh + key * row_stride + col, valid, bv + col);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sVt[col + j][r] = valid ? vv.h[j] : __float2bfloat16(0.f);
      }
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys (8 n-tiles of 8 keys).
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const __nv_bfloat16* kr = &sK[nt * 8 + g][ks * 16 + 2 * t];
        mma_16816(s[nt], qa[ks], ld32(kr), ld32(kr + 8));
      }
    }

    // Scale into the log2 domain, mask keys >= kv_len, row max.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = key0 + nt * 8 + 2 * t + (i & 1);
        const float val = key < kv_len ? s[nt][i] * scale_log2 : -INFINITY;
        s[nt][i] = val;
        mx[i >> 1] = fmaxf(mx[i >> 1], val);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffff, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffff, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);  // finite: key0 < kv_len
      corr[r] = exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= corr[r];
    }
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      o[dt][0] *= corr[0];
      o[dt][1] *= corr[0];
      o[dt][2] *= corr[1];
      o[dt][3] *= corr[1];
    }

    // P = exp2(S - m), rounded to bf16 once: the same values feed the row
    // sum and the P.V product.
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = round_bf16(exp2f(s[nt][i] - m_run[i >> 1]));
        s[nt][i] = p;
        l_run[i >> 1] += p;
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
      for (int dt = 0; dt < 8; ++dt) {
        const __nv_bfloat16* vr = &sVt[dt * 8 + g][j * 16 + 2 * t];
        mma_16816(o[dt], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffff, l, 1);
    l += __shfl_xor_sync(0xffffffff, l, 2);
    inv[r] = 1.f / l;
  }
  const int row0 = q0 + wr + g;
  const int row1 = row0 + 8;
  __nv_bfloat16* ob = out + (long long)b * seq * channels + head * kHeadDim;
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
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

}  // namespace

// q, k, v: (batch, seq, heads*64) bf16 with unit column stride and the given
// row and batch strides (in elements); bias: (3, heads*64) bf16 (q, k, v);
// out: contiguous (batch, seq, heads*64) bf16. Keys >= kv_len are excluded.
// scale_log2 = softmax scale * log2(e). Returns cudaGetLastError().
extern "C" int cryovit_flash_attention(const void* q, const void* k,
                                       const void* v, const void* bias,
                                       void* out, int batch, int seq, int heads,
                                       long long row_stride,
                                       long long batch_stride, int kv_len,
                                       float scale_log2, void* stream) {
  dim3 grid((seq + kBlockQ - 1) / kBlockQ, heads, batch);
  flash_attention_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const __nv_bfloat16*)bias,
      (__nv_bfloat16*)out, seq, heads, row_stride, batch_stride, kv_len,
      scale_log2);
  return (int)cudaGetLastError();
}
