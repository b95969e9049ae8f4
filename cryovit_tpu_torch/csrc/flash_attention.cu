// The int8 internals of the DINOv2 pair attention on Hopper (sm_90a).
//
// Replaces the quant= modes of cryovit_tpu/ops/flash_attention.py:
// _flash_kernel_paired (flash_attention_pairs, channel_major=True): the int8
// branches on its single-K-block path (the K and V quantization :386-420,
// the int8 Q.K^T :445-457, the int8 P.V :486-498), entries
// cryovit_attention_int8_scales (a pre-pass writing the int8 scales) and
// cryovit_flash_attention_int8; the body is templated on mode (bits: 1
// int8 Q.K^T, 2 int8 P.V). The bf16 attention of the same TPU kernel (and
// of _flash_kernel and the Hiera global blocks) is csrc/attention_sm90.cu.
//
// What it computes, per (batch b, head h):
//   out[b, h, i, :] = softmax_j(scale * (q_i + bq) . (k_j + bk)) (v_j + bv)
// over keys j < kv_len, with q/k/v + bias rounded to bf16 and, by mode:
//   qk: s_ij = f32(sum qi.ki) * ((sq[chunk(i)] * sk) * scale*log2 e), with
//       qi = round(q_i / sq), ki = round(k_j / sk) (int8, half to even);
//   pv: m_i = max_j s_ij exactly (first pass), p = bf16(2^(s - m)),
//       pi = round(127 p), vi = round(v / sv) per column; out_i =
//       f32(sum pi.vi) * (sv / 127) / (f32(127 sum pi) / 127^2): the
//       denominator is the TPU kernel's ones column of V (scale exactly
//       1/127, int8 value 127), so it sums the same quantized probabilities
//       as the numerator;
//   qk alone: the online softmax, bf16 probabilities and row sums.
// q, k and v are column views of one fused (B, N, 3*H*64) projection output
// (row and batch strides in elements, unit column stride); the output is a
// contiguous (B, N, H*64). A q chunk holds chunk_rows consecutive rows from
// row 0 (the TPU kernel's automatic q chunk: a scale group, not a tile
// here). The TPU kernel pads q with zeros to whole chunks and adds the bias,
// so rows from seq up to the last chunk's end enter its scale as |b_q|.
//
// What bounds it on the H100: at ViT-g's slices (N = 1029 at 512^2, 4101 at
// 1024^2; d = 64) the two products Q.K^T and P.V are 2*N^2*d operations
// each per (batch, head) (bf16 at 989 TFLOP/s, int8 at 1979 TOP/s) against
// O(N*d) bytes, so the kernel is compute bound on the tensor cores, and the
// N x N score matrix must never reach device memory.
//
// What the design does about it:
// - one block of 4 warps per (query tile of 64 rows, head, batch); each warp
//   owns 16 query rows and keeps their Q fragments, the running row max and
//   row sum and the 16 x 64 f32 output accumulator in registers;
// - keys stream through shared memory in tiles of 64 (K row-major, V stored
//   transposed so both products read 32-bit fragment pairs);
// - the int8 products are mma.sync m16n8k32 s8 x s8 -> s32 (exact, so the
//   kernel and its plain version differ only through exp2 and f32 order),
//   a bf16 product (mode pv's Q.K^T) m16n8k16 with f32 accumulation; the
//   score accumulator is re-packed in registers as the A operand of P.V
//   (the FlashAttention-2 register layout), so scores never leave the SM;
//   for the int8 P.V the keys of each 32-key step are permuted, and V^T is
//   stored with that permutation, so A and B agree on the order of the sum;
// - softmax in the log2 domain: scores are multiplied by scale*log2(e) and
//   exponentiated with exp2f, with the row-max shift kept;
// - the q/k/v biases are added while the tiles are staged in shared memory
//   (rounded to bf16, as the TPU kernel adds them in bf16); keys at or past
//   kv_len are masked to -inf after the bias, and their V rows are zeroed,
//   so the ragged tail needs no padding by the caller;
// - the scales come first, from one small pre-pass (one block per (batch,
//   head) for sk and sv, one per q chunk for sq), so every block knows its
//   scales before its first key tile and its tiles need not line up with
//   the chunks; q, k and v are quantized while they are staged into shared
//   memory (as the TPU kernel does in VMEM): no int8 copy goes to device
//   memory;
// - without int8 P.V, an online softmax; the probabilities are rounded to
//   bf16 once for P.V, and the denominator is the row sum of those rounded
//   values (the TPU kernel gets it from a ones column appended to V);
// - with int8 P.V, two passes over the keys: the first takes the exact row
//   max, the second recomputes the scores and quantizes p. An online
//   softmax would rescale partial sums of already rounded probabilities.
// Not yet done (later work): the wgmma + TMA design of attention_sm90.cu,
// keeping K in shared memory across both int8 passes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 64;
constexpr int kBlockQ = 64;  // 4 warps x 16 query rows
constexpr int kBlockK = 64;
constexpr int kThreads = 128;
constexpr int kPad = 8;  // bf16 elements of row padding in shared memory
constexpr int kScaleThreads = 256;
constexpr int kModeQK = 1;  // int8 Q.K^T
constexpr int kModePV = 2;  // int8 P.V
constexpr float kInv127 = 1.0f / 127.0f;
// dequantization of V's ones column: its scale 1/127 times 1/127, in f32
constexpr float kOnesDequant = kInv127 * kInv127;

// Element strides of one (batch, head, token, 64) operand.
struct Strides {
  long long b, h, n;
};

struct AttnStrides {
  Strides q, k, v, o;
};

// The int8 modes' f32 scales from cryovit_attention_int8_scales (a mode's
// unused ones are not read): sq (batch, heads, chunks), chunk c over q rows
// c*chunk_rows ..; sk (batch, heads); sv (batch, heads, 64).
struct Int8Scales {
  const float* sq;
  const float* sk;
  const float* sv;
  int chunk_rows, chunks;
};

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

__device__ __forceinline__ uint32_t ld32(const void* p) {
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

// D = A(16x32, row) * B(32x8, col) + D, int8 inputs, int32 accumulators.
// The fragments hold the same bytes as m16n8k16 bf16 ones: A row g (g + 8)
// bytes 4t..4t+3 and 16+4t..16+4t+3; B column g the same k bytes.
__device__ __forceinline__ void mma_s8(int d[4], const uint32_t a[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
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

// four int8 values (low byte first: the lowest k index of a fragment)
__device__ __forceinline__ uint32_t pack_s8(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | (uint32_t)(b & 0xff) << 8 |
         (uint32_t)(c & 0xff) << 16 | (uint32_t)(d & 0xff) << 24;
}

// round(x * inv), half to even, as int8 bits (|x * inv| <= 127 by the scale)
__device__ __forceinline__ int quant(float x, float inv) {
  return __float2int_rn(x * inv);
}

__device__ __forceinline__ float inv_scale(float s) { return 1.f / fmaxf(s, 1e-20f); }

// 8 bf16 values times one reciprocal scale, as 8 int8 bytes.
__device__ __forceinline__ uint2 quant8(const Vec8& x, float inv) {
  int qv[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) qv[j] = quant(__bfloat162float(x.h[j]), inv);
  return make_uint2(pack_s8(qv[0], qv[1], qv[2], qv[3]),
                    pack_s8(qv[4], qv[5], qv[6], qv[7]));
}

// Where key r of a 64-key tile sits in a row of the int8 V^T: within each
// 32-key step, thread t of a quad holds the scores of keys 2t, 2t+1 of the
// four 8-key n-tiles m = 0..3, and the int8 A fragment wants k indices
// 4t..4t+3 (m = 0, 1) and 16+4t..16+4t+3 (m = 2, 3). Storing key
// 8m + 2t + e at 16(m/2) + 4t + 2(m%2) + e gives V^T that k order.
__device__ __forceinline__ int pv_slot(int r) {
  const int w = r & 31, m = w >> 3, t = (w >> 1) & 3, e = w & 1;
  return (r & 32) + ((m >> 1) << 4) + (t << 2) + ((m & 1) << 1) + e;
}

// bias: (3, heads*64) bf16 rows q, k, v.
template <int kMode>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ bias,
                           __nv_bfloat16* __restrict__ out, int seq, int heads,
                           AttnStrides st, int kv_len, float scale_log2,
                           Int8Scales sc) {
  constexpr bool kIntQK = (kMode & kModeQK) != 0;
  constexpr bool kIntPV = (kMode & kModePV) != 0;
  // bytes per row of the Q and K tiles and of V^T, padded so that the
  // fragment loads of a warp fall in distinct banks
  constexpr int kRowQK = kIntQK ? kHeadDim + 16 : (kHeadDim + kPad) * 2;
  constexpr int kRowV = kIntPV ? kBlockK + 16 : (kBlockK + kPad) * 2;
  __shared__ __align__(16) unsigned char sQ[kBlockQ * kRowQK];
  __shared__ __align__(16) unsigned char sK[kBlockK * kRowQK];
  __shared__ __align__(16) unsigned char sVt[kHeadDim * kRowV];
  __shared__ float inv_sv[kIntPV ? kHeadDim : 1], deq_sv[kIntPV ? kHeadDim : 1];

  const int q0 = blockIdx.x * kBlockQ;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int bh = b * heads + head;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int channels = heads * kHeadDim;
  const int wr = warp * 16;

  const __nv_bfloat16* qh = q + b * st.q.b + head * st.q.h;
  const __nv_bfloat16* kh = k + b * st.k.b + head * st.k.h;
  const __nv_bfloat16* vh = v + b * st.v.b + head * st.v.h;
  const __nv_bfloat16* bq = bias + head * kHeadDim;
  const __nv_bfloat16* bk = bias + channels + head * kHeadDim;
  const __nv_bfloat16* bv = bias + 2 * channels + head * kHeadDim;
  const float* sq_bh = sc.sq + (long long)bh * sc.chunks;

  // Per row: the int8 scores' dequantization times scale*log2 e.
  float inv_sk = 0.f, fac[2] = {0.f, 0.f};
  if constexpr (kIntQK) {
    const float skv = sc.sk[bh];
    inv_sk = inv_scale(skv);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + wr + g + 8 * r;
      if (row < seq) fac[r] = (sq_bh[row / sc.chunk_rows] * skv) * scale_log2;
    }
  }
  if constexpr (kIntPV) {
    if (tid < kHeadDim) {
      const float s = sc.sv[bh * kHeadDim + tid];
      inv_sv[tid] = inv_scale(s);
      deq_sv[tid] = s * kInv127;
    }
  }

  // Stage the query tile (+ q bias), as bf16 or quantized with its rows'
  // chunk scales.
  for (int c = tid; c < kBlockQ * kHeadDim / 8; c += kThreads) {
    const int r = c >> 3, col = (c & 7) * 8;
    const int row = q0 + r;
    const Vec8 val = load_row8(qh + row * st.q.n + col, row < seq, bq + col);
    if constexpr (kIntQK) {
      const float inv = row < seq ? inv_scale(sq_bh[row / sc.chunk_rows]) : 0.f;
      *reinterpret_cast<uint2*>(sQ + r * kRowQK + col) = quant8(val, inv);
    } else {
      *reinterpret_cast<uint4*>(sQ + r * kRowQK + col * 2) = val.u;
    }
  }
  __syncthreads();

  uint32_t qa[4][4];  // int8: k steps 0..1 of 32; bf16: 0..3 of 16
#pragma unroll
  for (int ks = 0; ks < (kIntQK ? 2 : 4); ++ks) {
    // byte offset of the fragment's first k half; the second is 16 bytes
    // on (16 int8 or 8 bf16 values)
    const int kb = kIntQK ? ks * 32 + 4 * t : (ks * 16 + 2 * t) * 2;
    qa[ks][0] = ld32(sQ + (wr + g) * kRowQK + kb);
    qa[ks][1] = ld32(sQ + (wr + g + 8) * kRowQK + kb);
    qa[ks][2] = ld32(sQ + (wr + g) * kRowQK + kb + 16);
    qa[ks][3] = ld32(sQ + (wr + g + 8) * kRowQK + kb + 16);
  }

  // Stages the key tile from key0: K row-major (bf16 or int8) and, with_v,
  // V^T (bf16 in key order, or int8 at the P.V slots of pv_slot); keys at or
  // past kv_len are zero. K and V of one row are loaded together.
  auto stage = [&](int key0, bool with_v) {
    for (int c = tid; c < kBlockK * kHeadDim / 8; c += kThreads) {
      const int r = c >> 3, col = (c & 7) * 8;
      const int key = key0 + r;
      const bool valid = key < kv_len;
      const Vec8 kv = load_row8(kh + key * st.k.n + col, valid, bk + col);
      if constexpr (kIntQK) {
        *reinterpret_cast<uint2*>(sK + r * kRowQK + col) =
            valid ? quant8(kv, inv_sk) : make_uint2(0, 0);
      } else {
        *reinterpret_cast<uint4*>(sK + r * kRowQK + col * 2) = kv.u;
      }
      if (!with_v) continue;
      const Vec8 vv = load_row8(vh + key * st.v.n + col, valid, bv + col);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if constexpr (kIntPV) {
          const int qv = valid ? quant(__bfloat162float(vv.h[j]), inv_sv[col + j]) : 0;
          reinterpret_cast<int8_t*>(sVt)[(col + j) * kRowV + pv_slot(r)] = (int8_t)qv;
        } else {
          reinterpret_cast<__nv_bfloat16*>(sVt + (col + j) * kRowV)[r] =
              valid ? vv.h[j] : __float2bfloat16(0.f);
        }
      }
    }
  };
  // S for this warp's 16 rows x the tile's 64 keys (8 n-tiles of 8 keys),
  // in the log2 domain; keys >= kv_len are -inf.
  auto scores = [&](float (&s)[8][4], int key0) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const unsigned char* kr = sK + (nt * 8 + g) * kRowQK;
      if constexpr (kIntQK) {
        int acc[4] = {0, 0, 0, 0};
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          mma_s8(acc, qa[ks], ld32(kr + ks * 32 + 4 * t), ld32(kr + ks * 32 + 16 + 4 * t));
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) s[nt][i] = (float)acc[i] * fac[i >> 1];
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const int kb = (ks * 16 + 2 * t) * 2;
          mma_16816(s[nt], qa[ks], ld32(kr + kb), ld32(kr + kb + 16));
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) s[nt][i] *= scale_log2;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (key0 + nt * 8 + 2 * t + (i & 1) >= kv_len) s[nt][i] = -INFINITY;
      }
    }
  };

  const int num_kt = (kv_len + kBlockK - 1) / kBlockK;
  float s[8][4];
  float o[8][4];  // the output tile before the row's 1 / denominator
  float inv[2];   // 1 / denominator of the row (g, g + 8)

  if constexpr (kIntPV) {
    // Pass 1: the exact row max.
    float m[2] = {-INFINITY, -INFINITY};
    for (int kt = 0; kt < num_kt; ++kt) {
      __syncthreads();  // previous tile fully consumed
      stage(kt * kBlockK, false);
      __syncthreads();
      scores(s, kt * kBlockK);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) m[i >> 1] = fmaxf(m[i >> 1], s[nt][i]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffff, m[r], 1));
      m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffff, m[r], 2));
    }
    // Pass 2: p quantized against that max, int8 P.V and the integer row
    // sum of the quantized p (V's ones column).
    int oi[8][4], lsum[2] = {0, 0};
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) oi[dt][i] = 0;
    }
    for (int kt = 0; kt < num_kt; ++kt) {
      __syncthreads();
      stage(kt * kBlockK, true);
      __syncthreads();
      scores(s, kt * kBlockK);
      int pi[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = round_bf16(exp2f(s[nt][i] - m[i >> 1]));
          pi[nt][i] = __float2int_rn(p * 127.f);
          lsum[i >> 1] += pi[nt][i];
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t pa[4];
        pa[0] = pack_s8(pi[4 * j][0], pi[4 * j][1], pi[4 * j + 1][0], pi[4 * j + 1][1]);
        pa[1] = pack_s8(pi[4 * j][2], pi[4 * j][3], pi[4 * j + 1][2], pi[4 * j + 1][3]);
        pa[2] = pack_s8(pi[4 * j + 2][0], pi[4 * j + 2][1], pi[4 * j + 3][0], pi[4 * j + 3][1]);
        pa[3] = pack_s8(pi[4 * j + 2][2], pi[4 * j + 2][3], pi[4 * j + 3][2], pi[4 * j + 3][3]);
#pragma unroll
        for (int dt = 0; dt < 8; ++dt) {
          const unsigned char* vr = sVt + (dt * 8 + g) * kRowV + 32 * j + 4 * t;
          mma_s8(oi[dt], pa, ld32(vr), ld32(vr + 16));
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      int l = lsum[r];
      l += __shfl_xor_sync(0xffffffff, l, 1);
      l += __shfl_xor_sync(0xffffffff, l, 2);
      inv[r] = 1.f / ((float)(127 * l) * kOnesDequant);
    }
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) o[dt][i] = (float)oi[dt][i] * deq_sv[dt * 8 + 2 * t + (i & 1)];
    }
  } else {
    // The online softmax.
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};  // per-thread partial row sums
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) o[dt][i] = 0.f;
    }
    for (int kt = 0; kt < num_kt; ++kt) {
      __syncthreads();  // previous tile fully consumed
      stage(kt * kBlockK, true);
      __syncthreads();
      scores(s, kt * kBlockK);

      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) mx[i >> 1] = fmaxf(mx[i >> 1], s[nt][i]);
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

      // P = exp2(S - m), rounded to bf16 once for the P.V product; the row
      // sum adds the rounded values.
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = round_bf16(exp2f(s[nt][i] - m_run[i >> 1]));
          s[nt][i] = p;
          l_run[i >> 1] += p;
        }
      }

      // O += P V: the score accumulators of n-tiles (2j, 2j+1) are exactly
      // the A fragment of the k-step over keys 16j..16j+15.
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t pa[4];
        pa[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
        pa[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
        pa[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
        pa[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
        for (int dt = 0; dt < 8; ++dt) {
          const unsigned char* vr = sVt + (dt * 8 + g) * kRowV + (j * 16 + 2 * t) * 2;
          mma_16816(o[dt], pa, ld32(vr), ld32(vr + 16));
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffff, l, 1);
      l += __shfl_xor_sync(0xffffffff, l, 2);
      inv[r] = 1.f / l;
    }
  }

  const int row0 = q0 + wr + g;
  const int row1 = row0 + 8;
  __nv_bfloat16* ob = out + b * st.o.b + head * st.o.h;
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (row0 < seq) {
      *reinterpret_cast<uint32_t*>(ob + row0 * st.o.n + col) =
          pack_bf16(o[dt][0] * inv[0], o[dt][1] * inv[0]);
    }
    if (row1 < seq) {
      *reinterpret_cast<uint32_t*>(ob + row1 * st.o.n + col) =
          pack_bf16(o[dt][2] * inv[1], o[dt][3] * inv[1]);
    }
  }
}

template <int kMode>
int launch(const void* q, const void* k, const void* v, const void* bias,
           void* out, int batch, int seq, int heads, const AttnStrides& st,
           int kv_len, float scale_log2, void* stream,
           const Int8Scales& sc) {
  dim3 grid((seq + kBlockQ - 1) / kBlockQ, heads, batch);
  flash_attention_kernel<kMode>
      <<<grid, kThreads, 0, (cudaStream_t)stream>>>(
          (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
          (const __nv_bfloat16*)v, (const __nv_bfloat16*)bias,
          (__nv_bfloat16*)out, seq, heads, st, kv_len, scale_log2, sc);
  return (int)cudaGetLastError();
}

// (batch, seq, heads*64) q, k, v sharing the given row and batch strides,
// and a contiguous output of that shape.
AttnStrides channel_major(int seq, int heads, long long row_stride,
                          long long batch_stride) {
  const long long channels = (long long)heads * kHeadDim;
  const Strides in{batch_stride, kHeadDim, row_stride};
  return AttnStrides{in, in, in, Strides{seq * channels, kHeadDim, channels}};
}

// max over the block (all threads get it); smem: one float per warp
__device__ __forceinline__ float block_max(float v, float* smem) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffff, v, o));
  if ((threadIdx.x & 31) == 0) smem[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = smem[0];
  for (int i = 1; i < (int)(blockDim.x >> 5); ++i) r = fmaxf(r, smem[i]);
  return r;
}

// The int8 scales. Grid (1 + chunks, heads, batch), kScaleThreads threads.
// Block x = 0 takes sk (mode qk) and sv (mode pv) over keys < kv_len; block
// x = 1 + c takes sq of q chunk c (rows c*chunk_rows ..). Each thread reads
// 8 columns of one row per step, 32 rows a step.
__global__ void __launch_bounds__(kScaleThreads)
    attention_int8_scales_kernel(const __nv_bfloat16* __restrict__ q,
                                 const __nv_bfloat16* __restrict__ k,
                                 const __nv_bfloat16* __restrict__ v,
                                 const __nv_bfloat16* __restrict__ bias,
                                 float* __restrict__ sq, float* __restrict__ sk,
                                 float* __restrict__ sv, int seq, int heads,
                                 long long row_stride, long long batch_stride,
                                 int kv_len, int chunk_rows, int chunks,
                                 int mode) {
  __shared__ float col_max[kScaleThreads / 8][kHeadDim];
  __shared__ float warp_max[kScaleThreads / 32];
  const int head = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int bh = b * heads + head;
  const int channels = heads * kHeadDim;
  const int col = (tid & 7) * 8, r0 = tid >> 3;
  constexpr int kRowsPerStep = kScaleThreads / 8;
  const long long base = b * batch_stride + head * kHeadDim + col;
  const __nv_bfloat16* bq = bias + head * kHeadDim + col;
  const __nv_bfloat16* bk = bq + channels;
  const __nv_bfloat16* bv = bq + 2 * channels;

  if (blockIdx.x == 0) {
    float kmax = 0.f, vmax[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int key = r0; key < kv_len; key += kRowsPerStep) {
      if (mode & kModeQK) {
        const Vec8 kv = load_row8(k + base + key * row_stride, true, bk);
#pragma unroll
        for (int j = 0; j < 8; ++j) kmax = fmaxf(kmax, fabsf(__bfloat162float(kv.h[j])));
      }
      if (mode & kModePV) {
        const Vec8 vv = load_row8(v + base + key * row_stride, true, bv);
#pragma unroll
        for (int j = 0; j < 8; ++j) vmax[j] = fmaxf(vmax[j], fabsf(__bfloat162float(vv.h[j])));
      }
    }
    if (mode & kModeQK) {
      const float m = block_max(kmax, warp_max);
      if (tid == 0) sk[bh] = m * kInv127;
    }
    if (mode & kModePV) {
#pragma unroll
      for (int j = 0; j < 8; ++j) col_max[r0][col + j] = vmax[j];
      __syncthreads();
      if (tid < kHeadDim) {
        float m = 0.f;
        for (int i = 0; i < kRowsPerStep; ++i) m = fmaxf(m, col_max[i][tid]);
        sv[bh * kHeadDim + tid] = m * kInv127;
      }
    }
    return;
  }
  const int chunk = blockIdx.x - 1;
  float qmax = 0.f;
  for (int row = chunk * chunk_rows + r0; row < (chunk + 1) * chunk_rows;
       row += kRowsPerStep) {
    const Vec8 qv = load_row8(q + base + row * row_stride, row < seq, bq);
#pragma unroll
    for (int j = 0; j < 8; ++j) qmax = fmaxf(qmax, fabsf(__bfloat162float(qv.h[j])));
  }
  const float m = block_max(qmax, warp_max);
  if (tid == 0) sq[bh * chunks + chunk] = m * kInv127;
}

}  // namespace

// Scales of the int8 modes (mode bits: 1 qk, 2 pv). q, k, v: (batch, seq,
// heads*64) bf16 with unit column stride and the given row and batch strides
// (elements); bias (3, heads*64) bf16. Writes, as max|x + bias| / 127 in f32:
// under qk sq (batch, heads, chunks), chunk c over rows c*chunk_rows ..
// (c+1)*chunk_rows - 1 (rows >= seq count as the bias), and sk (batch,
// heads) over keys < kv_len; under pv sv (batch, heads, 64) per column over
// keys < kv_len. Returns cudaGetLastError().
extern "C" int cryovit_attention_int8_scales(
    const void* q, const void* k, const void* v, const void* bias, void* sq,
    void* sk, void* sv, int batch, int seq, int heads, long long row_stride,
    long long batch_stride, int kv_len, int chunk_rows, int chunks, int mode,
    void* stream) {
  dim3 grid(1 + ((mode & kModeQK) ? chunks : 0), heads, batch);
  attention_int8_scales_kernel<<<grid, kScaleThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const __nv_bfloat16*)bias, (float*)sq, (float*)sk, (float*)sv, seq, heads,
      row_stride, batch_stride, kv_len, chunk_rows, chunks, mode);
  return (int)cudaGetLastError();
}

// Row 1 with the int8 internals of mode (1 qk, 2 pv, 3 qkpv), on the scales
// of cryovit_attention_int8_scales (same q, k, v, bias, chunk_rows, chunks,
// mode); arguments otherwise as cryovit_flash_attention's. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for an unknown mode.
extern "C" int cryovit_flash_attention_int8(
    const void* q, const void* k, const void* v, const void* bias,
    const void* sq, const void* sk, const void* sv, void* out, int batch,
    int seq, int heads, long long row_stride, long long batch_stride,
    int kv_len, int chunk_rows, int chunks, float scale_log2, int mode,
    void* stream) {
  const AttnStrides st = channel_major(seq, heads, row_stride, batch_stride);
  const Int8Scales sc{(const float*)sq, (const float*)sk, (const float*)sv,
                      chunk_rows, chunks};
  switch (mode) {
    case kModeQK:
      return launch<kModeQK>(q, k, v, bias, out, batch, seq, heads,
                                          st, kv_len, scale_log2, stream, sc);
    case kModePV:
      return launch<kModePV>(q, k, v, bias, out, batch, seq, heads,
                                          st, kv_len, scale_log2, stream, sc);
    case kModeQK | kModePV:
      return launch<kModeQK | kModePV>(q, k, v, bias, out, batch,
                                                    seq, heads, st, kv_len,
                                                    scale_log2, stream, sc);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
