// The int8 internals of the DINOv2 pair attention on Hopper (sm_90a): TMA
// loads, an mbarrier ring and wgmma products on the int8 tensor cores, fed
// by a pre-pass that quantizes K and V once per (batch, head).
//
// Replaces the quant= modes of cryovit_tpu/ops/flash_attention.py:
// _flash_kernel_paired (flash_attention_pairs, channel_major=True): the int8
// branches on its single-K-block path (the K and V quantization :386-420,
// the int8 Q.K^T :445-457, the int8 P.V :486-498). Three entries, launched
// in this order by the wrapper (ops/flash_attention.py):
// - cryovit_attention_int8_scales: the f32 scales;
// - cryovit_attention_int8_operands: K and V as the attention's operands;
// - cryovit_flash_attention_int8: the attention, templated on mode (bits:
//   1 int8 Q.K^T, 2 int8 P.V).
// The bf16 attention of the same TPU kernel (and of _flash_kernel and the
// Hiera global blocks) is csrc/attention_sm90.cu; both take their TMA,
// mbarrier and wgmma helpers from csrc/sm90.cuh.
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
// 1024^2; d = 64) each product is 2*N^2*d operations per (batch, head) (int8
// at 1979 TOP/s, bf16 at 989 TFLOP/s) against O(N*d) bytes, so it is bound
// by the tensor cores; and every score takes one exp2 on the SFU (16 a clock
// per SM), as long as an int8 product of the tile on the tensor cores. The
// N x N scores never reach device memory.
//
// What the design does about it:
// - the pre-pass writes K and V once, with their biases added (rounded to
//   bf16), zero at or past kv_len and padded to n_pad = 64 * ceil(N / 64)
//   keys: K as int8 (qk; per-head scale) or bf16 (pv alone), (B, H, n_pad,
//   64), K-major rows; V as int8 V^T (pv; per-column scales), (B, H, 64,
//   n_pad), or bf16 (qk alone), (B, H, n_pad, 64). The int8 wgmma takes B
//   only K-major (its reduction dimension contiguous), and P.V reduces over
//   keys, so V^T is what the tensor cores read. Every query tile then
//   streams ready operands by TMA: no tile re-quantizes a head's K and V;
// - V^T's keys are permuted within each 32-key step (pv_slot) so that the
//   s32 score accumulator, packed to int8 in place, is the A fragment of
//   P.V without shuffles: integer sums are exact, so the order of the sum
//   changes no bit;
// - a block takes 64 * kConsumers query rows of one (b, h): kConsumers = 3
//   consumer warpgroups of 64 rows and one producer warp whose lane 0
//   issues every TMA load; K/V tiles of 64 keys pass through a ring of
//   kStages stages with "full" (bytes landed) and "empty" (every consumer
//   warp done) mbarriers. The q tiles of one (b, h) are adjacent in the grid,
//   so they run together and stream that head's K and V from L2;
// - Q lands as a bf16 tile; each consumer thread adds b_q to its own
//   fragment elements and quantizes them with its rows' chunk scales (a 64-row
//   tile may straddle two chunks: the scale is per row) straight into
//   registers, once. Both products are RS wgmma (A from registers, B from
//   shared memory): Q.K^T m64n64k32 s8 (bf16 m64n64k16 under pv alone) and
//   P.V m64n64k32 s8 (bf16 m64n64k16 under qk alone);
// - the s32 sums become floats without a conversion instruction (the SFU
//   that converts also takes the exp2s): an int i added to the bits of
//   1.5 * 2^23 is the float 1.5 * 2^23 + i; likewise round(127 p) is
//   fma(p, 127, 1.5 * 2^23), whose low byte is the int8 value;
// - with int8 P.V, two passes over the keys: pass 1 runs Q.K^T and takes
//   the row max on the integer sums (f32(max) * factor is the max of the
//   scores exactly, the factor being positive), with no exp2; pass 2
//   recomputes Q.K^T, quantizes p against that max and runs P.V, whose
//   softmax of tile kt overlaps tile kt - 1's P.V on the tensor cores. An
//   online softmax would rescale partial sums of already rounded
//   probabilities. Pass 2 streams K through the ring again: one head's K is
//   262 KB of int8 at 4101 tokens, more than a block's 227 KB;
// - without int8 P.V, the online softmax and software pipeline of
//   attention_sm90.cu;
// - keys at or past kv_len score -inf (p = 0), query rows past seq are not
//   stored, a consumer warpgroup whose rows all lie past seq does not run.
// A thread of the 13-warp block gets at most 128 registers (one SM
// sub-partition holds 4 of its warps): more live values than these bodies
// hold make ptxas serialize the wgmmas (C7511/C7515 in the build log).
// Not yet done (later work): K kept in shared memory across the two passes
// at 1029 tokens (69 KB of int8), fewer instructions per score (the ALU
// issue rate, not the tensor cores, bounds pass 2), ping-pong consumer
// warpgroups.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"

namespace {

constexpr int kHeadDim = 64;
constexpr int kKeyTile = 64;  // keys per ring stage (n_pad is a multiple)
constexpr int kConsumers = 3;  // consumer warpgroups of 64 query rows
constexpr int kStages = 4;     // K/V ring depth (even: pass 1 takes stages in pairs)
constexpr int kThreads = kConsumers * 128 + 32;
constexpr int kQBytes = 64 * 64 * 2;  // one bf16 Q tile, 128-byte rows
constexpr int kScaleThreads = 256;
constexpr int kOperandThreads = 256;
constexpr int kModeQK = 1;  // int8 Q.K^T
constexpr int kModePV = 2;  // int8 P.V
constexpr float kInv127 = 1.0f / 127.0f;
// dequantization of V's ones column: its scale 1/127 times 1/127, in f32
constexpr float kOnesDequant = kInv127 * kInv127;
// 1.5 * 2^23: floats in [2^23, 2^24) are the integers, one apart, so
// x + kMagic rounds x to an integer (half to even) for |x| < 2^22, and the
// bits of kMagic plus an int i (|i| < 2^22) are the float kMagic + i.
constexpr float kMagic = 12582912.0f;
constexpr int kMagicBits = 0x4B400000;

union Vec8 {
  uint4 u;
  __nv_bfloat16 h[8];
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Loads 8 consecutive bf16 of one row (zeros when the row is out of range)
// and adds 8 bias values, rounding the sum to bf16.
__device__ __forceinline__ Vec8 load_row8(const __nv_bfloat16* src, bool valid,
                                          const __nv_bfloat16* bias) {
  Vec8 in, out;
  in.u = valid ? *reinterpret_cast<const uint4*>(src) : make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    out.h[j] = __float2bfloat16(__bfloat162float(in.h[j]) + __bfloat162float(bias[j]));
  }
  return out;
}

// four int8 values (low byte first: the lowest k index of a fragment)
__device__ __forceinline__ uint32_t pack_s8(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | (uint32_t)(b & 0xff) << 8 | (uint32_t)(c & 0xff) << 16 |
         (uint32_t)(d & 0xff) << 24;
}

// The low bytes of four words, a's lowest.
__device__ __forceinline__ uint32_t pack_low_bytes(uint32_t a, uint32_t b, uint32_t c,
                                                   uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

__device__ __forceinline__ float inv_scale(float s) { return 1.f / fmaxf(s, 1e-20f); }

// round(x * inv), half to even (|x * inv| <= 127 by the scale)
__device__ __forceinline__ int quant(float x, float inv) { return __float2int_rn(x * inv); }

// 8 bf16 values times one reciprocal scale, as 8 int8 bytes.
__device__ __forceinline__ uint2 quant8(const Vec8& x, float inv) {
  int qv[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) qv[j] = quant(__bfloat162float(x.h[j]), inv);
  return make_uint2(pack_s8(qv[0], qv[1], qv[2], qv[3]), pack_s8(qv[4], qv[5], qv[6], qv[7]));
}

// Where key r sits in a row of the int8 V^T. A thread (g = lane / 4, t =
// lane % 4) of a warpgroup holds, in the s32 accumulator of a 64 x 64
// product, the scores of keys 8m + 2t + e (n-tile m, e = 0, 1); the 8-bit
// wgmma's register A fragment of a k32 step wants k indices 4t .. 4t + 3
// in its registers 0, 1 and 16 + 4t .. 16 + 4t + 3 in 2, 3 (PTX ISA, wgmma
// .m64nNk32 A fragment). Packing n-tiles (0, 1) of each 32-key step into
// registers 0, 1 and n-tiles (2, 3) into 2, 3 puts key 8m + 2t + e of the
// step at k index 16 (m / 2) + 4t + 2 (m % 2) + e, so V^T stores it there.
// ops/flash_attention.py:pv_key_positions is the plain twin.
__device__ __forceinline__ int pv_slot(int r) {
  const int w = r & 31, m = w >> 3, t = (w >> 1) & 3, e = w & 1;
  return (r & ~31) + ((m >> 1) << 4) + (t << 2) + ((m & 1) << 1) + e;
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

// The attention's K and V operands. Grid (n_pad / 64, heads, batch),
// kOperandThreads threads; a block takes 64 keys of one (b, h), a thread 8
// columns of one key a step. int8 V^T passes through shared memory, where
// its keys are permuted (pv_slot) and turned into rows of 64 keys.
__global__ void __launch_bounds__(kOperandThreads)
    attention_int8_operands_kernel(const __nv_bfloat16* __restrict__ k,
                                   const __nv_bfloat16* __restrict__ v,
                                   const __nv_bfloat16* __restrict__ bias,
                                   const float* __restrict__ sk, const float* __restrict__ sv,
                                   void* __restrict__ kop, void* __restrict__ vop, int heads,
                                   long long row_stride, long long batch_stride, int kv_len,
                                   int n_pad, int mode) {
  __shared__ __align__(16) int8_t vt[kHeadDim][kKeyTile + 16];
  const int key0 = blockIdx.x * kKeyTile, head = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const long long bh = (long long)b * heads + head;
  const int channels = heads * kHeadDim;
  const int col = (tid & 7) * 8;
  const long long base = b * batch_stride + head * kHeadDim + col;
  const __nv_bfloat16* bk = bias + channels + head * kHeadDim + col;
  const __nv_bfloat16* bv = bk + channels;
  const bool int_qk = (mode & kModeQK) != 0, int_pv = (mode & kModePV) != 0;
  const float inv_k = int_qk ? inv_scale(sk[bh]) : 0.f;
  float inv_v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) inv_v[j] = int_pv ? inv_scale(sv[bh * kHeadDim + col + j]) : 0.f;

  for (int r = tid >> 3; r < kKeyTile; r += kOperandThreads / 8) {
    const int key = key0 + r;
    const bool valid = key < kv_len;
    const long long row = bh * n_pad + key;  // of K, and of V in bf16
    const Vec8 kv = load_row8(k + base + key * row_stride, valid, bk);
    if (int_qk) {
      *reinterpret_cast<uint2*>(static_cast<int8_t*>(kop) + row * kHeadDim + col) =
          valid ? quant8(kv, inv_k) : make_uint2(0, 0);
    } else {
      *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(kop) + row * kHeadDim + col) =
          valid ? kv.u : make_uint4(0, 0, 0, 0);
    }
    const Vec8 vv = load_row8(v + base + key * row_stride, valid, bv);
    if (int_pv) {
      const int slot = pv_slot(r);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        vt[col + j][slot] = (int8_t)(valid ? quant(__bfloat162float(vv.h[j]), inv_v[j]) : 0);
      }
    } else {
      *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(vop) + row * kHeadDim + col) =
          valid ? vv.u : make_uint4(0, 0, 0, 0);
    }
  }
  if (int_pv) {
    __syncthreads();
    const int d = tid >> 2, c = (tid & 3) * 16;  // 64 rows of 4 x 16 bytes
    *reinterpret_cast<uint4*>(static_cast<int8_t*>(vop) + (bh * kHeadDim + d) * n_pad + key0 +
                              c) = *reinterpret_cast<const uint4*>(&vt[d][c]);
  }
}

// Shared-memory tiles of one ring stage, by mode.
template <int kMode>
struct Layout {
  static constexpr bool kIntQK = (kMode & kModeQK) != 0;
  static constexpr bool kIntPV = (kMode & kModePV) != 0;
  static constexpr int kKRow = kIntQK ? 64 : 128;  // bytes a key of K
  // bytes a row of the V tile: a head column of V^T (64 keys of int8), or a
  // key of bf16 V
  static constexpr int kVRow = kIntPV ? 64 : 128;
  static constexpr int kKBytes = 64 * kKRow;
  static constexpr int kVBytes = 64 * kVRow;
  // wgmma layout types: 2 = 64-byte swizzle, 1 = 128-byte
  static constexpr int kKLayout = kIntQK ? 2 : 1;
  static constexpr int kStageBytes = kKBytes + kVBytes;  // a multiple of 1 KB
  static constexpr int kSmem =
      1024 + kConsumers * kQBytes + kStages * kStageBytes + 8 * (1 + 2 * kStages);
};

struct Maps {
  CUtensorMap q, k, v;
};

struct Int8Args {
  const __nv_bfloat16* bias;  // (3, heads * 64): only its q row is read
  const float* sq;            // (batch, heads, chunks), qk
  const float* sk;            // (batch, heads), qk
  const float* sv;            // (batch, heads, 64), pv
  __nv_bfloat16* out;         // (batch, seq, heads * 64)
  // null, or two counters: SM clocks of consumer warpgroup 0 in pass 1 and
  // in pass 2 (the whole attention without int8 P.V), summed over blocks
  unsigned long long* clocks;
  int seq, heads, kv_len, n_pad, chunk_rows, chunks;
  float scale_log2;
};

__device__ __forceinline__ int vmax(int a, int b) { return max(a, b); }
__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }

template <int kMode>
__global__ void __launch_bounds__(kThreads, 1)
    attention_int8_sm90_kernel(const __grid_constant__ Maps maps, const Int8Args a) {
  using L = Layout<kMode>;
  constexpr bool kIntQK = L::kIntQK, kIntPV = L::kIntPV;
  // the score accumulator: s32 sums of int8 products, or f32 ones of bf16
  using Acc = std::conditional_t<kIntQK, int, float>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzle patterns need 1 KB alignment
  const uint8_t* smem = smem_raw + (base - raw);
  const uint32_t sq_tiles = base;                          // kConsumers Q tiles
  // the ring: kStages K tiles, adjacent (pass 1 reads two as one), then
  // kStages V tiles
  const uint32_t ring = sq_tiles + kConsumers * kQBytes;
  const uint32_t bars = ring + kStages * L::kStageBytes;  // q_full, full[], empty[]
  const uint32_t q_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kStages + s); };
  auto k_tile = [&](int s) { return ring + s * L::kKBytes; };
  auto v_tile = [&](int s) { return ring + kStages * L::kKBytes + s * L::kVBytes; };

  const int q0 = blockIdx.x * 64 * kConsumers;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int bh = b * a.heads + head;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int active = min(kConsumers, (a.seq - q0 + 63) / 64);  // warpgroups with rows
  const int num_kt = (a.kv_len + kKeyTile - 1) / kKeyTile;
  constexpr int kPasses = kIntPV ? 2 : 1;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * active);  // lane 0 of every active consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * kConsumers) {  // the producer warp
    if (lane == 0) {
      mbar_expect_tx(q_full, active * kQBytes);
      for (int w = 0; w < active; ++w) {
        tma_load(sq_tiles + w * kQBytes, &maps.q, 0, q0 + 64 * w, head, b, q_full);
      }
      // pass 1 (int8 P.V): K alone; then K and V
      for (int it = 0; it < kPasses * num_kt; ++it) {
        const int s = it % kStages;
        const int key0 = (it < num_kt ? it : it - num_kt) * kKeyTile;
        const bool with_v = !kIntPV || it >= num_kt;
        if (it >= kStages) mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), L::kKBytes + (with_v ? L::kVBytes : 0));
        tma_load(k_tile(s), &maps.k, 0, key0, head, b, full(s));
        if (with_v) {
          if constexpr (kIntPV) {
            tma_load(v_tile(s), &maps.v, key0, 0, head, b, full(s));
          } else {
            tma_load(v_tile(s), &maps.v, 0, key0, head, b, full(s));
          }
        }
      }
    }
    return;
  }

  // A consumer warpgroup: 64 query rows from row0, 16 per warp.
  const int wg = warp >> 2;
  const int row0 = q0 + 64 * wg;
  if (row0 >= a.seq) return;
  const int wr = (warp & 3) * 16;  // the warp's first row in the tile
  const int g = lane >> 2;         // fragment row group
  const int t = lane & 3;          // thread in group
  const int rows[2] = {row0 + wr + g, row0 + wr + g + 8};
  const bool timer = a.clocks != nullptr && wg == 0 && (threadIdx.x & 127) == 0;
  const long long t0 = timer ? clock64() : 0;

  // Per row: the factor of the score sums in the log2 domain and, for qk,
  // the reciprocal of the row's chunk scale (0 past seq: never stored).
  float fac[2], inv_q[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if constexpr (kIntQK) {
      fac[r] = 0.f;
      if (rows[r] < a.seq) {
        const float s = a.sq[bh * a.chunks + rows[r] / a.chunk_rows];
        inv_q[r] = inv_scale(s);
        fac[r] = (s * a.sk[bh]) * a.scale_log2;
      }
    } else {
      fac[r] = a.scale_log2;
    }
  }

  // Q + b_q (rounded to bf16) into registers as the A fragments of Q.K^T:
  // int8 (2 k steps of 32; register j: row g + 8 (j & 1), columns
  // 16 (j >> 1) + 4t ..) or bf16 (4 k steps of 16; columns 8 (j >> 1) + 2t ..).
  constexpr int kQSteps = kIntQK ? 2 : 4;
  uint32_t qa[kQSteps][4];
  mbar_wait(q_full, 0);
  {
    const uint8_t* qt = smem + (sq_tiles - base) + wg * kQBytes;
    const __nv_bfloat16* bq = a.bias + head * kHeadDim;
    // element (r, c) of the 128-byte-swizzled bf16 tile
    auto q_at = [&](int r, int c) {
      return reinterpret_cast<const __nv_bfloat16*>(qt + r * 128 + (((c >> 3) ^ (r & 7)) << 4) +
                                                     (c & 7) * 2);
    };
    auto qb = [&](const __nv_bfloat16* p, int c, int e) {
      return __bfloat162float(p[e]) + __bfloat162float(bq[c + e]);
    };
#pragma unroll
    for (int ks = 0; ks < kQSteps; ++ks) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = wr + g + 8 * (j & 1);
        if constexpr (kIntQK) {
          const int c = 32 * ks + 16 * (j >> 1) + 4 * t;
          const __nv_bfloat16* p = q_at(r, c);
          const float inv = inv_q[j & 1];
          qa[ks][j] = pack_s8(quant(round_bf16(qb(p, c, 0)), inv), quant(round_bf16(qb(p, c, 1)), inv),
                              quant(round_bf16(qb(p, c, 2)), inv), quant(round_bf16(qb(p, c, 3)), inv));
        } else {
          const int c = 16 * ks + 8 * (j >> 1) + 2 * t;
          const __nv_bfloat16* p = q_at(r, c);
          qa[ks][j] = pack_bf16(qb(p, c, 0), qb(p, c, 1));  // rounds the sums to bf16
        }
      }
    }
  }

  Acc s[32];  // S tile: s[4j + e] is key 8j + 2t + (e & 1) of rows[e >> 1]
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0;
  // the float value of a score sum: exact for the s32 sums (|sum| <= 64 * 127^2)
  auto to_f = [](Acc x) -> float {
    if constexpr (kIntQK) {
      return __int_as_float(x + kMagicBits) - kMagic;
    } else {
      return x;
    }
  };
  auto bits_of = [](Acc x) -> uint32_t {
    if constexpr (kIntQK) {
      return (uint32_t)x;
    } else {
      return __float_as_uint(x);
    }
  };
  auto from_f = [](float x) -> Acc {
    if constexpr (kIntQK) {
      return __float_as_int(x);
    } else {
      return x;
    }
  };
  auto masked = [&](int key0, int i) { return key0 + 8 * (i >> 2) + 2 * t + (i & 1) >= a.kv_len; };
  auto stage_of = [&](int it) { return it % kStages; };
  auto parity_of = [&](int it) { return (uint32_t)((it / kStages) & 1); };

  // d = Q K^T of the K tile in stage st, or with 64 accumulators (bf16 K
  // only) of the two in stages st, st + 1 (issued, not waited for)
  auto issue_s = [&](auto& d, int st) {
    const uint64_t dk = desc_k_major(k_tile(st), L::kKRow, L::kKLayout);
#pragma unroll
    for (int ks = 0; ks < kQSteps; ++ks) {
      if constexpr (kIntQK) {
        wgmma_rs_s8_n64(d, qa[ks], dk + 2 * ks, ks);
      } else if constexpr (sizeof(d) / sizeof(Acc) == 64) {
        wgmma_rs_n128_kmajor(d, qa[ks], dk + 2 * ks, ks);
      } else {
        wgmma_rs_n64_kmajor(d, qa[ks], dk + 2 * ks, ks);
      }
    }
  };
  auto release = [&](int st) {  // this warp is done with the stage
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  };
  // this thread's part of the row max of the tile at key0 into mx, over
  // keys below kv_len, taken on the sums: f32(max sum) * fac is the max of
  // the scores
  auto tile_max = [&](const auto& sc, Acc (&mx)[2], int key0) {
    constexpr int kN = sizeof(sc) / sizeof(Acc);  // 32 or 64 accumulators: 64 or 128 keys
    if (key0 + 2 * kN > a.kv_len) {
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        if (!masked(key0, i)) mx[(i >> 1) & 1] = vmax(mx[(i >> 1) & 1], sc[i]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kN; ++i) mx[(i >> 1) & 1] = vmax(mx[(i >> 1) & 1], sc[i]);
    }
  };
  auto quad_max = [&](Acc (&mx)[2]) {  // over the 4 threads of each row
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = vmax(mx[r], __shfl_xor_sync(0xffffffff, mx[r], 1));
      mx[r] = vmax(mx[r], __shfl_xor_sync(0xffffffff, mx[r], 2));
    }
  };
  auto lowest = []() -> Acc {
    if constexpr (kIntQK) {
      return INT_MIN;
    } else {
      return -INFINITY;
    }
  };

  float inv[2];  // 1 / the row's denominator
  __nv_bfloat16* const ob = a.out + (long long)b * a.seq * a.heads * kHeadDim + head * kHeadDim;
  const long long ld_out = (long long)a.heads * kHeadDim;

  if constexpr (kIntPV) {
    // Pass 1: Q K^T and the exact row max, on the integer (or f32) sums.
    // With bf16 K, two adjacent K tiles a product (m64n128 ran faster than
    // two m64n64 on the H100; with int8 K it ran slower), an odd last tile
    // alone.
    Acc mx[2] = {lowest(), lowest()};
    for (int kt = 0; kt < num_kt; ++kt) {
      const int st = stage_of(kt);  // even where a pair starts
      mbar_wait(full(st), parity_of(kt));
      if constexpr (!kIntQK) {
        if (kt + 1 < num_kt) {
          Acc s2[64];
          mbar_wait(full(st + 1), parity_of(kt + 1));
          fence_regs(s2);
          wgmma_fence();
          issue_s(s2, st);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(s2);
          release(st);
          release(st + 1);
          tile_max(s2, mx, kt * kKeyTile);
          ++kt;
          continue;
        }
      }
      fence_regs(s);
      wgmma_fence();
      issue_s(s, st);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      release(st);
      tile_max(s, mx, kt * kKeyTile);
    }
    quad_max(mx);
    const float m[2] = {to_f(mx[0]) * fac[0], to_f(mx[1]) * fac[1]};
    const long long t1 = timer ? clock64() : 0;

    // Pass 2: p quantized against that max, int8 P.V, and the integer row
    // sum of the quantized p (V's ones column), by dp4a on the packed pi.
    int o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0;
    uint32_t lsum[2] = {0u, 0u};
    uint32_t pa[2][4];  // pi as the A fragments of P.V's 2 k steps
    // pi = round(127 bf16(2^(s - m))) in place of S, as fma(p, 127, kMagic):
    // its low byte is pi. It writes no register but s: it runs while the
    // previous tile's P.V reads pa.
    auto quant_p = [&](int key0, auto ragged) {
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int r = (i >> 1) & 1;
        float x0 = fmaf(to_f(s[i]), fac[r], -m[r]);
        float x1 = fmaf(to_f(s[i + 1]), fac[r], -m[r]);
        if constexpr (decltype(ragged)::value) {
          if (masked(key0, i)) x0 = -INFINITY;
          if (masked(key0, i + 1)) x1 = -INFINITY;
        }
        const __nv_bfloat162 p = __floats2bfloat162_rn(ex2(x0), ex2(x1));
        s[i] = from_f(fmaf(__low2float(p), 127.f, kMagic));
        s[i + 1] = from_f(fmaf(__high2float(p), 127.f, kMagic));
      }
    };
    auto quant_tile = [&](int kt) {
      const int key0 = kt * kKeyTile;
      if (key0 + kKeyTile > a.kv_len) {
        quant_p(key0, std::true_type{});
      } else {
        quant_p(key0, std::false_type{});
      }
    };
    // pi into pa, once the P.V that read pa is done: k step kk takes
    // n-tiles 4kk .. 4kk + 3 (see pv_slot); registers 0, 2 hold row g,
    // 1, 3 row g + 8, whose pi the row sums add four at a time
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        auto lo = [&](int i) { return bits_of(s[16 * kk + i]); };
        pa[kk][0] = pack_low_bytes(lo(0), lo(1), lo(4), lo(5));
        pa[kk][1] = pack_low_bytes(lo(2), lo(3), lo(6), lo(7));
        pa[kk][2] = pack_low_bytes(lo(8), lo(9), lo(12), lo(13));
        pa[kk][3] = pack_low_bytes(lo(10), lo(11), lo(14), lo(15));
#pragma unroll
        for (int j = 0; j < 4; ++j) lsum[j & 1] = __dp4a(pa[kk][j], 0x01010101u, lsum[j & 1]);
      }
    };
    // O += P V^T's tile in stage st (issued, not waited for)
    auto issue_pv = [&](int st) {
      const uint64_t dv = desc_k_major(v_tile(st), L::kVRow, 2);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) wgmma_rs_s8_n64(o, pa[kk], dv + 2 * kk, 1);
    };

    mbar_wait(full(stage_of(num_kt)), parity_of(num_kt));
    fence_regs(s);
    wgmma_fence();
    issue_s(s, stage_of(num_kt));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    quant_tile(0);
    pack_p();
    for (int kt = 1; kt < num_kt; ++kt) {
      const int st = stage_of(num_kt + kt), prev = stage_of(num_kt + kt - 1);
      fence_regs(pa);
      mbar_wait(full(st), parity_of(num_kt + kt));
      fence_regs(s);
      fence_regs(o);
      wgmma_fence();
      issue_s(s, st);
      wgmma_commit();
      issue_pv(prev);
      wgmma_commit();
      wgmma_wait<1>();  // S of tile kt; P.V of tile kt - 1 may still run
      fence_regs(s);
      quant_tile(kt);
      wgmma_wait<0>();
      fence_regs(pa);
      fence_regs(o);
      release(prev);
      pack_p();
    }
    const int last = stage_of(2 * num_kt - 1);
    fence_regs(pa);
    fence_regs(o);
    wgmma_fence();
    issue_pv(last);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(pa);
    fence_regs(o);
    release(last);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      uint32_t l = lsum[r];
      l += __shfl_xor_sync(0xffffffff, l, 1);
      l += __shfl_xor_sync(0xffffffff, l, 2);
      inv[r] = 1.f / ((float)(127 * l) * kOnesDequant);
    }
    const float* svh = a.sv + (long long)bh * kHeadDim;
    // o[4j + e]: column 8j + 2t + (e & 1) of rows[e >> 1]
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * t;
      const float d0 = svh[col] * kInv127, d1 = svh[col + 1] * kInv127;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (rows[r] < a.seq) {
          *reinterpret_cast<uint32_t*>(ob + rows[r] * ld_out + col) =
              pack_bf16((float)o[4 * j + 2 * r] * d0 * inv[r],
                        (float)o[4 * j + 2 * r + 1] * d1 * inv[r]);
        }
      }
    }
    if (timer) {
      atomicAdd(&a.clocks[0], (unsigned long long)(t1 - t0));
      atomicAdd(&a.clocks[1], (unsigned long long)(clock64() - t1));
    }
  } else {
    // The online softmax (qk alone): bf16 probabilities, bf16 P.V with V
    // (+ b_v, from the pre-pass) read MN-major.
    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    uint32_t pa[4][4];  // P as the A fragments of P.V's 4 k steps
    float m_run[2] = {-INFINITY, -INFINITY};  // running row max, log2 domain
    float l_run[2] = {0.f, 0.f};              // per-thread partial row sums
    float corr[2];                            // rescale of o and l for this tile
    // P = 2^(s - m), rounded to bf16 once for P.V, in place of S; the row
    // sums add the rounded values
    auto softmax = [&](int key0, auto ragged) {
      Acc mx[2] = {lowest(), lowest()};
      tile_max(s, mx, key0);
      quad_max(mx);
      float mn[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mn[r] = fmaxf(m_run[r], to_f(mx[r]) * fac[r]);  // finite: key0 < kv_len
        corr[r] = ex2(m_run[r] - mn[r]);                 // 2^-inf = 0 on the first tile
        m_run[r] = mn[r];
        l_run[r] *= corr[r];
      }
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int r = (i >> 1) & 1;
        float x0 = fmaf(to_f(s[i]), fac[r], -mn[r]);
        float x1 = fmaf(to_f(s[i + 1]), fac[r], -mn[r]);
        if constexpr (decltype(ragged)::value) {
          if (masked(key0, i)) x0 = -INFINITY;
          if (masked(key0, i + 1)) x1 = -INFINITY;
        }
        const __nv_bfloat162 p = __floats2bfloat162_rn(ex2(x0), ex2(x1));
        const float p0 = __low2float(p), p1 = __high2float(p);
        l_run[r] += p0 + p1;
        s[i] = from_f(p0);
        s[i + 1] = from_f(p1);
      }
    };
    auto softmax_tile = [&](int kt) {
      const int key0 = kt * kKeyTile;
      if (key0 + kKeyTile > a.kv_len) {
        softmax(key0, std::true_type{});
      } else {
        softmax(key0, std::false_type{});
      }
    };
    // n-tiles (2kk, 2kk + 1) of P are the A fragment of the k step over keys
    // 16kk .. 16kk + 15
    auto pack_p = [&]() {
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        pa[i >> 3][(i >> 1) & 3] =
            pack_bf16(__uint_as_float(bits_of(s[i])), __uint_as_float(bits_of(s[i + 1])));
      }
    };
    auto issue_pv = [&](int st) {
      const uint64_t dv = desc_mn_major(v_tile(st), 128, 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs_n64(o, pa[kk], dv + kk * ((16 * 128) >> 4));
    };
    auto rescale_o = [&]() {
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] *= corr[(i >> 1) & 1];
    };

    mbar_wait(full(0), 0);
    fence_regs(s);
    wgmma_fence();
    issue_s(s, 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    softmax_tile(0);
    pack_p();
    for (int kt = 1; kt < num_kt; ++kt) {
      const int st = stage_of(kt), prev = stage_of(kt - 1);
      fence_regs(pa);
      mbar_wait(full(st), parity_of(kt));
      fence_regs(s);
      fence_regs(o);
      wgmma_fence();
      issue_s(s, st);
      wgmma_commit();
      issue_pv(prev);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(s);
      softmax_tile(kt);
      wgmma_wait<0>();
      fence_regs(pa);
      fence_regs(o);
      release(prev);
      rescale_o();
      pack_p();
    }
    const int last = stage_of(num_kt - 1);
    fence_regs(pa);
    fence_regs(o);
    wgmma_fence();
    issue_pv(last);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(pa);
    fence_regs(o);
    release(last);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffff, l, 1);
      l += __shfl_xor_sync(0xffffffff, l, 2);
      inv[r] = 1.f / l;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * t;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (rows[r] < a.seq) {
          *reinterpret_cast<uint32_t*>(ob + rows[r] * ld_out + col) =
              pack_bf16(o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]);
        }
      }
    }
    if (timer) atomicAdd(&a.clocks[1], (unsigned long long)(clock64() - t0));
  }
}

// A tensor map of dims (cols, rows, heads, batch) with the given byte
// strides and a box of 64 x 64 of one head. TMA needs 16-byte aligned bases
// and strides (the wrapper checks q's; the operands are contiguous).
bool encode(EncodeTiled fn, CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
            cuuint64_t cols, cuuint64_t rows, int heads, int batch, cuuint64_t row_bytes,
            cuuint64_t head_bytes, cuuint64_t batch_bytes, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[4] = {cols, rows, (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {row_bytes, head_bytes, batch_bytes};
  const cuuint32_t box[4] = {64, 64, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, type, 4, const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kMode>
int launch(const void* q, const void* kop, const void* vop, const Int8Args& args, int batch,
           long long row_stride, long long batch_stride, void* stream) {
  using L = Layout<kMode>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const int heads = args.heads;
  const cuuint64_t n_pad = args.n_pad;
  const cuuint64_t k_head = n_pad * L::kKRow;  // bytes of one head's K
  Maps maps;
  bool ok = encode(fn, &maps.q, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, q, kHeadDim, args.seq, heads,
                   batch, row_stride * 2, kHeadDim * 2, batch_stride * 2,
                   CU_TENSOR_MAP_SWIZZLE_128B);
  ok = ok && encode(fn, &maps.k,
                    L::kIntQK ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                    kop, kHeadDim, n_pad, heads, batch, L::kKRow, k_head, k_head * heads,
                    L::kIntQK ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B);
  if constexpr (L::kIntPV) {  // V^T: (n_pad keys, 64 head columns) per head
    ok = ok && encode(fn, &maps.v, CU_TENSOR_MAP_DATA_TYPE_UINT8, vop, n_pad, kHeadDim, heads,
                      batch, n_pad, n_pad * kHeadDim, n_pad * kHeadDim * heads,
                      CU_TENSOR_MAP_SWIZZLE_64B);
  } else {
    ok = ok && encode(fn, &maps.v, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, vop, kHeadDim, n_pad, heads,
                      batch, 128, n_pad * 128, n_pad * 128 * heads, CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  auto kernel = attention_int8_sm90_kernel<kMode>;
  const cudaError_t rc =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (rc != cudaSuccess) return (int)rc;
  const dim3 grid((args.seq + 64 * kConsumers - 1) / (64 * kConsumers), heads, batch);
  kernel<<<grid, kThreads, L::kSmem, (cudaStream_t)stream>>>(maps, args);
  return (int)cudaGetLastError();
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

// The attention's operands from k, v, bias (as for the scales) and the
// scales sk, sv of cryovit_attention_int8_scales (same mode), over n_pad
// keys (a multiple of 64 covering seq), zero at or past kv_len: kop (batch,
// heads, n_pad, 64) int8 round((k + b_k) / sk) under qk, else bf16 k + b_k;
// vop (batch, heads, 64, n_pad) int8 round((v + b_v) / sv) with the keys of
// each 32-key step at their pv_slot positions under pv, else (batch, heads,
// n_pad, 64) bf16 v + b_v. Returns cudaGetLastError().
extern "C" int cryovit_attention_int8_operands(
    const void* k, const void* v, const void* bias, const void* sk, const void* sv, void* kop,
    void* vop, int batch, int heads, long long row_stride, long long batch_stride, int kv_len,
    int n_pad, int mode, void* stream) {
  if (n_pad % kKeyTile != 0 || mode < 1 || mode > 3) return (int)cudaErrorInvalidValue;
  const dim3 grid(n_pad / kKeyTile, heads, batch);
  attention_int8_operands_kernel<<<grid, kOperandThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, (const __nv_bfloat16*)bias,
      (const float*)sk, (const float*)sv, kop, vop, heads, row_stride, batch_stride, kv_len, n_pad,
      mode);
  return (int)cudaGetLastError();
}

// Row 1 with the int8 internals of mode (1 qk, 2 pv, 3 qkpv): q and bias as
// for the scales, the scales of cryovit_attention_int8_scales and the
// operands of cryovit_attention_int8_operands (same mode, kv_len, n_pad);
// out: contiguous (batch, seq, heads*64) bf16; scale_log2 = softmax scale *
// log2(e). clocks: null, or two zeroed counters that receive the SM clocks
// of the passes (see Int8Args). Returns cudaGetLastError(), or
// cudaErrorInvalidValue for an unknown mode or a tensor map that cannot be
// built.
extern "C" int cryovit_flash_attention_int8(
    const void* q, const void* bias, const void* sq, const void* sk, const void* sv,
    const void* kop, const void* vop, void* out, void* clocks, int batch, int seq, int heads,
    long long row_stride, long long batch_stride, int kv_len, int chunk_rows, int chunks,
    int n_pad, float scale_log2, int mode, void* stream) {
  const Int8Args args{(const __nv_bfloat16*)bias, (const float*)sq, (const float*)sk,
                      (const float*)sv, (__nv_bfloat16*)out, (unsigned long long*)clocks,
                      seq, heads, kv_len, n_pad, chunk_rows, chunks, scale_log2};
  switch (mode) {
    case kModeQK:
      return launch<kModeQK>(q, kop, vop, args, batch, row_stride, batch_stride, stream);
    case kModePV:
      return launch<kModePV>(q, kop, vop, args, batch, row_stride, batch_stride, stream);
    case kModeQK | kModePV:
      return launch<kModeQK | kModePV>(q, kop, vop, args, batch, row_stride, batch_stride,
                                       stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
