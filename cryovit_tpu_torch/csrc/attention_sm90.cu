// Multi-head bf16 attention on Hopper (sm_90a): TMA loads, mbarrier
// pipeline, wgmma products.
//
// Replaces the bf16 paths of three Pallas kernels:
// - cryovit_tpu/ops/flash_attention.py:_flash_kernel_paired
//   (flash_attention_pairs, channel_major=True), entry
//   cryovit_flash_attention (row 1): q/k/v biases, keys at or past kv_len
//   masked, the denominator summed from the bf16 probabilities;
// - cryovit_tpu/ops/flash_attention.py:_flash_kernel (flash_attention_bhnd
//   on (B, H, N, D), flash_attention on (B, N, H, D)), entry
//   cryovit_flash_attention_strided (rows 2/3): no bias, the denominator
//   summed from the f32 probabilities before their rounding to bf16
//   (flash_attention.py:81-84);
// - cryovit_tpu/ops/window_attention.py:_wk_kernel (window_attention, the
//   Hiera global blocks) and the attention stage of _wkb_kernel
//   (window_block_attention, through csrc/window_block.cu), entry
//   cryovit_window_attention (rows 11 and 9): q pre-scaled by
//   D^-1/2 * log2(e), p = bf16(exp2(bf16(s - m))), the denominator summed
//   from the bf16 probabilities.
// One body, templated on <D, has_bias, f32_row_sum>, D the head width in
// {64, 72, 96}. The int8 modes of row 12 have their own wgmma body in
// csrc/attention_int8_sm90.cu.
//
// What it computes, per (batch b, head h, query row i), over keys j < kv_len:
//   s_ij = scale_log2 * q_i . k_j                      (f32, log2 domain)
//   p_ij = bf16(2^(s_ij - m_i)),  out_i = sum_j p_ij v_j / l_i
// with the online softmax: m_i is the running row max, and the partial sums
// are rescaled when it grows. The TPU window kernel takes the exact row max
// in a first pass over K; the one-pass form is the same function with the
// bf16 probabilities rounded against the running max, within the kernel
// rows' limit (2^-6 * max|plain|) of the plain versions, which keep the
// exact max.
//
// Row 1's biases. b_q is added to the Q tile in shared memory once, after
// its TMA copy lands (rounded to bf16, as the reference adds it). b_k and
// b_v are folded out: (q + b_q) . b_k is the same for every key of a row,
// so it cancels in the softmax and is not computed; and since the
// denominator sums the same probabilities as the numerator,
// sum_j p_ij (v_j + b_v) / l_i = sum_j p_ij v_j / l_i + b_v, added in the
// epilogue. The reference rounds k + b_k and v + b_v to bf16 first; the
// kernel does not, a difference of bf16 rounding.
//
// What bounds it on the H100: per (b, h) the two products are 4 * N^2 * D
// operations against O(N * D) bytes, so it is bound by the tensor cores
// (989 TFLOP/s bf16): at ViT-g's 64 x 1029 tokens, 24 heads of 64, 416
// GFLOP against 51 MB; the N x N scores never reach device memory. At
// D = 64 the softmax's exp2 (16 a clock per SM) takes as long as the
// products of a tile, so the two have to overlap across warpgroups.
//
// What the design does about it:
// - a block takes 64 * kConsumers query rows of one (b, h): kConsumers = 3
//   consumer warpgroups of 64 rows each, and one producer warp whose lane 0
//   issues every TMA load (116-128 registers a thread: one block, 13 warps,
//   per SM). The K/V tiles (64 keys) pass through a ring of kStages = 3
//   stages, each with a "full" mbarrier (TMA bytes landed) and an "empty"
//   one (every consumer warp done with the stage), so loads run ahead of
//   the products and the consumer warpgroups share each tile;
// - one CUtensorMap per operand, dims (D columns, token, head, batch) with
//   the caller's strides, built on the host in the C entry
//   (cuTensorMapEncodeTiled from cudaGetDriverEntryPoint) and passed as a
//   __grid_constant__ parameter: column views of one fused qkv output and
//   permuted head-major views load without a copy, and TMA's zero fill past
//   each extent (columns past D, tokens past seq or kv_len) replaces
//   zero-filling loops;
// - shared-memory tiles are 128-byte swizzled rows of 64 columns; a head
//   width above 64 adds a second tile of the next 16 (D = 72, 32-byte
//   swizzle; TMA fills columns 72..79 with zeros, never the next head's) or
//   32 columns (D = 96, 64-byte swizzle), each with its own tensor map and
//   wgmma descriptors;
// - S = Q K^T: wgmma m64n64k16, Q and K K-major from shared memory (4 k
//   steps over the 64-column tile, 1 or 2 over the second);
// - O += P V: wgmma m64nNk16 with P from registers (the S accumulator
//   re-packed as bf16 is exactly the A fragment) and V read MN-major from
//   its row-major tile (N = 64, and 16 or 32 for the second tile), so V is
//   never transposed; the extra zero columns of D = 72 are not stored;
// - a software pipeline inside each warpgroup: tile kt's Q K^T and tile
//   kt - 1's P V are issued together, and tile kt's softmax runs while
//   that P V is still on the tensor cores. The softmax writes P in place
//   of S and packs it into the A fragment only after the P V that read the
//   previous fragment is done: defining a register that a running wgmma
//   reads makes ptxas serialize the whole wgmma pipeline (warning C7513);
// - keys at or past kv_len score -inf; query rows past seq are not stored;
//   a consumer warpgroup whose 64 rows all lie past seq does not run.
// The TMA, mbarrier and wgmma helpers are csrc/sm90.cuh's, shared with
// csrc/window_block.cu.
// Not yet done (later work): ping-pong scheduling of the consumer
// warpgroups, 128-key tiles, persistent blocks, TMA stores.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"

namespace {

constexpr int kConsumers = 3;  // consumer warpgroups of 64 query rows
constexpr int kStages = 3;     // K/V ring depth
constexpr int kBlockK = 64;    // keys per tile
constexpr int kThreads = kConsumers * 128 + 32;
constexpr int kMainBytes = 64 * 64 * 2;  // one 64 x 64 bf16 tile

// Tiles of one operand: the first 64 columns (128-byte rows, 128-byte
// swizzle) and, for D > 64, a second tile of kTail columns.
template <int D>
struct Tiles {
  static_assert(D == 64 || D == 72 || D == 96, "head width 64, 72 or 96");
  static constexpr int kTail = D == 64 ? 0 : (D == 72 ? 16 : 32);
  static constexpr int kTailRow = kTail * 2;        // bytes per row
  static constexpr int kTailBytes = 64 * kTailRow;  // 2048 or 4096
  static constexpr int kBytes = kMainBytes + kTailBytes;
  // wgmma layout type of the second tile: 3 = 32-byte, 2 = 64-byte swizzle
  static constexpr int kTailLayout = kTail == 16 ? 3 : 2;
  static constexpr int kTailSteps = kTail / 16;  // its k steps in Q K^T
  static constexpr int kTailOut = D - 64;        // its real output columns
  static_assert(kTailSteps * 16 == kTail && kTailOut <= kTail, "tail tile layout");
};

struct OutStrides {  // elements
  long long b, h, n;
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// The operands' tensor maps: the first 64 columns, and for D > 64 the next
// Tiles<D>::kTail.
struct Maps {
  CUtensorMap q, k, v, q_tail, k_tail, v_tail;
};

// bias: (3, heads * 64) bf16 rows q, k, v, read only with kHasBias (only
// its q and v rows: b_k cancels in the softmax).
template <int D, bool kHasBias, bool kF32RowSum>
__global__ void __launch_bounds__(kThreads, 1)
    attention_sm90_kernel(const __grid_constant__ Maps maps,
                          const __nv_bfloat16* __restrict__ bias,
                          __nv_bfloat16* __restrict__ out, OutStrides os, int seq,
                          int kv_len, float scale_log2) {
  using T = Tiles<D>;
  // Row 11's recipe (no bias, bf16 row sum): the exponent is rounded to
  // bf16 before exp2, as the TPU window kernel computes it.
  constexpr bool kRoundExponent = !kHasBias && !kF32RowSum;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzle patterns need 1 KB alignment
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t sq = base;                          // kConsumers Q tiles
  const uint32_t sk = sq + kConsumers * T::kBytes;   // kStages K tiles
  const uint32_t sv = sk + kStages * T::kBytes;      // kStages V tiles
  const uint32_t bars = sv + kStages * T::kBytes;    // q_full, full[], empty[]
  const uint32_t q_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kStages + s); };

  const int q0 = blockIdx.x * 64 * kConsumers;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int active = min(kConsumers, (seq - q0 + 63) / 64);  // warpgroups with rows
  const int num_kt = (kv_len + kBlockK - 1) / kBlockK;

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
      mbar_expect_tx(q_full, active * T::kBytes);
      for (int w = 0; w < active; ++w) {
        const uint32_t dst = sq + w * T::kBytes;
        tma_load(dst, &maps.q, 0, q0 + 64 * w, head, b, q_full);
        if constexpr (T::kTail > 0) {
          tma_load(dst + kMainBytes, &maps.q_tail, 64, q0 + 64 * w, head, b, q_full);
        }
      }
      for (int kt = 0; kt < num_kt; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(empty(s), ((kt / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * T::kBytes);
        const uint32_t dk = sk + s * T::kBytes, dv = sv + s * T::kBytes;
        const int key0 = kt * kBlockK;
        tma_load(dk, &maps.k, 0, key0, head, b, full(s));
        tma_load(dv, &maps.v, 0, key0, head, b, full(s));
        if constexpr (T::kTail > 0) {
          tma_load(dk + kMainBytes, &maps.k_tail, 64, key0, head, b, full(s));
          tma_load(dv + kMainBytes, &maps.v_tail, 64, key0, head, b, full(s));
        }
      }
    }
    return;
  }

  // A consumer warpgroup: 64 query rows from row0, 16 per warp.
  const int wg = warp >> 2;
  const int row0 = q0 + 64 * wg;
  if (row0 >= seq) return;
  const int tid = threadIdx.x & 127;
  const int wr = (warp & 3) * 16;  // the warp's first row in the tile
  const int g = lane >> 2;         // fragment row group
  const int t = lane & 3;          // thread in group
  const uint32_t my_q = sq + wg * T::kBytes;

  mbar_wait(q_full, 0);
  if constexpr (kHasBias) {
    // b_q into the landed Q tile (D = 64: 64 rows x 8 swizzled 16-byte chunks)
    const __nv_bfloat16* bq = bias + head * 64;
    for (int c = tid; c < 64 * 8; c += 128) {
      const int r = c >> 3, j = c & 7;
      uint4* p = reinterpret_cast<uint4*>(smem + (my_q - base) + r * 128 + ((j ^ (r & 7)) << 4));
      uint4 val = *p;
      __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        h[e] = __float2bfloat16(__bfloat162float(h[e]) + __bfloat162float(bq[8 * j + e]));
      }
      *p = val;
    }
    fence_proxy_async();  // generic-proxy writes, read next by wgmma
    bar_sync(1 + wg, 128);
  }
  const uint64_t dq = desc_k_major(my_q, 128, 1);
  const uint64_t dq_tail = desc_k_major(my_q + kMainBytes, T::kTailRow, T::kTailLayout);

  float s[32];        // S tile: rows (wr + g, wr + g + 8), 16 keys each
  float o[32];        // output columns 0..63 before the 1 / denominator
  float ot[T::kTail ? T::kTail / 2 : 1];  // columns 64.. (D > 64)
  uint32_t pa[4][4];  // P as the A fragments of P V's 4 k steps
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (T::kTail ? T::kTail / 2 : 1); ++i) ot[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // running row max of the unscaled scores
  float l_run[2] = {0.f, 0.f};              // per-thread partial row sums
  float corr[2];                            // rescale of o and l for this tile

  // S = Q K^T of the tile in stage st (issued, not waited for)
  auto issue_s = [&](int st) {
    const uint32_t tk = sk + st * T::kBytes;
    const uint64_t dk = desc_k_major(tk, 128, 1);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wgmma_ss_n64(s, dq + 2 * ks, dk + 2 * ks, ks);
    if constexpr (T::kTail > 0) {
      const uint64_t dk_tail = desc_k_major(tk + kMainBytes, T::kTailRow, T::kTailLayout);
#pragma unroll
      for (int ks = 0; ks < T::kTailSteps; ++ks) {
        wgmma_ss_n64(s, dq_tail + 2 * ks, dk_tail + 2 * ks, 1);
      }
    }
  };
  // O += P V of the tile in stage st with P = pa (issued, not waited for)
  auto issue_pv = [&](int st) {
    const uint32_t tv = sv + st * T::kBytes;
    const uint64_t dv = desc_mn_major(tv, 128, 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_n64(o, pa[kk], dv + kk * ((16 * 128) >> 4));
    if constexpr (T::kTail > 0) {
      const uint64_t dv_tail = desc_mn_major(tv + kMainBytes, T::kTailRow, T::kTailLayout);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t d = dv_tail + kk * ((16 * T::kTailRow) >> 4);
        if constexpr (T::kTail == 16) wgmma_rs_n16(ot, pa[kk], d);
        if constexpr (T::kTail == 32) wgmma_rs_n32(ot, pa[kk], d);
      }
    }
  };
  // The online softmax of the tile at key0, in the log2 domain: the new
  // row max, corr, l rescaled and grown, and P (bf16 values, as f32) in
  // place of S. s[4j + e]: key 8j + 2t + (e & 1) of the row wr + g (e < 2)
  // or wr + g + 8. It writes no register but s, m, l and corr: it runs while
  // the previous tile's P V reads pa, and a register that a running wgmma
  // reads must not be defined (ptxas would serialize the wgmma pipeline).
  auto softmax = [&](int key0, auto ragged) {
    auto score = [&](int i) {  // keys at or past kv_len score -inf
      if constexpr (decltype(ragged)::value) {
        if (key0 + 8 * (i >> 2) + 2 * t + (i & 1) >= kv_len) return -INFINITY;
      }
      return s[i];
    };
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], score(i));
    float ms[2];  // the row max, scaled
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffff, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffff, mx[r], 2));
      // finite: key0 < kv_len; 2^-inf = 0 on the first tile
      corr[r] = ex2((m_run[r] - mx[r]) * scale_log2);
      m_run[r] = mx[r];
      ms[r] = mx[r] * scale_log2;
      l_run[r] *= corr[r];
    }
    // P = 2^(scale S - m), rounded to bf16 once for P V; the row sum adds
    // the rounded values or, with kF32RowSum, the f32 ones.
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = (i >> 1) & 1;
      float x0 = fmaf(score(i), scale_log2, -ms[r]);
      float x1 = fmaf(score(i + 1), scale_log2, -ms[r]);
      if (kRoundExponent) {
        x0 = round_bf16(x0);
        x1 = round_bf16(x1);
      }
      const float e0 = ex2(x0), e1 = ex2(x1);
      const __nv_bfloat162 p = __floats2bfloat162_rn(e0, e1);
      s[i] = __low2float(p);
      s[i + 1] = __high2float(p);
      l_run[r] += kF32RowSum ? e0 + e1 : s[i] + s[i + 1];
    }
  };
  // P into pa, once the P V that read pa is done: n-tiles (2kk, 2kk + 1)
  // of S are the A fragment of the k step over keys 16kk .. 16kk + 15
  // (exact: the values are bf16 already)
  auto pack_p = [&]() {
#pragma unroll
    for (int i = 0; i < 32; i += 2) pa[i >> 3][(i >> 1) & 3] = pack_bf16(s[i], s[i + 1]);
  };
  auto softmax_tile = [&](int kt) {
    const int key0 = kt * kBlockK;
    if (key0 + kBlockK > kv_len) {
      softmax(key0, std::true_type{});
    } else {
      softmax(key0, std::false_type{});
    }
  };
  auto rescale_o = [&]() {
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] *= corr[(i >> 1) & 1];
    if constexpr (T::kTail > 0) {
#pragma unroll
      for (int i = 0; i < T::kTail / 2; ++i) ot[i] *= corr[(i >> 1) & 1];
    }
  };
  auto release = [&](int st) {  // this warp is done with the stage
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  };

  // Software pipeline: while the tensor cores run tile kt - 1's P V (and
  // the other warpgroups' products), this warpgroup runs tile kt's softmax.
  mbar_wait(full(0), 0);
  fence_regs(s);
  wgmma_fence();
  issue_s(0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  softmax_tile(0);
  pack_p();
  for (int kt = 1; kt < num_kt; ++kt) {
    const int st = kt % kStages, prev = (kt - 1) % kStages;
    fence_regs(pa);
    mbar_wait(full(st), (kt / kStages) & 1);
    fence_regs(s);
    fence_regs(o);
    if constexpr (T::kTail > 0) fence_regs(ot);
    wgmma_fence();
    issue_s(st);
    wgmma_commit();
    issue_pv(prev);
    wgmma_commit();
    wgmma_wait<1>();  // S of tile kt; P V of tile kt - 1 may still run
    fence_regs(s);
    softmax_tile(kt);
    wgmma_wait<0>();
    fence_regs(pa);
    fence_regs(o);
    if constexpr (T::kTail > 0) fence_regs(ot);
    release(prev);
    rescale_o();
    pack_p();
  }
  fence_regs(pa);
  fence_regs(o);
  if constexpr (T::kTail > 0) fence_regs(ot);
  wgmma_fence();
  issue_pv((num_kt - 1) % kStages);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(pa);
  fence_regs(o);
  if constexpr (T::kTail > 0) fence_regs(ot);
  release((num_kt - 1) % kStages);

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffff, l, 1);
    l += __shfl_xor_sync(0xffffffff, l, 2);
    inv[r] = 1.f / l;
  }
  const int rows[2] = {row0 + wr + g, row0 + wr + g + 8};
  __nv_bfloat16* ob = out + b * os.b + head * os.h;
  // o[4j + e] / ot[4j + e]: column 8j + 2t + (e & 1) of rows[e >> 1]
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * t;
    float b0 = 0.f, b1 = 0.f;
    if constexpr (kHasBias) {  // b_v: row 2 of bias, heads = gridDim.y
      const __nv_bfloat16* bv = bias + (2 * gridDim.y + head) * 64;
      b0 = __bfloat162float(bv[col]);
      b1 = __bfloat162float(bv[col + 1]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rows[r] < seq) {
        *reinterpret_cast<uint32_t*>(ob + rows[r] * os.n + col) =
            pack_bf16(o[4 * j + 2 * r] * inv[r] + b0, o[4 * j + 2 * r + 1] * inv[r] + b1);
      }
    }
  }
  if constexpr (T::kTail > 0) {
#pragma unroll
    for (int j = 0; j < T::kTailOut / 8; ++j) {
      const int col = 64 + 8 * j + 2 * t;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (rows[r] < seq) {
          *reinterpret_cast<uint32_t*>(ob + rows[r] * os.n + col) =
              pack_bf16(ot[4 * j + 2 * r] * inv[r], ot[4 * j + 2 * r + 1] * inv[r]);
        }
      }
    }
  }
}

// One (batch, head, token, D) bf16 operand: its base, element strides with a
// unit column stride, and its token extent (seq, or kv_len for K and V).
struct Operand {
  const void* ptr;
  long long b, h, n;
  int tokens;
};

// A tensor map of dims (d columns, tokens, heads, batch) whose box is
// box_cols columns x 64 tokens of one head. TMA needs 16-byte aligned bases
// and strides (the wrappers check both).
bool encode(EncodeTiled fn, CUtensorMap* map, const Operand& x, int d, int heads,
            int batch, int box_cols, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)x.tokens, (cuuint64_t)heads,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)x.n * 2, (cuuint64_t)x.h * 2,
                                 (cuuint64_t)x.b * 2};
  const cuuint32_t box[4] = {(cuuint32_t)box_cols, 64, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x.ptr), dims,
            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, bool kHasBias, bool kF32RowSum>
int launch(const Operand& q, const Operand& k, const Operand& v, const void* bias,
           void* out, const OutStrides& os, int batch, int seq, int heads, int kv_len,
           float scale_log2, void* stream) {
  static_assert(!kHasBias || D == 64, "the q bias add assumes one 64-column tile");
  using T = Tiles<D>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  Maps maps;
  const CUtensorMapSwizzle tail_swizzle =
      T::kTail == 16 ? CU_TENSOR_MAP_SWIZZLE_32B : CU_TENSOR_MAP_SWIZZLE_64B;
  bool ok = encode(fn, &maps.q, q, D, heads, batch, 64, CU_TENSOR_MAP_SWIZZLE_128B) &&
            encode(fn, &maps.k, k, D, heads, batch, 64, CU_TENSOR_MAP_SWIZZLE_128B) &&
            encode(fn, &maps.v, v, D, heads, batch, 64, CU_TENSOR_MAP_SWIZZLE_128B);
  if (T::kTail > 0) {
    ok = ok && encode(fn, &maps.q_tail, q, D, heads, batch, T::kTail, tail_swizzle) &&
         encode(fn, &maps.k_tail, k, D, heads, batch, T::kTail, tail_swizzle) &&
         encode(fn, &maps.v_tail, v, D, heads, batch, T::kTail, tail_swizzle);
  } else {
    maps.q_tail = maps.k_tail = maps.v_tail = maps.q;  // unused
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  constexpr int kSmem = 1024 + (kConsumers + 2 * kStages) * T::kBytes + 8 * (1 + 2 * kStages);
  auto kernel = attention_sm90_kernel<D, kHasBias, kF32RowSum>;
  const cudaError_t rc =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (rc != cudaSuccess) return (int)rc;
  const dim3 grid((seq + 64 * kConsumers - 1) / (64 * kConsumers), heads, batch);
  kernel<<<grid, kThreads, kSmem, (cudaStream_t)stream>>>(
      maps, (const __nv_bfloat16*)bias, (__nv_bfloat16*)out, os, seq, kv_len, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// Row 1. q, k, v: (batch, seq, heads*64) bf16 with unit column stride and
// the given row and batch strides (in elements, multiples of 8; 16-byte
// aligned bases); bias: (3, heads*64) bf16 (q, k, v); out: contiguous
// (batch, seq, heads*64) bf16. Keys >= kv_len are excluded. scale_log2 =
// softmax scale * log2(e). Returns cudaGetLastError(), or an error code if
// a tensor map cannot be built.
extern "C" int cryovit_flash_attention(const void* q, const void* k, const void* v,
                                       const void* bias, void* out, int batch, int seq,
                                       int heads, long long row_stride,
                                       long long batch_stride, int kv_len,
                                       float scale_log2, void* stream) {
  const long long channels = (long long)heads * 64;
  return launch<64, true, false>(
      Operand{q, batch_stride, 64, row_stride, seq},
      Operand{k, batch_stride, 64, row_stride, kv_len},
      Operand{v, batch_stride, 64, row_stride, kv_len}, bias, out,
      OutStrides{seq * channels, 64, channels}, batch, seq, heads, kv_len, scale_log2,
      stream);
}

// Rows 2/3. q, k, v, out: (batch, heads, seq, 64) bf16 operands with unit
// column stride; strides holds, in elements, the (batch, head, token)
// strides of q, k, v and out in that order (12 values; those of q, k and v
// multiples of 8, their bases 16-byte aligned). No bias, no masking.
// Returns as cryovit_flash_attention.
extern "C" int cryovit_flash_attention_strided(const void* q, const void* k, const void* v,
                                               void* out, int batch, int seq, int heads,
                                               const long long* strides, float scale_log2,
                                               void* stream) {
  const long long* s = strides;
  return launch<64, false, true>(
      Operand{q, s[0], s[1], s[2], seq}, Operand{k, s[3], s[4], s[5], seq},
      Operand{v, s[6], s[7], s[8], seq}, nullptr, out, OutStrides{s[9], s[10], s[11]},
      batch, seq, heads, seq, scale_log2, stream);
}

// Rows 11 and 9's attention stage. q, k, v: (batch, seq, heads*head_dim)
// bf16 with unit column stride and the given row and batch strides (in
// elements, multiples of 8; 16-byte aligned bases), q pre-scaled by the
// softmax scale * log2(e); out: contiguous (batch, seq, heads*head_dim)
// bf16. head_dim is 72 (sam2.1_hiera_l) or 96 (Hiera-T's global blocks).
// Returns cudaGetLastError(), or cudaErrorInvalidValue for another head
// width or a tensor map that cannot be built.
extern "C" int cryovit_window_attention(const void* q, const void* k, const void* v,
                                        void* out, int batch, int seq, int heads,
                                        int head_dim, long long row_stride,
                                        long long batch_stride, void* stream) {
  const long long channels = (long long)heads * head_dim;
  const OutStrides os{seq * channels, head_dim, channels};
  const Operand qo{q, batch_stride, head_dim, row_stride, seq};
  const Operand ko{k, batch_stride, head_dim, row_stride, seq};
  const Operand vo{v, batch_stride, head_dim, row_stride, seq};
  switch (head_dim) {
    case 72:
      return launch<72, false, false>(qo, ko, vo, nullptr, out, os, batch, seq, heads, seq,
                                      1.f, stream);
    case 96:
      return launch<96, false, false>(qo, ko, vo, nullptr, out, os, batch, seq, heads, seq,
                                      1.f, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
