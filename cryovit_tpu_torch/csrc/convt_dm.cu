// 2x lateral ConvTranspose (kernel (1, 2, 2), stride (1, 2, 2)) on
// depth-major activations, Hopper (sm_90a): a bf16 tensor-core product.
//
// Replaces: cryovit_tpu/ops/convt_dm.py:convt2x_dm (Pallas kernel
//   _fwd_kernel, convt_dm.py:74, via _convt2x_single).
//
// What it computes: x (B, D, Ci, H, W) bf16 and per-parity weights
// Wp (2, 2, Ci, Co) bf16 (the wrapper takes the flax kernel and flips its
// taps, since flax's unflipped kernel puts tap (a, c) at output parity
// (1-a, 1-c)):
//   y[b, d, co, 2h + a, 2w + c] = sum_ci x[b, d, ci, h, w] * Wp[a, c, ci, co]
// f32 sums, bf16 output (B, D, Co, 2H, 2W). Any H and W; Ci <= 64; Co in
// {1, 8, 16, 32}.
//
// What bounds it on the H100: the bytes. Per input pixel it reads 2*Ci
// bytes and writes 8*Co, against 8*Ci*Co FLOP (26 FLOP/byte at 32 -> 32,
// far below the bf16 tensor cores' ridge), so the output write, 4/5 of the
// bytes at 32 -> 32, sets the time. The f32 CUDA-core body this replaces
// needed more time for the arithmetic of the 32 -> 32 call than for its
// bytes.
//
// What the design does about it:
// - The product: M = 16 input pixels of a tile row, K = Ci (padded with zero
//   channels to a multiple of 16), N = 4*Co ordered (co, a, c) with c
//   innermost (Co = 1 padded to a second, unstored channel), mma.sync
//   m16n8k16 bf16 -> f32. A comes from the [ci][row][col] x tile as it
//   landed, by ldmatrix.trans; the B fragments (Wp) live in registers for
//   the block's life.
// - The interleave is free: a C fragment's adjacent column pair (c = 0,
//   c = 1) of one pixel is one 32-bit word of an output row, so each pair
//   is one STS.32 into a [co][2TH rows][128 columns] staging tile (rows
//   padded to 72 words and channels to an odd multiple of 16 words: the
//   four (co, a) rows of a store fall in four distinct bank octets), and y
//   leaves it in 16-byte stores of whole output rows. There is no bit-pack
//   of column pairs: that existed only for the TPU's 32-bit lanes.
// - Tiles: a work item is one (b, d) plane's TH x 64 input pixels, TH =
//   64 / max(Co, 8), so the staged output is 32 KB at Co >= 8. One
//   persistent block of 8 warps per SM walks its items; x tiles land by
//   16-byte cp.async in a ring of 2-4 stages while earlier items multiply,
//   and the stores of an item drain under the next one's products (two
//   staging tiles, one barrier an item).
// - W % 8 != 0 (or an unaligned base) lands and stores element by element.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTW = 64;  // input columns of a tile
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxStages = 4;
constexpr int kMaxCi = 64;
constexpr int kSmemMax = 232448;  // dynamic shared memory a block can have
constexpr int kYRow = 72;         // words a staged output row takes: 64 + 8

// KS: k16 steps (Ci padded to 16 * KS); CO: output channels.
template <int KS, int CO>
struct Geometry {
  static constexpr int CP = CO < 2 ? 2 : CO;          // staged output channels
  static constexpr int TH = 64 / (CO < 8 ? 8 : CO);  // input rows of a tile
  static constexpr int NT = CO < 2 ? 1 : CO / 2;     // n-tiles: 2 co x 2 a x 2 c each
  static constexpr int WN = NT >= 16 ? 2 : 1;        // warps sharing an m-tile
  static constexpr int NTW = NT / WN;                // n-tiles a warp owns
  static constexpr int WM = kWarps / WN;             // warps along the m-tiles
  static constexpr int MT = 4 * TH / WM;             // m-tiles a warp owns per item
  static constexpr int kXCh = TH * kTW + 8;          // bf16 an x channel takes: odd x 16 B
  static constexpr int kX = 16 * KS * kXCh;          // bf16 of an x tile
  static constexpr int kYCh = 2 * TH * kYRow + 16;   // words an output channel takes
  static constexpr int kY = CP * kYCh;               // words of a staging tile
  static constexpr int kStage = 2 * kX;              // bytes
  static constexpr int kFixed = 2 * 4 * kY;          // two staging tiles, bytes
  static constexpr int kRingMax = (kSmemMax - kFixed) / kStage;
  static constexpr int kStages = kRingMax < kMaxStages ? kRingMax : kMaxStages;
  static constexpr int kSmem = kFixed + kStages * kStage;
  static_assert(kStages >= 2, "two stages fit");
  static_assert(MT * WM == 4 * TH && NTW * WN == NT, "whole m- and n-tiles a warp");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// D = A(16x16, row) * B(16x8, col) + D, bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma_16816(float d[4], const uint32_t a[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// grid (blocks); each block strides over the work items (b * depth + d,
// tile row of TH input rows, tile column of 64).
template <int KS, int CO>
__global__ void __launch_bounds__(kThreads, 1)
    convt2x_dm_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ w,
                      uint16_t* __restrict__ y, int batch_depth, int ci_total, int height,
                      int width, bool vec) {
  using Geo = Geometry<KS, CO>;
  constexpr int TH = Geo::TH, NTW = Geo::NTW, WN = Geo::WN, WM = Geo::WM, MT = Geo::MT;
  constexpr int kXCh = Geo::kXCh, kYCh = Geo::kYCh, kStages = Geo::kStages;
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* const ring = smem;                                      // kStages x tiles
  uint32_t* const outs = reinterpret_cast<uint32_t*>(smem + kStages * Geo::kX);  // 2 x staging

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wn = warp % WN;
  const int wm = warp / WN;

  // the x channels past Ci stay zero in every slot
  for (int s = 0; s < kStages; ++s)
    for (int i = threadIdx.x; i < (16 * KS - ci_total) * kXCh; i += kThreads)
      ring[s * Geo::kX + ci_total * kXCh + i] = 0;

  // B fragments (k = ci, n = (co, a, c)) for the block's life: b0b1 is ci
  // 16s + 2 * (lane % 4) and + 1, b2b3 the same + 8, at n = 8 * ntg + lane /
  // 4: co = 2 * ntg + lane / 16, a = (lane / 8) % 2, c = (lane / 4) % 2;
  // zero past Ci and Co
  uint32_t wb[KS][NTW][2];
#pragma unroll
  for (int s = 0; s < KS; ++s)
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int co = 2 * (wn * NTW + nt) + (lane >> 4);
        const int ac = (lane >> 2) & 3;  // a * 2 + c
        uint32_t v = 0;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ci = 16 * s + 8 * r + 2 * (lane & 3) + e;
          if (ci < ci_total && co < CO) v |= (uint32_t)w[(ac * ci_total + ci) * CO + co] << (16 * e);
        }
        wb[s][nt][r] = v;
      }

  const int tiles_w = (width + kTW - 1) / kTW;
  const int tiles_h = (height + TH - 1) / TH;
  const long long n_items = (long long)batch_depth * tiles_h * tiles_w;
  const long long n_mine =
      n_items > blockIdx.x ? (n_items - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const long long plane = (long long)height * width;
  const int out_w = 2 * width;

  struct Item {
    long long bd;
    int h0, w0;
  };
  auto item = [&](long long t) {
    const long long i = blockIdx.x + t * gridDim.x;
    Item it;
    it.w0 = (int)(i % tiles_w) * kTW;
    const long long rest = i / tiles_w;
    it.h0 = (int)(rest % tiles_h) * TH;
    it.bd = rest / tiles_h;
    return it;
  };
  auto stage = [&](long long t) {  // item t's x tile (Ci x TH x 64) into its slot
    const Item it = item(t);
    uint16_t* const dst = ring + (int)(t % kStages) * Geo::kX;
    const uint16_t* const src = x + it.bd * ci_total * plane + (long long)it.h0 * width + it.w0;
    const int row_end = height - it.h0, col_end = width - it.w0;
    for (int i = threadIdx.x; i < ci_total * TH * 8; i += kThreads) {
      const int q = i % 8;
      const int r = (i / 8) % TH;
      const int c = i / (8 * TH);
      uint16_t* d = dst + c * kXCh + r * kTW + 8 * q;
      const uint16_t* s = src + c * plane + (long long)r * width + 8 * q;
      if (vec) {
        if (r < row_end && 8 * q < col_end)
          cp_async16(d, s);
        else
          *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          d[e] = r < row_end && 8 * q + e < col_end ? s[e] : (uint16_t)0;
      }
    }
  };
  auto write_out = [&](long long t) {  // item t's staged output (Co x 2TH x 128) into y
    const Item it = item(t);
    const uint32_t* const o = outs + (t & 1) * Geo::kY;
    uint16_t* const yp = y + (it.bd * CO * 4 * plane + (long long)(2 * it.h0) * out_w + 2 * it.w0);
    const int row_end = 2 * (height - it.h0), col_end = 2 * (width - it.w0);
    for (int i = threadIdx.x; i < CO * 2 * TH * 16; i += kThreads) {
      const int q = i % 16;
      const int r = (i / 16) % (2 * TH);
      const int co = i / (32 * TH);
      if (r >= row_end) continue;
      const uint32_t* s = o + co * kYCh + r * kYRow + 4 * q;
      uint16_t* d = yp + co * 4 * plane + (long long)r * out_w + 8 * q;
      if (vec) {
        if (8 * q < col_end) *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
      } else {
        const uint16_t* s16 = reinterpret_cast<const uint16_t*>(s);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (8 * q + e < col_end) d[e] = s16[e];
      }
    }
  };

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_mine) stage(s);
    cp_async_commit();
  }
  for (long long t = 0; t < n_mine; ++t) {
    cp_async_wait<kStages - 2>();
    // item t has landed; every warp is done with item t - 1 (its slot is
    // free, its output staged)
    __syncthreads();
    if (t + kStages - 1 < n_mine) stage(t + kStages - 1);
    cp_async_commit();
    if (t > 0) write_out(t - 1);  // its stores drain under this item's products

    const uint16_t* const xs = ring + (int)(t % kStages) * Geo::kX;
    uint32_t* const o = outs + (t & 1) * Geo::kY;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int mt = i * WM + wm;  // 16 pixels of tile row mt / 4
      const int hl = mt >> 2;
      const int p0 = (mt & 3) * 16;
      float acc[NTW][4];
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
      // A (pixel, ci) by ldmatrix.trans from [ci][row][col]: lanes 0-7 /
      // 8-15 / 16-23 / 24-31 address the ci rows 0-7 / 0-7 / 8-15 / 8-15 of
      // the k16 step at pixels +0 / +8 / +0 / +8
      const uint16_t* xa = xs + ((lane & 7) + ((lane >> 4) << 3)) * kXCh + hl * kTW + p0 + (lane & 8);
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        uint32_t a[4];
        ldmatrix_x4_trans(a, smem_u32(xa + 16 * s * kXCh));
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) mma_16816(acc[nt], a, wb[s][nt][0], wb[s][nt][1]);
      }
      // C fragment: rows (pixels) lane / 4 and + 8, columns n = 8 * ntg + 2 *
      // (lane % 4) and + 1, i.e. (co = 2 * ntg + (lane % 4) / 2, a = lane %
      // 2) at c = 0 and 1: one word of output row 2 * hl + a
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
        const int co = 2 * (wn * NTW + nt) + ((lane & 3) >> 1);
        uint32_t* yw = o + co * kYCh + (2 * hl + (lane & 1)) * kYRow + p0 + (lane >> 2);
        yw[0] = pack_bf16(acc[nt][0], acc[nt][1]);
        yw[8] = pack_bf16(acc[nt][2], acc[nt][3]);
      }
    }
  }
  __syncthreads();
  if (n_mine > 0) write_out(n_mine - 1);
  cp_async_wait<0>();
}

template <int KS, int CO>
int launch(const void* x, const void* w, void* y, int batch_depth, int ci, int height,
           int width, int nblocks, cudaStream_t stream) {
  using Geo = Geometry<KS, CO>;
  auto kernel = convt2x_dm_kernel<KS, CO>;
  int rc = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     Geo::kSmem);
  if (rc != 0) return rc;
  const bool vec = width % 8 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0;
  kernel<<<nblocks, kThreads, Geo::kSmem, stream>>>(
      (const uint16_t*)x, (const uint16_t*)w, (uint16_t*)y, batch_depth, ci, height, width,
      vec);
  return (int)cudaGetLastError();
}

template <int CO>
int launch_ks(const void* x, const void* w, void* y, int batch_depth, int ci, int height,
              int width, int nblocks, cudaStream_t stream) {
  switch ((ci + 15) / 16) {
    case 1: return launch<1, CO>(x, w, y, batch_depth, ci, height, width, nblocks, stream);
    case 2: return launch<2, CO>(x, w, y, batch_depth, ci, height, width, nblocks, stream);
    case 3: return launch<3, CO>(x, w, y, batch_depth, ci, height, width, nblocks, stream);
    case 4: return launch<4, CO>(x, w, y, batch_depth, ci, height, width, nblocks, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x: contiguous (batch, depth, ci, height, width) bf16; w: contiguous
// (2, 2, ci, co) bf16 indexed by output parity (a, c); y: contiguous
// (batch, depth, co, 2*height, 2*width) bf16; nblocks: persistent blocks
// (one per SM at most). Returns cudaGetLastError(), or
// cudaErrorInvalidValue for an unsupported ci, co or grid.
extern "C" int cryovit_convt2x_dm(const void* x, const void* w, void* y, int batch, int depth,
                                  int ci, int co, int height, int width, int nblocks,
                                  void* stream) {
  if (ci < 1 || ci > kMaxCi || nblocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int bd = batch * depth;
  switch (co) {
    case 1: return launch_ks<1>(x, w, y, bd, ci, height, width, nblocks, s);
    case 8: return launch_ks<8>(x, w, y, bd, ci, height, width, nblocks, s);
    case 16: return launch_ks<16>(x, w, y, bd, ci, height, width, nblocks, s);
    case 32: return launch_ks<32>(x, w, y, bd, ci, height, width, nblocks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
