// Backward of the 2x lateral ConvTranspose (kernel (1, 2, 2), stride
// (1, 2, 2)) on depth-major activations, Hopper (sm_90a): dx and dW from one
// pass over g and x, both products on bf16 tensor cores.
//
// Replaces: cryovit_tpu/ops/convt_dm.py:convt2x_dm_bwd (Pallas kernel
//   _bwd_kernel, convt_dm.py:162, via _convt2x_bwd_single).
//
// What it computes: g (B, D, Co, 2H, 2W) bf16 (the cotangent of the
// forward's output), x (B, D, Ci, H, W) bf16 (its input) and the parity
// weights Wp (2, 2, Ci, Co) bf16 (Wp[a, c] is the flax kernel's tap
// (1-a, 1-c), as in convt_dm.cu):
//   dx[b, d, ci, h, w] = sum_{a, c, co} Wp[a, c, ci, co] * g[b, d, co, 2h+a, 2w+c]
//   dWp[a, c, ci, co]  = sum_{b, d, h, w} x[b, d, ci, h, w] * g[b, d, co, 2h+a, 2w+c]
// f32 sums; dx in bf16, dWp in f32 (the wrapper maps parity (a, c) back to
// the flax tap (1-a, 1-c)). Any H and W; Ci and Co in {8, 16, 32}.
//
// What bounds it on the H100: the bytes. Per input pixel it reads 2*Ci of x
// and 8*Co of g and writes 2*Ci of dx, against 16*Ci*Co FLOP: 43 FLOP/byte
// at 32 -> 32, far below the bf16 tensor cores' ridge (295). At the train
// step's shapes (128 slices) the two calls move 1.9 GB: 0.56 ms at 3.35
// TB/s. The f32 CUDA-core body this replaces needed 0.51 ms for the
// arithmetic of the 32 -> 32 call alone, twice its byte bound.
//
// What the design does about it:
// - Tiles. A work item is one (b, d) plane's TH x 64 input pixels, TH =
//   64 / Co, so its g tile (Co x 2TH x 128) is 32 KB at every Co. One
//   persistent block of 8 warps per SM walks its items through a ring of
//   2-4 stages: g and x land by 16-byte cp.async while earlier items
//   multiply, and g is read from device memory once, for both products.
// - dx (M = 16 input pixels of a tile row, N = Ci, K = 4*Co ordered (co, a,
//   c) with c innermost): the pair (c = 0, c = 1) of one input column is one
//   32-bit word of a g row, exactly one k pair of mma.sync m16n8k16's A, so
//   each A register is one LDS.32 of the g tile as it landed. g rows are
//   padded to 72 words and channels to an odd multiple of 16 words, so the
//   four k pairs of a load fall in four distinct bank octets. Wp^T's B
//   fragments live in registers for the block's life (Ci*Co/16 a lane).
//   The accumulators go to a [ci][row][col] staging tile by stmatrix.trans,
//   and dx leaves in 16-byte stores at the start of the next item (two
//   staging tiles, so one barrier an item).
// - dW (M = 4*Co rows ordered (c, co, a), N = Ci, K = pixels): its A is the
//   same g tile, two LDS.64 of consecutive words and four __byte_perm that
//   part the column parities; its B is x straight from the [ci][row][col]
//   tile by ldmatrix. Warp w owns the 16 rows of co in [4m, 4m + 4), m = w
//   mod Co/4, for every ci, over a fixed 128-pixel group of each item; its
//   accumulators live across the block's items. The TPU kernel carries dW
//   in VMEM across its sequential grid; here the warps' partials are added
//   in warp order at the end, each block writes one partial, and
//   block_sum.cuh adds the partials in block order: the same bits from run
//   to run.
// - W % 8 != 0 (or an unaligned base) lands and stores element by element.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_sum.cuh"

namespace {

constexpr int kTW = 64;     // input columns of a tile
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxStages = 4;
constexpr int kSmemMax = 232448;  // dynamic shared memory a block can have
constexpr int kGRow = 72;         // words a staged g row takes: 64 + 8 (8 banks a parity apart)

template <int CI, int CO>
struct Geometry {
  static constexpr int TH = 64 / CO;                // input rows of a tile
  static constexpr int GR = 2 * TH;                 // g rows of a tile
  static constexpr int kGCh = GR * kGRow + 16;      // words a g channel takes: 16 banks apart
  static constexpr int kG = CO * kGCh;              // words of a g tile
  static constexpr int kXCh = TH * kTW + 8;         // bf16 an x (or dx) channel takes: odd x 16 B
  static constexpr int kX = CI * kXCh;              // bf16 of an x tile, and of a dx staging tile
  static constexpr int kStage = 4 * kG + 2 * kX;    // bytes
  static constexpr int kFixed = 2 * 2 * kX;         // two dx staging tiles, bytes
  static constexpr int kRingMax = (kSmemMax - kFixed) / kStage;
  static constexpr int kStages = kRingMax < kMaxStages ? kRingMax : kMaxStages;
  static constexpr int kSmem = kStages * kStage + kFixed;
  static constexpr int KS = CO / 4;                 // dx k16 steps
  static constexpr int NT = CI / 8;                 // n-tiles of 8 ci (dx and dW)
  static constexpr int MT = 4 * TH / kWarps;        // dx m-tiles a warp owns
  static constexpr int MW = CO / 4;                 // dW m-tiles: warps a pixel group has
  static constexpr int PG = kWarps / MW;            // pixel groups: 2 input rows each
  static_assert(kStages >= 2, "two stages fit");
  static_assert(MT * kWarps == 4 * TH && PG * 2 == TH, "Ci, Co in {8, 16, 32}");
  static_assert(kWarps * 32 * NT * 4 * 4 <= kStages * kStage, "the dW sum fits the ring");
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t r[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ __forceinline__ void stmatrix_x2_trans(uint32_t addr, uint32_t r0, uint32_t r1) {
  asm volatile("stmatrix.sync.aligned.m8n8.x2.trans.shared.b16 [%0], {%1, %2};\n" ::"r"(addr),
               "r"(r0), "r"(r1)
               : "memory");
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

// Copies a rows x (16-byte chunks) window: chunk q of row r of channel c
// goes from src + c * src_ch + r * src_row + 8q to dst + c * dst_ch + r *
// dst_row + 8q (bf16 elements), the parts at rows >= row_end or columns
// >= col_end as zeros. vec: 16-byte cp.async, each chunk wholly in or out;
// otherwise element by element.
template <int NCH, int ROWS, int CHUNKS>
__device__ __forceinline__ void land(uint16_t* dst, int dst_ch, int dst_row, const uint16_t* src,
                                     long long src_ch, int src_row, int row_end, int col_end,
                                     bool vec) {
  for (int i = threadIdx.x; i < NCH * ROWS * CHUNKS; i += kThreads) {
    const int q = i % CHUNKS;
    const int r = (i / CHUNKS) % ROWS;
    const int c = i / (CHUNKS * ROWS);
    uint16_t* d = dst + c * dst_ch + r * dst_row + 8 * q;
    const uint16_t* s = src + c * src_ch + (long long)r * src_row + 8 * q;
    const bool row_in = r < row_end;
    if (vec) {
      if (row_in && 8 * q < col_end)
        cp_async16(d, s);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) d[e] = row_in && 8 * q + e < col_end ? s[e] : (uint16_t)0;
    }
  }
}

// grid (blocks); each block strides over the work items (b * depth + d,
// tile row of TH input rows, tile column of 64), writes its dx, and one
// partial dWp (4 * Ci * Co f32, parity-major) at partial + blockIdx.x * 4 *
// Ci * Co.
template <int CI, int CO>
__global__ void __launch_bounds__(kThreads, 1)
    convt2x_dm_bwd_kernel(const uint16_t* __restrict__ g, const uint16_t* __restrict__ x,
                          const uint16_t* __restrict__ w, uint16_t* __restrict__ dx,
                          float* __restrict__ partial, int batch_depth, int height, int width,
                          bool vec) {
  using Geo = Geometry<CI, CO>;
  constexpr int TH = Geo::TH, GR = Geo::GR, kGCh = Geo::kGCh, kXCh = Geo::kXCh;
  constexpr int KS = Geo::KS, NT = Geo::NT, MT = Geo::MT, MW = Geo::MW, PG = Geo::PG;
  constexpr int kStages = Geo::kStages, kStage = Geo::kStage;
  extern __shared__ __align__(16) uint16_t smem[];
  uint8_t* const ring = reinterpret_cast<uint8_t*>(smem);
  uint16_t* const outs = reinterpret_cast<uint16_t*>(ring + kStages * kStage);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // dx's B fragments, Wp^T (k = (co, a, c), n = ci), for the block's life:
  // b0b1 is k pair lane % 4 of the k16 step (co = 4s + (lane % 4) / 2,
  // a = lane % 2; c = 0, 1) at ci = 8nt + lane / 4; b2b3 the k pair 4 on,
  // co + 2
  uint32_t wb[KS][NT][2];
#pragma unroll
  for (int s = 0; s < KS; ++s)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int co = 4 * s + ((lane & 3) >> 1) + 2 * r;
        const int a = lane & 1;
        const int ci = 8 * nt + (lane >> 2);
        wb[s][nt][r] = (uint32_t)w[((a * 2) * CI + ci) * CO + co] |
                       (uint32_t)w[((a * 2 + 1) * CI + ci) * CO + co] << 16;
      }

  // dW: this warp's 16 rows (c, co in [4mw, 4mw + 4), a) and pixel group
  const int mw = warp % MW;
  const int pg = warp / MW;
  float accw[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) accw[nt][e] = 0.f;

  const int tiles_w = (width + kTW - 1) / kTW;
  const int tiles_h = (height + TH - 1) / TH;
  const long long n_items = (long long)batch_depth * tiles_h * tiles_w;
  const long long n_mine =
      n_items > blockIdx.x ? (n_items - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const long long plane = (long long)height * width;

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
  auto g_slot = [&](long long t) {
    return reinterpret_cast<uint32_t*>(ring + (int)(t % kStages) * kStage);
  };
  auto x_slot = [&](long long t) {
    return reinterpret_cast<uint16_t*>(ring + (int)(t % kStages) * kStage + 4 * Geo::kG);
  };
  auto stage = [&](long long t) {  // item t's g and x tiles into their slot
    const Item it = item(t);
    land<CO, GR, 16>(reinterpret_cast<uint16_t*>(g_slot(t)), 2 * kGCh, 2 * kGRow,
                     g + (it.bd * CO * 4 * plane + (long long)(2 * it.h0) * 2 * width +
                          2 * it.w0),
                     4 * plane, 2 * width, 2 * (height - it.h0), 2 * (width - it.w0), vec);
    land<CI, TH, 8>(x_slot(t), kXCh, kTW,
                    x + (it.bd * CI * plane + (long long)it.h0 * width + it.w0), plane, width,
                    height - it.h0, width - it.w0, vec);
  };
  auto write_out = [&](long long t) {  // item t's staged dx tile into dx
    const Item it = item(t);
    const uint16_t* o = outs + (t & 1) * Geo::kX;
    uint16_t* const dp = dx + it.bd * CI * plane + (long long)it.h0 * width + it.w0;
    const int row_end = height - it.h0, col_end = width - it.w0;
    for (int i = threadIdx.x; i < CI * TH * 8; i += kThreads) {
      const int q = i % 8;
      const int r = (i / 8) % TH;
      const int ci = i / (8 * TH);
      if (r >= row_end) continue;
      const uint16_t* s = o + ci * kXCh + r * kTW + 8 * q;
      uint16_t* d = dp + ci * plane + (long long)r * width + 8 * q;
      if (vec) {
        if (8 * q < col_end) *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (8 * q + e < col_end) d[e] = s[e];
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
    // free, its dx staged)
    __syncthreads();
    if (t + kStages - 1 < n_mine) stage(t + kStages - 1);
    cp_async_commit();
    if (t > 0) write_out(t - 1);  // its stores drain under this item's products

    const uint32_t* gs = g_slot(t);
    const uint16_t* xs = x_slot(t);
    uint16_t* const o = outs + (t & 1) * Geo::kX;

    // dx: m-tile mt is 16 pixels of tile row mt / 4. A register (k pair j
    // of the k16 step, pixel) is the g word (co = 4s + j / 2, row 2h + j % 2,
    // word = pixel): lanes read pixel lane / 4 (+ 8) at j = lane % 4 (+ 4)
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int mt = i * kWarps + warp;
      const int hl = mt >> 2;
      const int p0 = (mt & 3) * 16;
      const uint32_t* ga =
          gs + ((lane & 3) >> 1) * kGCh + (2 * hl + (lane & 1)) * kGRow + p0 + (lane >> 2);
      float acc[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        uint32_t a[4];
        a[0] = ga[4 * s * kGCh];
        a[1] = ga[4 * s * kGCh + 8];
        a[2] = ga[(4 * s + 2) * kGCh];
        a[3] = ga[(4 * s + 2) * kGCh + 8];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_16816(acc[nt], a, wb[s][nt][0], wb[s][nt][1]);
      }
      // C fragment: rows (pixels) lane / 4 and + 8, columns (ci) 2 * (lane
      // % 4) and + 1; stmatrix.trans writes 8 ci rows of 8 pixels, lanes
      // 0-7 / 8-15 addressing the rows of pixels +0 / +8
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        stmatrix_x2_trans(smem_u32(o + (nt * 8 + (lane & 7)) * kXCh + hl * kTW + p0 + (lane & 8)),
                          pack_bf16(acc[nt][0], acc[nt][1]), pack_bf16(acc[nt][2], acc[nt][3]));
    }

    // dW over this warp's pixel group (input rows 2pg, 2pg + 1: 8 k16 steps).
    // Row j = lane / 4 of the A fragment is (co = 4mw + j / 2, a = j % 2) at
    // c = 0, row j + 8 the same at c = 1: two consecutive g words hold the
    // pixel pair of both parities, and __byte_perm parts them
#pragma unroll 2
    for (int q = 0; q < 8; ++q) {
      const int hl = 2 * pg + (q >> 2);
      const int p0 = (q & 3) * 16;
      const uint32_t* ga = gs + (4 * mw + (lane >> 3)) * kGCh +
                           (2 * hl + ((lane >> 2) & 1)) * kGRow + p0 + 2 * (lane & 3);
      const uint2 lo = *reinterpret_cast<const uint2*>(ga);
      const uint2 hi = *reinterpret_cast<const uint2*>(ga + 8);
      uint32_t a[4];
      a[0] = __byte_perm(lo.x, lo.y, 0x5410);
      a[1] = __byte_perm(lo.x, lo.y, 0x7632);
      a[2] = __byte_perm(hi.x, hi.y, 0x5410);
      a[3] = __byte_perm(hi.x, hi.y, 0x7632);
      // B (k = pixel, n = ci) from the [ci][row][col] x tile: lanes 0-7 /
      // 8-15 / 16-23 / 24-31 address ci rows of pixels +0 / +8 of n-tile
      // 2np, then of n-tile 2np + 1
      const uint16_t* xb = xs + (lane & 7) * kXCh + hl * kTW + p0 + (lane & 8);
      if constexpr (NT == 1) {
        uint32_t b[2];
        ldmatrix_x2(b, smem_u32(xb));
        mma_16816(accw[0], a, b[0], b[1]);
      } else {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t b[4];
          ldmatrix_x4(b, smem_u32(xb + (16 * np + ((lane >> 4) << 3)) * kXCh));
          mma_16816(accw[2 * np], a, b[0], b[1]);
          mma_16816(accw[2 * np + 1], a, b[2], b[3]);
        }
      }
    }
  }
  __syncthreads();
  if (n_mine > 0) write_out(n_mine - 1);

  // the warps' dW in warp order: C fragment rows lane / 4 (c = 0) and + 8
  // (c = 1), columns ci = 8nt + 2 * (lane % 4) and + 1
  cp_async_wait<0>();
  __syncthreads();
  float* const red = reinterpret_cast<float*>(ring);
  constexpr int kPer = NT * 4;  // accumulators a lane
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) red[(warp * 32 + lane) * kPer + nt * 4 + e] = accw[nt][e];
  __syncthreads();
  float* const out = partial + (long long)blockIdx.x * 4 * CI * CO;
  for (int i = threadIdx.x; i < MW * 32 * kPer; i += kThreads) {
    const int m = i / (32 * kPer);
    const int l = (i / kPer) % 32;
    const int r = i % kPer;
    float sum = 0.f;
#pragma unroll
    for (int p = 0; p < PG; ++p) sum += red[((p * MW + m) * 32 + l) * kPer + r];
    const int j = l >> 2;
    const int co = 4 * m + (j >> 1);
    const int a = j & 1;
    const int c = (r & 3) >> 1;
    const int ci = 8 * (r >> 2) + 2 * (l & 3) + (r & 1);
    out[((a * 2 + c) * CI + ci) * CO + co] = sum;
  }
}

template <int CI, int CO>
int launch(const void* g, const void* x, const void* w, void* dx, float* partial, float* dw,
           int batch_depth, int height, int width, int nblocks, cudaStream_t stream) {
  using Geo = Geometry<CI, CO>;
  auto kernel = convt2x_dm_bwd_kernel<CI, CO>;
  int rc = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     Geo::kSmem);
  if (rc != 0) return rc;
  const bool vec = width % 8 == 0 && (uintptr_t)g % 16 == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)dx % 16 == 0;
  kernel<<<nblocks, kThreads, Geo::kSmem, stream>>>(
      (const uint16_t*)g, (const uint16_t*)x, (const uint16_t*)w, (uint16_t*)dx, partial,
      batch_depth, height, width, vec);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  return cryovit::sum_partials(partial, dw, nblocks, 4 * CI * CO, stream);
}

template <int CI>
int launch_co(int co, const void* g, const void* x, const void* w, void* dx, float* partial,
              float* dw, int batch_depth, int height, int width, int nblocks,
              cudaStream_t stream) {
  switch (co) {
    case 8: return launch<CI, 8>(g, x, w, dx, partial, dw, batch_depth, height, width, nblocks, stream);
    case 16: return launch<CI, 16>(g, x, w, dx, partial, dw, batch_depth, height, width, nblocks, stream);
    case 32: return launch<CI, 32>(g, x, w, dx, partial, dw, batch_depth, height, width, nblocks, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// g: contiguous (batch, depth, co, 2*height, 2*width) bf16; x: contiguous
// (batch, depth, ci, height, width) bf16; w: contiguous (2, 2, ci, co) bf16
// indexed by output parity; dx: (batch, depth, ci, height, width) bf16
// output; partial: nblocks * 4 * ci * co f32 scratch; dw: (2, 2, ci, co) f32
// output indexed by output parity; nblocks: persistent blocks (one per SM
// at most, and no more than the work items of 64 / co input rows x 64
// columns). Returns cudaGetLastError(), or cudaErrorInvalidValue for an
// unsupported ci, co or grid.
extern "C" int cryovit_convt2x_dm_bwd(const void* g, const void* x, const void* w, void* dx,
                                      void* partial, void* dw, int batch, int depth, int ci,
                                      int co, int height, int width, int nblocks,
                                      void* stream) {
  if (nblocks < 1) return (int)cudaErrorInvalidValue;
  float* p = (float*)partial;
  float* out = (float*)dw;
  cudaStream_t s = (cudaStream_t)stream;
  const int bd = batch * depth;
  switch (ci) {
    case 8: return launch_co<8>(co, g, x, w, dx, p, out, bd, height, width, nblocks, s);
    case 16: return launch_co<16>(co, g, x, w, dx, p, out, bd, height, width, nblocks, s);
    case 32: return launch_co<32>(co, g, x, w, dx, p, out, bd, height, width, nblocks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
