// Weight gradient of the SAME 3x3x3 depth-major convolution, Hopper (sm_90a):
// a bf16 tensor-core implicit GEMM.
//
// Replaces: cryovit_tpu/ops/conv3d_dm.py:conv3d_dm_dw (Pallas kernel
//   _dw_kernel, conv3d_dm.py:272, via _conv3d_dm_dw_single).
//
// What it computes: x (B, D, Ci, H, W) bf16 (the forward's input), g
// (B, D, Co, H, W) bf16 (the cotangent of its output), dilation (dil, 1, 1):
//   dW[kd, kh, kw, ci, co] = sum_{b, d, h, w} x[b, d + (kd-1)*dil, ci,
//                            h + kh - 1, w + kw - 1] * g[b, d, co, h, w]
// with every out-of-range tap counting as zero, as f32 (3, 3, 3, Ci, Co).
// Any H and W, any Ci >= 1; Co in {1, 8, 16, 32}.
//
// What bounds it on the H100: 27*Ci*Co MACs per voxel against 2*(Ci + Co)
// bytes read once. At the six shapes of a 128x512^2 decoder train step
// (710 GFLOP of valid taps in 3.56 GB) four shapes sit below the bf16 ridge
// (~295 FLOP/byte) and the two 32 -> 32 ones just above it; summed, the
// bytes bound it, 1.062 ms at 3.35 TB/s. Only the tensor cores bring the
// products under the bytes, and only one pass over x and g brings the bytes
// down to that bound.
//
// What the design does about it:
// - The GEMM. The TPU kernel computes dW[kd] += im2col_kd . g^T, the
//   shifted windows of x against g. Here the shift moves to g:
//     dW[kd, kh, kw] = sum_u x[z, u] * g[z - (kd-1)*dil, u - (kh-1, kw-1)]
//   over the voxels u of every x plane z. A work item is a TH x 64 tile of
//   one x plane (b, z): the x tile is mma's A (input channels x voxels),
//   the same for all 27 taps, and each tap's B (voxels x output channels)
//   is a shifted window of one of the three g planes z + dil, z, z - dil,
//   landed with a one-voxel halo. Both operands are voxel-contiguous in the
//   (B, D, C, H, W) layout, as mma's row-major A and column-major B want.
// - One pass over x and g. A block walks one depth chain z = r, r + dil,
//   r + 2*dil, ... (a segment of up to 32 items of it) at one tile position.
//   Consecutive items share two of their three g planes, so each item lands
//   one x tile and one new g plane, by 16-byte cp.async two items ahead of
//   the products (each thread always copies the same 16-byte column chunk
//   of its rows): a ring of 5 g-plane slots (three in use) and 3 x-tile
//   slots. One cp.async.bulk per tile row, counted on an mbarrier, was
//   tried instead and was slower at every shape (not kept). Bytes read into shared memory per call, against 2*(Ci + Co)
//   bytes a voxel read once: x once; g (TH + 2) / TH times (the halo rows),
//   +3 % (halo columns), +2 planes per segment. At the train step's shapes
//   (128 slices): 32 -> 32 at 128^2: 340 MB (268 once); 32 -> 16 at 256^2:
//   897 (805); 16 -> 16: 634 (537); 8 -> 8 at 512^2: 1201 (1074); 8 -> 1:
//   620 (604).
//   The output is not split across blocks: each block holds all 27 taps of
//   its input channels (one block per 32 of them, so Ci > 32 re-reads g).
// - Warps. 12: warp (kd, q) holds the 9 (kh, kw) taps of depth tap kd for
//   the block's input channels and one n-tile of 8 output channels (72 f32
//   accumulators a lane at 32 -> 32); with Co < 32 the 4 / COT warps of one
//   n-tile take every (4 / COT)-th 16-column strip and are summed at the
//   end in a fixed order. A warp walks each strip's g rows: g row rho feeds
//   tile row rho - 2 + kh of every kh, so its B fragments are loaded once
//   for all three kh, and the A fragments (ldmatrix) of the last three tile
//   rows stay in registers.
// - The kw shift. Taps kw = 0 and 2 start one bf16 (2 bytes) off the
//   32-bit grid of a fragment. The g plane lands aligned, and each shifted
//   fragment register is two aligned words joined by __byte_perm (high half
//   of one, low half of the next): words at column offsets 6, 8, 10 give
//   kw = 2, 1, 0, so the three taps cost 3 loads and 2 byte_perms per
//   register where one tap costs 1 load, and nothing extra in shared
//   memory. The shift sits on g, the operand with no more channels than x
//   at every decoder shape (Co <= Ci). Not tried: three pre-shifted copies
//   of g in shared memory (3x its slots, which do not fit beside the ring at
//   Co = 32), and shifting x instead.
// - Products: mma.sync.aligned.m16n8k16 bf16 -> f32 (bf16 x bf16 is exact
//   in f32, so only the order of summation differs from the plain version).
//   wgmma is not needed: Co <= 32 keeps N tiny, and at half the bf16 peak
//   the two operation-bound 32 -> 32 shapes would still take ~0.23 ms.
//   Ci is padded to 16 with zero rows written once per block, except for
//   Ci <= 8: there an A tile holds 8 channels of two tile rows, so one mma
//   gives taps kh and kh + 1 (6 mma per g row and strip instead of 9). Co = 1
//   is padded to 8.
// - Tile height TH: the tallest of 16, 8, 4 whose ring fits in 227 KB
//   (4 at Co = 32, 8 at Co = 16 or at Co <= 8 with Ci > 16, else 16): a
//   taller tile spends fewer of its g rows on the halo and less per item.
// - Registers (ptxas, sm_90a, one block of 384 threads per SM, 168 at
//   most): Ci > 16 uses 168 at every Co and spills 8-24 bytes of stack
//   (Co = 32: 24 stored, 44 loaded; 16: 20/20; 8: 8/8; 1: 16/20); Ci <= 16
//   uses 126-146 and spills nothing.
// - Depth taps whose plane is out of range (dil >= D among them) are
//   skipped for the whole item; H and W edges are zero-filled. W % 8 != 0
//   (or an unaligned base) lands element by element instead of by cp.async.
// - Split-K over voxels: each block writes one partial dW (27*Ci*Co floats)
//   and block_sum.cuh adds the partials in block order, so a second run
//   gives the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_sum.cuh"

namespace {

constexpr int kTW = 64;  // tile columns
constexpr int kStrips = kTW / 16;  // 16-voxel k-steps of a tile row
constexpr int kWarps = 12;         // 3 kd x 4
constexpr int kThreads = 32 * kWarps;
constexpr int kSeg = 32;    // items per work unit: a segment of one depth chain
constexpr int kAhead = 2;   // items whose copies are in flight during the products
constexpr int kXSlots = kAhead + 1;
constexpr int kGSlots = kAhead + 3;  // three planes in use
constexpr int kGW = kTW + 16;        // g plane row pitch: the tile's columns from 8
constexpr int kSmemMax = 232448;     // dynamic shared memory a block can have

// The geometry of one instantiation. CIT: m-tiles of 16 input channels
// (1 or 2); 0 for Ci <= 8, where an m-tile holds 8 channels of two tile
// rows. TH: tile rows, the tallest of 16, 8, 4 whose ring fits.
template <int CO, int CIT, int TH>
struct Geometry {
  static constexpr int COT = (CO + 7) / 8;  // n-tiles of 8 output channels
  static constexpr int S = kStrips / COT;   // warps that share one (kd, n-tile)
  static constexpr int MT = CIT == 0 ? 1 : CIT;
  static constexpr int CIC = CIT == 0 ? 8 : 16 * CIT;  // input channels of a block
  static constexpr int NP = CIT == 0 ? 2 : 3;          // C tiles per (kw, m-tile)
  // x tile: channel pitch = 8 mod 64 elements (the 8 rows of an ldmatrix
  // fall in 8 different 16-byte bank groups); with row pairs a zero row
  // above and below the tile
  static constexpr int XROWS = CIT == 0 ? TH + 2 : TH;
  static constexpr int kXP = XROWS * kTW + 8;
  // g plane: TH + 2 rows, the halo words at columns 6 (w0-2, w0-1) and
  // kTW + 8 (w0+kTW, w0+kTW+1); channel pitch 40 * (TH + 2) + 4 words, 20
  // mod 32: the 8 channels x 4 words of a fragment load fall in 32 banks
  static constexpr int kGP = (TH + 2) * kGW + 8;
  static constexpr int kGSlot = 8 * COT * kGP;
  static constexpr int kXSlot = CIC * kXP;
  static constexpr int kAcc = NP * 3 * MT * 4;  // accumulators per lane
  static constexpr int kRing = 2 * (kGSlots * kGSlot + kXSlots * kXSlot);
  static constexpr int kReduce = 4 * (S - 1) * 3 * COT * 32 * kAcc;
  static constexpr int kSmem = kRing > kReduce ? kRing : kReduce;
};

template <int CO, int CIT>
__host__ __device__ constexpr int tile_rows() {
  return Geometry<CO, CIT, 16>::kSmem <= kSmemMax  ? 16
         : Geometry<CO, CIT, 8>::kSmem <= kSmemMax ? 8
                                                   : 4;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// the copies of all but the kAhead most recent groups landed
__device__ __forceinline__ void cp_async_wait_ahead() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kAhead) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const uint16_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// the two bf16 from one element past the start of word lo: lo's high half
// below hi's low half
__device__ __forceinline__ uint32_t shifted(uint32_t lo, uint32_t hi) {
  return __byte_perm(lo, hi, 0x5432);
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

// Lands rows [r0, r0 + nrows) and columns [w0 - HALO, w0 + kTW + HALO) of
// nch channel planes of src (channel pitch hw) in dst (channel pitch cp,
// row pitch rp, column w0 at dst column dcol), zero outside the plane. vec
// (W % 8 == 0, 16-byte aligned base): the tile's columns land as 16-byte
// cp.async, thread t always taking 16-byte chunk t % 8 of a row (of rows
// t / 8, + 48, ...), and each side's halo as one 4-byte cp.async of the
// column pair next to it; otherwise element by element.
template <int HALO>
__device__ __forceinline__ void stage(uint16_t* dst, const uint16_t* src, int nch, int nrows,
                                      int r0, int w0, int height, int width, long long hw,
                                      int cp, int rp, int dcol, bool vec) {
  constexpr int kChunks = kTW / 8;
  if (vec) {
    const int q = threadIdx.x % kChunks;
    const bool col_in = w0 + 8 * q < width;
    const uint16_t* s = src + w0 + 8 * q;
    uint16_t* d = dst + dcol + 8 * q;
    for (int i = threadIdx.x / kChunks; i < nch * nrows; i += kThreads / kChunks) {
      const int c = i / nrows;
      const int r = i - c * nrows;
      const int hh = r0 + r;
      uint16_t* dd = d + c * cp + r * rp;
      if (col_in && (unsigned)hh < (unsigned)height)
        cp_async16(dd, s + c * hw + (long long)hh * width);
      else
        *reinterpret_cast<uint4*>(dd) = make_uint4(0u, 0u, 0u, 0u);
    }
    if (HALO) {
      for (int i = threadIdx.x; i < nch * nrows * 2; i += kThreads) {
        const int side = i & 1;
        const int c = (i >> 1) / nrows;
        const int r = (i >> 1) - c * nrows;
        const int hh = r0 + r;
        const int ww = side ? w0 + kTW : w0 - 2;
        uint16_t* dd = dst + c * cp + r * rp + (side ? dcol + kTW : dcol - 2);
        if ((unsigned)hh < (unsigned)height && ww >= 0 && ww < width)
          cp_async4(dd, src + c * hw + (long long)hh * width + ww);
        else
          *reinterpret_cast<uint32_t*>(dd) = 0u;
      }
    }
  } else {
    constexpr int kCols = kTW + 2 * HALO;
    for (int i = threadIdx.x; i < nch * nrows * kCols; i += kThreads) {
      const int col = i % kCols;
      const int r = (i / kCols) % nrows;
      const int c = i / (kCols * nrows);
      const int hh = r0 + r;
      const int ww = w0 - HALO + col;
      uint16_t v = 0;
      if (hh >= 0 && hh < height && ww >= 0 && ww < width)
        v = src[c * hw + (long long)hh * width + ww];
      dst[c * cp + r * rp + dcol - HALO + col] = v;
    }
  }
}

// grid (blocks, input-channel chunks of CIC); each block strides over the
// work units (b, depth residue r, segment, tile row, tile column).
//
// Warp roles: warp = 4 * kd + q; warp (kd, q) takes n-tile q % COT and the
// strips q / COT, + S, ... of every tile row: it holds all 9 (kh, kw) taps
// of depth tap kd for the block's input channels and 8 output channels, and
// the S warps of one (kd, n-tile) are summed at the end.
template <int CO, int CIT>
__global__ void __launch_bounds__(kThreads, 1)
    conv3d_dm_dw_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ g,
                        float* __restrict__ partial, int batch, int depth, int ci_total,
                        int height, int width, int dil, bool vec) {
  constexpr int TH = tile_rows<CO, CIT>();
  using Geo = Geometry<CO, CIT, TH>;
  constexpr int COT = Geo::COT, S = Geo::S, MT = Geo::MT, NP = Geo::NP, CIC = Geo::CIC;
  constexpr int kXP = Geo::kXP, kGP = Geo::kGP, kGSlot = Geo::kGSlot, kXSlot = Geo::kXSlot;
  constexpr bool kPairs = CIT == 0;
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* const gs = smem;                     // kGSlots g planes
  uint16_t* const xs = smem + kGSlots * kGSlot;  // kXSlots x tiles

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int kd = warp / 4;
  const int cot = (warp % 4) % COT;
  const int strip0 = (warp % 4) / COT;
  const int c0 = blockIdx.y * CIC;
  const int nch = min(CIC, ci_total - c0);
  const long long hw = (long long)height * width;

  // zeros that stay: x channels past Ci, the row-pair mode's rows above and
  // below the tile, g channels past Co
  for (int s = 0; s < kXSlots; ++s) {
    for (int i = threadIdx.x; i < (CIC - nch) * kXP; i += kThreads)
      xs[s * kXSlot + nch * kXP + i] = 0;
    if (kPairs)
      for (int i = threadIdx.x; i < nch * 2 * kTW; i += kThreads)
        xs[s * kXSlot + (i / (2 * kTW)) * kXP + (i / kTW) % 2 * (TH + 1) * kTW + i % kTW] = 0;
  }
  for (int s = 0; s < kGSlots; ++s)
    for (int i = threadIdx.x; i < (8 * COT - CO) * kGP; i += kThreads)
      gs[s * kGSlot + CO * kGP + i] = 0;

  // [p][kw][m-tile][C fragment]: p = kh; with row pairs p = 0 holds kh 0
  // (rows 0-7) and kh 1 (rows 8-15), p = 1 kh 2 (rows 0-7)
  float acc[NP][3][MT][4];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int kw = 0; kw < 3; ++kw)
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[p][kw][m][e] = 0.f;

  // ldmatrix rows: lanes 0-7 / 8-15 / 16-23 / 24-31 give a0a1 / a2a3 /
  // a4a5 / a6a7: channels 0-7 / 8-15 / 0-7 / 8-15 of one tile row, or with
  // row pairs channels 0-7 of tile rows j / j + 1 / j / j + 1, at voxels
  // +0 / +0 / +8 / +8
  const int a_off = kPairs ? (lane & 7) * kXP + ((lane >> 3) & 1) * kTW + (lane >> 4) * 8
                           : (lane & 15) * kXP + (lane >> 4) * 8;
  // B fragment words: output channel lane / 4 of the warp's n-tile, voxel
  // pair 2 * (lane % 4), from column offset 6
  const int b_off = (cot * 8 + (lane >> 2)) * kGP + 2 * (lane & 3) + 6;

  const int tiles_w = (width + kTW - 1) / kTW;
  const int tiles_h = (height + TH - 1) / TH;
  const int res = min(dil, depth);
  const int segs = ((depth + dil - 1) / dil + kSeg - 1) / kSeg;
  const long long n_units = (long long)batch * res * segs * tiles_h * tiles_w;

  for (long long unit = blockIdx.x; unit < n_units; unit += gridDim.x) {
    const int tw = (int)(unit % tiles_w);
    long long rest = unit / tiles_w;
    const int th = (int)(rest % tiles_h);
    rest /= tiles_h;
    const int seg = (int)(rest % segs);
    rest /= segs;
    const int r = (int)(rest % res);
    const int b = (int)(rest / res);
    const int chain = (depth - r + dil - 1) / dil;  // x planes z = r + k * dil
    const int k0 = seg * kSeg;
    const int k1 = min(chain, k0 + kSeg);
    if (k0 >= k1) continue;  // uniform across the block
    const int h0 = th * TH;
    const int w0 = tw * kTW;
    const long long plane0 = (long long)b * depth + r;

    auto stage_g = [&](int m) {  // g plane r + m * dil (m >= -1) into its slot
      if (m < 0 || m >= chain) return;
      stage<1>(gs + (m % kGSlots) * kGSlot, g + (plane0 + (long long)m * dil) * CO * hw, CO,
               TH + 2, h0 - 1, w0, height, width, hw, kGP, kGW, 8, vec);
    };
    auto stage_x = [&](int k) {  // x tile of plane r + k * dil into its slot
      stage<0>(xs + (k % kXSlots) * kXSlot + (kPairs ? kTW : 0),
               x + ((plane0 + (long long)k * dil) * ci_total + c0) * hw, nch, TH, h0, w0,
               height, width, hw, kXP, kTW, 0, vec);
    };

    // one commit group per item: its x tile and the g plane first needed by it
    stage_g(k0 - 1);
    stage_g(k0);
    for (int k = k0; k < k0 + kAhead; ++k) {
      if (k < k1) {
        stage_g(k + 1);
        stage_x(k);
      }
      cp_async_commit();
    }
    for (int k = k0; k < k1; ++k) {
      if (k + kAhead < k1) {
        stage_g(k + kAhead + 1);
        stage_x(k + kAhead);
      }
      cp_async_commit();
      cp_async_wait_ahead();
      __syncthreads();
      const int m = k + 1 - kd;  // this warp's g plane: d = z - (kd - 1) * dil
      if (m >= 0 && m < chain) {
        const uint16_t* xa = xs + (k % kXSlots) * kXSlot + a_off;
        const uint16_t* gb = gs + (m % kGSlots) * kGSlot + b_off;
#pragma unroll
        for (int st = 0; st < kStrips / S; ++st) {
          const int j0 = (strip0 + st * S) * 16;
          // Walk the strip's g rows: g row rho feeds tile row rho - 2 + kh
          // for each kh, so its B fragments are loaded once for all three.
          // The A fragments of the last three tile rows (row pairs j, j + 1
          // from tile row -1) stay in registers, at [row % 3].
          uint32_t a[3][MT][4];
          if (kPairs) ldmatrix_x4(a[2][0], xa + j0);  // the pair (-1, 0)
#pragma unroll
          for (int rho = 0; rho < TH + 2; ++rho) {
            if (rho < TH) {
#pragma unroll
              for (int mt = 0; mt < MT; ++mt)
                ldmatrix_x4(a[rho % 3][mt],
                            xa + mt * 16 * kXP + (rho + (kPairs ? 1 : 0)) * kTW + j0);
            }
            const uint16_t* p = gb + rho * kGW + j0;
            const uint32_t w6 = ld32(p), w8 = ld32(p + 2), w10 = ld32(p + 4);
            const uint32_t w14 = ld32(p + 8), w16 = ld32(p + 10), w18 = ld32(p + 12);
            // voxel u reads g column u - kw + 1, at word offset 9 - kw
            const uint32_t bf[3][2] = {{shifted(w8, w10), shifted(w16, w18)},
                                       {w8, w16},
                                       {shifted(w6, w8), shifted(w14, w16)}};
#pragma unroll
            for (int kw = 0; kw < 3; ++kw) {
              if (kPairs) {  // pair (rho - 2, rho - 1): kh 0, 1; pair (rho, rho + 1): kh 2
                if (rho >= 1) mma_16816(acc[0][kw][0], a[(rho + 1) % 3][0], bf[kw][0], bf[kw][1]);
                if (rho < TH) mma_16816(acc[NP - 1][kw][0], a[rho % 3][0], bf[kw][0], bf[kw][1]);
              } else {
#pragma unroll
                for (int kh = 0; kh < 3; ++kh) {
                  const int i = rho - 2 + kh;  // tile row
                  if (i < 0 || i >= TH) continue;
#pragma unroll
                  for (int mt = 0; mt < MT; ++mt)
                    mma_16816(acc[kh][kw][mt], a[i % 3][mt], bf[kw][0], bf[kw][1]);
                }
              }
            }
          }
        }
      }
      __syncthreads();  // slots of this item free for later copies
    }
  }

  // the S warps of one (kd, n-tile) add up in strip order through shared
  // memory (the ring is free now), then write the block's partial dW
  float* const red = reinterpret_cast<float*>(smem);
  const int group = kd * COT + cot;
  if (S > 1) {
    __syncthreads();
    if (strip0 > 0) {
      float* dst = red + ((strip0 - 1) * 3 * COT + group) * Geo::kAcc * 32 + lane;
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int kw = 0; kw < 3; ++kw)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              dst[(((p * 3 + kw) * MT + mt) * 4 + e) * 32] = acc[p][kw][mt][e];
    }
    __syncthreads();
    if (strip0 > 0) return;
    for (int s = 1; s < S; ++s) {
      const float* src = red + ((s - 1) * 3 * COT + group) * Geo::kAcc * 32 + lane;
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int kw = 0; kw < 3; ++kw)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[p][kw][mt][e] += src[(((p * 3 + kw) * MT + mt) * 4 + e) * 32];
    }
  }
  // C fragment: rows lane / 4 and + 8 (input channels, or with row pairs
  // kh and kh + 1), columns (output channels) 2 * (lane % 4) and + 1
  float* out = partial + (long long)blockIdx.x * 27 * ci_total * CO;
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int kw = 0; kw < 3; ++kw)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (kPairs && p == 1 && e >= 2) continue;  // kh 3 does not exist
          const int kh = kPairs ? (p == 0 ? e >> 1 : 2) : p;
          const int ci = c0 + (kPairs ? lane >> 2 : mt * 16 + (lane >> 2) + (e >> 1) * 8);
          const int co = cot * 8 + 2 * (lane & 3) + (e & 1);
          if (ci < ci_total && co < CO)
            out[((kd * 9 + kh * 3 + kw) * ci_total + ci) * CO + co] = acc[p][kw][mt][e];
        }
}

template <int CO, int CIT>
int launch(const void* x, const void* g, float* partial, float* dw, int batch, int depth,
           int ci, int height, int width, int dil, int nblocks, cudaStream_t stream) {
  constexpr int smem = Geometry<CO, CIT, tile_rows<CO, CIT>()>::kSmem;
  constexpr int cic = Geometry<CO, CIT, 4>::CIC;
  int rc = (int)cudaFuncSetAttribute(conv3d_dm_dw_kernel<CO, CIT>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != 0) return rc;
  const bool vec = width % 8 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)g % 16 == 0;
  const dim3 grid(nblocks, (ci + cic - 1) / cic);
  conv3d_dm_dw_kernel<CO, CIT><<<grid, kThreads, smem, stream>>>(
      (const uint16_t*)x, (const uint16_t*)g, partial, batch, depth, ci, height, width, dil,
      vec);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  return cryovit::sum_partials(partial, dw, nblocks, 27 * ci * CO, stream);
}

// Ci <= 8: one m-tile of two tile rows; <= 16: one m-tile; more: blocks of 32
template <int CO>
int launch_co(const void* x, const void* g, float* partial, float* dw, int batch, int depth,
              int ci, int height, int width, int dil, int nblocks, cudaStream_t stream) {
  if (ci <= 8)
    return launch<CO, 0>(x, g, partial, dw, batch, depth, ci, height, width, dil, nblocks,
                         stream);
  if (ci <= 16)
    return launch<CO, 1>(x, g, partial, dw, batch, depth, ci, height, width, dil, nblocks,
                         stream);
  return launch<CO, 2>(x, g, partial, dw, batch, depth, ci, height, width, dil, nblocks,
                       stream);
}

}  // namespace

// x: contiguous (batch, depth, ci, height, width) bf16; g: contiguous
// (batch, depth, co, height, width) bf16; partial: nblocks * 27 * ci * co
// f32 scratch; dw: (3, 3, 3, ci, co) f32 output. Returns cudaGetLastError(),
// or cudaErrorInvalidValue for an unsupported co or grid.
extern "C" int cryovit_conv3d_dm_dw(const void* x, const void* g, void* partial, void* dw,
                                    int batch, int depth, int ci, int co, int height,
                                    int width, int dil, int nblocks, void* stream) {
  if (nblocks < 1 || ci < 1 || dil < 1 || (ci + 31) / 32 > 65535)
    return (int)cudaErrorInvalidValue;
  float* p = (float*)partial;
  float* out = (float*)dw;
  cudaStream_t s = (cudaStream_t)stream;
  switch (co) {
    case 1: return launch_co<1>(x, g, p, out, batch, depth, ci, height, width, dil, nblocks, s);
    case 8: return launch_co<8>(x, g, p, out, batch, depth, ci, height, width, dil, nblocks, s);
    case 16: return launch_co<16>(x, g, p, out, batch, depth, ci, height, width, dil, nblocks, s);
    case 32: return launch_co<32>(x, g, p, out, batch, depth, ci, height, width, dil, nblocks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
