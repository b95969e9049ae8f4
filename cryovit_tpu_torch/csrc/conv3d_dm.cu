// SAME 3x3x3 convolution on depth-major activations, Hopper (sm_90a): a bf16
// tensor-core implicit GEMM.
//
// Replaces: cryovit_tpu/ops/conv3d_dm.py:conv3d_dm (Pallas kernel
//   _conv_kernel, conv3d_dm.py:162, via _conv3d_dm_single).
//
// What it computes: x (B, D, Ci, H, W) bf16, weights (3, 3, 3, Ci, Co) bf16
// in the flax DHWIO tap order, dilation (dil, 1, 1):
//   y[b, d, co, h, w] = sum_{kd, kh, kw, ci} x[b, d + (kd-1)*dil, ci,
//                       h + kh - 1, w + kw - 1] * W[kd, kh, kw, ci, co]
// with every out-of-range tap counting as zero, f32 sums, stored as bf16
// (B, D, Co, H, W). Any H and W; Ci in {1, 8, 16, 24, 32}; Co in {1, 8, 16,
// 32}. The same kernel is the conv's input gradient (flipped taps, Ci and Co
// swapped), so a train step runs it twice per decoder conv.
//
// What bounds it on the H100: 27*Ci*Co MACs per output voxel against
// 2*(Ci + Co) bytes. At a 128x512^2 train step's shapes the two 32 -> 32
// convs on 128^2 planes are operation-bound (~111 GFLOP each), the rest
// bytes-bound; the twelve calls' bound is 2.1 ms. Only the tensor cores
// bring the 32 -> 32 products under cuDNN's time, and only one pass over x
// brings the bytes down to the bound.
//
// What the design does about it:
// - The GEMM. Per tap, y_tile += x_shift . W_tap: mma.sync m16n8k16 bf16 ->
//   f32 with M = 16 voxels of a tile row (a strip), K = 16 input channels,
//   N = 8 output channels (Co = 1 padded to 8). bf16 x bf16 is exact in
//   f32, so only the order of summation differs from the plain version.
// - The kw shift. x lands in a ring of plane slots laid out channels
//   innermost, [row][col][ci], so a one-voxel shift moves a row of ldmatrix
//   by 2*Ci bytes, a multiple of 16: every tap's A fragments come straight
//   from ldmatrix. The 16-byte chunks of a voxel are XOR-swizzled by the
//   column so the 8 rows of an ldmatrix fall in 8 bank groups. x arrives
//   voxel-contiguous ([ci][row][col] in (B, D, C, H, W)), so each plane tile
//   lands by 16-byte cp.async in a raw buffer of that layout and is turned
//   into the slot's layout by ldmatrix.trans + stmatrix, 4 blocks of 8
//   channels x 8 voxels per warp instruction pair. The other way, slots
//   voxel-contiguous and each A register built from two aligned words by
//   __byte_perm (8 loads and 4 byte_perm a fragment), was slower at 32 -> 32
//   and 8 -> 8 (times in PERF.md).
// - One pass over x. A block walks one depth chain of output planes z = r,
//   r + dil, ... (a segment of up to 32 items), one TH x 64 tile position.
//   Consecutive items share two of their three input planes, so each item
//   lands one new plane: its raw copy is in flight during the products of
//   the item before, and is converted into the slot the item before has
//   just freed (3 slots). Out-of-range planes (dil >= D among them) are
//   zero-filled slots; where the loop order allows (Ci >= 16, Ci = 1) their
//   taps are skipped for the whole item.
// - The row walk. Warp (strip, row half) owns R = TH / 2 output rows of one
//   16-voxel strip and keeps all of their Co accumulators. For each column
//   group (depth tap kd, kw and 16 channels) it loads the B fragments of the
//   three kh once and walks the slot rows: slot row rho feeds output row
//   rho - kh for each kh, so each A fragment (one ldmatrix.x4) serves up to
//   three mma per n-tile.
// - Ci = 8: one k16 holds two column groups (kd, kw) of 8 channels (5 pairs
//   for the 9, the last half zero), so nothing is padded but that half.
//   Ci = 1: each voxel's 9 lateral taps become 16 channels of an expanded
//   slot (built from the raw plane), so a depth tap is one k16 and nothing
//   is padded 16-fold.
// - The weights: the wrapper packs them as mma B fragments (27*Ci*Co bf16,
//   55 KB at 32 -> 32), which stay in shared memory for the block's life
//   (one persistent block per SM) and load as one LDS.64 a lane.
// - Output: the accumulators go to a (Co, TH, 64) staging tile by
//   stmatrix.trans, and y is written in 16-byte rows at the start of the
//   next item, so the stores drain under its products.
// - Tried and not kept (slower at the decoder's shapes): producer warps that
//   land, convert and store while 8 warps multiply (384 threads cap the
//   multiplying warps at 168 registers, and they spill; fewer producers
//   cannot keep up); the stores by the bulk-copy engine (cp.async.bulk, one
//   128-byte row each).
// - Tile height TH: the tallest of 32, 16, 8, 4 whose slots, raw buffer,
//   weights and staging fit in 227 KB and whose accumulators stay at 64 a
//   lane; at the decoder's shapes 4 for Ci = 32 (Co = 16 or 32), 8 for
//   16 -> 32, 16 for 16 -> 16 and 1 -> 8, 32 for Ci = 8 and Co <= 8.
// - W % 8 != 0 (or an unaligned base) lands and stores element by element.
// - No split across blocks: every output voxel's sum runs in one warp in a
//   fixed order, so a second run gives the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTW = 64;        // output tile columns: four 16-voxel strips
constexpr int kCols = 80;      // staged columns w0 - 8 .. w0 + 71: ten 16-byte groups
constexpr int kGroups = kCols / 8;
constexpr int kWarps = 8;      // 4 strips x 2 row halves
constexpr int kThreads = 32 * kWarps;
constexpr int kAccRegs = 64;   // accumulators a lane holds at most
constexpr int kSlots = 3;      // input plane slots: planes k - 1, k, k + 1
constexpr int kSeg = 32;       // output planes of a work unit: a segment of one depth chain
constexpr int kSmemMax = 232448;  // dynamic shared memory a block can have

// The geometry of one instantiation. CIP: input channels as laid out (8, 16
// or 32; 1 for Ci = 1, whose slots hold the 9 lateral taps as 16 channels).
template <int CIP, int CO, int TH>
struct Geometry {
  static constexpr bool kExpand = CIP == 1;
  static constexpr int CS = kExpand ? 16 : CIP;    // channels of a slot voxel
  static constexpr int C8 = CS / 8;                // its 16-byte chunks
  static constexpr int KH = kExpand ? 1 : 3;       // kh taps a slot row feeds
  static constexpr int NT = (CO + 7) / 8;          // n-tiles of 8 output channels
  static constexpr int KS = CIP / 16;              // k16 steps per (kd, kw), Ci >= 16
  // column groups, one A fragment each: (kd) for Ci = 1, pairs of (kd, kw)
  // for Ci = 8, (kd, kw, k16 step) otherwise
  static constexpr int CG = kExpand ? 3 : CIP == 8 ? 5 : 9 * KS;
  static constexpr int R = TH * 4 / kWarps;  // output rows a warp owns
  static constexpr int SROWS = kExpand ? TH : TH + 2;
  static constexpr int SCOLS = kExpand ? kTW : kCols;
  static constexpr int kSlot = SROWS * SCOLS * CS;
  // raw plane: [ci][TH + 2 rows][80 columns]; channel pitch an odd multiple
  // of 16 bytes, so the 8 channel rows of an ldmatrix.trans hit 8 bank groups
  static constexpr int kRawP = (TH + 2) * kCols + 8;
  static constexpr int kRaw = (kExpand ? 1 : CIP) * kRawP;
  static constexpr int kW = CG * KH * NT * 32 * 4;  // B fragments, 4 bf16 a lane
  // output staging: [co][TH][64]; co pitch an odd multiple of 16 bytes
  static constexpr int kOutP = TH * kTW + 8;
  static constexpr int kOut = NT * 8 * kOutP;
  static constexpr int kSmem = 2 * (kSlots * kSlot + kRaw + kW + kOut + 8);  // + a zero row
};

template <int CIP, int CO, int TH>
__host__ __device__ constexpr bool fits() {
  using Geo = Geometry<CIP, CO, TH>;
  return Geo::kSmem <= kSmemMax && Geo::R * Geo::NT * 4 <= kAccRegs;
}

template <int CIP, int CO>
__host__ __device__ constexpr int tile_rows() {
  return fits<CIP, CO, 32>() ? 32 : fits<CIP, CO, 16>() ? 16 : fits<CIP, CO, 8>() ? 8 : 4;
}

// the 16-byte chunk a voxel's chunk c is stored at: c ^ swz(col), so any 8
// consecutive columns put one chunk in 8 bank groups
template <int C8>
__device__ __forceinline__ int swz(int col) {
  return C8 == 4 ? (col >> 1) & 3 : C8 == 2 ? (col >> 2) & 1 : 0;
}

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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void stmatrix_x4(uint32_t addr, const uint32_t r[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
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
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Lands rows [r0, r0 + ROWS) and columns [c0, c0 + 80) of nch channel planes
// of src (channel pitch hw) in dst ([ci][row][80], channel pitch cp), zero
// outside the plane and everywhere when !in. vec (W % 8 == 0, 16-byte
// aligned base): 16-byte cp.async, a group lying wholly in or out of the
// plane; otherwise element by element.
template <int ROWS>
__device__ __forceinline__ void stage(uint16_t* dst, const uint16_t* src, int nch, int cp, int r0,
                                      int c0, int height, int width, long long hw, bool in,
                                      bool vec) {
  if (vec) {
    for (int i = threadIdx.x; i < nch * ROWS * kGroups; i += kThreads) {
      const int q = i % kGroups;
      const int t = i / kGroups;
      const int r = t % ROWS;
      const int c = t / ROWS;
      const int hh = r0 + r;
      const int ww = c0 + 8 * q;
      uint16_t* d = dst + c * cp + r * kCols + 8 * q;
      if (in && (unsigned)hh < (unsigned)height && (unsigned)ww < (unsigned)width)
        cp_async16(d, src + c * hw + (long long)hh * width + ww);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int i = threadIdx.x; i < nch * ROWS * kCols; i += kThreads) {
      const int col = i % kCols;
      const int t = i / kCols;
      const int r = t % ROWS;
      const int c = t / ROWS;
      const int hh = r0 + r;
      const int ww = c0 + col;
      uint16_t v = 0;
      if (in && (unsigned)hh < (unsigned)height && (unsigned)ww < (unsigned)width)
        v = src[c * hw + (long long)hh * width + ww];
      dst[c * cp + r * kCols + col] = v;
    }
  }
}

struct Unit {
  int b, r, chain, k0, k1, h0, w0;
};

// The work units: (b, depth residue r mod dil, segment of up to kSeg planes
// of r's chain, tile row of th rows, tile column of kTW). The kernel decodes
// them; the launch caps its grid at their count.
struct Units {
  int tiles_w, tiles_h, res, segs;
  long long n;
  __host__ __device__ Units(int batch, int depth, int height, int width, int dil, int th)
      : tiles_w((width + kTW - 1) / kTW),
        tiles_h((height + th - 1) / th),
        res(dil < depth ? dil : depth),
        segs(((depth + dil - 1) / dil + kSeg - 1) / kSeg),
        n((long long)batch * res * segs * tiles_h * tiles_w) {}
};

// grid (blocks); each block strides over the work units (b, depth residue r,
// segment, tile row, tile column) and walks the segment's output planes.
template <int CIP, int CO>
__global__ void __launch_bounds__(kThreads, 1)
    conv3d_dm_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ wpk,
                     uint16_t* __restrict__ y, int batch, int depth, int ci_total, int height,
                     int width, int dil, bool vec) {
  constexpr int TH = tile_rows<CIP, CO>();
  using Geo = Geometry<CIP, CO, TH>;
  constexpr bool kExpand = Geo::kExpand;
  constexpr int CS = Geo::CS, C8 = Geo::C8, KH = Geo::KH, NT = Geo::NT, KS = Geo::KS;
  constexpr int CG = Geo::CG, R = Geo::R, SCOLS = Geo::SCOLS;
  constexpr int kSlot = Geo::kSlot, kRawP = Geo::kRawP, kOutP = Geo::kOutP;
  constexpr uint32_t kRowB = SCOLS * CS * 2;  // bytes per slot row
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* const slots = smem;
  uint16_t* const raw = slots + kSlots * kSlot;
  uint16_t* const ws = raw + Geo::kRaw;
  uint16_t* const outs = ws + Geo::kW;
  uint16_t* const zero_row = outs + Geo::kOut;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int strip = warp & 3;
  const int r0 = (warp >> 2) * R;  // the warp's first output row in the tile
  const int nch = kExpand ? 1 : ci_total;
  const long long hw = (long long)height * width;

  // once per block: the packed weights; zeros that stay (the raw channels
  // past Ci, the zero row)
  for (int i = threadIdx.x; i < Geo::kW / 8; i += kThreads)
    reinterpret_cast<uint4*>(ws)[i] = reinterpret_cast<const uint4*>(wpk)[i];
  for (int i = threadIdx.x; i < Geo::kRaw - nch * kRawP; i += kThreads) raw[nch * kRawP + i] = 0;
  if (threadIdx.x < 8) zero_row[threadIdx.x] = 0;

  // ldmatrix rows of the A fragment: lanes 0-7 / 8-15 / 16-23 / 24-31 give
  // a0a1 / a2a3 / a4a5 / a6a7: voxels +0 / +8 / +0 / +8 of the strip, the
  // first / first / second / second 8 of the k16 (channels, or with Ci = 8
  // the pair's first / second column group)
  const int vq = (lane & 7) + (lane & 8);
  const int hi = lane >> 4;
  const uint32_t warp_off = (uint32_t)(r0 * SCOLS + strip * 16) * CS * 2;
  // byte offset of the lane's row within a slot row, per kw (and k16 step)
  uint32_t lane_off[3][KS > 0 ? KS : 1];
#pragma unroll
  for (int kw = 0; kw < 3; ++kw)
#pragma unroll
    for (int ks = 0; ks < (KS > 0 ? KS : 1); ++ks) {
      const int col = kExpand ? vq : 7 + vq + kw;
      const int chunk = kExpand ? hi : CIP == 8 ? 0 : 2 * ks + hi;
      lane_off[kw][ks] = (uint32_t)(col * CS + ((chunk ^ swz<C8>(col)) * 8)) * 2;
    }
  const uint32_t zero_addr = smem_u32(zero_row);

  const Units units(batch, depth, height, width, dil, TH);
  const int tiles_w = units.tiles_w, tiles_h = units.tiles_h, res = units.res, segs = units.segs;
  const long long n_units = units.n;

  auto decode = [&](long long unit, Unit& u) {
    u.w0 = (int)(unit % tiles_w) * kTW;
    long long rest = unit / tiles_w;
    u.h0 = (int)(rest % tiles_h) * TH;
    rest /= tiles_h;
    const int seg = (int)(rest % segs);
    rest /= segs;
    u.r = (int)(rest % res);
    u.b = (int)(rest / res);
    u.chain = (depth - u.r + dil - 1) / dil;  // output (and input) planes z = r + k * dil
    u.k0 = seg * kSeg;
    u.k1 = min(u.chain, u.k0 + kSeg);
    return u.k0 < u.k1;
  };
  auto next_unit = [&](long long unit, Unit& u) {  // the first non-empty unit from unit on
    while (unit < n_units && !decode(unit, u)) unit += gridDim.x;
    return unit;
  };
  auto land = [&](const Unit& u, int m) {  // raw copy of input plane r + m * dil (zero if none)
    const bool in = m >= 0 && m < u.chain;
    const uint16_t* src =
        in ? x + ((long long)u.b * depth + u.r + (long long)m * dil) * ci_total * hw : x;
    stage<TH + 2>(raw, src, nch, kRawP, u.h0 - 1, u.w0 - 8, height, width, hw, in, vec);
  };
  auto convert = [&](int m) {  // the raw plane into its slot, (m + 3) % 3
    uint16_t* const slot = slots + ((m + 3) % 3) * kSlot;
    if constexpr (kExpand) {
      // each voxel's 3 x 3 neighbourhood as 16 channels: tap t = kh*3 + kw, 9-15 zero
      for (int i = threadIdx.x; i < TH * kTW; i += kThreads) {
        const int row = i / kTW;
        const int v = i % kTW;
        const uint16_t* s = raw + row * kCols + 7 + v;
        uint16_t t[16];
#pragma unroll
        for (int k = 0; k < 16; ++k) t[k] = k < 9 ? s[(k / 3) * kCols + k % 3] : 0;
        uint4 c[2];
        uint32_t* cw = reinterpret_cast<uint32_t*>(c);
#pragma unroll
        for (int k = 0; k < 8; ++k) cw[k] = t[2 * k] | (uint32_t)t[2 * k + 1] << 16;
        uint16_t* d = slot + (row * kTW + v) * 16;
        *reinterpret_cast<uint4*>(d + (swz<2>(v) * 8)) = c[0];
        *reinterpret_cast<uint4*>(d + ((1 ^ swz<2>(v)) * 8)) = c[1];
      }
    } else {
      // blocks of 8 channels x 8 voxels: ldmatrix.trans from [ci][row][col]
      // gives each lane two channels of one voxel; stmatrix puts them in
      // [row][col][ci]
      constexpr int kBlocks = (TH + 2) * kGroups * C8;
      static_assert(kBlocks % 4 == 0, "whole ldmatrix.x4 / stmatrix.x4 groups");
      const int i8 = lane & 7;
      for (int op = warp; op < kBlocks / 4; op += kWarps) {
        const int blk = op * 4 + (lane >> 3);
        const int c = blk % C8;
        const int t = blk / C8;
        const int g = t % kGroups;
        const int row = t / kGroups;
        uint32_t v[4];
        ldmatrix_x4_trans(v, smem_u32(raw + (c * 8 + i8) * kRawP + row * kCols + g * 8));
        const int col = g * 8 + i8;
        stmatrix_x4(smem_u32(slot + (row * kCols + col) * CS + ((c ^ swz<C8>(col)) * 8)), v);
      }
    }
  };
  auto write_out = [&](const Unit& u, int k) {  // the staged (Co, TH, 64) tile into y
    uint16_t* const yp = y + ((long long)u.b * depth + u.r + (long long)k * dil) * CO * hw;
    if (vec) {
      for (int i = threadIdx.x; i < CO * TH * 8; i += kThreads) {
        const int g = i % 8;
        const int row = (i / 8) % TH;
        const int co = i / (8 * TH);
        const int hh = u.h0 + row;
        const int ww = u.w0 + 8 * g;
        if (hh < height && ww < width)
          *reinterpret_cast<uint4*>(yp + co * hw + (long long)hh * width + ww) =
              *reinterpret_cast<const uint4*>(outs + co * kOutP + row * kTW + 8 * g);
      }
    } else {
      for (int i = threadIdx.x; i < CO * TH * kTW; i += kThreads) {
        const int col = i % kTW;
        const int row = (i / kTW) % TH;
        const int co = i / (kTW * TH);
        const int hh = u.h0 + row;
        const int ww = u.w0 + col;
        if (hh < height && ww < width)
          yp[co * hw + (long long)hh * width + ww] = outs[co * kOutP + row * kTW + col];
      }
    }
  };

  Unit u, un;
  long long unit = next_unit(blockIdx.x, u);
  if (unit < n_units) land(u, u.k0 - 1);
  cp_async_commit();
  while (unit < n_units) {
    // the segment's first three input planes k0 - 1, k0, k0 + 1, and k0 + 2 in flight
    for (int m = u.k0 - 1; m <= u.k0 + 1; ++m) {
      cp_async_wait_all();
      __syncthreads();
      convert(m);
      __syncthreads();
      if (m + 1 <= u.k1) land(u, m + 1);
      cp_async_commit();
    }
    long long next = n_units;
    for (int k = u.k0; k < u.k1; ++k) {
      uint32_t sbase[3];  // slots of input planes k - 1, k, k + 1 (depth taps kd = 0, 1, 2)
      bool valid[3];
#pragma unroll
      for (int kd = 0; kd < 3; ++kd) {
        sbase[kd] = smem_u32(slots + ((k + kd + 2) % 3) * kSlot) + warp_off;
        valid[kd] = (unsigned)(k + kd - 1) < (unsigned)u.chain;
      }

      float acc[R][NT][4];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][nt][e] = 0.f;

#pragma unroll
      for (int cg = 0; cg < CG; ++cg) {
        // this column group's A rows: base address (slot row 0) and the step
        // per slot row; with Ci = 8 the lanes of the second half read the
        // pair's second (kd, kw), or the zero row for the last pair's
        uint32_t base, step = kRowB;
        if constexpr (kExpand) {
          if (!valid[cg]) continue;
          base = sbase[cg] + lane_off[0][0];
        } else if constexpr (CIP == 8) {
          const int ca = 2 * cg, cb = 2 * cg + 1;  // (kd, kw) = (c / 3, c % 3)
          const uint32_t a_addr = sbase[ca / 3] + lane_off[ca % 3][0];
          const uint32_t b_addr = cb < 9 ? sbase[cb < 9 ? cb / 3 : 0] + lane_off[cb % 3][0]
                                         : zero_addr;
          base = hi ? b_addr : a_addr;
          if (cb >= 9 && hi) step = 0;
        } else {
          const int kd = cg / (3 * KS), kw = (cg / KS) % 3, ks = cg % KS;
          if (!valid[kd]) continue;
          base = sbase[kd] + lane_off[kw][ks];
        }
        uint32_t b[KH][NT][2];
#pragma unroll
        for (int kh = 0; kh < KH; ++kh)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const uint2 v = *reinterpret_cast<const uint2*>(
                ws + (((cg * KH + kh) * NT + nt) * 32 + lane) * 4);
            b[kh][nt][0] = v.x;
            b[kh][nt][1] = v.y;
          }
        // slot row rho feeds output row rho - kh of the warp for each kh
#pragma unroll
        for (int rho = 0; rho < R + KH - 1; ++rho) {
          uint32_t a[4];
          ldmatrix_x4(a, base + rho * step);
#pragma unroll
          for (int kh = 0; kh < KH; ++kh) {
            const int i = rho - kh;
            if (i < 0 || i >= R) continue;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) mma_16816(acc[i][nt], a, b[kh][nt][0], b[kh][nt][1]);
          }
        }
      }

      cp_async_wait_all();
      // products done: plane k - 1's slot and the raw plane are free, and
      // every thread has read the item before from the staging tile
      __syncthreads();
      // C fragment: rows (voxels) lane / 4 and + 8, columns (output
      // channels) 2 * (lane % 4) and + 1; stmatrix.trans writes it as 8
      // output channels x 8 voxels, lanes 0-7 / 8-15 addressing the channel
      // rows of voxels +0 / +8
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          stmatrix_x2_trans(
              smem_u32(outs + (nt * 8 + (lane & 7)) * kOutP + (r0 + i) * kTW + strip * 16 +
                       (lane & 8)),
              pack_bf16(acc[i][nt][0], acc[i][nt][1]), pack_bf16(acc[i][nt][2], acc[i][nt][3]));
      if (k + 2 <= u.k1) convert(k + 2);
      __syncthreads();
      if (k + 3 <= u.k1) {
        land(u, k + 3);
      } else if (k + 1 == u.k1) {  // the next unit's first plane
        next = next_unit(unit + gridDim.x, un);
        if (next < n_units) land(un, un.k0 - 1);
      }
      cp_async_commit();
      write_out(u, k);  // its stores drain under the next item's products
    }
    unit = next;
    u = un;
  }
}

template <int CIP, int CO>
int launch(const void* x, const void* w, void* y, int batch, int depth, int ci, int height,
           int width, int dil, int nblocks, cudaStream_t stream) {
  constexpr int th = tile_rows<CIP, CO>();
  constexpr int smem = Geometry<CIP, CO, th>::kSmem;
  const long long n_units = Units(batch, depth, height, width, dil, th).n;
  if (n_units < nblocks) nblocks = n_units > 0 ? (int)n_units : 1;
  int rc = (int)cudaFuncSetAttribute(conv3d_dm_kernel<CIP, CO>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != 0) return rc;
  const bool vec = width % 8 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0;
  conv3d_dm_kernel<CIP, CO><<<nblocks, kThreads, smem, stream>>>(
      (const uint16_t*)x, (const uint16_t*)w, (uint16_t*)y, batch, depth, ci, height, width, dil,
      vec);
  return (int)cudaGetLastError();
}

template <int CO>
int launch_co(const void* x, const void* w, void* y, int batch, int depth, int ci, int height,
              int width, int dil, int nblocks, cudaStream_t stream) {
  switch (ci) {
    case 1: return launch<1, CO>(x, w, y, batch, depth, ci, height, width, dil, nblocks, stream);
    case 8: return launch<8, CO>(x, w, y, batch, depth, ci, height, width, dil, nblocks, stream);
    case 16: return launch<16, CO>(x, w, y, batch, depth, ci, height, width, dil, nblocks, stream);
    case 24:
    case 32: return launch<32, CO>(x, w, y, batch, depth, ci, height, width, dil, nblocks, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x: contiguous (batch, depth, ci, height, width) bf16; w: the weights packed
// as mma B fragments by ops/conv3d_dm.py:pack_weights (bf16); y: contiguous
// (batch, depth, co, height, width) bf16; nblocks: the most persistent
// blocks to launch (one per SM), capped at the work units. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for an unsupported ci, co or
// grid.
extern "C" int cryovit_conv3d_dm(const void* x, const void* w, void* y, int batch, int depth,
                                 int ci, int co, int height, int width, int dil, int nblocks,
                                 void* stream) {
  if (nblocks < 1 || dil < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (co) {
    case 1: return launch_co<1>(x, w, y, batch, depth, ci, height, width, dil, nblocks, s);
    case 8: return launch_co<8>(x, w, y, batch, depth, ci, height, width, dil, nblocks, s);
    case 16: return launch_co<16>(x, w, y, batch, depth, ci, height, width, dil, nblocks, s);
    case 32: return launch_co<32>(x, w, y, batch, depth, ci, height, width, dil, nblocks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
