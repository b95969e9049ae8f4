// The Hiera trunk's fused window blocks on Hopper (sm_90a): LayerNorm-prologue
// bf16 matrix products with bias, exact-GELU and residual epilogues, on
// wgmma and TMA.
//
// Replaces:
// - cryovit_tpu/ops/window_attention.py:window_block_attention (Pallas kernel
//   _wkb_kernel): out = x + proj(MHA(qkv(LN1(x)))) per window, as three
//   launches: [LN1 -> qkv + bias] (ln_gemm_kernel) into a bf16 (rows, 3*H*D)
//   scratch, the attention of csrc/attention_sm90.cu on column views of it
//   into a bf16 (rows, H*D) scratch, and [proj + bias + x]
//   (residual_gemm_kernel);
// - window_block_mlp (_wmlp_kernel): out = x + fc2(GELU(fc1(LN2(x)))) per
//   token, as two launches: [LN2 -> fc1 + bias -> erf GELU] (ln_gemm_kernel)
//   into a bf16 (rows, 4C) hidden scratch, and [fc2 + bias + x]
//   (residual_gemm_kernel).
//
// What bounds it on the H100: the four products (at Hiera-L's stage 3,
// 65,536 tokens x 576 channels: qkv 130 GFLOP, proj 44, fc1 and fc2 174 each)
// are compute bound on the tensor cores (989 TFLOP/s bf16). The TPU kernel
// holds a whole window (256 x 576 bf16 = 295 KB) and its f32 intermediates
// in VMEM; a Hopper block has 227 KB of shared memory, so each product is
// its own launch and the intermediates cross device memory in bf16, rounded
// exactly where the TPU kernel rounds them: qkv (226 MB written and read
// back), the attention output (75 MB each way), the MLP hidden (302 MB each
// way), about a quarter of the products' time at the memory rate.
//
// The LayerNorm products (ln_gemm_kernel: qkv, fc1) hold the whole row panel
// in shared memory. A block takes 128 rows: one TMA load of their C columns
// (128 x C bf16, 147 KB at C = 576), each row's f32 mean and E[x^2] - mean^2
// computed once, and the panel normalised in place, rounded to bf16 as
// _ln_f32 does. TMA fills the columns past C with zeros, and a normalised
// zero is not zero, so those columns are set back to 0; gamma and beta are
// never read past C. The normalised activations never reach device memory
// and are made once per 128 rows, not once per column tile (the mma.sync
// body this replaces computed the statistics 14 times for qkv, 18 for fc1).
// The block then walks every 144-column tile of the output (3C = 1728: 12
// tiles, 4C = 2304: 16) with wgmma m64n144k16, A from the panel and W's
// 144 x 64 k chunks from a ring of 128-byte-swizzled stages that one
// producer thread fills by TMA, guarded by "full" and "empty" mbarriers; the
// producer warpgroup hands its registers to the consumers (setmaxnreg 40 /
// 232). The two consumer warpgroups take alternate tiles, each the tile's
// 128 rows (two m64 products, 144 accumulators a thread), and a
// named-barrier token passes the ring from one to the other when a main
// loop has started all its products: one warpgroup's epilogue (bias and, for
// fc1, the GELU of ~150 M values a call) runs while the other's products
// are on the tensor cores, and the waits on the ring stay in fill order.
// Normalising in registers instead (wgmma with A from registers) would read
// and normalise the A tile again for every column tile and hold its
// fragments beside the accumulators; from shared memory, wgmma reads both
// operands itself and the consumer threads only start products and run
// epilogues. The cost of the panel is its width: C <= 704 (11 k chunks of
// 64 beside at least two ring stages in 227 KB), a multiple of 8 (TMA's
// 16-byte row stride). The port's Hiera configs reach the gate at C = 576
// (sam2.1_hiera_l) only; the tests take 16 to 704.
//
// The residual products (residual_gemm_kernel: proj, fc2) stream both
// operands: 128 x 64 chunks of A (the attention output or the MLP hidden)
// and 192 x 64 chunks of W through a 5-stage TMA ring that the two consumer
// warpgroups share (64 rows each, wgmma m64n192k16; 576 = 3 tiles). The
// block is persistent, one per SM over (row panel, column tile) pairs in
// column-fastest order, so the producer loads the next tile's chunks during
// the epilogue, and the blocks on the card at a time share their A panels
// in L2 (walking a panel's column tiles one after another, as the LayerNorm
// products do, reads fc2's 590 KB A panels from device memory again for
// each tile, and was slower on the card).
//
// Epilogues add the bias (and apply the GELU, or add x) to the f32
// accumulators before the one bf16 rounding of each output. The GELU takes
// erf as the TPU kernel does (Abramowitz & Stegun 7.1.26), branch-free. The
// four threads of a quad hold column pairs of the same 8-column blocks; they
// trade words (quad_transpose) so that x is read and the output written in
// 16-byte row pieces.
// Rows, output columns and the contraction are masked (TMA fills zeros past
// each extent; stores are checked), so any row count and any multiple of 8
// for 3C, the hidden width and C <= 704 is taken.
// Not yet done (later work): persistent LayerNorm blocks (the next panel's
// load under the last tile), TMA stores, W multicast across a cluster, and
// keeping a window's qkv in shared memory across the three launches of a
// block. Tried and slower on the card: 192-column LayerNorm tiles
// (register spills), L2 eviction hints, normalising the panel by one
// warpgroup under the first tile, and one warpgroup holding two
// accumulator sets (ptxas then waits on every product).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "sm90.cuh"

extern "C" int cryovit_window_attention(const void* q, const void* k,
                                        const void* v, void* out, int batch,
                                        int seq, int heads, int head_dim,
                                        long long row_stride,
                                        long long batch_stride, void* stream);

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;                     // rows of a tile
constexpr int kBK = 64;                      // columns of a k chunk: one 128-byte swizzled row
constexpr int kChunkBytes = kBM * kBK * 2;   // a 128-row chunk of A
constexpr int kHalfBytes = kChunkBytes / 2;  // its second 64 rows start here
constexpr int kThreads = 3 * 128;            // two consumer warpgroups, one producer warpgroup
constexpr int kProducer = 8;                 // the (first) producer warp
constexpr int kSmemMax = 232448;             // dynamic shared memory a block may use
constexpr int kLnBN = 144;                   // output columns of a LayerNorm-product tile
constexpr int kLnStageBytes = kLnBN * kBK * 2;
constexpr int kLnMaxChunks = 11;  // the LayerNorm panel: C <= 704
constexpr int kLnMaxStages = 8;
constexpr int kResBN = 192;  // output columns of a residual-product tile
constexpr int kResStages = 5;
constexpr int kResStageBytes = kChunkBytes + kResBN * kBK * 2;

enum Epilogue { kBias = 0, kBiasGelu = 1, kBiasResidual = 2 };

// Byte offset in the panel of 16-byte piece p (columns 8p .. 8p + 7) of row
// r: chunk p / 8, 128-byte swizzle (piece index XOR row % 8).
__device__ __forceinline__ uint32_t piece_offset(int p, int r) {
  return (p >> 3) * kChunkBytes + r * 128 + (((p & 7) ^ (r & 7)) << 4);
}

// The four threads of a quad (t = lane & 3) hold a 4 x 4 matrix of words,
// one row each; afterwards thread t holds column t (w[i] = thread i's old
// w[t]). Warp-collective.
__device__ __forceinline__ void quad_transpose(uint32_t (&w)[4], int t) {
  const bool hi = t & 2, odd = t & 1;
  uint32_t r0 = __shfl_xor_sync(0xffffffff, hi ? w[0] : w[2], 2);
  uint32_t r1 = __shfl_xor_sync(0xffffffff, hi ? w[1] : w[3], 2);
  if (hi) {
    w[0] = r0;
    w[1] = r1;
  } else {
    w[2] = r0;
    w[3] = r1;
  }
  r0 = __shfl_xor_sync(0xffffffff, odd ? w[0] : w[1], 1);
  r1 = __shfl_xor_sync(0xffffffff, odd ? w[2] : w[3], 1);
  if (odd) {
    w[0] = r0;
    w[2] = r1;
  } else {
    w[1] = r0;
    w[3] = r1;
  }
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

// The exact (erf) GELU with erf as the TPU kernel computes it
// (cryovit_tpu/ops/window_attention.py:_erf_f32): Abramowitz & Stegun
// 7.1.26, |error| <= 1.5e-7. With a = |v| / sqrt(2), t = 1 / (1 + p a) and
// erf(a) = 1 - P(t) t exp(-a^2), v * (1 + erf(v / sqrt(2))) / 2 is
// max(v, 0) - |v| P(t) t exp(-a^2) / 2; the 1/2 is folded into P's
// coefficients. Branch-free, about half the instructions of CUDA's erff
// (the fc1 epilogue takes ~150 M of them a call).
__device__ __forceinline__ float gelu(float v) {
  const float av = fabsf(v);
  const float t = __fdividef(1.f, fmaf(0.3275911f * 0.70710678118654752f, av, 1.f));
  const float half_poly =
      fmaf(fmaf(fmaf(fmaf(0.5f * 1.061405429f, t, 0.5f * -1.453152027f), t, 0.5f * 1.421413741f),
                t, 0.5f * -0.284496736f),
           t, 0.5f * 0.254829592f) * t;
  const float e = ex2(v * v * (-0.5f * 1.4426950408889634f));  // exp(-a^2)
  return fmaxf(v, 0.f) - av * half_poly * e;
}

// One output pair: accumulators v0, v1 plus the bias pair b, then the erf
// GELU or the residual pair r, in f32; one bf16 rounding.
template <int kEpi>
__device__ __forceinline__ uint32_t finish(float v0, float v1, uint32_t b, uint32_t r) {
  const float2 bb = unpack_bf16(b);
  v0 += bb.x;
  v1 += bb.y;
  if (kEpi == kBiasGelu) {
    v0 = gelu(v0);
    v1 = gelu(v1);
  }
  if (kEpi == kBiasResidual) {
    const float2 rr = unpack_bf16(r);
    v0 += rr.x;
    v1 += rr.y;
  }
  return pack_bf16(v0, v1);
}

// The bias pairs of this thread's columns n0 + 8j + 2t (0 past N), loaded
// together ahead of an epilogue.
template <int NJ>
__device__ __forceinline__ void load_bias(uint32_t (&b)[NJ], const bf16* __restrict__ bias,
                                          int n0, int N, int t) {
  const uint32_t* bias2 = reinterpret_cast<const uint32_t*>(bias);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int col = n0 + 8 * j + 2 * t;
    b[j] = col < N ? __ldg(bias2 + col / 2) : 0u;
  }
}

// The epilogue of one m64nNk16 accumulator, N = 8 * NJ: d[4j + e] belongs to
// row row0 + 8 * (e >> 1) and column n0 + 8j + 2t + (e & 1), row0 the
// thread's first row (tile row + 16 * warp + lane / 4); b from load_bias.
// Each four 8-column blocks go out as one 16-byte row piece a thread after
// a quad transpose (and x comes in the same way); the last NJ % 4 blocks as
// 4-byte pairs. c and res are (M, N) row-major; N is a multiple of 8.
template <int kEpi, int NJ>
__device__ __forceinline__ void store_tile(const float (&d)[4 * NJ], const uint32_t (&b)[NJ],
                                           int row0, int n0, int M, int N, int t,
                                           const bf16* __restrict__ res,
                                           bf16* __restrict__ c) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    const bool row_ok = row < M;
    const long long off = (long long)row * N;
#pragma unroll
    for (int q = 0; q < NJ / 4; ++q) {
      const int piece = n0 + 32 * q + 8 * t;  // this thread's 16-byte piece
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (kEpi == kBiasResidual) {
        if (row_ok && piece < N) {
          const uint4 v = *reinterpret_cast<const uint4*>(res + off + piece);
          w[0] = v.x;
          w[1] = v.y;
          w[2] = v.z;
          w[3] = v.w;
        }
        quad_transpose(w, t);  // w[i]: x at this thread's pair of block 4q + i
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 4 * q + i;
        w[i] = finish<kEpi>(d[4 * j + 2 * h], d[4 * j + 2 * h + 1], b[j], w[i]);
      }
      quad_transpose(w, t);  // w: block 4q + t of this row
      if (row_ok && piece < N) {
        *reinterpret_cast<uint4*>(c + off + piece) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
#pragma unroll
    for (int j = 4 * (NJ / 4); j < NJ; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      if (row_ok && col < N) {
        const uint32_t r =
            kEpi == kBiasResidual ? *reinterpret_cast<const uint32_t*>(res + off + col) : 0u;
        *reinterpret_cast<uint32_t*>(c + off + col) =
            finish<kEpi>(d[4 * j + 2 * h], d[4 * j + 2 * h + 1], b[j], r);
      }
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// The shared memory of ln_gemm_kernel from its 1 KB-aligned base: the
// LayerNorm'd panel (nkc chunks of 128 x 64), `stages` W chunks of 144 x 64,
// then the mbarriers panel_full, full[stages], empty[stages].
struct LnLayout {
  uint32_t panel, ring, bars;
  int stages;
  __device__ LnLayout(uint32_t base, int nkc, int stages_)
      : panel(base), ring(base + nkc * kChunkBytes), bars(ring + stages_ * kLnStageBytes),
        stages(stages_) {}
  __device__ uint32_t stage(int s) const { return ring + s * kLnStageBytes; }
  __device__ uint32_t panel_full() const { return bars; }
  __device__ uint32_t full(int s) const { return bars + 8 * (1 + s); }
  __device__ uint32_t empty(int s) const { return bars + 8 * (1 + stages + s); }
};

// The consumer warpgroups of ln_gemm_kernel: the LayerNorm of the panel,
// then the tiles' main loops and epilogues.
template <int kEpi>
__device__ __forceinline__ void ln_gemm_consumer(
    uint8_t* smem, const LnLayout& L, int nkc, int nt, const float* __restrict__ ln_w,
    const float* __restrict__ ln_b, const bf16* __restrict__ bias, bf16* __restrict__ c, int M,
    int N, int K, float eps) {
  constexpr int NJ = kLnBN / 8;
  const int m0 = blockIdx.x * kBM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  mbar_wait(L.panel_full(), 0);
  // The LayerNorm of the panel, in place: warp w takes rows 16w .. 16w + 15,
  // four at a time, eight lanes a row (piece sl + 8i of the row: lanes
  // 0-7 read one whole 128-byte line, free of bank conflicts).
  const int sl = lane & 7;
  for (int r = 16 * warp + (lane >> 3); r < 16 * warp + 16; r += 4) {
    uint4 v[kLnMaxChunks];
    float sum = 0.f, sq = 0.f;
#pragma unroll
    for (int i = 0; i < kLnMaxChunks; ++i) {
      v[i] = make_uint4(0u, 0u, 0u, 0u);
      if (i < nkc) {
        v[i] = *reinterpret_cast<const uint4*>(smem + piece_offset(sl + 8 * i, r));
      }
      const bf16* h = reinterpret_cast<const bf16*>(&v[i]);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float f = __bfloat162float(h[e]);
        sum += f;
        sq += f * f;
      }
    }
#pragma unroll
    for (int off = 4; off > 0; off >>= 1) {
      sum += __shfl_xor_sync(0xffffffff, sum, off);
      sq += __shfl_xor_sync(0xffffffff, sq, off);
    }
    const float mean = sum / K;
    const float rstd = rsqrtf(fmaxf(sq / K - mean * mean, 0.f) + eps);
#pragma unroll
    for (int i = 0; i < kLnMaxChunks; ++i) {
      const int p = sl + 8 * i, col = 8 * p;
      if (i >= nkc) break;
      uint4 y = make_uint4(0u, 0u, 0u, 0u);  // columns past K stay zero
      if (col < K) {
        const bf16* h = reinterpret_cast<const bf16*>(&v[i]);
        const float4 g0 = *reinterpret_cast<const float4*>(ln_w + col);
        const float4 g1 = *reinterpret_cast<const float4*>(ln_w + col + 4);
        const float4 b0 = *reinterpret_cast<const float4*>(ln_b + col);
        const float4 b1 = *reinterpret_cast<const float4*>(ln_b + col + 4);
        const float gs[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
        const float bs[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
        uint32_t* yw = reinterpret_cast<uint32_t*>(&y);
#pragma unroll
        for (int e = 0; e < 8; e += 2) {
          const float y0 = (__bfloat162float(h[e]) - mean) * rstd * gs[e] + bs[e];
          const float y1 = (__bfloat162float(h[e + 1]) - mean) * rstd * gs[e + 1] + bs[e + 1];
          yw[e / 2] = pack_bf16(y0, y1);
        }
      }
      *reinterpret_cast<uint4*>(smem + piece_offset(p, r)) = y;
    }
  }
  fence_proxy_async();  // generic-proxy writes, read next by wgmma
  bar_sync(1, 256);

  const int wg = warp >> 2;
  const int row0 = 16 * (warp & 3) + (lane >> 2);  // the thread's first row in a 64-row half
  const int t = lane & 3;
  auto release = [&](int s) {  // this warp is done with the stage
    __syncwarp();
    if (lane == 0) mbar_arrive(L.empty(s));
  };
  float acc0[4 * NJ], acc1[4 * NJ];  // the tile's rows 0..63 and 64..127
  zero(acc0);
  zero(acc1);
  for (int n = wg; n < nt; n += 2) {
    if (n > 0) bar_sync(2 + wg, 256);  // the other warpgroup has started all of tile n - 1
    for (int kc = 0; kc < nkc; ++kc) {
      const int it = n * nkc + kc, s = it % L.stages;
      mbar_wait(L.full(s), (it / L.stages) & 1);
      const uint32_t a = L.panel + kc * kChunkBytes;
      const uint64_t da0 = desc_k_major(a, 128, 1);
      const uint64_t da1 = desc_k_major(a + kHalfBytes, 128, 1);
      const uint64_t db = desc_k_major(L.stage(s), 128, 1);
      fence_regs(acc0);
      fence_regs(acc1);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        wgmma_ss_n144(acc0, da0 + 2 * ks, db + 2 * ks, kc | ks);
        wgmma_ss_n144(acc1, da1 + 2 * ks, db + 2 * ks, kc | ks);
      }
      wgmma_commit();
      if (kc > 0) {
        wgmma_wait<1>();  // the previous chunk's products are done
        fence_regs(acc0);
        fence_regs(acc1);
        release((it - 1) % L.stages);
      }
    }
    if (n + 1 < nt) bar_arrive(2 + (wg ^ 1), 256);  // tile n + 1 may start
    uint32_t b[NJ];
    load_bias(b, bias, n * kLnBN, N, t);
    wgmma_wait<0>();
    fence_regs(acc0);
    fence_regs(acc1);
    release((n * nkc + nkc - 1) % L.stages);
    store_tile<kEpi, NJ>(acc0, b, m0 + row0, n * kLnBN, M, N, t, nullptr, c);
    store_tile<kEpi, NJ>(acc1, b, m0 + 64 + row0, n * kLnBN, M, N, t, nullptr, c);
  }
}

// c[M, N] = epilogue(LN(x)[M, K] . w[N, K]^T + bias) for the 128 rows of
// block blockIdx.x and every 144-column tile: x (map_x, boxes of 64 columns
// x 128 rows) and c row-major bf16, ln_w / ln_b (K) f32, w (map_w, boxes of
// 64 x 144) a torch Linear weight (N, K) bf16, bias (N) bf16. K <= 704 and
// N multiples of 8; `stages` ring stages follow the panel.
template <int kEpi>
__global__ void __launch_bounds__(kThreads, 1)
    ln_gemm_kernel(const __grid_constant__ CUtensorMap map_x,
                   const __grid_constant__ CUtensorMap map_w, const float* __restrict__ ln_w,
                   const float* __restrict__ ln_b, const bf16* __restrict__ bias,
                   bf16* __restrict__ c, int M, int N, int K, int stages, float eps) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzle patterns need 1 KB alignment
  const int nkc = (K + kBK - 1) / kBK;
  const int nt = (N + kLnBN - 1) / kLnBN;
  const LnLayout L(base, nkc, stages);
  const int m0 = blockIdx.x * kBM;
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
    mbar_init(L.panel_full(), 1);
    for (int s = 0; s < stages; ++s) {
      mbar_init(L.full(s), 1);
      mbar_init(L.empty(s), 4);  // lane 0 of each warp of the consuming warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kProducer) {
    // The producer warpgroup gives 128 of its 168 registers a thread to the
    // consumers, which take 232 for their 144 accumulators; one thread
    // starts every load.
    setmaxnreg_dec<40>();
    if (warp == kProducer && (threadIdx.x & 31) == 0) {
      mbar_expect_tx(L.panel_full(), nkc * kChunkBytes);
      for (int kc = 0; kc < nkc; ++kc) {
        tma_load_2d(L.panel + kc * kChunkBytes, &map_x, kc * kBK, m0, L.panel_full());
      }
      // W chunks in the order the tiles' main loops take them
      for (int it = 0; it < nt * nkc; ++it) {
        const int s = it % stages;
        if (it >= stages) mbar_wait(L.empty(s), ((it / stages) & 1) ^ 1);
        mbar_expect_tx(L.full(s), kLnStageBytes);
        tma_load_2d(L.stage(s), &map_w, (it % nkc) * kBK, (it / nkc) * kLnBN, L.full(s));
      }
    }
  } else {
    setmaxnreg_inc<232>();
    ln_gemm_consumer<kEpi>(smem_raw + (base - raw), L, nkc, nt, ln_w, ln_b, bias, c, M, N, K,
                           eps);
  }
}

// c[M, N] = a[M, K] . w[N, K]^T + bias + res: a (map_a, boxes of 64 columns
// x 128 rows), res and c row-major bf16, w (map_w, boxes of 64 x 192) a
// torch Linear weight (N, K) bf16, bias (N) bf16. K and N multiples of 8.
// Persistent: block b takes tiles b, b + gridDim.x, ... in column-fastest
// order.
__global__ void __launch_bounds__(kThreads, 1)
    residual_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                         const __grid_constant__ CUtensorMap map_w,
                         const bf16* __restrict__ bias, const bf16* __restrict__ res,
                         bf16* __restrict__ c, int M, int N, int K) {
  constexpr int NJ = kResBN / 8;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;  // kResStages (A chunk, W chunk) stages
  const uint32_t bars = ring + kResStages * kResStageBytes;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kResStages + s); };
  const int nkc = (K + kBK - 1) / kBK;
  const int ntn = (N + kResBN - 1) / kResBN;
  const int tiles = ntn * ((M + kBM - 1) / kBM);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kResStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kProducer) {
    setmaxnreg_dec<40>();
    if (warp == kProducer && lane == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int n0 = (tile % ntn) * kResBN, m0 = (tile / ntn) * kBM;
        for (int kc = 0; kc < nkc; ++kc, ++it) {
          const int s = it % kResStages;
          if (it >= kResStages) mbar_wait(empty(s), ((it / kResStages) & 1) ^ 1);
          mbar_expect_tx(full(s), kResStageBytes);
          const uint32_t st = ring + s * kResStageBytes;
          tma_load_2d(st, &map_a, kc * kBK, m0, full(s));
          tma_load_2d(st + kChunkBytes, &map_w, kc * kBK, n0, full(s));
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int wg = warp >> 2;
    const int row0 = 64 * wg + 16 * (warp & 3) + (lane >> 2);  // the thread's first tile row
    const int t = lane & 3;
    auto release = [&](int s) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    };
    float acc[4 * NJ];
    zero(acc);
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int n0 = (tile % ntn) * kResBN, m0 = (tile / ntn) * kBM;
      for (int kc = 0; kc < nkc; ++kc, ++it) {
        const int s = it % kResStages;
        mbar_wait(full(s), (it / kResStages) & 1);
        const uint32_t st = ring + s * kResStageBytes;
        const uint64_t da = desc_k_major(st + wg * kHalfBytes, 128, 1);
        const uint64_t db = desc_k_major(st + kChunkBytes, 128, 1);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) wgmma_ss_n192(acc, da + 2 * ks, db + 2 * ks, kc | ks);
        wgmma_commit();
        if (kc > 0) {
          wgmma_wait<1>();
          fence_regs(acc);
          release((it - 1) % kResStages);
        }
      }
      uint32_t b[NJ];
      load_bias(b, bias, n0, N, t);
      wgmma_wait<0>();
      fence_regs(acc);
      release((it - 1) % kResStages);
      store_tile<kBiasResidual, NJ>(acc, b, m0 + row0, n0, M, N, t, res, c);
    }
  }
}

// A tensor map of a row-major (rows, cols) bf16 matrix, boxes of 64 columns
// x box_rows rows, 128-byte swizzled; zeros past either extent. TMA needs a
// 16-byte aligned base (the wrappers check it) and cols a multiple of 8.
bool encode_2d(EncodeTiled fn, CUtensorMap* map, const void* ptr, int cols, int rows,
               int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kEpi>
int ln_gemm(const void* x, const float* ln_w, const float* ln_b, const void* w,
            const void* bias, void* c, int M, int N, int K, float eps, cudaStream_t stream) {
  const int nkc = (K + kBK - 1) / kBK;
  const int fixed = 1024 + nkc * kChunkBytes;  // alignment slack and the panel
  const int stages = std::min(
      kLnMaxStages, (kSmemMax - fixed - 8 * (1 + 2 * kLnMaxStages)) / kLnStageBytes);
  if (M <= 0 || K <= 0 || N <= 0 || K % 8 || N % 8 || nkc > kLnMaxChunks || stages < 2) {
    return (int)cudaErrorInvalidValue;
  }
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap map_x, map_w;
  if (!encode_2d(fn, &map_x, x, K, M, kBM) || !encode_2d(fn, &map_w, w, K, N, kLnBN)) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = fixed + stages * kLnStageBytes + 8 * (1 + 2 * stages);
  auto kernel = ln_gemm_kernel<kEpi>;
  const cudaError_t rc =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  kernel<<<(M + kBM - 1) / kBM, kThreads, smem, stream>>>(
      map_x, map_w, ln_w, ln_b, (const bf16*)bias, (bf16*)c, M, N, K, stages, eps);
  return (int)cudaGetLastError();
}

int residual_gemm(const void* a, const void* w, const void* bias, const void* res, void* c,
                  int M, int N, int K, cudaStream_t stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 8 || N % 8) return (int)cudaErrorInvalidValue;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap map_a, map_w;
  if (!encode_2d(fn, &map_a, a, K, M, kBM) || !encode_2d(fn, &map_w, w, K, N, kResBN)) {
    return (int)cudaErrorInvalidValue;
  }
  constexpr int kSmem = 1024 + kResStages * kResStageBytes + 8 * 2 * kResStages;
  cudaError_t rc = cudaFuncSetAttribute(residual_gemm_kernel,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  int device = 0, sms = 0;
  if (rc == cudaSuccess) rc = cudaGetDevice(&device);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (rc != cudaSuccess) return (int)rc;
  const long long tiles = (long long)((N + kResBN - 1) / kResBN) * ((M + kBM - 1) / kBM);
  const int grid = (int)std::min<long long>(tiles, sms);
  residual_gemm_kernel<<<grid, kThreads, kSmem, stream>>>(
      map_a, map_w, (const bf16*)bias, (const bf16*)res, (bf16*)c, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

// out = x + proj(attention(qkv(LN(x)))) for `windows` windows of `tokens`
// tokens: x and out contiguous (windows*tokens, C) bf16; ln_w / ln_b (C) f32;
// w_qkv (3C, C), b_qkv (3C), w_proj (C, C), b_proj (C) bf16 (torch Linear
// layout), the q third of w_qkv and b_qkv pre-scaled by the softmax scale *
// log2(e); qkv (rows, 3C) and attn (rows, C) bf16 scratch. C = heads *
// head_dim, a multiple of 8 up to 704; 16-byte aligned bases. Returns the
// first non-zero error code of its launches (cudaErrorInvalidValue for a
// shape they do not take).
extern "C" int cryovit_window_block_attention(
    const void* x, const float* ln_w, const float* ln_b, const void* w_qkv,
    const void* b_qkv, const void* w_proj, const void* b_proj, void* qkv,
    void* attn, void* out, int windows, int tokens, int channels, int heads,
    float eps, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int rows = windows * tokens;
  const int head_dim = channels / heads;
  int rc = ln_gemm<kBias>(x, ln_w, ln_b, w_qkv, b_qkv, qkv, rows, 3 * channels, channels,
                          eps, st);
  if (rc) return rc;
  const bf16* q = (const bf16*)qkv;
  rc = cryovit_window_attention(q, q + channels, q + 2 * channels, attn, windows, tokens,
                                heads, head_dim, 3LL * channels, 3LL * channels * tokens,
                                stream);
  if (rc) return rc;
  return residual_gemm(attn, w_proj, b_proj, x, out, rows, channels, channels, st);
}

// out = x + fc2(GELU(fc1(LN(x)))) per token: x and out contiguous (rows, C)
// bf16; ln_w / ln_b (C) f32; w1 (F, C), b1 (F), w2 (C, F), b2 (C) bf16;
// hidden (rows, F) bf16 scratch. C a multiple of 8 up to 704, F a multiple
// of 8; 16-byte aligned bases. Returns as cryovit_window_block_attention.
extern "C" int cryovit_window_block_mlp(const void* x, const float* ln_w,
                                        const float* ln_b, const void* w1,
                                        const void* b1, const void* w2,
                                        const void* b2, void* hidden, void* out,
                                        int rows, int channels, int hidden_dim,
                                        float eps, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int rc = ln_gemm<kBiasGelu>(x, ln_w, ln_b, w1, b1, hidden, rows, hidden_dim, channels, eps,
                              st);
  if (rc) return rc;
  return residual_gemm(hidden, w2, b2, x, out, rows, channels, hidden_dim, st);
}
