// Fused compressed linear layer y = (x @ M) @ C (kernel K3), and its
// grouped form y_e = (x_e @ M_e) @ C_e over a stack of E experts (kernel K4):
// the device code of the grid schedule (built as bitlinear.cu).  The decode
// and stream schedules are kernels of their own, bitlinear_decode.cuh and
// bitlinear_stream.cuh (built as bitlinear_decode.cu and bitlinear_stream.cu,
// so nvcc builds the three in parallel), sharing their body through
// bitlinear_ring.cuh; the scalar helpers all three use are in
// bitlinear_common.cuh.
//
// Replaces the Pallas TPU kernels repro/kernels/bitlinear.py::bitlinear
// (grid _kernel) and ::bitlinear_grouped (_grouped_kernel).  The
// weight is stored per (row tile r, column tile c) as a bit-packed sign
// matrix M[r, c] in {-1,+1}^{tn x K} (uint8, LSB-first, kb = ceil(K/8)
// bytes per row) and a small real factor C[r, c] (K x td).  For every r, c:
//     z = x[:, r*tn:(r+1)*tn] @ M[r, c]          (f32; exact int32 for int8 x)
//     y[:, c*td:(c+1)*td] += z.to(C.dtype) @ C[r, c]      (f32 accumulation)
// and y is written once in x's dtype (int8: truncated toward zero and
// saturated, as the Pallas kernels' f32 -> int8 cast).
//
// Bit algebra (BITPLANE): unpack contracts x with the signs, z = sum +-x;
// bitplane forms z = 2 (x @ B) - s from the raw bits B = (M + 1) / 2 and the
// row sum s, one correction per (row, k) instead of a sign per element.
// For int8 x both are exact; for floats they round differently.
//
// What bounds it: bytes at small prefill T (C dominates: K*td elements per
// (r, c) tile, 1/8 of the dense weight at K/tn = 1/8); at prefill T the
// operations, on the tensor cores for bf16 x with bf16 C (the grid's mma
// body, below: K pads to 4 or 8 and 16/K' r tiles share one z @ C product)
// and on the f32 FMA pipes for every other call.  The FMA bodies keep as
// many independent (r, c) tiles in flight as the card holds:
//   * a block owns (expert e, column tile c) -- blockIdx.y = e * n_c + c,
//     all E experts in one launch, K3 is E = 1 -- and a row block of
//     row_block rows (block_t) in register groups of BT and a 32*NCOL column
//     chunk of it; x, M and C are read from device memory; its W warps take
//     the r tiles in chunks of rc
//     consecutive tiles, warp w the chunks w, w + W, ..., with no block
//     barrier inside the loop (the TPU's sequential "arbitrary" r axis
//     becomes this strided loop);
//   * per chunk a warp computes z for (tile, row, k) lane-parallel,
//     unpacking the sign bits in registers (no float M is materialised),
//     rounds z to C's dtype as the JAX kernel does and keeps it in its own
//     slice of shared memory -- the chunk's x and M loads are issued ahead
//     of their use by C; then lane l owns output columns l, l+32, ... and
//     accumulates z @ C into BT x NCOL f32 registers, C read coalesced;
//   * the W partial sums are added in warp order through shared memory
//     (deterministic), and y is written once.
// bf16 x with bf16 C above small_t rows runs bitlinear_mma_kernel instead
// (its own design note below).
// Ragged T is masked (rows >= T read zeros and are not written) and any K
// works (K % 8 != 0 included).  Every expert of a grouped call has the same
// T (the MoE dispatch layout pads each expert to its capacity).  wgmma and
// TMA for the grid are later work.
#pragma once

#include "bitlinear_common.cuh"

namespace bitlinear_impl {

// z = x[0:tn] @ M[:, k] for one row and one k (bit `bit` of byte `byte`)
template <typename XT, bool BITPLANE>
__device__ __forceinline__ typename Acc<XT>::type z_dot(const XT* xr, const uint8_t* m, int tn,
                                                       int kb, int byte, int bit) {
  using A = typename Acc<XT>::type;
  A z = 0, s = 0;
#pragma unroll 8
  for (int nn = 0; nn < tn; ++nn) {
    const A xv = ld(xr + nn);
    const bool set = (m[nn * kb + byte] >> bit) & 1;
    if (BITPLANE) {
      z += set ? xv : A(0);
      s += xv;
    } else {
      z += set ? xv : -xv;
    }
  }
  return BITPLANE ? A(2) * z - s : z;
}

// One chunk of nr consecutive r tiles for one warp.  xg points at row 0 of
// the register group and column r0*tn; tile j of M is m + j*m_stride and of
// C is cw + j*c_stride (device memory).
template <typename XT, typename CT, int BT, int NCOL, bool BITPLANE>
__device__ __forceinline__ void consume(const XT* xg, int x_stride, int rows, const uint8_t* m,
                                        size_t m_stride, const CT* cw, size_t c_stride, int nr,
                                        int tn, int kb, int K, int td, int d0, float* zbuf,
                                        float (&acc)[BT][NCOL], int lane) {
  const int per = BT * K;
  for (int p = lane; p < nr * per; p += 32) {
    const int j = p / per, q = p - j * per;
    const int t = q / K, k = q - t * K;
    float zc = 0.f;
    if (t < rows)
      zc = to_c<CT>(as_f32(z_dot<XT, BITPLANE>(xg + (size_t)t * x_stride + (size_t)j * tn,
                                               m + j * m_stride, tn, kb, k >> 3, k & 7)));
    zbuf[p] = zc;
  }
  __syncwarp();
  for (int j = 0; j < nr; ++j) {
    const CT* c = cw + j * c_stride;
    for (int k = 0; k < K; ++k) {
      float cv[NCOL];
#pragma unroll
      for (int jj = 0; jj < NCOL; ++jj) {
        const int d = d0 + jj * 32 + lane;
        cv[jj] = d < td ? ld(c + (size_t)k * td + d) : 0.f;
      }
#pragma unroll
      for (int t = 0; t < BT; ++t) {
        const float zt = zbuf[(j * BT + t) * K + k];
#pragma unroll
        for (int jj = 0; jj < NCOL; ++jj) acc[t][jj] += zt * cv[jj];
      }
    }
  }
  __syncwarp();
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Warps per block: 32 for register groups of 1 row, else 16 (the
// accumulators need the registers).
__host__ __device__ __forceinline__ int warps_for(int bt) { return bt <= 2 ? 32 : 16; }

template <typename XT, typename CT, int BT, int NCOL, bool BITPLANE>
__global__ void __launch_bounds__(BT <= 2 ? 1024 : 512)
    bitlinear_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ mp,
                     const CT* __restrict__ Cw, XT* __restrict__ y, int T, int n_r, int n_c,
                     int tn, int kb, int K, int td, int row_block, int rc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int e = blockIdx.y / n_c;                // expert (0 for K3)
  const int c = blockIdx.y - e * n_c;
  const int d_in = n_r * tn;
  const int d_out = n_c * td;
  const size_t m_tile = (size_t)tn * kb;         // bytes
  const size_t c_tile = (size_t)K * td;          // elements
  x += (size_t)e * T * d_in;
  mp += (size_t)e * n_r * n_c * m_tile;
  Cw += (size_t)e * n_r * n_c * c_tile;
  y += (size_t)e * T * d_out;

  // shared memory: [z buffers] [sums]
  float* zbuf = reinterpret_cast<float*>(smem) + (size_t)warp * rc * BT * K;
  float* sums = reinterpret_cast<float*>(smem) + (size_t)W * rc * BT * K;

  const int CW = 32 * NCOL;
  const int t_end = min(T, (int)(blockIdx.x + 1) * row_block);
  for (int d0 = blockIdx.z * CW; d0 < td; d0 += gridDim.z * CW) {
    for (int g = blockIdx.x * row_block; g < t_end; g += BT) {
      const int rows = min(BT, t_end - g);
      const XT* xg = x + (size_t)g * d_in;
      float acc[BT][NCOL];
#pragma unroll
      for (int t = 0; t < BT; ++t)
#pragma unroll
        for (int jj = 0; jj < NCOL; ++jj) acc[t][jj] = 0.f;

      for (int r0 = warp * rc; r0 < n_r; r0 += W * rc) {
        consume<XT, CT, BT, NCOL, BITPLANE>(
            xg + (size_t)r0 * tn, d_in, rows, mp + ((size_t)r0 * n_c + c) * m_tile,
            (size_t)n_c * m_tile, Cw + ((size_t)r0 * n_c + c) * c_tile, (size_t)n_c * c_tile,
            min(rc, n_r - r0), tn, kb, K, td, d0, zbuf, acc, lane);
      }

      // deterministic block reduction: warps add their partials in order
      for (int i = threadIdx.x; i < BT * CW; i += blockDim.x) sums[i] = 0.f;
      __syncthreads();
      for (int w = 0; w < W; ++w) {
        if (warp == w) {
#pragma unroll
          for (int t = 0; t < BT; ++t)
#pragma unroll
            for (int jj = 0; jj < NCOL; ++jj) sums[t * CW + jj * 32 + lane] += acc[t][jj];
        }
        __syncthreads();
      }
      for (int i = threadIdx.x; i < rows * CW; i += blockDim.x) {
        const int t = i / CW, dd = i - t * CW;
        const int d = d0 + dd;
        if (d < td) y[(size_t)(g + t) * d_out + (size_t)c * td + d] = store_y<XT>(sums[i]);
      }
      __syncthreads();   // sums are reused by the next group
    }
  }
}

// ---------------------------------------------------------------------------
// Grid schedule on the tensor cores: bf16 x and bf16 C
// ---------------------------------------------------------------------------
//
// y (16 rows x td) accumulates over r in two mma.sync products per warp:
//   z = x_r (16 x tn) @ M_r (tn x 8): m16n8k16 (m16n8k8 when tn % 16 != 0),
//       the B-fragment unpacked from M's bits in registers (unpack: +-1;
//       bitplane: {0,1}, and a second mma against ones gives the row sum s
//       for z = 2 zb - s); column n of the 8 holds k = n - off of the tile,
//       so with KP = 4 (K <= 4) two r tiles share one accumulator (offsets 0
//       and 4) and with KP = 8 (K <= 8) one tile fills it;
//   Z (16 x 16) = the z of GRP = 16 / KP consecutive r tiles, rounded to
//       bf16 in registers (z.astype(c.dtype)) and repacked as an A-fragment;
//   y += Z @ [C_r0; C_r1; ...] (16 x td): m16n8k16 against the stacked C
//       tiles, K rows each padded with zero rows to KP, staged in shared
//       memory and read with ldmatrix.trans.
// The first product has n = 8, so an x fragment feeds few mma: x is the
// traffic.  A block therefore owns rows_block rows of one expert and
// MMA_NCB column tiles, whose warps share each staged x tile, and one
// column chunk of CW = 16 * NTP columns of each: td padded up to a multiple
// of 16 with zero C columns, mma_ntp picking NTP so that the fewest chunks
// of at most MMA_MAX_NTP n-tile pairs cover it (td 128: one chunk of 128;
// 131: one of 144; 419: three of 144; 37: one of 48).  At NTP 9 the 72
// accumulators leave no registers for an unrolled z loop or for s (both
// spilled), so that instance rolls the loop over a half's tiles and folds
// -s / 2 into z's accumulator (an mma against -1/2; z = 2 (zb - s / 2) is
// 2 zb - s but for the f32 sums' order).  A block walks its rows in passes
// of 16 * mt rows (mt = min(MMA_ROW_TILES, ceil(T / 16)) row tiles); when T
// has fewer row tiles, rs = MMA_ROW_TILES / mt warps share each (row tile,
// column tile) and split every step's r tiles between them, their partial
// sums added in warp order at the end, through the stages' shared memory.
// Warp w owns row tile w % mt, column tile (w / mt) % MMA_NCB and r phase
// w / (mt * MMA_NCB).  Each step stages the x columns, M bits and stacked C
// of tiles_step = rs * u * GRP r tiles (u = ceil(r_chunk / GRP) z groups
// per warp) through cp.async into one of MMA_STAGES shared-memory stages,
// so the next step's copy is in flight while this one is consumed.
// C's rows ((r, c, k): td bf16 at ((r * n_c + c) * K + k) * td) start on a
// 16-byte boundary only when td % 8 == 0; then they are copied straight
// into each stage's padded layout that ldmatrix reads.  Otherwise (zamba2's
// 131, mamba2-130m's 419; the ODD instances) C is copied raw, in the
// 16-byte units that cover it from the boundary at or below its start --
// where one chunk covers td, each r tile's span of the block's MMA_NCB
// column tiles (K * td * MMA_NCB contiguous bf16), else each row's chunk --
// into one of MMA_STAGES - 1 raw slots; once it has landed, a block pass
// shifts every row into the one padded layout the step's warps read
// (repack_c: a warp per row, a lane per 4-byte word, byte-permuted by 2
// where the row starts 2 bytes off), and the next step's copies go out
// into the slot it emptied.  That is one more block barrier a step, and
// shared memory for one padded C and the raw slots instead of one padded C
// a stage (two would not fit at T <= 16, where 4 warps split each tile's
// r).  BITLINEAR_MMA_C_STAGING names the alternatives timed.  Rows past T,
// tiles past n_r, column tiles past n_c, C rows past K and C columns past
// td are zero-filled, so 0 x garbage never makes a NaN.  y is never stored
// past cw (a tile's padded columns are its neighbour's); at td % 8 != 0 it
// goes through shared memory and each row's columns of the block's tiles
// are stored by consecutive lanes, 4 bytes a lane from the first 4-byte
// boundary.  Consecutive blocks take consecutive column-tile blocks of one
// row block, sharing its x rows in L2.  The block's warps share each staged
// x tile (its MMA_NCB column-tile warps) and C tile (its row-tile warps),
// so a step ends in a block barrier.  (Staging per warp, with no barrier in
// the r loop, copied x and C once per warp and ran 2.6x slower at 8 warps:
// PERF.md.)
// What holds it back (H100, T = 4096, tools/torch_grid_variants.py): at
// td 128 (qwen3-32b's gate) the staging alone moves x and C at ~2.7 TB/s
// with one step in flight and takes as long as a dense bf16 matmul, and the
// mma work alone as long again (each warp unpacks M's bits and reloads C's
// fragments for only 16 rows); they overlap little.  At td 131 (zamba2's
// in_proj) the repack pass and its barrier add a third of the call, and
// the x restaged for each 144-column chunk more.  The constants below are
// the fastest of the block shapes timed at td 128; warp tiles of 32+ rows,
// wgmma and TMA are later work.
// Calls it takes: T > small_t (the launch's argument: kernels/bitlinear.py's
// SMALL_T, up to which the default rule decodes), K <= 8 (kb = 1),
// tn % 8 == 0, any td; x and C must be 16-byte and M and y 4-byte aligned
// (the wrapper clones a tensor that is not and allocates y; the launch
// refuses it).  Up to small_t rows the grid keeps the FMA body: its block is
// far smaller, so the rule's fallback to the grid, for a call whose decode
// block does not fit, still has one that does.  Every call with f32 or int8
// x or f32 C runs bitlinear_kernel's FMA body.

// The block shape, and BITLINEAR_MMA_VARIANT: 0 the kernel; the others are
// diagnostics that tools/torch_grid_variants.py builds with -D, as are
// other shapes: 1 staging only (no mma; y is 0), 2 mma only (no
// copies after the first stages, y wrong), 4 no repack_c pass (C stale, y
// wrong), 5 no store of y.  BITLINEAR_MMA_C_STAGING, for C at td % 8 != 0:
// 1 raw spans, 2 raw rows, always; 0 (as built) spans where one chunk
// covers td, else rows (a span holds every chunk's columns).
// BITLINEAR_MMA_MAX_NTP caps a column chunk at 16 * it columns.
#ifndef BITLINEAR_MMA_ROW_TILES
#define BITLINEAR_MMA_ROW_TILES 4
#endif
#ifndef BITLINEAR_MMA_NCB
#define BITLINEAR_MMA_NCB 4
#endif
#ifndef BITLINEAR_MMA_STAGES
#define BITLINEAR_MMA_STAGES 2
#endif
#ifndef BITLINEAR_MMA_MIN_BLOCKS
#define BITLINEAR_MMA_MIN_BLOCKS 1
#endif
#ifndef BITLINEAR_MMA_VARIANT
#define BITLINEAR_MMA_VARIANT 0
#endif
#ifndef BITLINEAR_MMA_C_STAGING
#define BITLINEAR_MMA_C_STAGING 0
#endif
#ifndef BITLINEAR_MMA_MAX_NTP
#define BITLINEAR_MMA_MAX_NTP 9
#endif
constexpr int MMA_STAGES = BITLINEAR_MMA_STAGES;
constexpr int MMA_ROW_TILES = BITLINEAR_MMA_ROW_TILES;   // row tiles (of 16) per pass
constexpr int MMA_NCB = BITLINEAR_MMA_NCB;               // column tiles per block
constexpr int MMA_WARPS = MMA_ROW_TILES * MMA_NCB;
constexpr int MMA_MIN_BLOCKS = BITLINEAR_MMA_MIN_BLOCKS; // resident blocks per SM for registers
constexpr int MMA_C_STAGING = BITLINEAR_MMA_C_STAGING;
constexpr int MMA_MAX_NTP = BITLINEAR_MMA_MAX_NTP;
static_assert(MMA_MAX_NTP >= 3 && MMA_MAX_NTP <= 9, "a chunk is 3 to 9 n-tile pairs");
static_assert(MMA_STAGES >= 2, "one stage in flight at least");

__host__ __device__ __forceinline__ bool grid_on_mma(int T, int small_t, int tn, int kb, int K,
                                                     int td, size_t xsize, size_t csize) {
  return T > small_t && xsize == 2 && csize == 2 && kb == 1 && K >= 1 && K <= 8 && tn > 0 &&
         tn % 8 == 0 && td > 0;
}

// NTP, the 16-column n-tile pairs of a column chunk: the fewest chunks of at
// most MMA_MAX_NTP pairs cover td padded to a multiple of 16, split evenly,
// and NTP is the smallest instantiated count (3, 4, 8, 9) that holds a share.
inline int mma_ntp(int td) {
  const int n16 = (td + 15) / 16;
  const int chunks = (n16 + MMA_MAX_NTP - 1) / MMA_MAX_NTP;
  const int need = (n16 + chunks - 1) / chunks;
  return need <= 3 ? 3 : need <= 4 ? 4 : need <= 8 ? 8 : 9;
}

// C's rows start on a 16-byte boundary (copied straight into the padded layout)
__host__ __device__ __forceinline__ bool c_rows_aligned(int td) { return td % 8 == 0; }

// n / d for 0 <= n < 2^31 by a multiply and a shift (d fixed per launch)
struct FastDiv {
  unsigned d, mul, shift;
};
inline FastDiv fast_div(unsigned d) {
  unsigned p = 0;
  while ((1u << p) < d) ++p;
  const unsigned long long two_p = 1ull << (31 + p);
  return {d, d == 1 ? 0u : (unsigned)((two_p + d - 1) / d), p == 0 ? 0u : p - 1};
}
__device__ __forceinline__ unsigned fdiv(unsigned n, const FastDiv& f) {
  return f.d == 1 ? n : __umulhi(n, f.mul) >> f.shift;
}
// v / span for 0 <= v < MMA_NCB * span
__device__ __forceinline__ int ncb_index(int v, int span) {
  int q = 0;
#pragma unroll
  for (int k = 1; k < MMA_NCB; ++k) q += v >= k * span;
  return q;
}

// The tensor-core grid's block geometry for T rows (see above).  Each of
// the MMA_STAGES stages holds [x rows][stacked C, padded][M bits]; where C's
// rows are unaligned (c_raw) a stage holds [x rows][M bits], and after the
// stages come one stacked C, padded, that repack_c fills for the step being
// consumed, and MMA_STAGES - 1 slots of raw C for the steps in flight (the
// next step's copies go out after repack_c, into the slot it emptied).
struct MmaGeom {
  int mt, rs, u, kp, grp, tiles_step, cw, xld, raw_ld, raw_chunks;
  bool c_raw;   // td % 8 != 0: C staged raw, then repack_c
  bool span;    // raw C as each r tile's span of the block's column tiles (else per row)
  size_t x_bytes, c_bytes, m_bytes, raw_bytes, stage, c_offset, raw_offset, smem;
};

inline MmaGeom mma_geom(int T, int tn, int K, int td, int r_chunk) {
  MmaGeom g;
  const int mtiles = (T + 15) / 16;
  g.mt = mtiles < MMA_ROW_TILES ? mtiles : MMA_ROW_TILES;
  g.rs = MMA_ROW_TILES / g.mt;
  g.kp = K <= 4 ? 4 : 8;
  g.grp = 16 / g.kp;
  g.u = (r_chunk + g.grp - 1) / g.grp;
  g.tiles_step = g.rs * g.u * g.grp;
  g.cw = 16 * mma_ntp(td);
  g.xld = g.tiles_step * tn + 8;   // padded row: 16-byte rows land in distinct banks
  g.x_bytes = align16((size_t)g.mt * 16 * g.xld * 2);
  const size_t c_rows = (size_t)MMA_NCB * g.rs * g.u * 16;
  g.c_bytes = align16(c_rows * (g.cw + 8) * 2);
  g.m_bytes = align16((size_t)MMA_NCB * g.tiles_step * tn);
  g.c_raw = !c_rows_aligned(td);
  g.span = g.c_raw && (MMA_C_STAGING == 1 || (MMA_C_STAGING == 0 && td <= g.cw));
  // raw C: the 16-byte units from the boundary at or below a row's (span's)
  // start that cover it, and room for the last word repack_c reads
  g.raw_ld = g.raw_chunks = 0;
  g.raw_bytes = 0;
  if (g.span) {
    g.raw_chunks = (int)(align16((size_t)MMA_NCB * K * td * 2 + 14) / 16);
    g.raw_ld = 16 * (g.raw_chunks + 2);
    g.raw_bytes = (size_t)g.tiles_step * g.raw_ld;
  } else if (g.c_raw) {
    g.raw_chunks = g.cw / 8 + 1;   // covers 14 + 2 cw bytes
    g.raw_ld = 16 * (g.raw_chunks + 1);
    g.raw_bytes = c_rows * g.raw_ld;
  }
  g.stage = g.x_bytes + g.m_bytes + (g.c_raw ? 0 : g.c_bytes);
  g.c_offset = g.c_raw ? MMA_STAGES * g.stage : g.x_bytes;   // absolute, or within a stage
  g.raw_offset = g.c_offset + g.c_bytes;
  const size_t stages =
      MMA_STAGES * g.stage + (g.c_raw ? g.c_bytes + (MMA_STAGES - 1) * g.raw_bytes : 0);
  // the partial sums of warps sharing a tile, then (td % 8 != 0) the
  // block's y rows, reuse the stages after the r loop
  const size_t red = (size_t)(g.rs - 1) * g.mt * MMA_NCB * 16 * g.cw * 4;
  const size_t ys = c_rows_aligned(td) ? 0 : (size_t)g.mt * 16 * (MMA_NCB * g.cw + 8) * 2;
  g.smem = stages > red ? stages : red;
  g.smem = g.smem > ys ? g.smem : ys;
  return g;
}

struct MmaParams {
  int T, n_r, n_c, tn, K, td, rows_block, n_cb, mt, rs, u, xld;
  int m_offset, c_offset, raw_offset, raw_bytes, raw_ld, stage_bytes;
  bool span;   // MmaGeom's
  // 16-byte x chunks per row, tn / 8, C chunks per row (raw: per row or
  // span), tn / 4
  FastDiv xrow, tn8, crow, mrow;
};

// src_bytes 0 zero-fills the destination
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_stages() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(MMA_STAGES - 2) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d (16x8 f32) += a (16x16 bf16, row) . b (16x8 bf16, col)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d (16x8 f32) += a (16x8 bf16, row) . b (8x8 bf16, col)
__device__ __forceinline__ void mma1688(float (&d)[4], const uint32_t (&a)[2], uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b0));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two bf16 of M's column at tile rows (nn, nn + 1), the bytes at p (bit:
// that column's mask): unpack +-1, bitplane {0, 1}; 0 when this lane's
// column is not the tile's.
template <bool BITPLANE>
__device__ __forceinline__ uint32_t m_pair(const uint8_t* p, bool mine, uint32_t bit) {
  const uint32_t two = *reinterpret_cast<const uint16_t*>(p);
  if (!mine) return 0u;
  const uint32_t off = BITPLANE ? 0u : 0xBF80u;   // bit clear: 0 or -1
  const uint32_t on = 0x3F80u;                     // bit set: +1
  return ((two & bit) ? on : off) | ((two & (bit << 8)) ? on << 16 : off << 16);
}

// ODD: td % 8 != 0 (C's rows unaligned: c_rows_aligned), an instance of
// its own, so that the aligned calls' code carries none of the raw staging
// or y through shared memory (with it, qwen's td 128 calls ran 5-10%
// slower: tools/torch_grid_variants.py --parent)
template <int KSTEP, int NTP, int KP, bool BITPLANE, bool ODD>
__global__ void __launch_bounds__(MMA_WARPS * 32, MMA_MIN_BLOCKS)
    bitlinear_mma_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ mp,
                         const __nv_bfloat16* __restrict__ Cw, __nv_bfloat16* __restrict__ y,
                         const MmaParams a) {
  constexpr int GRP = 16 / KP;       // r tiles per Z fragment
  constexpr int PER_HALF = 8 / KP;   // r tiles per 8-column half of Z
  constexpr int CW = 16 * NTP;       // columns per block and column tile
  constexpr int CLD = CW + 8;        // padded C row
  constexpr int NT = 2 * NTP;        // n-tiles of 8 columns
  // 72 accumulators leave no registers for an unrolled z loop or a
  // separate row-sum accumulator (they spilled): NTP 9 rolls the loop over
  // a half's tiles and folds s into z's accumulator
  constexpr bool LEAN = NTP == 9;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int tn = a.tn, K = a.K, td = a.td, n_r = a.n_r, n_c = a.n_c, xld = a.xld;
  const int mt = a.mt, rs = a.rs, u = a.u;

  const int rb = blockIdx.x / a.n_cb, cb = blockIdx.x - rb * a.n_cb;   // row, column-tile block
  const int e = blockIdx.y;
  const int d_in = n_r * tn, d_out = n_c * td;
  const int d0 = blockIdx.z * CW;
  const int cw = min(CW, td - d0);
  x += (size_t)e * a.T * d_in;
  mp += (size_t)e * n_r * n_c * tn;
  Cw += (size_t)e * n_r * n_c * K * td;
  y += (size_t)e * a.T * d_out;

  const int P = 16 * mt;
  const int tiles_step = rs * u * GRP;
  const int groups_step = rs * u;
  const int nsteps = (n_r + tiles_step - 1) / tiles_step;
  const int m_tile = warp % mt, cq = (warp / mt) % MMA_NCB, ph = warp / (mt * MMA_NCB);
  const int c = cb * MMA_NCB + cq;   // this warp's column tile (idle past n_c)
  float* red = reinterpret_cast<float*>(smem);   // after the r loop: partial sums
  const uint32_t ones = 0x3F803F80u;     // two bf16 1.0
  const uint32_t halves = 0xBF00BF00u;   // two bf16 -0.5

  // stacked C row rr of a step from tile0: its tile (r, cc) and row k; false
  // for a row that is zero (k >= K, r >= n_r, cc >= n_c)
  auto c_row = [&](int rr, int tile0, int& r, int& cc, int& k, int& cqi) {
    const int kz = rr & 15, j = kz / KP;
    k = kz - j * KP;
    cqi = ncb_index(rr, groups_step * 16);
    cc = cb * MMA_NCB + cqi;
    r = tile0 + ((rr >> 4) - cqi * groups_step) * GRP + j;
    return k < K && r < n_r && cc < n_c;
  };

  const int row_end = min(a.T, (rb + 1) * a.rows_block);
  for (int row0 = rb * a.rows_block; row0 < row_end; row0 += P) {
    // step s's x columns and M bits into stage st, its stacked C there too
    // (ODD: raw into its slot)
    auto issue = [&](int s, int st) {
      unsigned char* base = smem + (size_t)st * a.stage_bytes;
      __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(base);
      __nv_bfloat16* cs = reinterpret_cast<__nv_bfloat16*>(base + a.c_offset);
      uint8_t* ms = base + a.m_offset;
      const int tile0 = s * tiles_step;
      const int xrow = a.xrow.d;
      for (int i = threadIdx.x; i < P * xrow; i += blockDim.x) {
        const int r = fdiv(i, a.xrow), c8 = i - r * xrow;
        const int row = row0 + r;
        const bool in = row < row_end && tile0 + (int)fdiv(c8, a.tn8) < n_r;
        cp_async16_zfill(xs + r * xld + c8 * 8,
                         x + (in ? (size_t)row * d_in + (size_t)tile0 * tn + c8 * 8 : 0),
                         in ? 16 : 0);
      }
      const int crow = a.crow.d;
      if (!ODD) {   // aligned rows: straight into the padded layout
        for (int i = threadIdx.x; i < MMA_NCB * groups_step * 16 * crow; i += blockDim.x) {
          const int rr = fdiv(i, a.crow), c8 = i - rr * crow;
          int r, cc, k, cqi;
          const bool in = c_row(rr, tile0, r, cc, k, cqi) && d0 + c8 * 8 < td;
          cp_async16_zfill(cs + rr * CLD + c8 * 8,
                           Cw + (in ? (((size_t)r * n_c + cc) * K + k) * td + d0 + c8 * 8 : 0),
                           in ? 16 : 0);
        }
      } else {
        // raw, in 16-byte units from the boundary at or below each span's
        // (row's) start, never past this expert's C
        unsigned char* raw = smem + a.raw_offset + (size_t)(s % (MMA_STAGES - 1)) * a.raw_bytes;
        const unsigned char* c_end =
            reinterpret_cast<const unsigned char*>(Cw + (size_t)n_r * n_c * K * td);
        const int ncols = min(MMA_NCB, n_c - cb * MMA_NCB);
        const int units = a.span ? tiles_step * crow : MMA_NCB * groups_step * 16 * crow;
        for (int i = threadIdx.x; i < units; i += blockDim.x) {
          const int q = fdiv(i, a.crow), c16 = i - q * crow;   // span (r tile) or row
          const unsigned char* src;
          int len;
          if (a.span) {
            if (tile0 + q >= n_r) continue;
            src = reinterpret_cast<const unsigned char*>(
                Cw + ((size_t)(tile0 + q) * n_c + cb * MMA_NCB) * K * td);
            len = 2 * ncols * K * td;
          } else {
            int r, cc, k, cqi;
            if (!c_row(q, tile0, r, cc, k, cqi)) continue;
            src = reinterpret_cast<const unsigned char*>(
                Cw + (((size_t)r * n_c + cc) * K + k) * td + d0);
            len = 2 * cw;
          }
          const int lead = (int)(reinterpret_cast<uintptr_t>(src) & 15);
          if (c16 * 16 >= lead + len) continue;
          src += c16 * 16 - lead;
          cp_async16_zfill(raw + (size_t)q * a.raw_ld + c16 * 16, src,
                           (int)min(16LL, (long long)(c_end - src)));
        }
      }
      const int mrow = a.mrow.d;
      for (int i = threadIdx.x; i < MMA_NCB * tiles_step * mrow; i += blockDim.x) {
        const int jt = fdiv(i, a.mrow), b4 = i - jt * mrow;
        const int cqi = ncb_index(jt, tiles_step);
        const int cc = cb * MMA_NCB + cqi, tl = jt - cqi * tiles_step;
        const bool in = tile0 + tl < n_r && cc < n_c;
        cp_async4_zfill(ms + jt * tn + b4 * 4,
                        mp + (in ? ((size_t)(tile0 + tl) * n_c + cc) * tn + b4 * 4 : 0),
                        in ? 4 : 0);
      }
    };
    // ODD: step s's raw C (landed in its slot) shifted into the block's
    // padded layout, columns past cw and zero rows zero-filled: a warp per
    // row, a lane per 4-byte word (two columns), byte-permuted by 2 where
    // the row starts 2 bytes off
    auto repack_c = [&](int s) {
      uint32_t* cs = reinterpret_cast<uint32_t*>(smem + a.c_offset);
      const int raw = a.raw_offset + (s % (MMA_STAGES - 1)) * a.raw_bytes;
      const int tile0 = s * tiles_step;
      for (int rr = warp; rr < MMA_NCB * groups_step * 16; rr += blockDim.x >> 5) {
        int r, cc, k, cqi, src = 0, b = 0;   // the row's columns at byte b of smem + src
        const bool in = c_row(rr, tile0, r, cc, k, cqi);
        if (in && a.span) {
          const uintptr_t span =
              reinterpret_cast<uintptr_t>(Cw + ((size_t)r * n_c + cb * MMA_NCB) * K * td);
          b = (int)(span & 15) + 2 * ((cqi * K + k) * td + d0);
          src = raw + (r - tile0) * a.raw_ld;
        } else if (in) {
          b = (int)(reinterpret_cast<uintptr_t>(Cw + (((size_t)r * n_c + cc) * K + k) * td + d0) &
                    15);
          src = raw + rr * a.raw_ld;
        }
#pragma unroll 1
        for (int w = lane; w < CW / 2; w += 32) {
          uint32_t v = 0u;
          if (in && 2 * w < cw) {
            const int bb = src + b + 4 * w;   // the byte of column 2w
            const uint32_t* p = reinterpret_cast<const uint32_t*>(smem + (bb & ~3));
            v = (bb & 2) ? __byte_perm(p[0], p[1], 0x5432) : p[0];
            if (2 * w + 1 >= cw) v &= 0xFFFFu;
          }
          cs[rr * (CLD / 2) + w] = v;
        }
      }
    };

    float yacc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) yacc[n][i] = 0.f;

    __syncthreads();   // the previous pass is done with every stage and with red
#pragma unroll
    for (int s = 0; s < MMA_STAGES - 1; ++s) {
      if (s < nsteps) issue(s, s);
      cp_async_commit();
    }
    for (int s = 0; s < nsteps; ++s) {
      cp_async_wait_stages();   // step s has landed (this thread's copies)
      __syncthreads();          // ... every thread's; step s-1's stage (and C) is free
      if (ODD && BITLINEAR_MMA_VARIANT != 4) {
        repack_c(s);
        __syncthreads();        // step s's C is whole; its raw slot is free
      }
      const int ahead = s + MMA_STAGES - 1;
      if (ahead < nsteps && (BITLINEAR_MMA_VARIANT != 2 || ahead < MMA_STAGES))
        issue(ahead, ahead % MMA_STAGES);
      cp_async_commit();
      if (c >= n_c || BITLINEAR_MMA_VARIANT == 1) continue;
      // this warp's x rows, stacked C and M bits
      const unsigned char* base = smem + (size_t)(s % MMA_STAGES) * a.stage_bytes;
      const __nv_bfloat16* xw = reinterpret_cast<const __nv_bfloat16*>(base) + (size_t)m_tile * 16 * xld;
      const __nv_bfloat16* cs =
          reinterpret_cast<const __nv_bfloat16*>((ODD ? smem : base) + a.c_offset) +
          (size_t)cq * groups_step * 16 * CLD;
      const uint8_t* ms = base + a.m_offset + (size_t)cq * tiles_step * tn;
      for (int uu = 0; uu < u; ++uu) {
        const int q = ph * u + uu;            // this warp's z group in the step
        const int tq = q * GRP;               // its first tile in the step
        if (s * tiles_step + tq >= n_r) break;
        float zacc[2][4], sacc[2][4];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int i = 0; i < 4; ++i) zacc[hh][i] = sacc[hh][i] = 0.f;
        // z of tile j (of the group) into za, its half of Z, and its row sum
        // into sa (LEAN: -s / 2 into za)
        auto z_tile = [&](int j, float(&za)[4], float(&sa)[4]) {
          const int off = (j % PER_HALF) * KP;
          const bool mine = g >= off && g < off + K;
          const uint32_t bit = 1u << (mine ? g - off : 0);
          const uint8_t* mbits = ms + (tq + j) * tn;
          const __nv_bfloat16* xt = xw + (tq + j) * tn;
          const uint32_t o = mine ? (LEAN ? halves : ones) : 0u;
          for (int ks = 0; ks < tn / KSTEP; ++ks) {
            if (KSTEP == 16) {
              uint32_t af[4];
              ldmatrix_x4(af, xt + (lane & 15) * xld + ks * 16 + ((lane >> 4) << 3));
              const uint32_t b0 = m_pair<BITPLANE>(mbits + ks * 16 + 2 * t4, mine, bit);
              const uint32_t b1 = m_pair<BITPLANE>(mbits + ks * 16 + 8 + 2 * t4, mine, bit);
              mma16816(za, af, b0, b1);
              if (BITPLANE) mma16816(sa, af, o, o);
            } else {
              uint32_t af[2];
              ldmatrix_x2(af, xt + (lane & 15) * xld + ks * 8);
              mma1688(za, af, m_pair<BITPLANE>(mbits + ks * 8 + 2 * t4, mine, bit));
              if (BITPLANE) mma1688(sa, af, o);
            }
          }
        };
        if (LEAN) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
#pragma unroll 1
            for (int jj = 0; jj < PER_HALF; ++jj) {
              if (s * tiles_step + tq + hh * PER_HALF + jj >= n_r) break;
              z_tile(hh * PER_HALF + jj, zacc[hh], zacc[hh]);
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < GRP; ++j)
            if (s * tiles_step + tq + j < n_r) z_tile(j, zacc[j / PER_HALF], sacc[j / PER_HALF]);
        }
        if (BITPLANE) {   // z = 2 zb - s (LEAN: s / 2 already taken from zb)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              zacc[hh][i] = LEAN ? 2.f * zacc[hh][i] : 2.f * zacc[hh][i] - sacc[hh][i];
        }
        // z rounded to C's dtype, as the A-fragment of Z (16 x 16)
        const uint32_t za[4] = {pack_bf16(zacc[0][0], zacc[0][1]),
                                pack_bf16(zacc[0][2], zacc[0][3]),
                                pack_bf16(zacc[1][0], zacc[1][1]),
                                pack_bf16(zacc[1][2], zacc[1][3])};
        const __nv_bfloat16* ct = cs + (size_t)q * 16 * CLD;
#pragma unroll
        for (int p = 0; p < NTP; ++p) {
          if (p * 16 < cw) {
            uint32_t bf[4];
            ldmatrix_x4_trans(bf, ct + ((lane & 7) + (((lane >> 3) & 1) << 3)) * CLD + p * 16 +
                                      ((lane >> 4) << 3));
            mma16816(yacc[2 * p], za, bf[0], bf[1]);
            mma16816(yacc[2 * p + 1], za, bf[2], bf[3]);
          }
        }
      }
    }
    cp_async_wait0();

    // warps sharing a (row tile, column tile) add their partial sums in warp order
    const int slot = cq * mt + m_tile;
    if (rs > 1) {
      __syncthreads();   // every warp is done with the stages red reuses
      if (ph > 0) {
        float* dst = red + (size_t)((ph - 1) * mt * MMA_NCB + slot) * NT * 4 * 32;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) dst[(n * 4 + i) * 32 + lane] = yacc[n][i];
      }
      __syncthreads();
      if (ph == 0) {
        for (int p2 = 1; p2 < rs; ++p2) {
          const float* src = red + (size_t)((p2 - 1) * mt * MMA_NCB + slot) * NT * 4 * 32;
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) yacc[n][i] += src[(n * 4 + i) * 32 + lane];
        }
      }
    }
    if (ODD) {
      // y through shared memory, then each row's columns of the block's
      // tiles stored by consecutive lanes (the tiles are one run of a row
      // where one chunk covers td): a warp's fragments alone would be
      // 16-byte pieces of 8 rows, 2-byte stores where a pair is not 4-byte
      // aligned
      constexpr int YLD = MMA_NCB * CW + 8;   // padded: the 8 rows g of a store in distinct banks
      __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(smem);
      __syncthreads();   // every warp is done with the stages and red
      if (ph == 0 && c < n_c) {
        __nv_bfloat16* yw = ys + (m_tile * 16 + g) * YLD + cq * CW + 2 * t4;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          *reinterpret_cast<__nv_bfloat162*>(yw + n * 8) =
              __floats2bfloat162_rn(yacc[n][0], yacc[n][1]);
          *reinterpret_cast<__nv_bfloat162*>(yw + 8 * YLD + n * 8) =
              __floats2bfloat162_rn(yacc[n][2], yacc[n][3]);
        }
      }
      __syncthreads();
      const int ncols = min(MMA_NCB, n_c - cb * MMA_NCB);
      const int rows = min(P, row_end - row0);
      const bool whole = cw == td;
      const int run = whole ? ncols * td : cw, runs = whole ? 1 : ncols;
      for (int q = warp; q < rows * runs && BITLINEAR_MMA_VARIANT != 5; q += blockDim.x >> 5) {
        const int r = q / runs, sq = q - r * runs;
        const __nv_bfloat16* yr = ys + r * YLD + sq * CW;
        // element e of the run: past a tile's td columns lie its padded ones
        auto at = [&](int e) { return yr[whole ? e + ncb_index(e, td) * (CW - td) : e]; };
        __nv_bfloat16* dst = y + (size_t)(row0 + r) * d_out + (size_t)(cb * MMA_NCB + sq) * td + d0;
        const int lead = (int)((reinterpret_cast<uintptr_t>(dst) >> 1) & 1);   // 2 bytes off
        if (lane == 0 && lead) dst[0] = at(0);
        for (int e = lead + 2 * lane; e + 1 < run; e += 64) {
          __nv_bfloat162 v;
          v.x = at(e);
          v.y = at(e + 1);
          *reinterpret_cast<__nv_bfloat162*>(dst + e) = v;
        }
        if (lane == 0 && (run - lead) % 2) dst[run - 1] = at(run - 1);
      }
    } else if (ph == 0 && c < n_c && BITLINEAR_MMA_VARIANT != 5) {
      const int ra = row0 + m_tile * 16 + g, rb_ = ra + 8;
      __nv_bfloat16* yc = y + (size_t)c * td + d0 + 2 * t4;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (n * 8 < cw) {
          if (ra < row_end)
            *reinterpret_cast<__nv_bfloat162*>(yc + (size_t)ra * d_out + n * 8) =
                __floats2bfloat162_rn(yacc[n][0], yacc[n][1]);
          if (rb_ < row_end)
            *reinterpret_cast<__nv_bfloat162*>(yc + (size_t)rb_ * d_out + n * 8) =
                __floats2bfloat162_rn(yacc[n][2], yacc[n][3]);
        }
      }
    }
  }
}

struct Args {
  const void* x;
  const uint8_t* mp;
  const void* C;
  void* y;
  int E, T, n_r, n_c, tn, kb, K, td, block_t, rc;
  size_t smem;  // dynamic shared memory of one block (block_smem)
  cudaStream_t stream;
};

// The rows of one register group: 1 for a single row, else 8.
inline int group_rows(int T) { return T == 1 ? 1 : 8; }

// Columns per lane: one 32-column chunk for narrow C tiles, else four.
inline int ncol_for(int td) { return td <= 32 ? 1 : 4; }

// Dynamic shared memory of one grid block, the layout bitlinear_kernel
// carves: [each warp's z buffer] [block sums]; the tensor-core body's is
// mma_geom's.  The one definition of it: the launch checks it against the
// budget, and bitlinear_smem_bytes (bitlinear.cu) hands it to the Python
// side for admission.
inline size_t block_smem(int T, int tn, int kb, int K, int td, int r_chunk, size_t xsize,
                         size_t csize, int small_t) {
  if (grid_on_mma(T, small_t, tn, kb, K, td, xsize, csize))
    return mma_geom(T, tn, K, td, r_chunk).smem;
  const int bt = group_rows(T);
  const size_t W = warps_for(bt);
  const size_t rc = r_chunk;
  return W * rc * bt * K * 4 + (size_t)bt * 32 * ncol_for(td) * 4;
}

template <typename XT, typename CT, int BT, int NCOL, bool BP>
cudaError_t launch_cfg(const Args& a) {
  const int W = warps_for(BT);
  const int CW = 32 * NCOL;
  const int row_block = BT == 1 ? 1 : a.block_t;
  const dim3 grid((a.T + row_block - 1) / row_block, a.E * a.n_c, (a.td + CW - 1) / CW);
  if (a.smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(bitlinear_kernel<XT, CT, BT, NCOL, BP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)a.smem);
    if (err != cudaSuccess) return err;
  }
  bitlinear_kernel<XT, CT, BT, NCOL, BP><<<grid, W * 32, a.smem, a.stream>>>(
      static_cast<const XT*>(a.x), a.mp, static_cast<const CT*>(a.C), static_cast<XT*>(a.y), a.T,
      a.n_r, a.n_c, a.tn, a.kb, a.K, a.td, row_block, a.rc);
  return cudaGetLastError();
}

template <typename XT, typename CT, int BT, bool BP>
cudaError_t launch_ncol(const Args& a) {
  if (ncol_for(a.td) == 1) return launch_cfg<XT, CT, BT, 1, BP>(a);
  return launch_cfg<XT, CT, BT, 4, BP>(a);
}

template <typename XT, typename CT, bool BP>
cudaError_t launch_bt(const Args& a) {
  return group_rows(a.T) == 1 ? launch_ncol<XT, CT, 1, BP>(a) : launch_ncol<XT, CT, 8, BP>(a);
}

template <int KSTEP, int NTP, int KP, bool BP, bool ODD>
cudaError_t launch_mma_cfg(const Args& a) {
  const MmaGeom g = mma_geom(a.T, a.tn, a.K, a.td, a.rc);
  const int P = 16 * g.mt;
  MmaParams p;
  p.T = a.T;
  p.n_r = a.n_r;
  p.n_c = a.n_c;
  p.tn = a.tn;
  p.K = a.K;
  p.td = a.td;
  p.rows_block = P * ((a.block_t + P - 1) / P);   // block_t rounded up to whole passes
  const int n_rb = (a.T + p.rows_block - 1) / p.rows_block;
  p.n_cb = (a.n_c + MMA_NCB - 1) / MMA_NCB;
  p.mt = g.mt;
  p.rs = g.rs;
  p.u = g.u;
  p.xld = g.xld;
  p.m_offset = (int)(g.x_bytes + (g.c_raw ? 0 : g.c_bytes));
  p.c_offset = (int)g.c_offset;
  p.raw_offset = (int)g.raw_offset;
  p.raw_bytes = (int)g.raw_bytes;
  p.raw_ld = g.raw_ld;
  p.stage_bytes = (int)g.stage;
  p.span = g.span;
  p.xrow = fast_div(g.tiles_step * a.tn / 8);
  p.tn8 = fast_div(a.tn / 8);
  p.crow = fast_div(g.c_raw ? g.raw_chunks : (min(g.cw, a.td) + 7) / 8);
  p.mrow = fast_div(a.tn / 4);
  if ((long long)n_rb * p.n_cb > 0x7fffffffLL || a.E > 65535)
    return cudaErrorInvalidConfiguration;
  const dim3 grid(n_rb * p.n_cb, a.E, (a.td + g.cw - 1) / g.cw);
  if (a.smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(bitlinear_mma_kernel<KSTEP, NTP, KP, BP, ODD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)a.smem);
    if (err != cudaSuccess) return err;
  }
  bitlinear_mma_kernel<KSTEP, NTP, KP, BP, ODD><<<grid, g.mt * MMA_NCB * g.rs * 32, a.smem,
                                                  a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.x), a.mp, static_cast<const __nv_bfloat16*>(a.C),
      static_cast<__nv_bfloat16*>(a.y), p);
  return cudaGetLastError();
}

template <int KSTEP, int NTP, bool BP, bool ODD>
cudaError_t launch_mma_kp(const Args& a) {
  return a.K <= 4 ? launch_mma_cfg<KSTEP, NTP, 4, BP, ODD>(a)
                  : launch_mma_cfg<KSTEP, NTP, 8, BP, ODD>(a);
}

template <int KSTEP, bool BP, bool ODD>
cudaError_t launch_mma_ntp(const Args& a) {
  switch (mma_ntp(a.td)) {
    case 3:
      return launch_mma_kp<KSTEP, 3, BP, ODD>(a);
    case 4:
      return launch_mma_kp<KSTEP, 4, BP, ODD>(a);
    case 8:
      return launch_mma_kp<KSTEP, 8, BP, ODD>(a);
    default:
      return launch_mma_kp<KSTEP, 9, BP, ODD>(a);
  }
}

template <bool BP, bool ODD>
cudaError_t launch_mma_odd(const Args& a) {
  return a.tn % 16 == 0 ? launch_mma_ntp<16, BP, ODD>(a) : launch_mma_ntp<8, BP, ODD>(a);
}

template <bool BP>
cudaError_t launch_mma(const Args& a) {
  return c_rows_aligned(a.td) ? launch_mma_odd<BP, false>(a) : launch_mma_odd<BP, true>(a);
}

template <typename XT, typename CT>
cudaError_t launch_math(const Args& a, int bitplane) {
  return bitplane ? launch_bt<XT, CT, true>(a) : launch_bt<XT, CT, false>(a);
}

template <typename XT>
cudaError_t launch_c(const Args& a, int c_bf16, int bitplane) {
  return c_bf16 ? launch_math<XT, __nv_bfloat16>(a, bitplane)
                : launch_math<XT, float>(a, bitplane);
}

// x_kind: 0 float32, 1 bfloat16, 2 int8 (y in x's dtype); c_bf16: C is
// bfloat16 (else float32).  All pointers contiguous device memory.  small_t:
// the grid runs the FMA body up to that many rows (grid_on_mma);
// *tensor_cores is set to whether the launch took bitlinear_mma_kernel.
// Returns a cudaError_t, or minus the block's shared memory in bytes when
// that is over smem_budget (nothing is launched then).
inline int dispatch(const void* x, const uint8_t* mp, const void* C, void* y, int E, int T, int n_r,
             int n_c, int tn, int kb, int K, int td, int x_kind, int c_bf16, int bitplane,
             int block_t, int r_chunk, int smem_budget, int small_t, void* stream,
             int* tensor_cores) {
  *tensor_cores = 0;
  if (T <= 0 || E <= 0) return cudaSuccess;
  if ((long long)E * n_c > 65535) return cudaErrorInvalidConfiguration;  // gridDim.y
  if (block_t < 1 || r_chunk < 1 || x_kind < 0 || x_kind > 2) return cudaErrorInvalidValue;
  const int rc = r_chunk;
  const size_t xs = x_size(x_kind), cs = c_bf16 ? 2 : 4;
  const bool mma = grid_on_mma(T, small_t, tn, kb, K, td, xs, cs);
  // the tensor-core grid copies x and C in 16-byte and M in 4-byte units
  // and stores y in 4-byte pairs of columns from the first 4-byte boundary
  if (mma && (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(C) % 16 ||
              reinterpret_cast<uintptr_t>(mp) % 4 || reinterpret_cast<uintptr_t>(y) % 4))
    return cudaErrorMisalignedAddress;
  const size_t smem = block_smem(T, tn, kb, K, td, rc, xs, cs, small_t);
  if (smem > (size_t)smem_budget) return -(int)(smem < 0x7fffffff ? smem : 0x7fffffff);
  const Args a{x, mp, C, y, E, T, n_r, n_c, tn, kb, K, td, block_t,
               rc, smem, reinterpret_cast<cudaStream_t>(stream)};
  if (mma) {
    *tensor_cores = 1;
    return bitplane ? launch_mma<true>(a) : launch_mma<false>(a);
  }
  switch (x_kind) {
    case 0:
      return launch_c<float>(a, c_bf16, bitplane);
    case 1:
      return launch_c<__nv_bfloat16>(a, c_bf16, bitplane);
    default:
      return launch_c<int8_t>(a, c_bf16, bitplane);
  }
}

}  // namespace bitlinear_impl
