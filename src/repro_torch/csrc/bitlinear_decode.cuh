// Decode schedule of kernels K3 and K4: y_e = (x_e @ M_e) @ C_e for E >= 1
// experts at decode-sized T, one kernel of its own, bitlinear_decode_kernel.
//
// Replaces the Pallas TPU kernels repro/kernels/bitlinear.py::_decode_kernel
// (K3, call site :369) and ::_grouped_decode_kernel (K4, :536).  It computes
// what bitlinear.cuh's note says (z rounded to C's dtype before z @ C, f32
// accumulation, the unpack and bitplane algebras, f32/bf16/int8 x, f32/bf16
// C, any K and T, int8 output truncated toward zero and saturated).
//
// What bounds it: bytes.  At T <= 4 a (r, c) tile costs ~2 T K td operations
// per 2 K td bytes of bf16 C, far below the ~295 operations per byte where
// the tensor cores would matter, so the body stays on the FMA pipes and the
// design is about keeping the card's 3.35 TB/s busy:
//   * a block owns one column tile c of one expert e, and r is split across
//     the S blocks of a thread-block cluster: the launch is grid(S, E * n_c,
//     column chunks) with cluster dims (S, 1, 1), block s taking a
//     contiguous range of about n_r / S r tiles.  S is the host's rule
//     (kernels/bitlinear.py::decode_cluster_size: the most blocks that run
//     in one wave, three per SM, but at least 32 r tiles a block; S <= 8,
//     or 16 where that still fills less than a wave; its caps are defined
//     there only), passed to the launch, which allows non-portable sizes
//     (above 8).  Each block's partial y stays in its shared memory; after
//     a cluster barrier rank 0 adds the ranks' partials in rank order
//     through distributed shared memory and writes y, so sums run in a
//     fixed order and two launches give the same bits.
//   * a producer warp streams the block's tiles into a ring of DEC_STAGES
//     shared-memory stages with 1D bulk copies (cp.async.bulk ...
//     mbarrier::complete_tx, TMA without a tensor map), full and empty
//     mbarriers per stage.  A stage holds rs consecutive r tiles: their C
//     tiles (K td contiguous elements each, one copy each), M tiles (tn kb
//     contiguous bytes) and the T rows of x over their rs tn columns (one
//     copy a row).  The block's shared memory grows with T, K and td, never
//     with d_in.  A part whose tiles are not a multiple of 16 bytes (the BBO
//     tensors' 8-byte M tiles, tn = 8, K = 3), or a C wider than one column
//     chunk, is not staged: the consumers read it from device memory with
//     the widest load that fits; except C below:
//   * C tiles that span two column chunks, up to DEC_RAW_COLS x 32 columns
//     (zamba2's in_proj, td 131: 1,048-byte bf16 tiles, read one element a
//     load from device memory before, by two sets of blocks, one of them
//     for 3 columns): at T <= 4, each r tile's C is copied raw, from the 16-byte
//     boundary at or below its start, by one bulk copy rounded up to 16
//     bytes, into a ring slot of its own (c_slot), and the consumers read
//     it at the tile's offset.  One block covers all td columns against
//     the z it computed once: lane l owns the columns l, l + 32, ..., l +
//     128, so each of its 2- or 4-byte loads of the unaligned rows is one
//     conflict-free access of the warp (RAW instances, V = DEC_RAW_COLS).
//     The stage's split among the warps (rs, batch) stays the one the
//     other parts give, so every warp sums the same r tiles in the same
//     order and the bits do not change.  Wider odd tiles (mamba2-130m's
//     td 419) keep one set of blocks per 128-column chunk: one block over
//     its four chunks ran 1.6x slower than those 32 blocks (PERF.md).
//   * DEC_WARPS = 4 consumer warps read every stage, warp w its w-th quarter
//     of the stage's r tiles, and accumulate their partial y in registers.
//     z for its tiles is lane-parallel: lane (tile, pair of k, slice) loads
//     one 16-byte slice of x for all BT rows of a register group and the M
//     bytes of the slice's rows, decodes each bit once into a +-1 (or 0/1)
//     factor for the BT rows (one FMA each), and the lanes of a (tile, pair)
//     add their partials with xor shuffles; z goes through a per-warp shared
//     buffer.  In z @ C
//     lane l owns V contiguous columns and reads them as one 8- or 16-byte
//     vector per k.  Rows come in register groups of BT <= 8, and T > 8
//     loops over groups against the same staged tile, the partial sums of
//     every group kept in the warp's shared slot.
//   * the block reduction is one barrier: each warp leaves its partial in its
//     own slot, then the threads add the slots in warp order.
// The -D switches below build diagnostic bodies and other block shapes for
// tools/torch_decode_variants.py: BITLINEAR_DECODE_VARIANT 1 copies only
// (the consumers release each stage unread; y is 0), 2 body only (the
// producer fills each ring slot once, later stages reuse stale data; y is
// wrong), 3 z only (no z @ C), 4 z @ C only (no z; both wrong);
// BITLINEAR_DECODE_STAGES, _STAGE_BYTES, _MIN_BLOCKS.
#pragma once

#include "bitlinear_ring.cuh"

#ifndef BITLINEAR_DECODE_STAGES
#define BITLINEAR_DECODE_STAGES 2
#endif
#ifndef BITLINEAR_DECODE_STAGE_BYTES
#define BITLINEAR_DECODE_STAGE_BYTES 24576
#endif
#ifndef BITLINEAR_DECODE_MIN_BLOCKS
#define BITLINEAR_DECODE_MIN_BLOCKS 0
#endif
#ifndef BITLINEAR_DECODE_VARIANT
#define BITLINEAR_DECODE_VARIANT 0
#endif

namespace bitlinear_impl {

constexpr int DEC_WARPS = 4;             // consumer warps, each a quarter of every stage
constexpr int DEC_STAGES = BITLINEAR_DECODE_STAGES;
constexpr int DEC_STAGE_BYTES = BITLINEAR_DECODE_STAGE_BYTES;   // most bytes of one stage
// C staged raw: columns a lane owns, and the most bytes of one such stage
// (kernels/bitlinear.py::decode_layout mirrors the rule)
constexpr int DEC_RAW_COLS = 5;
constexpr int DEC_RAW_STAGE_BYTES = 65536;
// resident blocks per SM the registers must allow: 3 for groups of up to 4
// rows (at most 128 registers a thread: 4 blocks, 96, spilled and ran
// slower), 2 for 8-row groups; or the -D value
constexpr int dec_min_blocks(int bt) {
  return BITLINEAR_DECODE_MIN_BLOCKS ? BITLINEAR_DECODE_MIN_BLOCKS : bt <= 4 ? 3 : 2;
}

// The block's layout: [DEC_STAGES stages: C tiles | M tiles | x rows]
// [per-warp z buffers] [per-warp partial y slots] [full, empty mbarriers].
// A stage has rs r tiles, a warp's quarter of them one z batch of z_batch's
// units (tile, pair of k) of ls lanes each (a power of two covering the
// tile row's 16-byte slices of x, at most 32).  C is staged as whole tiles
// (stage_c), raw (raw_c: c_slot bytes a tile) or not at all.
struct DecodeGeom {
  int ls, ns, rs, batch;                   // lanes, slices per tile; r tiles per stage; per warp
  bool stage_c, raw_c, stage_m, stage_x;   // parts the producer copies
  int cols;                                // columns a lane owns: ring_cols(td), or DEC_RAW_COLS
  size_t c_slot;                           // bytes of one raw C tile in a stage
  size_t c_bytes, m_bytes, x_bytes;        // of one stage
  size_t stage, zbuf, slots, smem;
};

inline DecodeGeom decode_geom(int T, int tn, int kb, int K, int td, size_t xsize, size_t csize) {
  DecodeGeom g;
  z_lanes(tn, xsize, &g.ns, &g.ls);
  const int pairs = (K + 1) / 2;
  const int full = 32 / g.ls > pairs ? 32 / g.ls / pairs : 1;   // tiles in one pass of z_batch
  const size_t c_tile = (size_t)K * td * csize, m_tile = (size_t)tn * kb,
               x_tile = (size_t)tn * xsize;
  g.stage_c = c_tile % 16 == 0 && td <= 32 * ring_cols(td);
  g.stage_m = m_tile % 16 == 0;
  g.stage_x = x_tile % 16 == 0;
  const size_t per = (g.stage_c ? c_tile : 0) + (g.stage_m ? m_tile : 0) +
                     (g.stage_x ? (size_t)T * x_tile : 0);
  // a full batch per warp where DEC_STAGE_BYTES holds it, in multiples of 4
  const size_t fit = per ? DEC_STAGE_BYTES / per : (size_t)DEC_WARPS * full;
  const size_t ts = fit < (size_t)DEC_WARPS * full ? fit : (size_t)DEC_WARPS * full;
  g.rs = ts < DEC_WARPS ? DEC_WARPS : (int)(ts - ts % DEC_WARPS);
  g.batch = g.rs / DEC_WARPS;
  // raw C: a tile's span from the 16-byte boundary below it, rounded up;
  // the split above stays the parts' own
  g.c_slot = c_tile % 16 ? align16(c_tile) + 16 : c_tile;
  g.raw_c = td > 32 * ring_cols(td) && td <= 32 * DEC_RAW_COLS && T <= 4 &&
            (size_t)g.rs * (g.c_slot + per) <= (size_t)DEC_RAW_STAGE_BYTES;
  g.cols = g.raw_c ? DEC_RAW_COLS : ring_cols(td);
  g.c_bytes = g.stage_c ? g.rs * c_tile : g.raw_c ? g.rs * g.c_slot : 0;   // multiples of 16
  g.m_bytes = g.stage_m ? g.rs * m_tile : 0;
  g.x_bytes = g.stage_x ? (size_t)T * g.rs * x_tile : 0;
  g.stage = g.c_bytes + g.m_bytes + g.x_bytes;
  g.zbuf = align16((size_t)DEC_WARPS * g.batch * ring_rows(T) * K * 4);
  g.slots = (size_t)DEC_WARPS * T * 32 * g.cols * 4;
  g.smem = DEC_STAGES * g.stage + g.zbuf + g.slots + 2 * DEC_STAGES * 8;
  return g;
}

// acc[t][v] += z[j][k][t] * C[j][k][c0 + 32 v] over the batch's tiles from
// raw C spans in a stage: tile j's span sits at cst + j c_slot, from the
// 16-byte boundary below its C in device memory (cg + j c_gstr, read for
// the offset only); columns at or past td are not read (their sums stay
// unused).  zc_batch's additions, in its order.
template <typename CT, int BT, int V>
__device__ __forceinline__ void zc_raw(const unsigned char* cst, size_t c_slot, const CT* cg,
                                       size_t c_gstr, int nb, int K, int td, int c0,
                                       const float* zbuf, float (&acc)[BT][V]) {
  for (int j = 0; j < nb; ++j) {
    const uintptr_t off = reinterpret_cast<uintptr_t>(cg + (size_t)j * c_gstr) & 15;
    const CT* ct = reinterpret_cast<const CT*>(cst + (size_t)j * c_slot + off) + c0;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      float cv[V], zt[BT];
#pragma unroll
      for (int v = 0; v < V; ++v) cv[v] = c0 + 32 * v < td ? ld(ct + (size_t)k * td + 32 * v) : 0.f;
      load_z<BT>(zt, zbuf + (j * K + k) * BT);
#pragma unroll
      for (int t = 0; t < BT; ++t)
#pragma unroll
        for (int v = 0; v < V; ++v) acc[t][v] = fmaf(zt[t], cv[v], acc[t][v]);
    }
  }
}

struct DecodeParams {
  int T, n_r, n_c, tn, kb, K, td;
  int rs, batch, ls, ns;                // r tiles per stage and per warp; lanes and 16-byte
                                        // slices per tile row
  int stage_c, raw_c, stage_m, stage_x; // parts in the stages (else read from device memory)
  int x_vec, m_vec, c_vec;              // vector loads fit
  unsigned c_slot;                      // bytes of one raw C tile in a stage
  unsigned stage_bytes, m_off, x_off, zbuf_off, slots_off, bar_off;
};

// RAW: C staged raw (p.raw_c), V = DEC_RAW_COLS columns a lane, 32 apart
template <typename XT, typename CT, int BT, int V, bool BP, bool RAW>
__global__ void __launch_bounds__((DEC_WARPS + 1) * 32, dec_min_blocks(BT))
    bitlinear_decode_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ mp,
                            const CT* __restrict__ Cw, XT* __restrict__ y, const DecodeParams p) {
  constexpr int CW = 32 * V;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int T = p.T, n_r = p.n_r, n_c = p.n_c, tn = p.tn, K = p.K, td = p.td;
  const int e = blockIdx.y / n_c, c = blockIdx.y - e * n_c;
  const int d0 = blockIdx.z * CW;
  const int d_in = n_r * tn, d_out = n_c * td;
  const size_t m_tile = (size_t)tn * p.kb, c_tile = (size_t)K * td;
  x += (size_t)e * T * d_in;
  mp += (size_t)e * n_r * n_c * m_tile;
  Cw += (size_t)e * n_r * n_c * c_tile;
  y += (size_t)e * T * d_out;

  // this block's r tiles [rb, re) and their stages of rs tiles
  const int S = gridDim.x, rank = blockIdx.x;
  const int rb = (int)((long long)n_r * rank / S), re = (int)((long long)n_r * (rank + 1) / S);
  const int rs = p.rs, n_st = (re - rb + rs - 1) / rs;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.bar_off);
  uint64_t* empty = full + DEC_STAGES;
  float* slots = reinterpret_cast<float*>(smem + p.slots_off);
  if (threadIdx.x < DEC_STAGES) {
    mbar_init(&full[threadIdx.x], 1);
    mbar_init(&empty[threadIdx.x], DEC_WARPS);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();

  if (warp == DEC_WARPS) {
    // producer: stage i into ring slot i % DEC_STAGES once its readers released it
    for (int i = 0; i < n_st; ++i) {
      const int slot = i % DEC_STAGES, use = i / DEC_STAGES;
      if (use > 0) mbar_wait(&empty[slot], (use - 1) & 1);
      const int r0 = rb + i * rs, nr = min(rs, re - r0);
      const bool copy = BITLINEAR_DECODE_VARIANT != 2 || use == 0;
      const int nc = copy && (RAW || p.stage_c) ? nr : 0, nm = copy && p.stage_m ? nr : 0,
                nx = copy && p.stage_x ? T : 0;
      const unsigned cb = (unsigned)(c_tile * sizeof(CT)), mb = (unsigned)m_tile,
                     xb = (unsigned)(nr * tn * sizeof(XT));
      // a raw C tile's copy: from the 16-byte boundary at or below it, rounded up
      auto raw_src = [&](int q) {
        return reinterpret_cast<uintptr_t>(Cw + ((size_t)(r0 + q) * n_c + c) * c_tile);
      };
      unsigned c_all = nc * cb;
      if (RAW) {
        unsigned mine = 0;
        for (int q = lane; q < nc; q += 32) mine += (unsigned)align16((raw_src(q) & 15) + cb);
        c_all = __reduce_add_sync(0xffffffffu, mine);
      }
      if (lane == 0) mbar_arrive_expect_tx(&full[slot], c_all + nm * mb + nx * xb);
      __syncwarp();
      unsigned char* st = smem + (size_t)slot * p.stage_bytes;
      for (int q = lane; q < nc + nm + nx; q += 32) {
        if (RAW && q < nc) {
          const uintptr_t src = raw_src(q);
          bulk_copy(st + (size_t)q * p.c_slot, reinterpret_cast<const void*>(src & ~uintptr_t(15)),
                    (unsigned)align16((src & 15) + cb), &full[slot]);
        } else if (q < nc)   // the C tile of r tile r0 + q
          bulk_copy(st + (size_t)q * cb, Cw + ((size_t)(r0 + q) * n_c + c) * c_tile, cb,
                    &full[slot]);
        else if (q < nc + nm)
          bulk_copy(st + p.m_off + (size_t)(q - nc) * mb,
                    mp + ((size_t)(r0 + q - nc) * n_c + c) * m_tile, mb, &full[slot]);
        else          // row t of x over the stage's columns
          bulk_copy(st + p.x_off + (size_t)(q - nc - nm) * rs * tn * sizeof(XT),
                    x + (size_t)(q - nc - nm) * d_in + (size_t)r0 * tn, xb, &full[slot]);
      }
    }
  } else {
    // consumer warp: its quarter of every stage's r tiles
    const int b = p.batch;
    float* slot_w = slots + (size_t)warp * T * CW;
    float* zbuf = reinterpret_cast<float*>(smem + p.zbuf_off) + (size_t)warp * b * BT * K;
    const bool multi = T > BT;   // row groups: partial sums kept in slot_w
    const int d = d0 + lane * V;
    // the lane's column v (from d0): 32 apart where C is raw
    auto col = [&](int v) { return RAW ? lane + 32 * v : lane * V + v; };
    float acc[BT][V];
#pragma unroll
    for (int t = 0; t < BT; ++t)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[t][v] = 0.f;
    if (multi) {
      for (int i = lane; i < T * CW; i += 32) slot_w[i] = 0.f;
      __syncwarp();
    }
    for (int i = 0; i < n_st; ++i) {
      const int slot = i % DEC_STAGES;
      mbar_wait(&full[slot], (i / DEC_STAGES) & 1);
      const int r0 = rb + i * rs, nr = min(rs, re - r0);
      const int j0 = warp * b, nb = min(b, nr - j0);   // this warp's tiles of the stage
      if (nb > 0 && BITLINEAR_DECODE_VARIANT != 1) {
        const unsigned char* st = smem + (size_t)slot * p.stage_bytes;
        const int ra = r0 + j0;        // the first tile's r
        const XT* xs = p.stage_x ? reinterpret_cast<const XT*>(st + p.x_off) + (size_t)j0 * tn
                                 : x + (size_t)ra * tn;
        const size_t x_row = p.stage_x ? (size_t)rs * tn : (size_t)d_in;
        const uint8_t* ms = p.stage_m ? st + p.m_off + (size_t)j0 * m_tile
                                      : mp + ((size_t)ra * n_c + c) * m_tile;
        const size_t m_str = p.stage_m ? m_tile : (size_t)n_c * m_tile;
        const CT* cs = p.stage_c ? reinterpret_cast<const CT*>(st) + (size_t)j0 * c_tile
                                 : Cw + ((size_t)ra * n_c + c) * c_tile;
        const size_t c_str = p.stage_c ? c_tile : (size_t)n_c * c_tile;
        for (int g0 = 0; g0 < T; g0 += BT) {
          if (multi) {
#pragma unroll
            for (int t = 0; t < BT; ++t)
#pragma unroll
              for (int v = 0; v < V; ++v)
                acc[t][v] = g0 + t < T ? slot_w[(g0 + t) * CW + col(v)] : 0.f;
          }
          if (BITLINEAR_DECODE_VARIANT != 4)
            z_batch<XT, CT, BT, BP>(xs + (size_t)g0 * x_row, x_row, ms, m_str, nb,
                                    min(BT, T - g0), p, zbuf, lane);
          __syncwarp();
          if (BITLINEAR_DECODE_VARIANT != 3) {
            if constexpr (RAW)
              zc_raw<CT, BT, V>(st + (size_t)j0 * p.c_slot, p.c_slot,
                                Cw + ((size_t)ra * n_c + c) * c_tile, (size_t)n_c * c_tile, nb, K,
                                td, lane, zbuf, acc);
            else
              zc_batch<CT, BT, V>(cs + d, c_str, td, nb, K, td - d, p.c_vec, zbuf, acc);
          }
          __syncwarp();
          if (multi) {
#pragma unroll
            for (int t = 0; t < BT; ++t)
#pragma unroll
              for (int v = 0; v < V; ++v)
                if (g0 + t < T) slot_w[(g0 + t) * CW + col(v)] = acc[t][v];
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
    }
    if (!multi) {
#pragma unroll
      for (int t = 0; t < BT; ++t)
#pragma unroll
        for (int v = 0; v < V; ++v)
          if (t < T) slot_w[t * CW + col(v)] = acc[t][v];
    }
  }

  // block reduction (warp order), then the cluster's (rank order) into y
  const int n = T * CW;
  block_reduce(slots, n, DEC_WARPS);
  cluster_reduce(slots, n, S, rank, [&](int i, float s) {
    const int t = i / CW, col = d0 + (i - t * CW);
    if (col < td) y[(size_t)t * d_out + (size_t)c * td + col] = store_y<XT>(s);
  });
}

struct DecodeArgs {
  const void* x;
  const uint8_t* mp;
  const void* C;
  void* y;
  int E, S;
  DecodeParams p;
  size_t smem;
  cudaStream_t stream;
};

template <typename XT, typename CT, int BT, int V, bool BP, bool RAW>
cudaError_t launch_decode_cfg(const DecodeArgs& a) {
  auto kern = bitlinear_decode_kernel<XT, CT, BT, V, BP, RAW>;
  // set on every launch: a function-local cache in this template would be
  // one object for every library of the process that instantiates it
  cudaError_t err;
  if (a.smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.smem);
    if (err != cudaSuccess) return err;
  }
  // the host's rule alone decides S (kernels/bitlinear.py): a size the card
  // cannot co-schedule fails the launch below
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.S, a.E * a.p.n_c, RAW ? 1 : (a.p.td + 32 * V - 1) / (32 * V));
  cfg.blockDim = dim3((DEC_WARPS + 1) * 32);
  cfg.dynamicSmemBytes = a.smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, static_cast<const XT*>(a.x), a.mp,
                           static_cast<const CT*>(a.C), static_cast<XT*>(a.y), a.p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename XT, typename CT, int BT, bool BP>
cudaError_t launch_decode_v(const DecodeArgs& a) {
  if constexpr (BT <= 4) {   // C staged raw only at T <= 4 (decode_geom)
    if (a.p.raw_c) return launch_decode_cfg<XT, CT, BT, DEC_RAW_COLS, BP, true>(a);
  }
  return ring_cols(a.p.td) == 1 ? launch_decode_cfg<XT, CT, BT, 1, BP, false>(a)
                               : launch_decode_cfg<XT, CT, BT, 4, BP, false>(a);
}

template <typename XT, typename CT, bool BP>
cudaError_t launch_decode_bt(const DecodeArgs& a) {
  const int T = a.p.T;
  if (T <= 1) return launch_decode_v<XT, CT, 1, BP>(a);
  if (T <= 2) return launch_decode_v<XT, CT, 2, BP>(a);
  if (T <= 4) return launch_decode_v<XT, CT, 4, BP>(a);
  return launch_decode_v<XT, CT, 8, BP>(a);
}

template <typename XT>
cudaError_t launch_decode_x(const DecodeArgs& a, int c_bf16, int bitplane) {
  if (c_bf16)
    return bitplane ? launch_decode_bt<XT, __nv_bfloat16, true>(a)
                    : launch_decode_bt<XT, __nv_bfloat16, false>(a);
  return bitplane ? launch_decode_bt<XT, float, true>(a) : launch_decode_bt<XT, float, false>(a);
}

// See bitlinear_decode (bitlinear_decode.cu) for the arguments.
inline int decode_dispatch(const void* x, const uint8_t* mp, const void* C, void* y, int E,
                           int T, int n_r, int n_c, int tn, int kb, int K, int td, int x_kind,
                           int c_bf16, int bitplane, int clusters, int smem_budget,
                           void* stream) {
  if (T <= 0 || E <= 0) return cudaSuccess;
  if (x_kind < 0 || x_kind > 2 || clusters < 1 || n_r < 1 ||
      n_c < 1 || tn < 1 || K < 1 || kb != (K + 7) / 8 || td < 1)
    return cudaErrorInvalidValue;
  if ((long long)E * n_c > 65535) return cudaErrorInvalidConfiguration;   // gridDim.y
  const size_t xs = x_size(x_kind), cs = c_bf16 ? 2 : 4;
  const DecodeGeom g = decode_geom(T, tn, kb, K, td, xs, cs);
  if (g.smem > (size_t)smem_budget) return -(int)(g.smem < 0x7fffffff ? g.smem : 0x7fffffff);
  const int VX = (int)(16 / xs);
  DecodeParams p;
  p.T = T, p.n_r = n_r, p.n_c = n_c, p.tn = tn, p.kb = kb, p.K = K, p.td = td;
  p.rs = g.rs;
  p.batch = g.batch;
  p.ns = g.ns;
  p.ls = g.ls;
  // a part is staged when its tiles are whole 16-byte units (the layout) and
  // its base is 16-byte aligned (the wrapper clones a view that is not)
  p.stage_c = g.stage_c && aligned(C, 16);
  p.raw_c = g.raw_c && aligned(C, 16);
  p.c_slot = (unsigned)g.c_slot;
  p.stage_m = g.stage_m && aligned(mp, 16);
  p.stage_x = g.stage_x && aligned(x, 16);
  p.x_vec = tn % VX == 0 && (p.stage_x || ((size_t)n_r * tn * xs % 16 == 0 && aligned(x, 16)));
  p.m_vec = kb == 1 && tn % VX == 0 && (p.stage_m || aligned(mp, 16));
  p.c_vec = ring_cols(td) == 4 && td % 4 == 0 && aligned(C, 16);
  p.stage_bytes = (unsigned)g.stage;
  p.m_off = (unsigned)g.c_bytes;
  p.x_off = (unsigned)(g.c_bytes + g.m_bytes);
  p.zbuf_off = (unsigned)(DEC_STAGES * g.stage);
  p.slots_off = (unsigned)(p.zbuf_off + g.zbuf);
  p.bar_off = (unsigned)(p.slots_off + g.slots);
  const DecodeArgs a{x, mp, C, y, E, clusters, p, g.smem, reinterpret_cast<cudaStream_t>(stream)};
  switch (x_kind) {
    case 0:
      return launch_decode_x<float>(a, c_bf16, bitplane);
    case 1:
      return launch_decode_x<__nv_bfloat16>(a, c_bf16, bitplane);
    default:
      return launch_decode_x<int8_t>(a, c_bf16, bitplane);
  }
}

}  // namespace bitlinear_impl
