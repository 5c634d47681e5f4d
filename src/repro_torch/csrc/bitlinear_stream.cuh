// Stream schedule of kernel K3: y = (x @ M) @ C with each column tile's r
// tiles streamed through shared memory r_chunk tiles at a time, a kernel of
// its own, bitlinear_stream_kernel.
//
// Replaces the Pallas TPU kernel repro/kernels/bitlinear.py::_stream_kernel
// (call site :388): for each column tile, y accumulates over every r tile,
// the tiles arriving in chunks of r_chunk through a ring of DMA copies.  It
// computes what bitlinear.cuh's note says (z rounded to C's dtype before
// z @ C, f32 accumulation, the unpack and bitplane algebras, f32/bf16/int8
// x, f32/bf16 C, any K and T, int8 output truncated toward zero and
// saturated); K3 only, as in JAX.
//
// What bounds it: bytes.  At the T it serves (decode-sized) a (r, c) tile
// costs ~2 T K td operations per 2 K td bytes of bf16 C, far below the
// tensor cores' ~295 operations per byte, so the body stays on the FMA
// pipes and the design is about keeping the card's 3.35 TB/s busy:
//   * r is split across the S blocks of a thread-block cluster: the launch
//     is grid(S, n_c, column chunks x row blocks) with cluster dims (S, 1,
//     1), block s taking a contiguous range of whole r chunks (n_r / r_chunk
//     of them).  S is the host's rule (kernels/bitlinear.py::
//     stream_cluster_size: the most blocks one wave holds, at least
//     STREAM_MIN_TILES r tiles a block, S <= 8 or 16), passed to the launch.
//     Each block's partial y stays in its shared memory; rank 0 adds the
//     ranks' partials in rank order through distributed shared memory and
//     writes y (bitlinear_ring.cuh), so two launches give the same bits.
//   * a ring stage holds one r chunk, JAX's meaning of r_chunk: the chunk's
//     C tiles, M tiles and the block's rows of x over its columns, each part
//     one tensor-map copy (cp.async.bulk.tensor, TMA) issued by one elected
//     producer thread, completion through full and empty mbarriers
//     (arrive.expect_tx).  The views and boxes: C as {td, K, n_c, n_r}, box
//     {the chunk's columns, K, 1, r_chunk}; M as bytes {tn kb, n_c, n_r},
//     box {tn kb, 1, r_chunk}; x as {tn, n_r, T}, box {tn, r_chunk, rows}.
//     Rows past T, columns past td and r tiles past n_r land as zeros.  The
//     ring has as many stages as STREAM_RING_BYTES holds, a multiple of
//     STREAM_WARPS between STREAM_WARPS and STREAM_STAGES.
//   * TMA's rules decide what goes through a tensor map (stream_map_ok, the
//     one definition, mirrored by kernels/bitlinear.py::tensor_map_ok): the
//     inner box a multiple of 16 bytes, every box dimension <= 256, the
//     global strides multiples of 16 bytes, the global address 16-byte
//     aligned (each part's shared destination is 128-byte aligned by the
//     layout).  A part that breaks one (the BBO tensors' 8-byte M tiles, tn
//     = 8 and K = 3; int8 x over tn = 8) is read by the consumers from
//     device memory with the widest load that fits.  M's and C's maps are
//     cached by the library (bitlinear_stream.cu, keyed by every field of
//     the encoding), x's is encoded per call (x's address changes).
//   * STREAM_WARPS consumer warps take the stages in turn, warp w the
//     stages w, w + W, ..., each a whole chunk (a slot's next stage is the
//     same warp's, so each warp waits on every phase of its slots' full
//     barriers, as a parity wait needs), with decode's lane-parallel
//     body (bitlinear_ring.cuh: z_batch decodes each bit once for a group of
//     up to 8 rows; zc_batch reads C as vectors); a warp's partial y stays in
//     registers, or, past one register group, in its shared slot while the
//     groups loop against the same stage.  The warps' slots are added in
//     warp order at the end.
//   * a block covers at most STREAM_ROWS rows of x (more rows: more row
//     blocks along z), so its shared memory stops growing with T there.
// The -D switches below build diagnostic bodies and other block shapes for
// tools/torch_stream_variants.py: BITLINEAR_STREAM_VARIANT 1 copies only
// (the consumers release each stage unread; y is 0), 2 body only (the
// producer fills each ring slot once, later stages reuse stale data; y is
// wrong), 3 z only (no z @ C), 4 z @ C only (no z; both wrong);
// BITLINEAR_STREAM_WARPS, _STAGES, _RING_BYTES, _ROWS, _MIN_BLOCKS.
#pragma once

#include <cuda.h>

#include <cstring>

#include "bitlinear_ring.cuh"

#ifndef BITLINEAR_STREAM_WARPS
#define BITLINEAR_STREAM_WARPS 4
#endif
#ifndef BITLINEAR_STREAM_STAGES
#define BITLINEAR_STREAM_STAGES 8
#endif
#ifndef BITLINEAR_STREAM_RING_BYTES
#define BITLINEAR_STREAM_RING_BYTES 49152
#endif
#ifndef BITLINEAR_STREAM_ROWS
#define BITLINEAR_STREAM_ROWS 32
#endif
#ifndef BITLINEAR_STREAM_MIN_BLOCKS
#define BITLINEAR_STREAM_MIN_BLOCKS 0
#endif
#ifndef BITLINEAR_STREAM_VARIANT
#define BITLINEAR_STREAM_VARIANT 0
#endif

namespace bitlinear_impl {

constexpr int STREAM_WARPS = BITLINEAR_STREAM_WARPS;     // consumer warps
constexpr int STREAM_STAGES = BITLINEAR_STREAM_STAGES;   // most ring stages
constexpr size_t STREAM_RING_BYTES = BITLINEAR_STREAM_RING_BYTES;
constexpr int STREAM_ROWS = BITLINEAR_STREAM_ROWS;       // most rows of x a block covers
// resident blocks per SM the registers must allow (as decode's), or the -D value
constexpr int stream_min_blocks(int bt) {
  return BITLINEAR_STREAM_MIN_BLOCKS ? BITLINEAR_STREAM_MIN_BLOCKS : bt <= 4 ? 3 : 2;
}
// a failed tensor-map encode returns this plus its CUresult
constexpr int STREAM_ENCODE_ERROR = 20000;

// One operand's tensor map: its view (dims innermost first, the byte
// strides of dims 1 ...; dim 0 is contiguous) and box, in elements of esize
// bytes.
struct MapSpec {
  int rank;
  size_t esize;
  uint64_t dims[4];
  uint64_t strides[3];
  uint32_t box[4];
};

// TMA's rules for one tensor map at global address `base`: the one
// definition (kernels/bitlinear.py::tensor_map_ok mirrors it).
inline bool stream_map_ok(const MapSpec& s, uintptr_t base) {
  if (base % 16 || (s.box[0] * s.esize) % 16) return false;
  for (int i = 0; i < s.rank; ++i)
    if (s.box[i] < 1 || s.box[i] > 256) return false;
  for (int i = 0; i + 1 < s.rank; ++i)
    if (s.strides[i] % 16) return false;
  return true;
}

// C (n_r, n_c, K, td) as {td, K, n_c, n_r}, box {cbox columns, K, 1, rc}
inline MapSpec c_map(int n_r, int n_c, int K, int td, size_t cs, int cbox, int rc) {
  return {4, cs, {(uint64_t)td, (uint64_t)K, (uint64_t)n_c, (uint64_t)n_r},
          {td * cs, (uint64_t)K * td * cs, (uint64_t)n_c * K * td * cs},
          {(uint32_t)cbox, (uint32_t)K, 1u, (uint32_t)rc}};
}
// M (n_r, n_c, tn, kb) as bytes {tn kb, n_c, n_r}, box {tn kb, 1, rc}
inline MapSpec m_map(int n_r, int n_c, int tn, int kb, int rc) {
  const uint64_t mt = (uint64_t)tn * kb;
  return {3, 1, {mt, (uint64_t)n_c, (uint64_t)n_r, 0}, {mt, (uint64_t)n_c * mt, 0},
          {(uint32_t)mt, 1u, (uint32_t)rc, 0u}};
}
// x (T, n_r tn) as {tn, n_r, T}, box {tn, rc, rows}
inline MapSpec x_map(int T, int n_r, int tn, size_t xs, int rc, int rows) {
  return {3, xs, {(uint64_t)tn, (uint64_t)n_r, (uint64_t)T, 0},
          {tn * xs, (uint64_t)n_r * tn * xs, 0}, {(uint32_t)tn, (uint32_t)rc, (uint32_t)rows, 0u}};
}

__host__ __device__ __forceinline__ size_t align128(size_t n) {
  return (n + 127) & ~size_t(127);
}

// The block's geometry and layout: [stages: C tiles | M tiles | x rows,
// each part 128-byte aligned] [per-warp z buffers] [per-warp partial-y
// slots] [full, empty mbarriers].  The maps here are the layout's (shapes
// alone); a launch also needs each part's base 16-byte aligned.
struct StreamGeom {
  int rows, row_blocks;   // rows of x a block covers; blocks along T
  int cols, col_chunks;   // columns of a chunk (32 x lane columns); chunks along td
  int cbox, bt, ns;       // C columns staged; rows of a register group; ring stages
  bool map_c, map_m, map_x;
  size_t c_bytes, m_bytes, x_bytes, stage, zbuf, slots, smem;
};

inline StreamGeom stream_geom(int T, int tn, int kb, int K, int td, size_t xs, size_t cs,
                              int rc) {
  StreamGeom g;
  g.rows = T < STREAM_ROWS ? T : STREAM_ROWS;
  g.row_blocks = (T + g.rows - 1) / g.rows;
  g.cols = 32 * ring_cols(td);
  g.col_chunks = (td + g.cols - 1) / g.cols;
  g.cbox = td < g.cols ? td : g.cols;
  g.bt = ring_rows(g.rows);
  // the rules hold for any n_r, n_c: every stride is a multiple of dim 1's
  g.map_c = stream_map_ok(c_map(1, 1, K, td, cs, g.cbox, rc), 0);
  g.map_m = stream_map_ok(m_map(1, 1, tn, kb, rc), 0);
  g.map_x = stream_map_ok(x_map(T, 1, tn, xs, rc, g.rows), 0);
  g.c_bytes = g.map_c ? align128((size_t)rc * K * g.cbox * cs) : 0;
  g.m_bytes = g.map_m ? align128((size_t)rc * tn * kb) : 0;
  g.x_bytes = g.map_x ? align128((size_t)g.rows * rc * tn * xs) : 0;
  g.stage = g.c_bytes + g.m_bytes + g.x_bytes;
  size_t fit = g.stage ? STREAM_RING_BYTES / g.stage : STREAM_STAGES;
  fit = fit > STREAM_STAGES ? STREAM_STAGES : fit;
  fit -= fit % STREAM_WARPS;
  g.ns = fit < STREAM_WARPS ? STREAM_WARPS : (int)fit;
  g.zbuf = align16((size_t)STREAM_WARPS * rc * K * g.bt * 4);
  g.slots = (size_t)STREAM_WARPS * g.rows * g.cols * 4;
  g.smem = g.ns * g.stage + g.zbuf + g.slots + 2 * (size_t)g.ns * 8;
  return g;
}

struct StreamParams {
  int T, n_r, n_c, tn, kb, K, td;
  int rc, n_ch, rows, col_chunks, stages, cbox;   // r tiles per chunk, chunks; see StreamGeom
  int ls, ns;                                     // z_batch's lanes, 16-byte x slices per row
  int map_c, map_m, map_x;                        // parts in the stages (else device memory)
  int x_vec, m_vec, c_vec;                        // vector loads fit
  unsigned stage_bytes, m_off, x_off, zbuf_off, slots_off, bar_off, tx_bytes;
};

template <typename XT, typename CT, int BT, int V, bool BP>
__global__ void __launch_bounds__((STREAM_WARPS + 1) * 32, stream_min_blocks(BT))
    bitlinear_stream_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ mp,
                            const CT* __restrict__ Cw, XT* __restrict__ y, const StreamParams p,
                            const __grid_constant__ CUtensorMap cmap,
                            const __grid_constant__ CUtensorMap mmap,
                            const __grid_constant__ CUtensorMap xmap) {
  constexpr int CW = 32 * V;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int T = p.T, n_r = p.n_r, n_c = p.n_c, tn = p.tn, K = p.K, td = p.td, rc = p.rc;
  const int c = blockIdx.y;
  const int cc = blockIdx.z % p.col_chunks, rb = blockIdx.z / p.col_chunks;
  const int d0 = cc * CW, row0 = rb * p.rows, rows = min(p.rows, T - row0);
  const int d_in = n_r * tn, d_out = n_c * td;
  const size_t m_tile = (size_t)tn * p.kb, c_tile = (size_t)K * td;

  // this block's r chunks [cb, ce), one per ring stage
  const int S = gridDim.x, rank = blockIdx.x;
  const int cb = (int)((long long)p.n_ch * rank / S);
  const int ce = (int)((long long)p.n_ch * (rank + 1) / S);
  const int n_st = ce - cb, NS = p.stages;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.bar_off);
  uint64_t* empty = full + NS;
  float* slots = reinterpret_cast<float*>(smem + p.slots_off);
  for (int i = threadIdx.x; i < NS; i += blockDim.x) {
    mbar_init(&full[i], 1);
    mbar_init(&empty[i], 1);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();

  if (warp == STREAM_WARPS) {
    // producer: chunk cb + i into ring slot i % NS once its reader released it
    for (int i = 0; i < n_st; ++i) {
      const int slot = i % NS, use = i / NS;
      const int r0 = (cb + i) * rc;
      const bool copy = BITLINEAR_STREAM_VARIANT != 2 || use == 0;
      unsigned char* st = smem + (size_t)slot * p.stage_bytes;
      if (lane == 0) {
        if (use > 0) mbar_wait(&empty[slot], (use - 1) & 1);
        mbar_arrive_expect_tx(&full[slot], copy ? p.tx_bytes : 0);
        if (copy) {
          if (p.map_c) tma_load_4d(st, &cmap, &full[slot], d0, 0, c, r0);
          if (p.map_m) tma_load_3d(st + p.m_off, &mmap, &full[slot], 0, c, r0);
          if (p.map_x) tma_load_3d(st + p.x_off, &xmap, &full[slot], 0, r0, row0);
        }
      }
    }
  } else {
    // consumer warp: the stages warp, warp + W, ...
    float* slot_w = slots + (size_t)warp * rows * CW;
    float* zbuf = reinterpret_cast<float*>(smem + p.zbuf_off) + (size_t)warp * rc * BT * K;
    const bool multi = rows > BT;   // row groups: partial sums kept in slot_w
    const int dl = lane * V;        // this lane's first column of the chunk
    float acc[BT][V];
#pragma unroll
    for (int t = 0; t < BT; ++t)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[t][v] = 0.f;
    if (multi) {
      for (int i = lane; i < rows * CW; i += 32) slot_w[i] = 0.f;
      __syncwarp();
    }
    for (int i = warp; i < n_st; i += STREAM_WARPS) {
      const int slot = i % NS;
      mbar_wait(&full[slot], (i / NS) & 1);
      const int r0 = (cb + i) * rc, nb = min(rc, n_r - r0);
      if (BITLINEAR_STREAM_VARIANT != 1) {
        const unsigned char* st = smem + (size_t)slot * p.stage_bytes;
        const XT* xs = p.map_x ? reinterpret_cast<const XT*>(st + p.x_off)
                               : x + (size_t)row0 * d_in + (size_t)r0 * tn;
        const size_t x_row = p.map_x ? (size_t)rc * tn : (size_t)d_in;
        const uint8_t* ms = p.map_m ? st + p.m_off : mp + ((size_t)r0 * n_c + c) * m_tile;
        const size_t m_str = p.map_m ? m_tile : (size_t)n_c * m_tile;
        const CT* cs = p.map_c ? reinterpret_cast<const CT*>(st) + dl
                               : Cw + ((size_t)r0 * n_c + c) * c_tile + d0 + dl;
        const size_t c_str = p.map_c ? (size_t)K * p.cbox : (size_t)n_c * c_tile;
        const size_t c_row = p.map_c ? (size_t)p.cbox : (size_t)td;
        const int n = (p.map_c ? min(td - d0, p.cbox) : td - d0) - dl;
        for (int g0 = 0; g0 < rows; g0 += BT) {
          if (multi) {
#pragma unroll
            for (int t = 0; t < BT; ++t)
#pragma unroll
              for (int v = 0; v < V; ++v)
                acc[t][v] = g0 + t < rows ? slot_w[(g0 + t) * CW + dl + v] : 0.f;
          }
          if (BITLINEAR_STREAM_VARIANT != 4)
            z_batch<XT, CT, BT, BP>(xs + (size_t)g0 * x_row, x_row, ms, m_str, nb,
                                    min(BT, rows - g0), p, zbuf, lane);
          __syncwarp();
          if (BITLINEAR_STREAM_VARIANT != 3)
            zc_batch<CT, BT, V>(cs, c_str, c_row, nb, K, n, p.c_vec, zbuf, acc);
          __syncwarp();
          if (multi) {
#pragma unroll
            for (int t = 0; t < BT; ++t)
#pragma unroll
              for (int v = 0; v < V; ++v)
                if (g0 + t < rows) slot_w[(g0 + t) * CW + dl + v] = acc[t][v];
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
          if (t < rows) slot_w[t * CW + dl + v] = acc[t][v];
    }
  }

  // block reduction (warp order), then the cluster's (rank order) into y
  const int n = rows * CW;
  block_reduce(slots, n, STREAM_WARPS);
  cluster_reduce(slots, n, S, rank, [&](int i, float s) {
    const int t = i / CW, col = d0 + (i - t * CW);
    if (col < td) y[(size_t)(row0 + t) * d_out + (size_t)c * td + col] = store_y<XT>(s);
  });
}

struct StreamArgs {
  const void* x;
  const uint8_t* mp;
  const void* C;
  void* y;
  int S, grid_z;
  StreamParams p;
  size_t smem;
  cudaStream_t stream;
  const CUtensorMap *cmap, *mmap, *xmap;
};

template <typename XT, typename CT, int BT, int V, bool BP>
cudaError_t launch_stream_cfg(const StreamArgs& a) {
  auto kern = bitlinear_stream_kernel<XT, CT, BT, V, BP>;
  // set on every launch: no function-local cache in a template
  cudaError_t err;
  if (a.smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.smem);
    if (err != cudaSuccess) return err;
  }
  // the host's rule alone decides S: a size the card cannot co-schedule
  // fails the launch below
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.S, a.p.n_c, a.grid_z);
  cfg.blockDim = dim3((STREAM_WARPS + 1) * 32);
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
                           static_cast<const CT*>(a.C), static_cast<XT*>(a.y), a.p, *a.cmap,
                           *a.mmap, *a.xmap);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename XT, typename CT, int BT, bool BP>
cudaError_t launch_stream_v(const StreamArgs& a) {
  return ring_cols(a.p.td) == 1 ? launch_stream_cfg<XT, CT, BT, 1, BP>(a)
                                : launch_stream_cfg<XT, CT, BT, 4, BP>(a);
}

template <typename XT, typename CT, bool BP>
cudaError_t launch_stream_bt(const StreamArgs& a) {
  switch (ring_rows(a.p.rows)) {
    case 1:
      return launch_stream_v<XT, CT, 1, BP>(a);
    case 2:
      return launch_stream_v<XT, CT, 2, BP>(a);
    case 4:
      return launch_stream_v<XT, CT, 4, BP>(a);
    default:
      return launch_stream_v<XT, CT, 8, BP>(a);
  }
}

template <typename XT>
cudaError_t launch_stream_x(const StreamArgs& a, int c_bf16, int bitplane) {
  if (c_bf16)
    return bitplane ? launch_stream_bt<XT, __nv_bfloat16, true>(a)
                    : launch_stream_bt<XT, __nv_bfloat16, false>(a);
  return bitplane ? launch_stream_bt<XT, float, true>(a) : launch_stream_bt<XT, float, false>(a);
}

// Encodes s over `base` into *out (bitlinear_stream.cu: M's and C's maps
// from the library's cache when `cached`); 0, or STREAM_ENCODE_ERROR plus the
// driver's CUresult, or a cudaError_t when the driver's entry point is
// missing.
int stream_encode(CUtensorMap* out, const MapSpec& s, const void* base, bool cached);

// See bitlinear_stream (bitlinear_stream.cu) for the arguments.
inline int stream_dispatch(const void* x, const uint8_t* mp, const void* C, void* y, int T,
                           int n_r, int n_c, int tn, int kb, int K, int td, int x_kind,
                           int c_bf16, int bitplane, int r_chunk, int clusters, int smem_budget,
                           void* stream, int* maps) {
  *maps = 0;
  if (T <= 0) return cudaSuccess;
  if (x_kind < 0 || x_kind > 2 || clusters < 1 || r_chunk < 1 || n_r < 1 || n_c < 1 ||
      tn < 1 || K < 1 || kb != (K + 7) / 8 || td < 1)
    return cudaErrorInvalidValue;
  const size_t xs = x_size(x_kind), cs = c_bf16 ? 2 : 4;
  const StreamGeom g = stream_geom(T, tn, kb, K, td, xs, cs, r_chunk);
  if (g.smem > (size_t)smem_budget) return -(int)(g.smem < 0x7fffffff ? g.smem : 0x7fffffff);
  if (n_c > 65535 || (long long)g.col_chunks * g.row_blocks > 65535)
    return cudaErrorInvalidConfiguration;   // gridDim.y, gridDim.z
  StreamParams p;
  p.T = T, p.n_r = n_r, p.n_c = n_c, p.tn = tn, p.kb = kb, p.K = K, p.td = td;
  p.rc = r_chunk;
  p.n_ch = (n_r + r_chunk - 1) / r_chunk;
  p.rows = g.rows;
  p.col_chunks = g.col_chunks;
  p.stages = g.ns;
  p.cbox = g.cbox;
  z_lanes(tn, xs, &p.ns, &p.ls);
  // a part goes through its map where the layout staged it and its base is
  // 16-byte aligned (the wrapper clones a view that is not)
  p.map_c = g.map_c && aligned(C, 16);
  p.map_m = g.map_m && aligned(mp, 16);
  p.map_x = g.map_x && aligned(x, 16);
  const int VX = (int)(16 / xs);
  p.x_vec = tn % VX == 0 && (p.map_x || ((size_t)n_r * tn * xs % 16 == 0 && aligned(x, 16)));
  p.m_vec = kb == 1 && tn % VX == 0 && (p.map_m || aligned(mp, 16));
  p.c_vec = ring_cols(td) == 4 && (p.map_c || (td % 4 == 0 && aligned(C, 16)));
  p.stage_bytes = (unsigned)g.stage;
  p.m_off = (unsigned)g.c_bytes;
  p.x_off = (unsigned)(g.c_bytes + g.m_bytes);
  p.zbuf_off = (unsigned)(g.ns * g.stage);
  p.slots_off = (unsigned)(p.zbuf_off + g.zbuf);
  p.bar_off = (unsigned)(p.slots_off + g.slots);
  p.tx_bytes = (unsigned)((p.map_c ? (size_t)r_chunk * K * g.cbox * cs : 0) +
                          (p.map_m ? (size_t)r_chunk * tn * kb : 0) +
                          (p.map_x ? (size_t)g.rows * r_chunk * tn * xs : 0));
  CUtensorMap cmap, mmap, xmap;
  memset(&cmap, 0, sizeof(cmap));
  memset(&mmap, 0, sizeof(mmap));
  memset(&xmap, 0, sizeof(xmap));
  int err = 0;
  if (p.map_c) err = stream_encode(&cmap, c_map(n_r, n_c, K, td, cs, g.cbox, r_chunk), C, true);
  if (!err && p.map_m) err = stream_encode(&mmap, m_map(n_r, n_c, tn, kb, r_chunk), mp, true);
  if (!err && p.map_x)
    err = stream_encode(&xmap, x_map(T, n_r, tn, xs, r_chunk, g.rows), x, false);
  if (err) return err;
  *maps = p.map_c | p.map_m << 1 | p.map_x << 2;
  const StreamArgs a{x, mp, C, y, clusters, g.col_chunks * g.row_blocks, p, g.smem,
                     reinterpret_cast<cudaStream_t>(stream), &cmap, &mmap, &xmap};
  switch (x_kind) {
    case 0:
      return launch_stream_x<float>(a, c_bf16, bitplane);
    case 1:
      return launch_stream_x<__nv_bfloat16>(a, c_bf16, bitplane);
    default:
      return launch_stream_x<int8_t>(a, c_bf16, bitplane);
  }
}

}  // namespace bitlinear_impl
