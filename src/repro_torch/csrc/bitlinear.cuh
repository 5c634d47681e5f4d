// Fused compressed linear layer y = (x @ M) @ C (kernel K3), and its
// grouped form y_e = (x_e @ M_e) @ C_e over a stack of E experts (kernel K4):
// the device code shared by the three schedules, one source each
// (bitlinear.cu: grid; bitlinear_decode.cu: decode; bitlinear_stream.cu:
// stream), so nvcc builds them in parallel.
//
// Replaces the Pallas TPU kernels repro/kernels/bitlinear.py::bitlinear
// (grid _kernel, decode _decode_kernel, stream _stream_kernel) and
// ::bitlinear_grouped (_grouped_kernel, _grouped_decode_kernel).  The
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
// What bounds it: bytes at decode and small prefill T (C dominates: K*td
// elements per (r, c) tile, 1/8 of the dense weight at K/tn = 1/8), and the
// f32 FMA rate at large T, since K (3-4) is below the tensor cores'
// k-minimum.  Every schedule keeps as many independent (r, c) tiles in
// flight as the card holds:
//   * a block owns (expert e, column tile c) -- blockIdx.y = e * n_c + c,
//     all E experts in one launch, K3 is E = 1 -- and a set of rows and
//     columns of it; its W warps take the r tiles in chunks of rc
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
// The schedules differ in where the operands come from:
//   grid    a block covers row_block rows (block_t) in register groups of
//           BT and a 32*NCOL column chunk; x, M, C read from device memory.
//   decode  one block per (e, c) with all T rows and all td columns: the
//           expert's x rows are staged once in shared memory, BT fits T.
//   stream  one block per (e, c) as decode, x read from device memory; each
//           warp double-buffers its r chunks of M and C in two shared-memory
//           slots filled with cp.async: the copy of chunk i+1 is issued
//           before chunk i is consumed (commit_group / wait_group 1).
//           16-byte copies where the tile size allows it, else 4-byte
//           copies, else plain byte loads (an M tile is tn*kb bytes: 8 B for
//           the BBO tensors, tn = 8 and K = 3).
// Ragged T is masked (rows >= T read zeros and are not written) and any K
// works (K % 8 != 0 included).  Every expert of a grouped call has the same
// T (the MoE dispatch layout pads each expert to its capacity).  wgmma, TMA
// and a split of r across blocks for the fewest-column decode shapes are
// later work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bitlinear_impl {

enum { GRID = 0, DECODE = 1, STREAM = 2 };

template <typename XT>
struct Acc {
  using type = float;
};
template <>
struct Acc<int8_t> {
  using type = int;
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ int ld(const int8_t* p) { return static_cast<int>(*p); }

__device__ __forceinline__ float as_f32(float z) { return z; }
// exact: |z| <= 128 * tn is far below 2^24
__device__ __forceinline__ float as_f32(int z) { return __int2float_rn(z); }

// z rounded to C's dtype (round to nearest), as the Pallas kernels' z.astype(c.dtype)
template <typename CT>
__device__ __forceinline__ float to_c(float z);
template <>
__device__ __forceinline__ float to_c<float>(float z) { return z; }
template <>
__device__ __forceinline__ float to_c<__nv_bfloat16>(float z) {
  return __bfloat162float(__float2bfloat16_rn(z));
}

template <typename XT>
__device__ __forceinline__ XT store_y(float acc);
template <>
__device__ __forceinline__ float store_y<float>(float acc) { return acc; }
template <>
__device__ __forceinline__ __nv_bfloat16 store_y<__nv_bfloat16>(float acc) {
  return __float2bfloat16_rn(acc);
}
template <>
__device__ __forceinline__ int8_t store_y<int8_t>(float acc) {
  // toward zero, then saturate (cvt.rzi saturates to the int32 range itself)
  return static_cast<int8_t>(max(-128, min(127, __float2int_rz(acc))));
}

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
// C is cw + j*c_stride (device memory or a stream slot).
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// n tiles of `tile` bytes, src tiles src_stride bytes apart, packed in dst;
// the warp's lanes split the copy in units of `vec` bytes
__device__ __forceinline__ void copy_tiles(unsigned char* dst, const unsigned char* src,
                                           size_t src_stride, size_t tile, int n, int vec,
                                           int lane) {
  if (vec == 1) {
    for (size_t u = lane; u < (size_t)n * tile; u += 32) {
      const size_t j = u / tile, o = u - j * tile;
      dst[j * tile + o] = src[j * src_stride + o];
    }
    return;
  }
  const size_t units = tile / vec;
  for (size_t u = lane; u < (size_t)n * units; u += 32) {
    const size_t j = u / units, o = (u - j * units) * vec;
    if (vec == 16)
      cp_async16(dst + j * tile + o, src + j * src_stride + o);
    else
      cp_async4(dst + j * tile + o, src + j * src_stride + o);
  }
}

__host__ __device__ __forceinline__ size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// Warps per block: 32 for register groups of 1-2 rows, else 16 (the
// accumulators need the registers); stream always 16, since each warp keeps
// two slots of M and C in shared memory.
template <int MODE>
__host__ __device__ __forceinline__ int warps_for(int bt) {
  return MODE != STREAM && bt <= 2 ? 32 : 16;
}

template <typename XT, typename CT, int BT, int NCOL, bool BITPLANE, int MODE>
__global__ void __launch_bounds__(MODE != STREAM && BT <= 2 ? 1024 : 512)
    bitlinear_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ mp,
                     const CT* __restrict__ Cw, XT* __restrict__ y, int T, int n_r, int n_c,
                     int tn, int kb, int K, int td, int row_block, int rc, int m_vec,
                     int c_vec) {
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

  // shared memory: [x rows (decode) | M/C slots (stream)] [z buffers] [sums]
  unsigned char* p = smem;
  const XT* xs = x;
  if (MODE == DECODE) {
    XT* xsm = reinterpret_cast<XT*>(p);
    for (size_t i = threadIdx.x; i < (size_t)T * d_in; i += blockDim.x) xsm[i] = x[i];
    p += align16((size_t)T * d_in * sizeof(XT));
    xs = xsm;
    __syncthreads();
  }
  const size_t m_slot = align16((size_t)rc * m_tile);
  const size_t c_slot = align16((size_t)rc * c_tile * sizeof(CT));
  unsigned char* slot0 = p + (size_t)warp * 2 * (m_slot + c_slot);
  unsigned char* slot1 = slot0 + m_slot + c_slot;
  if (MODE == STREAM) p += (size_t)W * 2 * (m_slot + c_slot);
  float* zbuf = reinterpret_cast<float*>(p) + (size_t)warp * rc * BT * K;
  float* sums = reinterpret_cast<float*>(p) + (size_t)W * rc * BT * K;

  const int CW = 32 * NCOL;
  const int t_end = min(T, (int)(blockIdx.x + 1) * row_block);
  for (int d0 = blockIdx.z * CW; d0 < td; d0 += gridDim.z * CW) {
    for (int g = blockIdx.x * row_block; g < t_end; g += BT) {
      const int rows = min(BT, t_end - g);
      const XT* xg = xs + (size_t)g * d_in;
      float acc[BT][NCOL];
#pragma unroll
      for (int t = 0; t < BT; ++t)
#pragma unroll
        for (int jj = 0; jj < NCOL; ++jj) acc[t][jj] = 0.f;

      if (MODE == STREAM) {
        auto issue = [&](unsigned char* slot, int r0) {
          const int nr = min(rc, n_r - r0);
          copy_tiles(slot, mp + ((size_t)r0 * n_c + c) * m_tile, (size_t)n_c * m_tile, m_tile,
                     nr, m_vec, lane);
          copy_tiles(slot + m_slot,
                     reinterpret_cast<const unsigned char*>(Cw + ((size_t)r0 * n_c + c) * c_tile),
                     (size_t)n_c * c_tile * sizeof(CT), c_tile * sizeof(CT), nr, c_vec, lane);
        };
        int r0 = warp * rc;
        if (r0 < n_r) issue(slot0, r0);
        cp_async_commit();
        for (int i = 0; r0 < n_r; ++i, r0 += W * rc) {
          // overlapped copy: chunk i+1 is in flight while chunk i is consumed
          if (r0 + W * rc < n_r) issue((i & 1) ? slot0 : slot1, r0 + W * rc);
          cp_async_commit();
          cp_async_wait1();
          __syncwarp();
          const unsigned char* s = (i & 1) ? slot1 : slot0;
          consume<XT, CT, BT, NCOL, BITPLANE>(
              xg + (size_t)r0 * tn, d_in, rows, s, m_tile,
              reinterpret_cast<const CT*>(s + m_slot), c_tile, min(rc, n_r - r0), tn, kb, K, td,
              d0, zbuf, acc, lane);
        }
        cp_async_wait0();
        __syncwarp();
      } else {
        for (int r0 = warp * rc; r0 < n_r; r0 += W * rc) {
          consume<XT, CT, BT, NCOL, BITPLANE>(
              xg + (size_t)r0 * tn, d_in, rows, mp + ((size_t)r0 * n_c + c) * m_tile,
              (size_t)n_c * m_tile, Cw + ((size_t)r0 * n_c + c) * c_tile, (size_t)n_c * c_tile,
              min(rc, n_r - r0), tn, kb, K, td, d0, zbuf, acc, lane);
        }
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

struct Args {
  const void* x;
  const uint8_t* mp;
  const void* C;
  void* y;
  int E, T, n_r, n_c, tn, kb, K, td, block_t, rc;
  size_t smem;  // dynamic shared memory of one block (block_smem)
  cudaStream_t stream;
};

// The rows of one register group: grid keeps {1, 8}; decode and stream fit T.
template <int MODE>
inline int group_rows(int T) {
  if (MODE == GRID) return T == 1 ? 1 : 8;
  return T <= 1 ? 1 : T <= 2 ? 2 : T <= 4 ? 4 : 8;
}

// Columns per lane: one 32-column chunk for narrow C tiles, else four.
inline int ncol_for(int td) { return td <= 32 ? 1 : 4; }

// Dynamic shared memory of one block of MODE, the layout bitlinear_kernel
// carves: [x rows (decode) | two M/C slots per warp (stream)] [each warp's
// z buffer] [block sums].  The one definition of it: the launch checks it
// against the budget, and bitlinear_smem_bytes (bitlinear.cu) hands it to
// the Python side for admission.
template <int MODE>
inline size_t block_smem(int T, int n_r, int tn, int kb, int K, int td, int r_chunk,
                         size_t xsize, size_t csize) {
  const int bt = group_rows<MODE>(T);
  const size_t W = warps_for<MODE>(bt);
  const size_t rc = MODE == DECODE ? 1 : r_chunk;
  size_t n = W * rc * bt * K * 4 + (size_t)bt * 32 * ncol_for(td) * 4;
  if (MODE == DECODE) n += align16((size_t)T * n_r * tn * xsize);
  if (MODE == STREAM)
    n += W * 2 * (align16(rc * tn * kb) + align16(rc * K * td * csize));
  return n;
}

inline size_t x_size(int x_kind) { return x_kind == 0 ? 4 : x_kind == 1 ? 2 : 1; }

inline int copy_width(size_t bytes, const void* base) {
  const uintptr_t b = reinterpret_cast<uintptr_t>(base);
  if (bytes % 16 == 0 && b % 16 == 0) return 16;
  if (bytes % 4 == 0 && b % 4 == 0) return 4;
  return 1;
}

template <int MODE, typename XT, typename CT, int BT, int NCOL, bool BP>
cudaError_t launch_cfg(const Args& a) {
  const int W = warps_for<MODE>(BT);
  const int CW = 32 * NCOL;
  const int row_block = MODE == GRID ? (BT == 1 ? 1 : a.block_t) : a.T;
  const dim3 grid(MODE == GRID ? (a.T + row_block - 1) / row_block : 1, a.E * a.n_c,
                  MODE == GRID ? (a.td + CW - 1) / CW : 1);
  if (a.smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(bitlinear_kernel<XT, CT, BT, NCOL, BP, MODE>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)a.smem);
    if (err != cudaSuccess) return err;
  }
  const int m_vec = copy_width((size_t)a.tn * a.kb, a.mp);
  const int c_vec = copy_width((size_t)a.K * a.td * sizeof(CT), a.C);
  bitlinear_kernel<XT, CT, BT, NCOL, BP, MODE><<<grid, W * 32, a.smem, a.stream>>>(
      static_cast<const XT*>(a.x), a.mp, static_cast<const CT*>(a.C), static_cast<XT*>(a.y), a.T,
      a.n_r, a.n_c, a.tn, a.kb, a.K, a.td, row_block, a.rc, m_vec, c_vec);
  return cudaGetLastError();
}

template <int MODE, typename XT, typename CT, int BT, bool BP>
cudaError_t launch_ncol(const Args& a) {
  if (ncol_for(a.td) == 1) return launch_cfg<MODE, XT, CT, BT, 1, BP>(a);
  return launch_cfg<MODE, XT, CT, BT, 4, BP>(a);
}

template <int MODE, typename XT, typename CT, bool BP>
cudaError_t launch_bt(const Args& a) {
  switch (group_rows<MODE>(a.T)) {
    case 1:
      return launch_ncol<MODE, XT, CT, 1, BP>(a);
    case 8:
      return launch_ncol<MODE, XT, CT, 8, BP>(a);
    default:
      break;
  }
  if constexpr (MODE != GRID) {
    if (group_rows<MODE>(a.T) == 2) return launch_ncol<MODE, XT, CT, 2, BP>(a);
    return launch_ncol<MODE, XT, CT, 4, BP>(a);
  }
  return cudaErrorInvalidValue;
}

template <int MODE, typename XT, typename CT>
cudaError_t launch_math(const Args& a, int bitplane) {
  return bitplane ? launch_bt<MODE, XT, CT, true>(a) : launch_bt<MODE, XT, CT, false>(a);
}

template <int MODE, typename XT>
cudaError_t launch_c(const Args& a, int c_bf16, int bitplane) {
  return c_bf16 ? launch_math<MODE, XT, __nv_bfloat16>(a, bitplane)
                : launch_math<MODE, XT, float>(a, bitplane);
}

// x_kind: 0 float32, 1 bfloat16, 2 int8 (y in x's dtype); c_bf16: C is
// bfloat16 (else float32).  All pointers contiguous device memory.  Returns
// a cudaError_t, or minus the block's shared memory in bytes when that is
// over smem_budget (nothing is launched then).
template <int MODE>
int dispatch(const void* x, const uint8_t* mp, const void* C, void* y, int E, int T, int n_r,
             int n_c, int tn, int kb, int K, int td, int x_kind, int c_bf16, int bitplane,
             int block_t, int r_chunk, int smem_budget, void* stream) {
  if (T <= 0 || E <= 0) return cudaSuccess;
  if ((long long)E * n_c > 65535) return cudaErrorInvalidConfiguration;  // gridDim.y
  if (block_t < 1 || r_chunk < 1 || x_kind < 0 || x_kind > 2) return cudaErrorInvalidValue;
  const int rc = MODE == DECODE ? 1 : r_chunk;
  const size_t smem = block_smem<MODE>(T, n_r, tn, kb, K, td, rc, x_size(x_kind),
                                       c_bf16 ? 2 : 4);
  if (smem > (size_t)smem_budget) return -(int)(smem < 0x7fffffff ? smem : 0x7fffffff);
  const Args a{x, mp, C, y, E, T, n_r, n_c, tn, kb, K, td, block_t,
               rc, smem, reinterpret_cast<cudaStream_t>(stream)};
  switch (x_kind) {
    case 0:
      return launch_c<MODE, float>(a, c_bf16, bitplane);
    case 1:
      return launch_c<MODE, __nv_bfloat16>(a, c_bf16, bitplane);
    default:
      return launch_c<MODE, int8_t>(a, c_bf16, bitplane);
  }
}

}  // namespace bitlinear_impl
