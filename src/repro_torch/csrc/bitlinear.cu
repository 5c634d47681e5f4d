// Fused compressed linear layer y = (x @ M) @ C (kernel K3).
//
// Replaces the Pallas TPU kernel repro/kernels/bitlinear.py::bitlinear
// (grid schedule _kernel, decode schedule _decode_kernel).  The weight is
// stored per (row tile r, column tile c) as a bit-packed sign matrix
// M[r, c] in {-1,+1}^{tn x K} (uint8, LSB-first, kb = ceil(K/8) bytes per
// row) and a small real factor C[r, c] (K x td).  For every r, c:
//     z = x[:, r*tn:(r+1)*tn] @ M[r, c]                  (f32 accumulation)
//     y[:, c*td:(c+1)*td] += z.to(C.dtype) @ C[r, c]      (f32 accumulation)
// and y is written once in x's dtype.
//
// What bounds it: bytes at decode and small prefill T (C dominates: K*td
// elements per (r, c) tile, 1/8 of the dense weight at K/tn = 1/8), and the
// f32 FMA rate at large T, since K (3-4) is below the tensor cores'
// k-minimum.  The design keeps as many independent (r, c) tiles in flight
// as the card holds:
//   * one block per (row block of BT tokens, column tile c, column chunk);
//     its W warps take the row tiles r = warp, warp + W, ... with no block
//     barrier inside the loop, so every warp streams its own C and M bytes
//     (the TPU's sequential "arbitrary" r axis becomes this strided loop);
//   * per r a warp computes z (BT x K) lane-parallel over (token, k) pairs,
//     unpacking the sign bits in registers (no float M is materialised),
//     rounds z to C's dtype as the JAX kernel does, and keeps it in its own
//     slice of shared memory; then lane l owns output columns l, l+32, ...
//     and accumulates z @ C[r, c] into BT x NCOL f32 registers, with C read
//     coalesced across the warp;
//   * at the end the W partial sums are added in warp order through shared
//     memory (deterministic), and y is written once.
// Ragged T is masked (rows >= T read zeros and are not written) and any K
// works (K % 8 != 0 included).  wgmma, TMA and a split of r across blocks
// for the fewest-column decode shapes are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename XT, typename CT, int BT, int NCOL>
__global__ void bitlinear_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ mp,
                                 const CT* __restrict__ Cw, XT* __restrict__ y, int T,
                                 int n_r, int n_c, int tn, int kb, int K, int td) {
  extern __shared__ float smem[];
  const int W = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* zbuf = smem + warp * BT * K;            // (BT, K) this warp's z
  float* sums = smem + W * BT * K;               // (BT, 32*NCOL) block sums

  const int t0 = blockIdx.x * BT;
  const int rows = min(BT, T - t0);
  const int c = blockIdx.y;
  const int d0 = blockIdx.z * 32 * NCOL;         // first column of this chunk
  const int d_in = n_r * tn;
  const int d_out = n_c * td;

  float acc[BT][NCOL];
#pragma unroll
  for (int t = 0; t < BT; ++t)
#pragma unroll
    for (int j = 0; j < NCOL; ++j) acc[t][j] = 0.f;

  for (int r = warp; r < n_r; r += W) {
    const uint8_t* mrc = mp + ((size_t)r * n_c + c) * tn * kb;
    const CT* crc = Cw + ((size_t)r * n_c + c) * K * td;
    for (int p = lane; p < BT * K; p += 32) {
      const int t = p / K, k = p - t * K;
      const int byte = k >> 3, bit = k & 7;
      float z = 0.f;
      if (t < rows) {
        const XT* xr = x + (size_t)(t0 + t) * d_in + (size_t)r * tn;
#pragma unroll 8
        for (int nn = 0; nn < tn; ++nn) {
          const float xv = to_f32(xr[nn]);
          z += ((mrc[nn * kb + byte] >> bit) & 1) ? xv : -xv;
        }
      }
      zbuf[p] = to_f32(from_f32<CT>(z));
    }
    __syncwarp();
    for (int k = 0; k < K; ++k) {
      float cv[NCOL];
#pragma unroll
      for (int j = 0; j < NCOL; ++j) {
        const int d = d0 + j * 32 + lane;
        cv[j] = d < td ? to_f32(crc[(size_t)k * td + d]) : 0.f;
      }
#pragma unroll
      for (int t = 0; t < BT; ++t) {
        const float zt = zbuf[t * K + k];
#pragma unroll
        for (int j = 0; j < NCOL; ++j) acc[t][j] += zt * cv[j];
      }
    }
    __syncwarp();
  }

  // deterministic block reduction: warps add their partials in order
  for (int i = threadIdx.x; i < BT * 32 * NCOL; i += blockDim.x) sums[i] = 0.f;
  __syncthreads();
  for (int w = 0; w < W; ++w) {
    if (warp == w) {
#pragma unroll
      for (int t = 0; t < BT; ++t)
#pragma unroll
        for (int j = 0; j < NCOL; ++j) sums[t * 32 * NCOL + j * 32 + lane] += acc[t][j];
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < rows * 32 * NCOL; i += blockDim.x) {
    const int t = i / (32 * NCOL), dd = i - t * 32 * NCOL;
    const int d = d0 + dd;
    if (d < td) y[(size_t)(t0 + t) * d_out + (size_t)c * td + d] = from_f32<XT>(sums[i]);
  }
}

template <typename XT, typename CT, int BT, int NCOL>
cudaError_t launch_cfg(const void* x, const uint8_t* mp, const void* C, void* y, int T,
                       int n_r, int n_c, int tn, int kb, int K, int td, cudaStream_t stream) {
  // decode rows (BT = 1) keep few registers: 32 warps per block; larger
  // row blocks hold BT x NCOL accumulators per lane: 16 warps
  const int warps = BT == 1 ? 32 : 16;
  const dim3 grid((T + BT - 1) / BT, n_c, (td + 32 * NCOL - 1) / (32 * NCOL));
  const size_t smem = sizeof(float) * ((size_t)warps * BT * K + (size_t)BT * 32 * NCOL);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(bitlinear_kernel<XT, CT, BT, NCOL>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
  }
  bitlinear_kernel<XT, CT, BT, NCOL><<<grid, warps * 32, smem, stream>>>(
      static_cast<const XT*>(x), mp, static_cast<const CT*>(C), static_cast<XT*>(y), T, n_r,
      n_c, tn, kb, K, td);
  return cudaGetLastError();
}

template <typename XT, typename CT, int BT>
cudaError_t launch_bt(const void* x, const uint8_t* mp, const void* C, void* y, int T, int n_r,
                      int n_c, int tn, int kb, int K, int td, cudaStream_t st) {
  if (td <= 32) return launch_cfg<XT, CT, BT, 1>(x, mp, C, y, T, n_r, n_c, tn, kb, K, td, st);
  if (td <= 64) return launch_cfg<XT, CT, BT, 2>(x, mp, C, y, T, n_r, n_c, tn, kb, K, td, st);
  return launch_cfg<XT, CT, BT, 4>(x, mp, C, y, T, n_r, n_c, tn, kb, K, td, st);
}

template <typename XT, typename CT>
cudaError_t launch(const void* x, const uint8_t* mp, const void* C, void* y, int T, int n_r,
                   int n_c, int tn, int kb, int K, int td, cudaStream_t st) {
  if (T == 1) return launch_bt<XT, CT, 1>(x, mp, C, y, T, n_r, n_c, tn, kb, K, td, st);
  return launch_bt<XT, CT, 8>(x, mp, C, y, T, n_r, n_c, tn, kb, K, td, st);
}

}  // namespace

extern "C" {

// x (T, n_r*tn) and y (T, n_c*td) are float32 (x_bf16 = 0) or bfloat16
// (x_bf16 = 1); m_packed (n_r, n_c, tn, kb) uint8; C (n_r, n_c, K, td) is
// float32 (c_bf16 = 0) or bfloat16 (c_bf16 = 1).  All contiguous device
// pointers.  Returns cudaGetLastError() of the launch.
int bitlinear(const void* x, const uint8_t* m_packed, const void* C, void* y, int T, int n_r,
              int n_c, int tn, int kb, int K, int td, int x_bf16, int c_bf16, void* stream) {
  if (T <= 0) return 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (x_bf16) {
    if (c_bf16)
      return launch<__nv_bfloat16, __nv_bfloat16>(x, m_packed, C, y, T, n_r, n_c, tn, kb, K,
                                                   td, st);
    return launch<__nv_bfloat16, float>(x, m_packed, C, y, T, n_r, n_c, tn, kb, K, td, st);
  }
  if (c_bf16)
    return launch<float, __nv_bfloat16>(x, m_packed, C, y, T, n_r, n_c, tn, kb, K, td, st);
  return launch<float, float>(x, m_packed, C, y, T, n_r, n_c, tn, kb, K, td, st);
}

}  // extern "C"
