// Kernels K3 and K4, grid schedule: bf16 x with bf16 C on the tensor cores
// (bitlinear_mma_kernel: a block per (row block, expert, four column tiles,
// column chunk of up to 144 columns, td padded to a multiple of 16)), every other call on the FMA pipes (bitlinear_kernel:
// a block per (row block of block_t rows, expert and column tile, 32*NCOL
// column chunk)).  Replaces repro/kernels/bitlinear.py::_kernel (call site
// :417) and ::_grouped_kernel (:558).  The designs and what bounds them:
// bitlinear.cuh.
#include "bitlinear.cuh"

extern "C" {

// x (E, T, n_r*tn) and y (E, T, n_c*td): x_kind 0 float32, 1 bfloat16,
// 2 int8 (y in x's dtype); m_packed (E, n_r, n_c, tn, kb) uint8; C (E, n_r,
// n_c, K, td) float32 (c_bf16 = 0) or bfloat16 (c_bf16 = 1); E = 1 for K3.
// bitplane selects the bit algebra; block_t is the rows a block covers,
// r_chunk the r tiles a warp (FMA body) or a step (tensor-core body) takes
// at a time; up to small_t rows (kernels/bitlinear.py's SMALL_T) the grid
// keeps the FMA body.  *tensor_cores is set to 1 when the launch ran the
// tensor-core body, else 0.  Returns cudaGetLastError() of the launch,
// cudaErrorMisalignedAddress for a tensor-core call whose x or C is not
// 16-byte or M or y not 4-byte aligned, or minus the block's shared memory in
// bytes when that is over smem_budget (nothing launched).
int bitlinear_grid(const void* x, const uint8_t* m_packed, const void* C, void* y, int E, int T,
                   int n_r, int n_c, int tn, int kb, int K, int td, int x_kind, int c_bf16,
                   int bitplane, int block_t, int r_chunk, int smem_budget, int small_t,
                   void* stream, int* tensor_cores) {
  return bitlinear_impl::dispatch(
      x, m_packed, C, y, E, T, n_r, n_c, tn, kb, K, td, x_kind, c_bf16, bitplane, block_t,
      r_chunk, smem_budget, small_t, stream, tensor_cores);
}

// Dynamic shared memory in bytes of one grid block for these shapes, as the
// launch computes it; -1 for an unknown x_kind (decode's and stream's:
// bitlinear_decode_smem_bytes and bitlinear_stream_smem_bytes in their own
// sources).  kernels/bitlinear.py admits schedules by it.
long long bitlinear_smem_bytes(int T, int tn, int kb, int K, int td, int x_kind, int c_bf16,
                               int r_chunk, int small_t) {
  using namespace bitlinear_impl;
  if (x_kind < 0 || x_kind > 2 || r_chunk < 1) return -1;
  return (long long)block_smem(T, tn, kb, K, td, r_chunk, x_size(x_kind), c_bf16 ? 2 : 4,
                               small_t);
}

}  // extern "C"
