// Kernel K3, stream schedule: one block per column tile; each warp
// double-buffers its chunks of r_chunk M and C tiles through two
// shared-memory slots filled with cp.async, the copy of chunk i+1 issued
// before chunk i is consumed.  Replaces
// repro/kernels/bitlinear.py::_stream_kernel (call site :388).  The design
// and what bounds it: bitlinear.cuh.
#include "bitlinear.cuh"

extern "C" {

// Arguments as bitlinear_grid (bitlinear.cu); block_t is ignored (a block
// covers all T rows).
int bitlinear_stream(const void* x, const uint8_t* m_packed, const void* C, void* y, int E, int T,
                     int n_r, int n_c, int tn, int kb, int K, int td, int x_kind, int c_bf16,
                     int bitplane, int block_t, int r_chunk, int smem_budget, int small_t,
                     void* stream, int* tensor_cores) {
  return bitlinear_impl::dispatch<bitlinear_impl::STREAM>(
      x, m_packed, C, y, E, T, n_r, n_c, tn, kb, K, td, x_kind, c_bf16, bitplane, block_t,
      r_chunk, smem_budget, small_t, stream, tensor_cores);
}

}  // extern "C"
