// Kernels K3 and K4, decode schedule: one block per (expert, column tile)
// with every r tile reduced inside it and the expert's T activation rows
// staged once in shared memory; the register group fits T (1, 2, 4 or 8
// rows).  Replaces repro/kernels/bitlinear.py::_decode_kernel (call site
// :369) and ::_grouped_decode_kernel (:536).  The design and what bounds it:
// bitlinear.cuh.
#include "bitlinear.cuh"

extern "C" {

// Arguments as bitlinear_grid (bitlinear.cu); block_t and r_chunk are
// ignored: a block covers all T rows and takes one r tile at a time.
int bitlinear_decode(const void* x, const uint8_t* m_packed, const void* C, void* y, int E, int T,
                     int n_r, int n_c, int tn, int kb, int K, int td, int x_kind, int c_bf16,
                     int bitplane, int block_t, int r_chunk, int smem_budget, int small_t,
                     void* stream, int* tensor_cores) {
  return bitlinear_impl::dispatch<bitlinear_impl::DECODE>(
      x, m_packed, C, y, E, T, n_r, n_c, tn, kb, K, td, x_kind, c_bf16, bitplane, block_t,
      r_chunk, smem_budget, small_t, stream, tensor_cores);
}

}  // extern "C"
