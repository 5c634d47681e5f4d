// Kernels K3 and K4, grid schedule: one block per (row block of block_t
// rows, expert and column tile, 32*NCOL column chunk).  Replaces
// repro/kernels/bitlinear.py::_kernel (call site :417) and
// ::_grouped_kernel (:558).  The design and what bounds it:
// bitlinear.cuh.
#include "bitlinear.cuh"

extern "C" {

// x (E, T, n_r*tn) and y (E, T, n_c*td): x_kind 0 float32, 1 bfloat16,
// 2 int8 (y in x's dtype); m_packed (E, n_r, n_c, tn, kb) uint8; C (E, n_r,
// n_c, K, td) float32 (c_bf16 = 0) or bfloat16 (c_bf16 = 1); E = 1 for K3.
// bitplane selects the bit algebra; block_t is the rows a block covers,
// r_chunk the r tiles a warp takes at a time.  Returns cudaGetLastError()
// of the launch, or minus the block's shared memory in bytes when that is
// over smem_budget (nothing launched).
int bitlinear_grid(const void* x, const uint8_t* m_packed, const void* C, void* y, int E, int T,
                   int n_r, int n_c, int tn, int kb, int K, int td, int x_kind, int c_bf16,
                   int bitplane, int block_t, int r_chunk, int smem_budget, void* stream) {
  return bitlinear_impl::dispatch<bitlinear_impl::GRID>(x, m_packed, C, y, E, T, n_r, n_c, tn,
                                                        kb, K, td, x_kind, c_bf16, bitplane,
                                                        block_t, r_chunk, smem_budget, stream);
}

// Dynamic shared memory in bytes of one block of schedule `mode` (0 grid,
// 1 decode, 2 stream) for these shapes, as the launch computes it; -1 for
// an unknown mode or x_kind.  kernels/bitlinear.py admits schedules by it.
long long bitlinear_smem_bytes(int mode, int T, int n_r, int tn, int kb, int K, int td,
                               int x_kind, int c_bf16, int r_chunk) {
  using namespace bitlinear_impl;
  if (x_kind < 0 || x_kind > 2 || r_chunk < 1) return -1;
  const size_t xs = x_size(x_kind), cs = c_bf16 ? 2 : 4;
  switch (mode) {
    case GRID:
      return (long long)block_smem<GRID>(T, n_r, tn, kb, K, td, r_chunk, xs, cs);
    case DECODE:
      return (long long)block_smem<DECODE>(T, n_r, tn, kb, K, td, r_chunk, xs, cs);
    case STREAM:
      return (long long)block_smem<STREAM>(T, n_r, tn, kb, K, td, r_chunk, xs, cs);
    default:
      return -1;
  }
}

}  // extern "C"
