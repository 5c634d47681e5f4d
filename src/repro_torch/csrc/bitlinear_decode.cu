// Kernels K3 and K4, decode schedule: bitlinear_decode_kernel, a block per
// (expert, column tile) with r split across the blocks of a thread-block
// cluster, a producer warp streaming the tiles into shared memory with bulk
// copies, consumer warps with a lane-parallel body.  Replaces
// repro/kernels/bitlinear.py::_decode_kernel (call site :369) and
// ::_grouped_decode_kernel (:536).  The design and what bounds it:
// bitlinear_decode.cuh.
#include "bitlinear_decode.cuh"

extern "C" {

// x (E, T, n_r*tn) and y (E, T, n_c*td): x_kind 0 float32, 1 bfloat16,
// 2 int8 (y in x's dtype); m_packed (E, n_r, n_c, tn, kb) uint8; C (E, n_r,
// n_c, K, td) float32 (c_bf16 = 0) or bfloat16 (c_bf16 = 1); E = 1 for K3.
// bitplane selects the bit algebra; clusters is S >= 1, the blocks of a
// cluster that split each (expert, column tile)'s r tiles
// (kernels/bitlinear.py::decode_cluster_size; above 8 a non-portable
// cluster).  Returns cudaGetLastError() of the launch (the launch's own
// error for an S the card cannot run), cudaErrorInvalidValue for bad
// arguments, or minus the block's shared memory in bytes when that is over
// smem_budget (nothing launched).
int bitlinear_decode(const void* x, const uint8_t* m_packed, const void* C, void* y, int E, int T,
                     int n_r, int n_c, int tn, int kb, int K, int td, int x_kind, int c_bf16,
                     int bitplane, int clusters, int smem_budget, void* stream) {
  return bitlinear_impl::decode_dispatch(x, m_packed, C, y, E, T, n_r, n_c, tn, kb, K, td, x_kind,
                                         c_bf16, bitplane, clusters, smem_budget, stream);
}

// Dynamic shared memory in bytes of one decode block for these shapes, as
// the launch computes it (decode_geom: independent of n_r); -1 for an
// unknown x_kind.  kernels/bitlinear.py admits the schedule by it.
long long bitlinear_decode_smem_bytes(int T, int tn, int kb, int K, int td, int x_kind,
                                      int c_bf16) {
  using namespace bitlinear_impl;
  if (x_kind < 0 || x_kind > 2) return -1;
  return (long long)decode_geom(T, tn, kb, K, td, x_size(x_kind), c_bf16 ? 2 : 4).smem;
}

// The decode block's layout for these shapes, as decode_geom computes it:
// out[0] r tiles a stage, out[1] how C reaches the consumers (0 read from
// device memory, 1 staged as whole tiles, 2 staged raw), out[2] the blocks
// along td.  Returns -1 for an unknown x_kind, else 0.
// kernels/bitlinear.py::decode_layout mirrors it.
int bitlinear_decode_layout(int T, int tn, int kb, int K, int td, int x_kind, int c_bf16,
                            int* out) {
  using namespace bitlinear_impl;
  if (x_kind < 0 || x_kind > 2) return -1;
  const DecodeGeom g = decode_geom(T, tn, kb, K, td, x_size(x_kind), c_bf16 ? 2 : 4);
  out[0] = g.rs;
  out[1] = g.stage_c ? 1 : g.raw_c ? 2 : 0;
  out[2] = g.raw_c ? 1 : (td + 32 * ring_cols(td) - 1) / (32 * ring_cols(td));
  return 0;
}

}  // extern "C"
