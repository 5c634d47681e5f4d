// Kernel K3, stream schedule: bitlinear_stream_kernel, a block per (column
// tile, column chunk, row block) with r split across the blocks of a
// thread-block cluster, one producer thread feeding a ring of r_chunk-tile
// stages with tensor-map copies, consumer warps with decode's lane-parallel
// body.  Replaces repro/kernels/bitlinear.py::_stream_kernel (call site
// :388).  The design and what bounds it: bitlinear_stream.cuh.  This file
// also holds the library's cache of M's and C's tensor maps: at namespace
// scope in this translation unit, so each library that builds it has its
// own.
#include <mutex>
#include <string>
#include <unordered_map>

#include "bitlinear_stream.cuh"

namespace {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

std::mutex lock;
EncodeTiled encode_tiled = nullptr;
std::unordered_map<std::string, CUtensorMap> cache;   // M's and C's maps
long long encodes = 0;                                 // cache misses
constexpr size_t MAX_MAPS = 4096;

// cuTensorMapEncodeTiled from the driver through the runtime (no -lcuda)
int driver_encode(EncodeTiled* fn) {
  if (encode_tiled == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault,
                                              &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || f == nullptr) return cudaErrorSymbolNotFound;
    encode_tiled = reinterpret_cast<EncodeTiled>(f);
  }
  *fn = encode_tiled;
  return 0;
}

}  // namespace

namespace bitlinear_impl {

int stream_encode(CUtensorMap* out, const MapSpec& s, const void* base, bool cached) {
  // the key: every field of the encoding (address, rank, element size,
  // dims, strides, box), field by field (no padding bytes)
  std::string key;
  auto put = [&key](const void* v, size_t n) { key.append(static_cast<const char*>(v), n); };
  put(&base, sizeof(base));
  put(&s.rank, sizeof(s.rank));
  put(&s.esize, sizeof(s.esize));
  put(s.dims, sizeof(s.dims));
  put(s.strides, sizeof(s.strides));
  put(s.box, sizeof(s.box));
  std::lock_guard<std::mutex> guard(lock);
  if (cached) {
    auto it = cache.find(key);
    if (it != cache.end()) {
      *out = it->second;
      return 0;
    }
  }
  EncodeTiled fn;
  const int err = driver_encode(&fn);
  if (err) return err;
  // the elements' bits are copied as they are: unsigned types of their size
  const CUtensorMapDataType type = s.esize == 1   ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                   : s.esize == 2 ? CU_TENSOR_MAP_DATA_TYPE_UINT16
                                                  : CU_TENSOR_MAP_DATA_TYPE_UINT32;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUresult r = fn(out, type, (cuuint32_t)s.rank, const_cast<void*>(base), s.dims,
                        s.strides, s.box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return STREAM_ENCODE_ERROR + (int)r;
  if (cached) {
    if (cache.size() >= MAX_MAPS) cache.clear();
    cache.emplace(key, *out);
    ++encodes;
  }
  return 0;
}

}  // namespace bitlinear_impl

extern "C" {

// x (T, n_r*tn) and y (T, n_c*td): x_kind 0 float32, 1 bfloat16, 2 int8 (y
// in x's dtype); m_packed (n_r, n_c, tn, kb) uint8; C (n_r, n_c, K, td)
// float32 (c_bf16 = 0) or bfloat16 (c_bf16 = 1).  bitplane selects the bit
// algebra; r_chunk is the r tiles of a ring stage; clusters is S >= 1, the
// blocks of a cluster that split each column tile's r chunks
// (kernels/bitlinear.py::stream_cluster_size; above 8 a non-portable
// cluster).  *maps is set to the parts that went through a tensor map
// (1 C, 2 M, 4 x).  Returns cudaGetLastError() of the launch (the launch's
// own error for an S the card cannot run), cudaErrorInvalidValue for bad
// arguments, 20000 plus the driver's CUresult when a tensor map fails to
// encode, or minus the block's shared memory in bytes when that is over
// smem_budget (nothing launched).
int bitlinear_stream(const void* x, const uint8_t* m_packed, const void* C, void* y, int T,
                     int n_r, int n_c, int tn, int kb, int K, int td, int x_kind, int c_bf16,
                     int bitplane, int r_chunk, int clusters, int smem_budget, void* stream,
                     int* maps) {
  return bitlinear_impl::stream_dispatch(x, m_packed, C, y, T, n_r, n_c, tn, kb, K, td, x_kind,
                                         c_bf16, bitplane, r_chunk, clusters, smem_budget, stream,
                                         maps);
}

// Dynamic shared memory in bytes of one stream block for these shapes, as
// the launch computes it (stream_geom: independent of n_r and n_c); -1 for
// bad arguments.  kernels/bitlinear.py admits the schedule by it.
long long bitlinear_stream_smem_bytes(int T, int tn, int kb, int K, int td, int x_kind,
                                      int c_bf16, int r_chunk) {
  using namespace bitlinear_impl;
  if (x_kind < 0 || x_kind > 2 || r_chunk < 1 || T < 1) return -1;
  return (long long)stream_geom(T, tn, kb, K, td, x_size(x_kind), c_bf16 ? 2 : 4, r_chunk).smem;
}

// The parts the layout stages through a tensor map for these shapes (1 C,
// 2 M, 4 x), at 16-byte aligned bases: the rule kernels/bitlinear.py's
// stream_tensor_maps mirrors.
int bitlinear_stream_layout_maps(int T, int tn, int kb, int K, int td, int x_kind, int c_bf16,
                                 int r_chunk) {
  using namespace bitlinear_impl;
  if (x_kind < 0 || x_kind > 2 || r_chunk < 1 || T < 1) return -1;
  const StreamGeom g = stream_geom(T, tn, kb, K, td, x_size(x_kind), c_bf16 ? 2 : 4, r_chunk);
  return g.map_c | g.map_m << 1 | g.map_x << 2;
}

// M's and C's maps encoded so far (the cache's misses).
long long bitlinear_stream_map_encodes() {
  std::lock_guard<std::mutex> guard(lock);
  return encodes;
}

}  // extern "C"
