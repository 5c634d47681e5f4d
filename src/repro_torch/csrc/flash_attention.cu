// Causal (optionally sliding-window) GQA attention with an online softmax
// (kernel K5).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention.  q (B, H, S, hd), k/v (B, KV, S, hd) -> o (B, H, S, hd),
// query head h reading kv head h / (H / KV).  Per query row, over the kv
// positions it may see (k_pos <= q_pos, and q_pos - k_pos < window when
// window > 0):
//     s = (q . k) * scale                          (f32 accumulation)
//     m_new = max(m, max s);  p = exp(s - m_new)   (masked p = 0)
//     l = l * exp(m - m_new) + sum p
//     acc = acc * exp(m - m_new) + p.to(v.dtype) @ v   (f32 accumulation)
// and o = acc / max(l, 1e-30) in q's dtype, as the Pallas kernel does
// (masked scores are -1e30, p is re-masked to 0 after the exp, precise expf).
//
// What bounds it on an H100: at the serving prefill shape (B=4, H=64, KV=8,
// S=1024, hd=128, bf16) the causal work is ~69 GFLOP against ~151 MB of
// q/k/v/o: 0.069 ms at the bf16 tensor-core peak, 0.045 ms at 3.35 TB/s, so
// operations bound it.  This first version is the simple correct design and
// runs on the f32 FMA pipes, not the tensor cores:
//   * one block of 256 threads per (64-row query tile, head, batch row); the
//     q tile is staged once in shared memory as f32;
//   * the kv loop runs over 64-row tiles from the window's first tile to the
//     diagonal tile, so fully masked tiles are never visited; K and then V
//     of a tile are staged in one shared buffer (rows padded by one float so
//     the 16 column threads of a row hit 16 banks);
//   * thread (ty, tx) owns query rows ty + 16a (a < 4): scores for columns
//     tx + 16b (b < 4) in registers, the row max and sum reduced across the
//     16 lanes of the half-warp with shuffles, and output columns
//     tx + 16e (e < hd/16) of the accumulator in registers;
//   * any S works: rows past S load zeros and are not written.
// mma/wgmma, TMA and a layout that saves the caller's transposes are later
// work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // kv rows per tile
constexpr int THREADS = 256; // 16 x 16
constexpr float NEG = -1e30f;

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

// p rounded to v's dtype before P.V, as the Pallas kernel's p.astype(v.dtype)
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f32(from_f32<T>(v)); }

// rows [row0, row0 + BK) of a (S, HD) slab into dst (BK, HD + 1) as f32
template <typename T, int HD>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src, int row0, int S) {
  for (int i = threadIdx.x; i < BK * HD; i += THREADS) {
    const int r = i / HD, d = i - r * HD;
    const int row = row0 + r;
    dst[r * (HD + 1) + d] = row < S ? to_f32(src[(size_t)row * HD + d]) : 0.f;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int H, int KV, int S,
                       int window, float scale) {
  constexpr int E = HD / 16;   // accumulator columns per thread
  constexpr int LD = HD + 1;
  extern __shared__ float smem[];
  float* qs = smem;                 // (BQ, LD)
  float* kvs = qs + BQ * LD;        // (BK, LD): K, then V, of one tile
  float* ps = kvs + BK * LD;        // (BQ, BK + 1)

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = tile * BQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  const T* qb = q + ((size_t)b * H + h) * S * HD;
  const T* kb = k + ((size_t)b * KV + kvh) * S * HD;
  const T* vb = v + ((size_t)b * KV + kvh) * S * HD;
  stage<T, HD>(qs, qb, q0, S);

  float m[4], l[4], acc[4][E];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = NEG;
    l[a] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[a][e] = 0.f;
  }

  // kv tiles from the window's first one to the diagonal
  const int lo = window > 0 ? q0 - (window - 1) : 0;
  const int j_lo = lo > 0 ? lo / BK : 0;
  const int j_hi = min(q0 + BQ - 1, S - 1) / BK;

  for (int j = j_lo; j <= j_hi; ++j) {
    const int k0 = j * BK;
    __syncthreads();                    // previous tile's P.V is done with kvs
    stage<T, HD>(kvs, kb, k0, S);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qv[a] = qs[(ty + 16 * a) * LD + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = kvs[(tx + 16 * c) * LD + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[a][c] += qv[a] * kv[c];
    }

    float corr[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int qp = q0 + ty + 16 * a;
      bool ok[4];
      float mx = NEG;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kp = k0 + tx + 16 * c;
        ok[c] = qp >= kp && (window <= 0 || qp - kp < window);
        s[a][c] = ok[c] ? s[a][c] * scale : NEG;
        mx = fmaxf(mx, s[a][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[a], mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = ok[c] ? expf(s[a][c] - m_new) : 0.f;
        sum += p;
        ps[(ty + 16 * a) * (BK + 1) + tx + 16 * c] = round_to<T>(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      corr[a] = expf(m[a] - m_new);
      l[a] = l[a] * corr[a] + sum;
      m[a] = m_new;
    }

    __syncthreads();                    // every thread is done reading K
    stage<T, HD>(kvs, vb, k0, S);
    __syncthreads();

#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[a][e] *= corr[a];
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) pv[a] = ps[(ty + 16 * a) * (BK + 1) + kk];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float vv = kvs[kk * LD + tx + 16 * e];
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a][e] += pv[a] * vv;
      }
    }
  }

  T* ob = o + ((size_t)b * H + h) * S * HD;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + ty + 16 * a;
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(l[a], 1e-30f);
#pragma unroll
    for (int e = 0; e < E; ++e) ob[(size_t)row * HD + tx + 16 * e] = from_f32<T>(acc[a][e] * inv);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H, int KV,
                   int S, int window, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)(BQ + BK) * (HD + 1) + (size_t)BQ * (BK + 1));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_attention_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, KV, S, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* o, int B, int H, int KV,
                      int S, int hd, int window, float scale, cudaStream_t st) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, B, H, KV, S, window, scale, st);
    case 32: return launch<T, 32>(q, k, v, o, B, H, KV, S, window, scale, st);
    case 64: return launch<T, 64>(q, k, v, o, B, H, KV, S, window, scale, st);
    case 128: return launch<T, 128>(q, k, v, o, B, H, KV, S, window, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, o (B, H, S, hd); k, v (B, KV, S, hd); all contiguous device pointers of
// float32 (bf16 = 0) or bfloat16 (bf16 = 1).  H % KV == 0, hd in
// {16, 32, 64, 128}, window 0 (full causal) or > 0.  Returns
// cudaGetLastError() of the launch.
int flash_attention(const void* q, const void* k, const void* v, void* o, int B, int H, int KV,
                    int S, int hd, int window, float scale, int bf16, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (bf16) return launch_hd<__nv_bfloat16>(q, k, v, o, B, H, KV, S, hd, window, scale, st);
  return launch_hd<float>(q, k, v, o, B, H, KV, S, hd, window, scale, st);
}

}  // extern "C"
