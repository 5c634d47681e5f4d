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
// (masked scores are -1e30, p is re-masked to 0 after the exp).  Every
// tensor is addressed through its batch, head and sequence strides (hd
// contiguous), so the model's (B, S, H, hd) layout is read and written in
// place.
//
// What bounds it on an H100: at the serving prefill shape (B=4, H=64, KV=8,
// S=1024, hd=128, bf16) the causal work is ~69 GFLOP against ~151 MB of
// q/k/v/o: 0.069 ms at the bf16 tensor-core peak, 0.045 ms at 3.35 TB/s, so
// operations bound it.  Two bodies:
//
// bf16: a FlashAttention-2 shape on the tensor cores (flash_mma_kernel).
//   * a block owns 16 * WARPS query rows of one (head, batch row); warp w
//     owns rows 16w .. 16w+15 and keeps them in registers as mma
//     A-fragments for the whole kv loop;
//   * the kv loop runs over 64-row tiles from the window's first tile to the
//     diagonal, so fully masked tiles are never visited; the K and V tiles
//     come into shared memory through cp.async in two stages, the copy of
//     tile j+1 in flight while tile j is consumed; rows are padded by 8
//     elements (16 bytes), so the eight 16-byte rows an ldmatrix reads fall
//     in distinct banks; rows past S are zero-filled;
//   * S = Q K^T is mma.sync.m16n8k16 (bf16 in, f32 accumulate), K's
//     B-fragments by ldmatrix; the online softmax runs on the accumulator
//     fragments in the log2 domain (2^x of scores pre-scaled by
//     scale * log2 e, on the SFU), each row's max reduced over its quad of
//     lanes by __shfl_xor_sync; each lane keeps its own partial row sum,
//     added over the quad once at the end; only the tiles that some row of
//     the warp sees in part (the diagonal, the window's edge) are masked;
//   * P is rounded to bf16 in registers and repacked from the accumulator
//     layout into A-fragments (the Pallas kernel's p.astype(v.dtype)); it
//     never goes through shared memory; O += P V is mma.sync again, V's
//     B-fragments by ldmatrix.trans;
//   * query tiles are launched last-first, so the longest (diagonal-most)
//     blocks start first.
//   What holds it back (chip_smoke.py, PERF.md): ~2.5x SDPA at the qwen3-32b
//   prefill; each warp's softmax between its two products is serial work
//   that mma.sync cannot overlap, and 8 warps per block (128 rows) were
//   slower than 4.  wgmma with TMA, warp specialisation (a producer warp,
//   two consumer warpgroups ping-ponging softmax and mma) and skipping the
//   masked half of the diagonal tile are later work.
// f32: the first version's body on the FMA pipes (TF32 cannot meet K5's
//   f32 tolerance of 2e-5): one block of 256 threads per 64-row query tile,
//   q, K and V staged in shared memory as f32 (rows padded by one float),
//   thread (ty, tx) owns rows ty + 16a and columns tx + 16e, row statistics
//   reduced across the half-warp with shuffles; precise expf.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 64;       // kv rows per tile (both bodies)
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// element strides of one tensor: batch, head, sequence (hd is contiguous)
struct Strides {
  long long b, h, s;
};
struct AllStrides {
  Strides q, k, v, o;
};

// ---------------------------------------------------------------------------
// f32 body (FMA pipes)
// ---------------------------------------------------------------------------

constexpr int BQ_F32 = 64;
constexpr int THREADS_F32 = 256;   // 16 x 16

// rows [row0, row0 + BK) of a (S, HD) slab with row stride ld_src into dst
// (BK, HD + 1)
template <int HD>
__device__ __forceinline__ void stage_f32(float* dst, const float* __restrict__ src,
                                          long long ld_src, int row0, int S) {
  for (int i = threadIdx.x; i < BK * HD; i += THREADS_F32) {
    const int r = i / HD, d = i - r * HD;
    const int row = row0 + r;
    dst[r * (HD + 1) + d] = row < S ? src[(long long)row * ld_src + d] : 0.f;
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS_F32)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int H, int KV, int S,
                 AllStrides st, int window, float scale) {
  constexpr int E = HD / 16;   // accumulator columns per thread
  constexpr int LD = HD + 1;
  extern __shared__ float smem[];
  float* qs = smem;                   // (BQ, LD)
  float* kvs = qs + BQ_F32 * LD;      // (BK, LD): K, then V, of one tile
  float* ps = kvs + BK * LD;          // (BQ, BK + 1)

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = tile * BQ_F32;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  const float* qb = q + b * st.q.b + h * st.q.h;
  const float* kb = k + b * st.k.b + kvh * st.k.h;
  const float* vb = v + b * st.v.b + kvh * st.v.h;
  stage_f32<HD>(qs, qb, st.q.s, q0, S);

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
  const int j_hi = min(q0 + BQ_F32 - 1, S - 1) / BK;

  for (int j = j_lo; j <= j_hi; ++j) {
    const int k0 = j * BK;
    __syncthreads();                    // previous tile's P.V is done with kvs
    stage_f32<HD>(kvs, kb, st.k.s, k0, S);
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
        ps[(ty + 16 * a) * (BK + 1) + tx + 16 * c] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      corr[a] = expf(m[a] - m_new);
      l[a] = l[a] * corr[a] + sum;
      m[a] = m_new;
    }

    __syncthreads();                    // every thread is done reading K
    stage_f32<HD>(kvs, vb, st.v.s, k0, S);
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

  float* ob = o + b * st.o.b + h * st.o.h;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + ty + 16 * a;
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(l[a], 1e-30f);
#pragma unroll
    for (int e = 0; e < E; ++e) ob[(long long)row * st.o.s + tx + 16 * e] = acc[a][e] * inv;
  }
}

template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int B, int H,
                       int KV, int S, const AllStrides& st, int window, float scale,
                       cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(BQ_F32 + BK) * (HD + 1) + (size_t)BQ_F32 * (BK + 1));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(flash_f32_kernel<HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((S + BQ_F32 - 1) / BQ_F32, H, B);
  flash_f32_kernel<HD><<<grid, THREADS_F32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), H, KV, S, st, window, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 body (tensor cores)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d (16x8 f32) += a (16x16 bf16, row) . b (16x8 bf16, col)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the SFU's ex2.approx.ftz (what exp2f compiles to under fast math):
// relative error ~2^-22, far inside p's bf16 rounding (2^-8); results below
// 2^-126 flush to 0, which a bf16 p @ v cannot tell from their value
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats -> one register of two bf16, the first in the low half (RN)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int HD, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int H,
                 int KV, int S, AllStrides st, int window, float scale_log2) {
  constexpr int BQ = 16 * WARPS;
  constexpr int LDS = HD + 8;          // padded smem row (elements): ldmatrix conflict-free
  constexpr int KS = HD / 16;          // k-slices of q . k
  constexpr int NO = HD / 8;           // n-tiles of the output
  constexpr int CHUNKS = BK * HD / 8;  // 16-byte chunks of one K or V tile
  constexpr int THREADS = WARPS * 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [2][BK][LDS]
  __nv_bfloat16* vs = ks + 2 * BK * LDS;                            // [2][BK][LDS]

  const int tile = gridDim.x - 1 - blockIdx.x;   // longest (diagonal-most) tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = tile * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  const __nv_bfloat16* kb = k + b * st.k.b + kvh * st.k.h;
  const __nv_bfloat16* vb = v + b * st.v.b + kvh * st.v.h;

  // kv tile j into stage s: K and V rows [j*BK, j*BK + BK), rows past S zero
  auto issue = [&](int j, int s) {
    __nv_bfloat16* kd = ks + s * BK * LDS;
    __nv_bfloat16* vd = vs + s * BK * LDS;
    for (int c = threadIdx.x; c < CHUNKS; c += THREADS) {
      const int r = c / (HD / 8), d = (c - r * (HD / 8)) * 8;
      const int row = j * BK + r;
      const bool in = row < S;
      const long long rr = in ? row : 0;
      cp_async16(kd + r * LDS + d, kb + rr * st.k.s + d, in ? 16 : 0);
      cp_async16(vd + r * LDS + d, vb + rr * st.v.s + d, in ? 16 : 0);
    }
  };

  const int lo = window > 0 ? q0 - (window - 1) : 0;
  const int j_lo = lo > 0 ? lo / BK : 0;
  const int j_hi = min(q0 + BQ - 1, S - 1) / BK;
  issue(j_lo, 0);
  cp_async_commit();

  // this warp's 16 query rows as A-fragments (rows past S read as zero)
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  uint32_t qa[KS][4];
  {
    const __nv_bfloat16* qb = q + b * st.q.b + h * st.q.h;
    const __nv_bfloat16* q_r0 = qb + (long long)(r0 < S ? r0 : 0) * st.q.s;
    const __nv_bfloat16* q_r1 = qb + (long long)(r1 < S ? r1 : 0) * st.q.s;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int d = kk * 16 + 2 * t;
      qa[kk][0] = r0 < S ? *reinterpret_cast<const uint32_t*>(q_r0 + d) : 0u;
      qa[kk][1] = r1 < S ? *reinterpret_cast<const uint32_t*>(q_r1 + d) : 0u;
      qa[kk][2] = r0 < S ? *reinterpret_cast<const uint32_t*>(q_r0 + d + 8) : 0u;
      qa[kk][3] = r1 < S ? *reinterpret_cast<const uint32_t*>(q_r1 + d + 8) : 0u;
    }
  }

  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float oacc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) oacc[n][i] = 0.f;

  for (int j = j_lo; j <= j_hi; ++j) {
    const int cur = (j - j_lo) & 1;
    __syncthreads();                  // every warp is done with the other stage
    if (j < j_hi) issue(j + 1, cur ^ 1);
    cp_async_commit();
    cp_async_wait<1>();               // tile j has landed (this thread's copies)
    __syncthreads();                  // ... and every thread's
    const __nv_bfloat16* kt = ks + cur * BK * LDS;
    const __nv_bfloat16* vt = vs + cur * BK * LDS;
    const int k0 = j * BK;

    // S = Q K^T: 8 n-tiles of 8 kv positions
    float sacc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) sacc[n][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bf[4];
        ldmatrix_x4(bf, kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDS + kk * 16 +
                            (((lane >> 3) & 1) << 3));
        mma16816(sacc[2 * np], qa[kk], bf[0], bf[1]);
        mma16816(sacc[2 * np + 1], qa[kk], bf[2], bf[3]);
      }
    }

    // scale into the log2 domain, mask (only where this warp's 16 rows do not
    // all see the whole tile: the diagonal and the window's edge), row max
    // over the quad
    const int w0 = q0 + warp * 16;   // this warp's first row
    const bool whole = k0 + BK - 1 <= w0 && (window <= 0 || w0 + 15 - k0 < window);
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (whole) {
          sacc[n][i] *= scale_log2;
        } else {
          const int qp = i < 2 ? r0 : r1;
          const int kp = k0 + n * 8 + 2 * t + (i & 1);
          const bool ok = qp >= kp && (window <= 0 || qp - kp < window);
          sacc[n][i] = ok ? sacc[n][i] * scale_log2 : NEG;
        }
        mx[i >> 1] = fmaxf(mx[i >> 1], sacc[n][i]);
      }
    float corr[2];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      mx[a] = fmaxf(mx[a], __shfl_xor_sync(0xffffffffu, mx[a], 1));
      mx[a] = fmaxf(mx[a], __shfl_xor_sync(0xffffffffu, mx[a], 2));
      const float m_new = fmaxf(m[a], mx[a]);
      corr[a] = exp2_sfu(m[a] - m_new);
      m[a] = m_new;
    }
    // p = exp2(s - m) (masked p = 0), this lane's partial row sums, and P
    // rounded to bf16 as A-fragments: k-slice kk covers n-tiles 2kk, 2kk+1
    float sum[2] = {0.f, 0.f};
    uint32_t pa[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = sacc[n][i] == NEG ? 0.f : exp2_sfu(sacc[n][i] - m[i >> 1]);
        sum[i >> 1] += p[i];
      }
      pa[n >> 1][(n & 1) * 2 + 0] = pack_bf16(p[0], p[1]);
      pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int a = 0; a < 2; ++a) l[a] = l[a] * corr[a] + sum[a];
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      oacc[n][0] *= corr[0];
      oacc[n][1] *= corr[0];
      oacc[n][2] *= corr[1];
      oacc[n][3] *= corr[1];
    }

    // O += P V: 4 k-slices of 16 kv rows, output n-tiles in pairs
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, vt + (kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) * LDS +
                                  np * 16 + ((lane >> 4) << 3));
        mma16816(oacc[2 * np], pa[kk], bf[0], bf[1]);
        mma16816(oacc[2 * np + 1], pa[kk], bf[2], bf[3]);
      }
    }
  }
  cp_async_wait<0>();

  // o = acc / max(l, 1e-30), l summed over the quad
  __nv_bfloat16* ob = o + b * st.o.b + h * st.o.h;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    l[a] += __shfl_xor_sync(0xffffffffu, l[a], 1);
    l[a] += __shfl_xor_sync(0xffffffffu, l[a], 2);
    l[a] = fmaxf(l[a], 1e-30f);
  }
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int d = n * 8 + 2 * t;
    if (r0 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)r0 * st.o.s + d) =
          __floats2bfloat162_rn(oacc[n][0] / l[0], oacc[n][1] / l[0]);
    if (r1 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)r1 * st.o.s + d) =
          __floats2bfloat162_rn(oacc[n][2] / l[1], oacc[n][3] / l[1]);
  }
}

// query rows per block of the bf16 body: 4 warps (64 rows)
constexpr int MMA_WARPS = 4;

template <int HD>
size_t mma_smem() {
  return sizeof(__nv_bfloat16) * 2 * 2 * BK * (HD + 8);
}

template <int HD>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, int B, int H,
                       int KV, int S, const AllStrides& st, int window, float scale,
                       cudaStream_t stream) {
  const size_t smem = mma_smem<HD>();
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(flash_mma_kernel<HD, MMA_WARPS>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  constexpr int BQ = 16 * MMA_WARPS;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_mma_kernel<HD, MMA_WARPS><<<grid, MMA_WARPS * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), H, KV, S, st,
      window, scale * LOG2E);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H, int KV,
                   int S, const AllStrides& st, int window, float scale, int bf16,
                   cudaStream_t stream) {
  if (bf16) return launch_mma<HD>(q, k, v, o, B, H, KV, S, st, window, scale, stream);
  return launch_f32<HD>(q, k, v, o, B, H, KV, S, st, window, scale, stream);
}

}  // namespace

extern "C" {

// q, o (B, H, S, hd); k, v (B, KV, S, hd), device pointers of float32
// (bf16 = 0) or bfloat16 (bf16 = 1).  strides: 12 element strides, the
// (batch, head, sequence) strides of q, k, v and o in that order; hd is
// contiguous.  bf16 needs every stride a multiple of 8 and 16-byte aligned
// pointers (cp.async).  H % KV == 0, hd in {16, 32, 64, 128}, window 0
// (full causal) or > 0.  Returns cudaGetLastError() of the launch.
int flash_attention(const void* q, const void* k, const void* v, void* o, int B, int H, int KV,
                    int S, int hd, const long long* strides, int window, float scale, int bf16,
                    void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  const AllStrides st{{strides[0], strides[1], strides[2]},
                      {strides[3], strides[4], strides[5]},
                      {strides[6], strides[7], strides[8]},
                      {strides[9], strides[10], strides[11]}};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16>(q, k, v, o, B, H, KV, S, st, window, scale, bf16, s);
    case 32: return launch<32>(q, k, v, o, B, H, KV, S, st, window, scale, bf16, s);
    case 64: return launch<64>(q, k, v, o, B, H, KV, S, st, window, scale, bf16, s);
    case 128: return launch<128>(q, k, v, o, B, H, KV, S, st, window, scale, bf16, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
