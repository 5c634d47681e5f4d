// The Metropolis step shared by the annealers K1 (sa_sweep.cu) and K2
// (sqa_sweep.cu), with its acceptance decided by a threshold found ahead of
// the step.
//
// Both plain versions accept a spin step iff
//     dE < 0   or   u < expf(-dE / t),      dE = -2 x_i g,  x_i = +-1,
// where g is the local field f_i (K1) or f_i / T + jperp (X[q+1,i] + X[q-1,i])
// (K2).  With v = x_i g (exact), -dE = 2v exactly, so the decision is
// accepts(v, u, t) below, a function of v alone for a given uniform u and
// temperature t.  It is non-decreasing in v: 2v and the correctly rounded
// division are, expf is non-decreasing over every float z <= 0 (counted
// exhaustively on the card by anneal_expf_decreases: every float z <= 0,
// ~2.1e9 of them, a few milliseconds), and for 2v > 0 the step is accepted
// outright.  So for every u there is a least float theta with
//     accepts(v, u, t)  <=>  v >= theta        for every non-NaN v,
// and a NaN v is rejected by both forms.  anneal_thresholds_kernel finds
// theta for every uniform before the sweeps start, a thread per uniform, by
// bracketing the estimate t ln(u) / 2 in the order-preserving integer keys
// of the floats and bisecting with the exact predicate.  A
// sweep then decides a step with a compare and a select instead of a
// division and expf on its dependent path, and makes every decision the
// plain version makes, bit for bit, on any data.
//
// The monotonicity of expf is what makes this exact.  If the count of
// decreases were not 0 on some card, the threshold would be wrong there and
// chip_smoke.py fails.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace anneal {

// The plain versions' acceptance of a step with v = x_i g: -dE = 2v.
__device__ __forceinline__ bool accepts(float v, float u, float t) {
  const float w = __fmul_rn(2.f, v);
  return w > 0.f || u < expf(__fdiv_rn(w, t));
}

// Order-preserving integer key of a float: key(a) < key(b) iff a < b for
// non-NaN a, b, except that -0 (key -1) sorts just below +0 (key 0).  Keys
// run from key(-inf) = -0x7f800001 to key(+inf) = 0x7f800000.
__device__ __forceinline__ int key_of(float v) {
  const int b = __float_as_int(v);
  return b >= 0 ? b : -(b & 0x7fffffff) - 1;
}

__device__ __forceinline__ float float_of(int k) {
  return __int_as_float(k >= 0 ? k : (-(k + 1)) | (int)0x80000000u);
}

constexpr int kKeyMin = -0x7f800001;     // -inf
constexpr int kKeyMax = 1;               // 1.4e-45: accepted (2v > 0)
constexpr int kSpanMax = 1 << 30;

// The least float theta with accepts(v, u, t) <=> v >= theta (t > 0).
// accepts() is true at the least positive float and agrees on -0 and +0, so
// theta lies in [-inf, +1.4e-45] and never between the zeros.  The bracket
// starts around v = t ln(u) / 2, 1 + 0.25 / |ln u| keys wide each way
// (expf's steps near 1 are ~2^-24 wide, so the boundary may lie ~1/|ln u|
// keys from the estimate), grows by doubling until accepts(hi) and
// !accepts(lo), then bisects.
__device__ float threshold(float u, float t) {
  const float lu = logf(u);
  const float est = 0.5f * t * lu;
  int span = 1 + (int)fminf(0.25f / fabsf(lu), (float)kSpanMax);
  int k0 = isnan(est) ? 0 : key_of(est);
  k0 = k0 < kKeyMin ? kKeyMin : (k0 > kKeyMax ? kKeyMax : k0);
  int lo = k0 - kKeyMin > span ? k0 - span : kKeyMin;
  int hi = kKeyMax - k0 > span ? k0 + span : kKeyMax;
  bool lo_rejects = false;
  while (!accepts(float_of(hi), u, t)) {       // accepts at kKeyMax
    lo = hi;
    lo_rejects = true;
    span = span < kSpanMax ? 2 * span : span;
    hi = kKeyMax - hi > span ? hi + span : kKeyMax;
  }
  while (!lo_rejects) {
    if (!accepts(float_of(lo), u, t)) break;
    hi = lo;
    if (lo == kKeyMin) return -INFINITY;         // every non-NaN v accepted
    span = span < kSpanMax ? 2 * span : span;
    lo = lo - kKeyMin > span ? lo - span : kKeyMin;
  }
  while (hi - lo > 1) {                          // accepts(lo) false, accepts(hi) true
    const int mid = lo + (hi - lo) / 2;
    if (accepts(float_of(mid), u, t)) hi = mid; else lo = mid;
  }
  return float_of(hi);
}

// theta = threshold(u, max(t, 1e-12)) for every uniform.  grid (chains,
// ceil(per_chain / blockDim.x)), a thread per uniform: chain c's uniforms
// are u[c * per_chain ...], rows of n.  With temps (P, S) (K1), row s of
// chain c anneals at temps[(c / C) * S + s]; without (K2) at t_const.
__global__ void anneal_thresholds_kernel(const float* __restrict__ u,
                                         const float* __restrict__ temps, float t_const,
                                         float* __restrict__ theta, int per_chain, int n, int C,
                                         int S) {
  const int e = blockIdx.y * blockDim.x + threadIdx.x;
  if (e >= per_chain) return;
  const unsigned chain = blockIdx.x;
  const float t = temps ? fmaxf(temps[(size_t)(chain / C) * S + e / n], 1e-12f) : t_const;
  const size_t k = (size_t)chain * per_chain + e;
  theta[k] = threshold(u[k], t);
}

inline cudaError_t launch_thresholds(const float* u, const float* temps, float t_const,
                                     float* theta, long long chains, int per_chain, int n, int C,
                                     int S, cudaStream_t stream) {
  if (chains <= 0 || per_chain <= 0) return cudaSuccess;
  constexpr int kThreads = 256;
  const long long rows = (per_chain + kThreads - 1) / kThreads;
  if (chains > 0x7fffffffLL || rows > 65535) return cudaErrorInvalidValue;
  anneal_thresholds_kernel<<<dim3((unsigned)chains, (unsigned)rows), kThreads, 0, stream>>>(
      u, temps, t_const, theta, per_chain, n, C, S);
  return cudaGetLastError();
}

// Shared memory in the sweep loops, at 32-bit shared addresses.  The base
// and the lane are taken once, through volatile asm the compiler cannot
// re-evaluate: left to itself it rebuilds the shared window's base (a
// special-register read) and the lane at every step, at the head of the
// step's dependent path.
__device__ __forceinline__ unsigned shared_base(const float* p) {
  unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("" : "+r"(a));
  return a;
}

__device__ __forceinline__ int lane_id() {
  int l;
  asm volatile("mov.u32 %0, %%laneid;" : "=r"(l));
  return l;
}

__device__ __forceinline__ float lds(unsigned a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(a));
  return v;
}

__device__ __forceinline__ void sts(unsigned a, float v) {
  asm volatile("st.shared.f32 [%0], %1;" ::"r"(a), "f"(v) : "memory");
}

// K1's two bodies (sa_sweep.cu) and the rule that chooses between them,
// defined here once (kernels/sa_sweep.py::max_spins and MAX_SPINS mirror it;
// tests/test_torch_guards.py holds the mirror to this text).  The shared-
// memory body stages B (n*n floats) and one spin row per warp of a block of
// at most kSaMaxWarps warps, at most kSaSharedMaxSpins spins (8 per lane);
// above that the global-memory body reads B's rows from device memory (the
// L2 keeps them), up to kSaGlobalMaxSpins spins: a warp a chain, up to 32
// spins a lane, or one chain split over a block's warps (below).
constexpr int kSaSmemBytes = 232448;
constexpr int kSaMaxWarps = 8;
constexpr int kSaSharedMaxSpins = 256;
constexpr int kSaGlobalMaxSpins = 1024;

__host__ __device__ constexpr bool sa_shared_body(int n, int chains) {
  return n <= kSaSharedMaxSpins &&
         4LL * ((long long)n * n + (long long)(chains < kSaMaxWarps ? chains : kSaMaxWarps) * n) <=
             kSaSmemBytes;
}

// The global-memory body's two forms (sa_sweep.cu), and the rule between
// them (kernels/sa_sweep.py::global_warps mirrors it).  The split form runs
// one chain a block over W = ceil(n / (32 m)) compute warps, m = ceil(n /
// (32 kSaSplitWarps)) spins a lane, with a ring of B's rows in groups of
// kSaSplitGroup rows, as many groups as kSaSmemBytes holds (2 to 8).  Its
// block takes more than half of an SM's kSaSmSmemBytes (kSaBlockReservedBytes
// of them reserved a resident block), so one chain an SM at every n it
// serves.  The rule splits while the launch's chains run in one wave of
// such blocks, or in two from kSaSplitTwoWaveSpins spins on (where a warp
// a chain's step takes more than twice the split one's), else a warp a
// chain, up to 32 spins a lane (PERF.md has the times on both sides).
constexpr int kSaSplitWarps = 8;
constexpr int kSaSplitGroup = 16;
constexpr int kSaSmSmemBytes = 233472;
constexpr int kSaBlockReservedBytes = 1024;
constexpr int kSaSplitTwoWaveSpins = 512;

__host__ __device__ constexpr int sa_split_spins(int n) {
  return n > 0 ? (n + 32 * kSaSplitWarps - 1) / (32 * kSaSplitWarps) : 1;
}

__host__ __device__ constexpr int sa_split_warps(int n) {
  return (n + 32 * sa_split_spins(n) - 1) / (32 * sa_split_spins(n));
}

// floats of a ring row: n and the up to 3 before it (a row is copied from
// the 16-byte boundary at or below it), rounded up to 4
__host__ __device__ constexpr int sa_split_row_stride(int n) { return (n + 6) & ~3; }

// bytes of a split block's parts but the ring: stamped deltas (8 bytes a
// spin), the ring's mbarriers (full and empty, 8 bytes each, 8 groups),
// spins and B x (4 bytes a spin each); n rounded up to 4
__host__ __device__ constexpr long long sa_split_fixed_bytes(int n) {
  return 16LL * ((n + 3) & ~3) + 2 * 8 * 8;
}

// groups of kSaSplitGroup rows in the ring: as many as fit, 2 to 8
__host__ __device__ constexpr int sa_split_clamp(long long g) {
  return g < 2 ? 2 : g > 8 ? 8 : (int)g;
}

__host__ __device__ constexpr int sa_split_groups(int n) {
  return sa_split_clamp((kSaSmemBytes - sa_split_fixed_bytes(n)) /
                        (4LL * kSaSplitGroup * sa_split_row_stride(n)));
}

__host__ __device__ constexpr long long sa_split_smem_bytes(int n) {
  return sa_split_fixed_bytes(n) +
         4LL * kSaSplitGroup * sa_split_groups(n) * sa_split_row_stride(n);
}

// split blocks resident on one SM, as their shared memory allows
__host__ __device__ constexpr int sa_split_blocks_per_sm(int n) {
  return (int)(kSaSmSmemBytes / (sa_split_smem_bytes(n) + kSaBlockReservedBytes));
}

// waves of split blocks the rule takes
__host__ __device__ constexpr int sa_split_waves(int n) {
  return n >= kSaSplitTwoWaveSpins ? 2 : 1;
}

__host__ __device__ constexpr int sa_global_warps(long long chains, int n, int sms) {
  return chains <= (long long)sms * sa_split_blocks_per_sm(n) * sa_split_waves(n)
             ? sa_split_warps(n)
             : 1;
}

inline int device_sms() {
  int sms = 132, dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// Warps per block of a sweep launch that needs `need` warps for each of P
// problems (a block holds chains of one problem, so the problem's couplings
// are staged once): up to max_warps, but when the warps are few, fewer per
// block so the blocks spread over the SMs and no two chains share a
// scheduler (a chain is bound by its dependent path, not by the card).
inline int block_warps(int P, int need, int max_warps) {
  const int sms = device_sms();
  int w = need < max_warps ? need : max_warps;
  const long long total = (long long)P * need;
  if (total < (long long)sms * w) w = total / sms < 1 ? 1 : (int)(total / sms);
  return w;
}

// Counts the floats z <= 0 at which expf decreases: the bit patterns b in
// [0x80000000, 0xff800000) with expf(z(b + 1)) > expf(z(b)), z(b + 1) being
// the next float below z(b) (the last one -inf), and +0 against -0.
__global__ void expf_decreases_kernel(unsigned long long* __restrict__ count) {
  const unsigned stride = gridDim.x * blockDim.x;
  unsigned long long mine = 0;
  for (unsigned b = 0x80000000u + blockIdx.x * blockDim.x + threadIdx.x; b < 0xff800000u;
       b += stride)
    mine += expf(__uint_as_float(b + 1)) > expf(__uint_as_float(b));
  if (blockIdx.x == 0 && threadIdx.x == 0) mine += expf(0.f) != expf(-0.f);
  if (mine) atomicAdd(count, mine);
}

}  // namespace anneal

extern "C" {

// Writes to *count (a device pointer) the number of floats z <= 0 at which
// expf, compiled as the annealers are, decreases.  0 makes the thresholds
// exact.  Returns cudaGetLastError() of the launch.
int anneal_expf_decreases(unsigned long long* count, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(unsigned long long), st);
  if (err != cudaSuccess) return (int)err;
  anneal::expf_decreases_kernel<<<132 * 16, 256, 0, st>>>(count);
  return (int)cudaGetLastError();
}

// theta (the shape of u) = the acceptance thresholds of the uniforms u of
// `chains` chains of per_chain uniforms each, in rows of n; temps (P, S)
// per row (K1), or null for one temperature t.  Returns cudaGetLastError()
// of the launch.
int anneal_thresholds_f32(const float* u, const float* temps, float t, float* theta,
                          long long chains, int per_chain, int n, int C, int S, void* stream) {
  return (int)anneal::launch_thresholds(u, temps, fmaxf(t, 1e-12f), theta, chains, per_chain, n,
                                        C, S, reinterpret_cast<cudaStream_t>(stream));
}

}  // extern "C"
