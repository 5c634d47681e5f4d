// Simulated quantum annealing (path-integral Monte Carlo) sweeps over
// Trotter replicas of Ising problems (kernel K2).
//
// Replaces the Pallas TPU kernel repro/kernels/sqa_sweep.py::sqa_sweep_many
// (body _quench_chains): P problems x C chains, each chain carrying T coupled
// replicas X[q] of the n-spin system.  A sweep s visits (slice q, spin i) in
// order at inter-replica coupling jperp_s; with replica indices mod T,
//     dE = (-2 x_qi) (F[q,i] / T + jperp_s (X[q+1,i] + X[q-1,i]))
// and the spin flips iff dE < 0 or u < expf(-dE / max(temperature, 1e-12)).
// F[q] = h + 2 B X[q] is kept up to date incrementally.
//
// What bounds it: each (problem, chain) is S*T*n scalar steps in the plain
// version's order (12,288 at the paper's shape S=64, T=8, n=24), and at the
// paper's 250 chains the card is mostly idle, so one chain's dependent path
// sets the time.  That path is shorter than the order.  Number the rows
// r = s*T + q.  Step (r, i) depends only on (r, i-1), on (r-1, i) (slice
// q-1's spin i) and on all of row r-T (the previous pass over slice q, which
// wrote F[q]); it reads X[q+1, i] as row r-T+1 left it, and no row between
// touches slice q+1.  So row r may run spin i at step d*r + i for any skew
// d >= ceil(n / T): every F[q] still takes its additions in the sequential
// order and every neighbour read sees the sequential value, on any data.
// The design:
//   * one block per chain, G = min(T, 8) warps; warp g runs rows g, g + G,
//     ... from step d*r, so G rows (slices) are in flight at once and a
//     chain takes d*(S*T - 1) + n steps (1,557 at the paper's shape instead
//     of 12,288).  d = max(ceil(n/T), ceil(n/G)) comes from the wrapper
//     (kernels/sqa_sweep.py::wavefront_schedule); the launch refuses a skew
//     that breaks a dependency;
//   * the chain's replicas X and, between rows, its fields F live in shared
//     memory with its 2B (B is symmetric, so row i serves as column i).  A
//     value is written at least d steps before any warp reads it, and the
//     next write of a value read at a step comes at least d steps later, so
//     one block barrier every d steps orders the warps.  When G = T a warp
//     keeps its slice's fields and spins in registers for the whole run;
//     when T > G they pass between warps through shared memory at row starts
//     (multiples of d, where the barrier falls);
//   * within its row a warp is K1's chain at 32 lanes: lane l owns spins l,
//     l+32, ... (M = ceil(n / 32) per lane, a template parameter), the row's
//     spins run in order in a loop of their own (the owned slot a static
//     index), the owner decides, one __shfl_sync broadcasts delta and every
//     lane adds (2B)_ij * delta to its fields.  Each warp prefetches its next
//     row's thresholds and coupling a row ahead, into registers of its own.  The
//     acceptance is a threshold found before the sweeps (anneal_step.cuh)
//     and F/T is F * 2^-k when T = 2^k (the same correctly rounded value as
//     the division): the dependent path of a step is the shuffle, a
//     multiply and an add (the field), a multiply and two adds
//     (jperp (X[q+1,i] + X[q-1,i]) is read beside it), x_i g (exact), a
//     compare and a select;
//   * explicit round-to-nearest intrinsics in the plain version's order
//     (the library is also built with -fmad=false, -prec-div=true and
//     without fast math), so decisions match the plain version bit for bit;
//   * the initial fields ((B X_q)_j summed in index order) and each
//     replica's final energy h.x + x.(B x) (a warp reduction over lanes
//     owning spins l, l+32, ...) are computed as the earlier
//     slice-at-a-time kernel computed them, so its bits are kept on any
//     data.
#include <cuda_runtime.h>
#include <stdint.h>

#include "anneal_step.cuh"

namespace {

constexpr int kMaxGroups = 8;   // rows in flight per chain, a warp each

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One block per chain, warp g its group g.  M spins per lane (lane l owns
// spins l, l+32, ...); POW2: F / T is F * inv_t.
template <int M, bool POW2>
__global__ void __launch_bounds__(kMaxGroups * 32)
    sqa_sweep_kernel(const float* __restrict__ h, const float* __restrict__ B,
                     const float* __restrict__ X0, const float* __restrict__ theta,
                     const float* __restrict__ jperps, float* __restrict__ X_out,
                     float* __restrict__ E_out, int C, int T, int S, int n, int G, int d,
                     float inv_t) {
  extern __shared__ float smem[];
  const int Tn = T * n;
  float* B2 = smem;                            // (n, n): B for the initial fields, then 2B
  float* Xs = B2 + n * n;                      // (T, n) the chain's replicas
  float* Fs = Xs + Tn;                         // (T, n) their fields between rows
  const int g = threadIdx.x >> 5;              // the group: rows g, g + G, ...
  const int lane = anneal::lane_id();          // kept in a register (see anneal_step.cuh)
  const size_t chain = blockIdx.x;
  const int p = (int)(chain / C);
  const float* Bp = B + (size_t)p * n * n;
  for (int k = threadIdx.x; k < n * n; k += blockDim.x) B2[k] = Bp[k];
  for (int k = threadIdx.x; k < Tn; k += blockDim.x) Xs[k] = X0[chain * Tn + k];
  __syncthreads();
  // F[q, j] = h_j + 2 (B X_q)_j, (B X_q)_j summed in index order
  for (int k = threadIdx.x; k < Tn; k += blockDim.x) {
    const int q = k / n, j = k - q * n;
    float acc = 0.f;
    for (int i = 0; i < n; ++i) acc = __fadd_rn(acc, __fmul_rn(B2[j * n + i], Xs[q * n + i]));
    Fs[k] = __fadd_rn(h[(size_t)p * n + j], __fmul_rn(2.f, acc));
  }
  __syncthreads();
  for (int k = threadIdx.x; k < n * n; k += blockDim.x) B2[k] = __fmul_rn(2.f, B2[k]);
  __syncthreads();

  const float tf = (float)T;
  const int R = S * T;                         // rows r = s*T + q
  const float* thc = theta + chain * (size_t)R * n;
  bool own[M];                                 // spins lane + 32m that exist
#pragma unroll
  for (int m = 0; m < M; ++m) own[m] = lane + 32 * m < n;
  // byte addresses in shared memory: 2B, X, F
  const unsigned sb = anneal::shared_base(smem);
  const unsigned xs = sb + 4u * (n * n), fs = xs + 4u * Tn, rowb = 4u * n;
  const int steps = R > 0 ? d * (R - 1) + n : 0;
  const int cycle = d * G;                     // steps between a group's row starts
  // A value written at a step is read d or more steps later, and the next
  // write of a value read at a step comes d or more steps later: a block
  // barrier every d steps orders both across the warps.  Every warp counts
  // all the steps, idle ones too, so the barriers pair up.
  int sync = 0, step = 0;
  auto tick = [&]() {
    if (sync == 0) {
      __syncthreads();
      sync = d;
    }
    --sync;
    ++step;
  };
  float f[M], x[M], th[M], tn[M];
  float jp = 0.f, jpn = g < R ? jperps[g / T] : 0.f;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    f[m] = x[m] = th[m] = 0.f;
    tn[m] = own[m] && g < R ? thc[(size_t)g * n + lane + 32 * m] : 0.f;
  }
  while (step < d * g && step < steps) tick();   // the group's first row starts at d*g
  int q = g;                                   // row r's slice, r mod T
  for (int r = g; r < R; r += G) {
    // row r starts on slice q, at step d*r
    if (G < T && r >= G) {
      // the fields pass between groups: this group's finished slice out,
      // slice q in (with its spins: another group wrote them last)
      const unsigned fo = fs + (q - G < 0 ? q - G + T : q - G) * rowb + 4u * lane;
#pragma unroll
      for (int m = 0; m < M; ++m)
        if (own[m]) anneal::sts(fo + 128u * m, f[m]);
    }
    if (G < T || r < G) {
#pragma unroll
      for (int m = 0; m < M; ++m) {
        f[m] = own[m] ? anneal::lds(fs + q * rowb + 4u * (lane + 32 * m)) : 0.f;
        x[m] = own[m] ? anneal::lds(xs + q * rowb + 4u * (lane + 32 * m)) : 1.f;
      }
    }
    const int rn = r + G;                      // prefetch the group's next row
    jp = jpn;
    if (rn < R) jpn = jperps[rn / T];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      th[m] = tn[m];
      tn[m] = own[m] && rn < R ? thc[(size_t)rn * n + lane + 32 * m] : 0.f;
    }
    const unsigned aq = xs + q * rowb;         // rows q, q+1, q-1 of X
    const unsigned ap = xs + (q + 1 == T ? 0 : q + 1) * rowb;
    const unsigned am = xs + (q == 0 ? T - 1 : q - 1) * rowb;
#pragma unroll
    for (int slot = 0; slot < M; ++slot) {
      const int base = 32 * slot;
      if (base >= n) break;
      const int cnt = min(32, n - base);
      for (int o = 0; o < cnt; ++o) {          // spin i = base + o, owned by lane o
        tick();
        const unsigned ai = 4u * (base + o);
        const float nb = __fadd_rn(anneal::lds(ap + ai), anneal::lds(am + ai));
        const unsigned bi = sb + ai * n + 4u * lane;   // row i of 2B
        float b[M];
#pragma unroll
        for (int m = 0; m < M; ++m) b[m] = own[m] ? anneal::lds(bi + 128u * m) : 0.f;
        const float ft = POW2 ? __fmul_rn(f[slot], inv_t) : __fdiv_rn(f[slot], tf);
        // every lane decides on its own slot; the owner's decision is the
        // group's: accept <=> x_i g >= th (x_i = +-1, so the product is exact)
        const bool accept = __fmul_rn(x[slot], __fadd_rn(ft, __fmul_rn(jp, nb))) >= th[slot];
        const float dl = accept ? __fmul_rn(-2.f, x[slot]) : 0.f;
        const float delta = __shfl_sync(0xffffffffu, dl, o);
#pragma unroll
        for (int m = 0; m < M; ++m) f[m] = __fadd_rn(f[m], __fmul_rn(b[m], delta));
        if (lane == o) {
          x[slot] = __fadd_rn(x[slot], delta);
          anneal::sts(aq + ai, x[slot]);
        }
      }
    }
    for (int k = n; k < cycle && step < steps; ++k) tick();   // to the group's next row
    q = q + G >= T ? q + G - T : q + G;
  }
  while (step < steps) tick();
  __syncthreads();

  // energies: per replica (x . h) + (x . (B x)), each a warp reduction
  for (int q2 = g; q2 < T; q2 += G) {
    float eh = 0.f, eb = 0.f;
    for (int j = lane; j < n; j += 32) {
      float acc = 0.f;
      for (int k = 0; k < n; ++k)
        acc = __fadd_rn(acc, __fmul_rn(Bp[(size_t)j * n + k], Xs[q2 * n + k]));
      const float xv = Xs[q2 * n + j];
      eh = __fadd_rn(eh, __fmul_rn(xv, h[(size_t)p * n + j]));
      eb = __fadd_rn(eb, __fmul_rn(xv, acc));
      X_out[(chain * T + q2) * n + j] = xv;
    }
    eh = warp_sum(eh);
    eb = warp_sum(eb);
    if (lane == 0) E_out[chain * T + q2] = __fadd_rn(eh, eb);
  }
}

template <int M, bool POW2>
cudaError_t launch_pow2(const float* h, const float* B, const float* X0, const float* theta,
                        const float* jperps, float* X_out, float* E_out, int P, int C, int T,
                        int S, int n, int G, int d, float inv_t, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)n * n + (size_t)2 * T * n);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(sqa_sweep_kernel<M, POW2>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  sqa_sweep_kernel<M, POW2><<<(unsigned)((long long)P * C), G * 32, smem, stream>>>(
      h, B, X0, theta, jperps, X_out, E_out, C, T, S, n, G, d, inv_t);
  return cudaGetLastError();
}

template <int M>
cudaError_t launch(const float* h, const float* B, const float* X0, const float* theta,
                   const float* jperps, float* X_out, float* E_out, int P, int C, int T, int S,
                   int n, int G, int d, float inv_t, cudaStream_t stream) {
  return inv_t > 0.f ? launch_pow2<M, true>(h, B, X0, theta, jperps, X_out, E_out, P, C, T, S,
                                            n, G, d, inv_t, stream)
                     : launch_pow2<M, false>(h, B, X0, theta, jperps, X_out, E_out, P, C, T, S,
                                             n, G, d, inv_t, stream);
}

}  // namespace

extern "C" {

// All pointers are device pointers to contiguous float32 arrays:
// h (P, n), B (P, n, n), X0 (P, C, T, n), u (P, C, S, T, n), jperps (S,)
// -> X_out (P, C, T, n), E_out (P, C, T); theta (P, C, S, T, n) is scratch
// for the acceptance thresholds.  The wavefront runs G warps at skew d; it
// needs 1 <= G <= min(T, 8), d >= ceil(n / T), d >= ceil(n / G), n <= 256
// and 4 * (n*n + 2*T*n) bytes of shared memory per block.  Launches the
// thresholds, then the sweeps; returns the first nonzero cudaGetLastError()
// of the launches (cudaErrorInvalidValue for a schedule outside these
// bounds).
int sqa_sweep_many_f32(const float* h, const float* B, const float* X0, const float* u,
                       const float* jperps, float* theta, float* X_out, float* E_out, int P,
                       int C, int T, int S, int n, int G, int d, float temperature,
                       void* stream) {
  if (P <= 0 || C <= 0) return 0;
  if (T < 1 || n < 1 || n > 32 * 8 || G < 1 || G > T || G > kMaxGroups ||
      d < (n + T - 1) / T || d < (n + G - 1) / G || (long long)P * C > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err = anneal::launch_thresholds(u, nullptr, fmaxf(temperature, 1e-12f), theta,
                                              (long long)P * C, S * T * n, n, C, S, st);
  if (err != cudaSuccess) return (int)err;
  // F / T is F * 2^-k for T = 2^k (both the correctly rounded quotient)
  const float inv_t = (T & (T - 1)) == 0 ? 1.f / (float)T : 0.f;
  switch ((n + 31) / 32) {
#define K2_CASE(MM) \
    return (int)launch<MM>(h, B, X0, theta, jperps, X_out, E_out, P, C, T, S, n, G, d, inv_t, st)
    case 1: K2_CASE(1);
    case 2: K2_CASE(2);
    case 3: K2_CASE(3);
    case 4: K2_CASE(4);
    case 5:
    case 6: K2_CASE(6);
    default: K2_CASE(8);
#undef K2_CASE
  }
}

}  // extern "C"
