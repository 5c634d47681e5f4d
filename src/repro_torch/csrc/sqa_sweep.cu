// Simulated quantum annealing (path-integral Monte Carlo) sweeps over
// Trotter replicas of Ising problems (kernel K2).
//
// Replaces the Pallas TPU kernel repro/kernels/sqa_sweep.py::sqa_sweep_many
// (body _quench_chains): P problems x C chains, each chain carrying T coupled
// replicas X[p] of the n-spin system.  A sweep s visits (slice p, spin i) in
// order at inter-replica coupling jperp_s; with replica indices mod T,
//     dE = (-2 x_pi) (F[p,i] / T + jperp_s (X[p+1,i] + X[p-1,i]))
// and the spin flips iff dE < 0 or u < expf(-dE / max(temperature, 1e-12)).
// F[p] = h + 2 B X[p] is kept up to date incrementally.
//
// What bounds it: every (problem, chain) is a chain of S*T*n dependent scalar
// steps (12,288 at the paper's shape S=64, T=8, n=24), so latency, not
// bandwidth, sets the time; the uniforms (P*C*S*T*n floats) are the only
// large input, read once.  Slices cannot run in parallel: spin (p, i) reads
// slices p-1 and p+1.  The design is K1's (csrc/sa_sweep.cu), one slice at a
// time:
//   * one warp per (problem, chain), up to 8 chains per block, so the
//     problem's B is staged once in shared memory; B is symmetric, so row i
//     serves as column i;
//   * the chain's X and F (T x n floats each) live in a per-warp region of
//     shared memory, so any T fits without a register array per replica;
//     lane l owns spins l, l+32, ... of every slice and is the only lane that
//     touches them during the sweeps;
//   * for slice p the lane pulls its spins, fields and neighbour sums
//     X[p+1] + X[p-1] of slice p into registers (SPL = spins per lane, a
//     template parameter); slices p+-1 do not change during slice p's pass
//     (for T = 1 and 2 they are slice p itself or the other one), so the
//     inner loop runs on registers alone and writes x and F back at its end;
//   * each (s, p) row of uniforms is loaded coalesced one slice ahead and
//     broadcast with __shfl_sync with x_i, F_i and the neighbour sum from the
//     owning lane; every lane evaluates the acceptance identically;
//   * explicit round-to-nearest intrinsics in the plain version's order
//     (the library is also built with -fmad=false, -prec-div=true and
//     without fast math), F/T a true division, so acceptance decisions match
//     the plain version bit for bit;
//   * each replica's final energy h.x + x.(B x) is a warp reduction.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 8;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int SPL>
__global__ void sqa_sweep_kernel(const float* __restrict__ h, const float* __restrict__ B,
                                 const float* __restrict__ X0, const float* __restrict__ u,
                                 const float* __restrict__ jperps, float* __restrict__ X_out,
                                 float* __restrict__ E_out, int C, int T, int S, int n,
                                 float temperature) {
  extern __shared__ float smem[];
  float* Bs = smem;                            // (n, n) this problem's couplings
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int Tn = T * n;
  float* Xs = Bs + n * n + (size_t)warp * 2 * Tn;   // (T, n) this chain's replicas
  float* Fs = Xs + Tn;                               // (T, n) their local fields

  const int p = blockIdx.x;
  const int c = blockIdx.y * warps + warp;
  const float* Bp = B + (size_t)p * n * n;
  for (int k = threadIdx.x; k < n * n; k += blockDim.x) Bs[k] = Bp[k];
  const bool active = c < C;
  const size_t chain = (size_t)p * C + (active ? c : 0);
  if (active)
    for (int k = lane; k < Tn; k += 32) Xs[k] = X0[chain * Tn + k];
  __syncthreads();
  if (!active) return;

  float hr[SPL];
#pragma unroll
  for (int k = 0; k < SPL; ++k) {
    const int j = k * 32 + lane;
    hr[k] = j < n ? h[(size_t)p * n + j] : 0.f;
  }
  // F[q, j] = h_j + 2 (B X_q)_j, (B X_q)_j summed in index order
  for (int q = 0; q < T; ++q) {
#pragma unroll
    for (int k = 0; k < SPL; ++k) {
      const int j = k * 32 + lane;
      if (j < n) {
        float acc = 0.f;
        for (int i = 0; i < n; ++i) acc = __fadd_rn(acc, __fmul_rn(Bs[j * n + i], Xs[q * n + i]));
        Fs[q * n + j] = __fadd_rn(hr[k], __fmul_rn(2.f, acc));
      }
    }
  }

  const float tmin = fmaxf(temperature, 1e-12f);
  const float tf = (float)T;
  const float* uc = u + chain * (size_t)S * Tn;
  float un[SPL];                               // the next slice's uniforms
#pragma unroll
  for (int k = 0; k < SPL; ++k) {
    const int j = k * 32 + lane;
    un[k] = j < n && S > 0 ? uc[j] : 0.f;
  }
  for (int s = 0; s < S; ++s) {
    const float jp = jperps[s];
    for (int q = 0; q < T; ++q) {
      const int qu = q + 1 == T ? 0 : q + 1;
      const int qd = q == 0 ? T - 1 : q - 1;
      const size_t row = (size_t)s * T + q;   // this (sweep, slice) row of uniforms
      float x[SPL], f[SPL], nb[SPL], ur[SPL];
#pragma unroll
      for (int k = 0; k < SPL; ++k) {
        const int j = k * 32 + lane;
        ur[k] = un[k];
        un[k] = 0.f;
        x[k] = f[k] = nb[k] = 0.f;
        if (j < n) {
          x[k] = Xs[q * n + j];
          f[k] = Fs[q * n + j];
          nb[k] = __fadd_rn(Xs[qu * n + j], Xs[qd * n + j]);
          if (row + 1 < (size_t)S * T) un[k] = uc[(row + 1) * n + j];
        }
      }
#pragma unroll
      for (int slot = 0; slot < SPL; ++slot) {
        const int base = slot * 32;
        if (base >= n) break;
        const int cnt = min(32, n - base);
        for (int owner = 0; owner < cnt; ++owner) {
          const int i = base + owner;
          const float xi = __shfl_sync(0xffffffffu, x[slot], owner);
          const float fi = __shfl_sync(0xffffffffu, f[slot], owner);
          const float ni = __shfl_sync(0xffffffffu, nb[slot], owner);
          const float ui = __shfl_sync(0xffffffffu, ur[slot], owner);
          const float dE = __fmul_rn(__fmul_rn(-2.f, xi),
                                     __fadd_rn(__fdiv_rn(fi, tf), __fmul_rn(jp, ni)));
          const bool accept = (dE < 0.f) || (ui < expf(__fdiv_rn(-dE, tmin)));
          const float delta = accept ? __fmul_rn(-2.f, xi) : 0.f;
          const float* Bi = Bs + i * n;
#pragma unroll
          for (int k = 0; k < SPL; ++k) {
            const int j = k * 32 + lane;
            if (j < n) f[k] = __fadd_rn(f[k], __fmul_rn(__fmul_rn(2.f, Bi[j]), delta));
          }
          if (lane == owner) x[slot] = __fadd_rn(x[slot], delta);
        }
      }
#pragma unroll
      for (int k = 0; k < SPL; ++k) {
        const int j = k * 32 + lane;
        if (j < n) {
          Xs[q * n + j] = x[k];
          Fs[q * n + j] = f[k];
        }
      }
    }
  }

  // energies: per replica (x . h) + (x . (B x)), each a warp reduction
  __syncwarp();
  for (int q = 0; q < T; ++q) {
    float eh = 0.f, eb = 0.f;
#pragma unroll
    for (int k = 0; k < SPL; ++k) {
      const int j = k * 32 + lane;
      if (j < n) {
        float acc = 0.f;
        for (int i = 0; i < n; ++i) acc = __fadd_rn(acc, __fmul_rn(Bs[j * n + i], Xs[q * n + i]));
        const float xv = Xs[q * n + j];
        eh = __fadd_rn(eh, __fmul_rn(xv, hr[k]));
        eb = __fadd_rn(eb, __fmul_rn(xv, acc));
        X_out[(chain * T + q) * n + j] = xv;
      }
    }
    eh = warp_sum(eh);
    eb = warp_sum(eb);
    if (lane == 0) E_out[chain * T + q] = __fadd_rn(eh, eb);
  }
}

template <int SPL>
cudaError_t launch(const float* h, const float* B, const float* X0, const float* u,
                   const float* jperps, float* X_out, float* E_out, int P, int C, int T, int S,
                   int n, float temperature, cudaStream_t stream) {
  const int warps = C < kMaxWarps ? C : kMaxWarps;
  const dim3 grid(P, (C + warps - 1) / warps);
  const size_t smem = sizeof(float) * ((size_t)n * n + (size_t)warps * 2 * T * n);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        sqa_sweep_kernel<SPL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  sqa_sweep_kernel<SPL><<<grid, warps * 32, smem, stream>>>(h, B, X0, u, jperps, X_out, E_out,
                                                            C, T, S, n, temperature);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// All pointers are device pointers to contiguous float32 arrays:
// h (P, n), B (P, n, n), X0 (P, C, T, n), u (P, C, S, T, n), jperps (S,)
// -> X_out (P, C, T, n), E_out (P, C, T).  Needs n <= 256 and
// 4 * (n*n + min(C, 8) * 2*T*n) bytes of shared memory per block.
// Returns cudaGetLastError() of the launch.
int sqa_sweep_many_f32(const float* h, const float* B, const float* X0, const float* u,
                       const float* jperps, float* X_out, float* E_out, int P, int C, int T,
                       int S, int n, float temperature, void* stream) {
  if (P <= 0 || C <= 0) return 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int spl = (n + 31) / 32;
  switch (spl) {
    case 1: return launch<1>(h, B, X0, u, jperps, X_out, E_out, P, C, T, S, n, temperature, st);
    case 2: return launch<2>(h, B, X0, u, jperps, X_out, E_out, P, C, T, S, n, temperature, st);
    case 3:
    case 4: return launch<4>(h, B, X0, u, jperps, X_out, E_out, P, C, T, S, n, temperature, st);
    case 5:
    case 6:
    case 7:
    case 8: return launch<8>(h, B, X0, u, jperps, X_out, E_out, P, C, T, S, n, temperature, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
