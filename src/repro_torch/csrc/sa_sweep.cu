// Batched Metropolis annealing sweeps on Ising problems (kernel K1).
//
// Replaces the Pallas TPU kernel repro/kernels/sa_sweep.py::sa_sweep_many
// (body _anneal_block): P problems x C chains, each chain sweeping its n
// spins S times in order, with the local field f = h + 2 B x kept up to
// date incrementally.  Spin i is flipped iff
//     dE = -2 x_i f_i < 0   or   u < expf(-dE / max(t_s, 1e-12)).
//
// What bounds it: every (problem, chain) is a chain of S*n dependent scalar
// steps (576 at the BBO shape n=24, S=24), so latency, not bandwidth, sets
// the time of one chain; the uniforms (P*C*S*n floats) are the only large
// input, read once.  The design hides latency with many chains in flight:
//   * one warp per (problem, chain), C warps per block (up to 8), so the
//     problem's B is staged once in shared memory and shared by its chains;
//     B is symmetric, so row i is column i and the update reads a row;
//   * lane l owns spins l, l+32, ...: x and f of owned spins stay in
//     registers (SPL = spins per lane, a template parameter);
//   * a sweep's uniforms are loaded coalesced, one per owned spin, and
//     broadcast with __shfl_sync; every lane evaluates the acceptance of
//     spin i identically from the broadcast x_i, f_i, u, so no lane waits
//     on a divergent branch;
//   * f_j <- f_j + (2 B_ij) * delta for all owned j, in the plain version's
//     order, with explicit round-to-nearest intrinsics (the library is also
//     built with -fmad=false, -prec-div=true and without fast math), so
//     acceptance decisions match the plain version bit for bit;
//   * the final energy h.x + x.(B x) is a warp reduction.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 8;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int SPL>
__global__ void sa_sweep_kernel(const float* __restrict__ h, const float* __restrict__ B,
                                const float* __restrict__ x0, const float* __restrict__ u,
                                const float* __restrict__ temps, float* __restrict__ x_out,
                                float* __restrict__ e_out, int C, int S, int n) {
  extern __shared__ float smem[];
  float* Bs = smem;                       // (n, n) this problem's couplings
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* xs = Bs + n * n + warp * n;      // (n,) this warp's spins (setup / energy)

  const int p = blockIdx.x;
  const int c = blockIdx.y * warps + warp;
  const float* Bp = B + (size_t)p * n * n;
  for (int k = threadIdx.x; k < n * n; k += blockDim.x) Bs[k] = Bp[k];
  const bool active = c < C;
  const size_t chain = (size_t)p * C + (active ? c : 0);
  if (active)
    for (int j = lane; j < n; j += 32) xs[j] = x0[chain * n + j];
  __syncthreads();
  if (!active) return;

  float x[SPL], f[SPL], hr[SPL];
#pragma unroll
  for (int k = 0; k < SPL; ++k) {
    const int j = k * 32 + lane;
    x[k] = 0.f;
    f[k] = 0.f;
    hr[k] = 0.f;
    if (j < n) {
      x[k] = xs[j];
      hr[k] = h[(size_t)p * n + j];
      float acc = 0.f;  // (B x)_j, summed in index order
      for (int i = 0; i < n; ++i) acc = __fadd_rn(acc, __fmul_rn(Bs[j * n + i], xs[i]));
      f[k] = __fadd_rn(hr[k], __fmul_rn(2.f, acc));
    }
  }

  const float* up = u + chain * (size_t)S * n;
  const float* tp = temps + (size_t)p * S;
  for (int s = 0; s < S; ++s) {
    const float t = fmaxf(tp[s], 1e-12f);
    float ur[SPL];
#pragma unroll
    for (int k = 0; k < SPL; ++k) {
      const int j = k * 32 + lane;
      ur[k] = j < n ? up[(size_t)s * n + j] : 0.f;
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
        const float ui = __shfl_sync(0xffffffffu, ur[slot], owner);
        const float dE = __fmul_rn(__fmul_rn(-2.f, xi), fi);
        const bool accept = (dE < 0.f) || (ui < expf(__fdiv_rn(-dE, t)));
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
  }

  // energy: (x . h) + (x . (B x)), each a warp reduction
#pragma unroll
  for (int k = 0; k < SPL; ++k) {
    const int j = k * 32 + lane;
    if (j < n) xs[j] = x[k];
  }
  __syncwarp();
  float eh = 0.f, eb = 0.f;
#pragma unroll
  for (int k = 0; k < SPL; ++k) {
    const int j = k * 32 + lane;
    if (j < n) {
      float acc = 0.f;
      for (int i = 0; i < n; ++i) acc = __fadd_rn(acc, __fmul_rn(Bs[j * n + i], xs[i]));
      eh = __fadd_rn(eh, __fmul_rn(x[k], hr[k]));
      eb = __fadd_rn(eb, __fmul_rn(x[k], acc));
      x_out[chain * n + j] = x[k];
    }
  }
  eh = warp_sum(eh);
  eb = warp_sum(eb);
  if (lane == 0) e_out[chain] = __fadd_rn(eh, eb);
}

template <int SPL>
cudaError_t launch(const float* h, const float* B, const float* x0, const float* u,
                   const float* temps, float* x_out, float* e_out, int P, int C, int S,
                   int n, cudaStream_t stream) {
  const int warps = C < kMaxWarps ? C : kMaxWarps;
  const dim3 grid(P, (C + warps - 1) / warps);
  const size_t smem = sizeof(float) * ((size_t)n * n + (size_t)warps * n);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        sa_sweep_kernel<SPL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  sa_sweep_kernel<SPL><<<grid, warps * 32, smem, stream>>>(h, B, x0, u, temps, x_out, e_out,
                                                           C, S, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest supported spin count: SPL = 8 spins per lane, and B (n*n floats)
// plus one spin row per warp must fit the block's shared memory.
int sa_sweep_max_spins() { return 8 * 32; }

// All pointers are device pointers to contiguous float32 arrays:
// h (P, n), B (P, n, n), x0 (P, C, n), u (P, C, S, n), temps (P, S)
// -> x_out (P, C, n), e_out (P, C).  Returns cudaGetLastError() of the launch.
int sa_sweep_many_f32(const float* h, const float* B, const float* x0, const float* u,
                      const float* temps, float* x_out, float* e_out, int P, int C, int S,
                      int n, void* stream) {
  if (P <= 0 || C <= 0) return 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int spl = (n + 31) / 32;
  switch (spl) {
    case 1: return launch<1>(h, B, x0, u, temps, x_out, e_out, P, C, S, n, st);
    case 2: return launch<2>(h, B, x0, u, temps, x_out, e_out, P, C, S, n, st);
    case 3:
    case 4: return launch<4>(h, B, x0, u, temps, x_out, e_out, P, C, S, n, st);
    case 5:
    case 6:
    case 7:
    case 8: return launch<8>(h, B, x0, u, temps, x_out, e_out, P, C, S, n, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
