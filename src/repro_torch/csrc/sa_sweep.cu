// Batched Metropolis annealing sweeps on Ising problems (kernel K1).
//
// Replaces the Pallas TPU kernel repro/kernels/sa_sweep.py::sa_sweep_many
// (body _anneal_block): P problems x C chains, each chain sweeping its n
// spins S times in order, with the local field f = h + 2 B x kept up to
// date incrementally.  Spin i is flipped iff
//     dE = -2 x_i f_i < 0   or   u < expf(-dE / max(t_s, 1e-12)).
//
// What bounds it: every (problem, chain) is a chain of S*n dependent scalar
// steps (576 at the BBO pool's shape n=24, S=24; 1,536 at the paper's
// n=24, S=64), so latency, not bandwidth, sets the time of one chain; the
// uniforms (P*C*S*n floats) are the only large input, read once.  Two
// regimes: the compression pool (10,240 problems x 4 reads) has chains
// enough to fill the card and is bound by the instructions it issues; the
// paper's BBO loop (25 or 4 problems x 10 reads) has a few hundred chains
// and is bound by one chain's dependent path.  The design:
//   * L lanes per chain (a template parameter, 32 / L chains per warp,
//     chains of one problem per block so its 2B is staged once in shared
//     memory; B is symmetric, so row i serves as column i): lane l of a
//     chain owns spins l, l+L, ... (M = ceil(n / L) per lane, the other
//     template parameter), their x and f in registers.  All chains of a
//     warp are at the same spin, so the owned slot is a static index;
//   * per step the owner lane decides, one __shfl_sync inside the chain's
//     lanes broadcasts delta, and each lane adds (2B)_ij * delta to its
//     fields in the plain version's order, with explicit round-to-nearest
//     intrinsics (the library is also built with -fmad=false, -prec-div=true
//     and without fast math);
//   * few chains: the acceptance is a threshold (anneal_step.cuh): before
//     the sweeps, anneal_thresholds_kernel turns every uniform u into the
//     least theta with "accept <=> x_i f_i >= theta", exactly, and a step's
//     dependent path is x_i f_i (exact), a compare, a select, the shuffle, a
//     multiply and an add;
//   * chains that fill the card: bound by what it issues, where one step's
//     division and expf serve the 32 / L chains of a warp while the
//     threshold pass spends ~8 such evaluations per uniform, so each step
//     evaluates the plain acceptance on its uniform (DIRECT);
//   * the rule (kernels/sa_sweep.py::lanes_per_chain, direct_acceptance):
//     from 4,096 chains, as many chains per warp as the problem has (up to
//     8) and direct decisions; below, 32 lanes and thresholds.  Measured by
//     tools/torch_anneal_variants.py on an H100 80GB HBM3 at 700 W (device
//     time): the BBO pool's (10,240, 4, 24, 24) took 0.47 ms at 8 lanes
//     direct, 0.57 at 4, 0.92 at 16, 2.10 at 32, and 0.82 at 8 with
//     thresholds; the paper's (25, 10, 64, 24) took 0.083 ms at 32 lanes with
//     thresholds, 0.096 at 16, 0.127 at 8, 0.20 at 4, and 0.23-0.40 direct;
//   * the initial field (h + 2 B x, (B x)_j summed in index order) and the
//     final energy (h.x + x.(B x), per lane then a warp reduction over
//     lanes owning spins l, l+32, ...) are computed as the earlier one-warp-
//     per-chain kernel computed them, so its bits are kept on any data.
#include <cuda_runtime.h>
#include <stdint.h>

#include "anneal_step.cuh"

namespace {

constexpr int kMaxWarps = 8;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// DIRECT: a step evaluates the plain acceptance on its uniform (`theta` holds
// the uniforms, temps the schedule); else `theta` holds the thresholds.
template <int L, int M, bool DIRECT>
__global__ void __launch_bounds__(kMaxWarps * 32)
    sa_sweep_kernel(const float* __restrict__ h, const float* __restrict__ B,
                    const float* __restrict__ x0, const float* __restrict__ theta,
                    const float* __restrict__ temps, float* __restrict__ x_out,
                    float* __restrict__ e_out, int C, int S, int n) {
  constexpr int kChains = 32 / L;          // chains per warp
  extern __shared__ float smem[];
  float* B2 = smem;                        // (n, n): B for the initial fields, then 2B
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = lane / L;                // the warp's chain this lane works on
  const int gl = lane & (L - 1);           // its lane within the chain
  float* xw = B2 + n * n + (size_t)warp * kChains * n;   // (kChains, n) spins (setup, energy)
  float* xc = xw + grp * n;

  const int p = blockIdx.x;
  const int c0 = (blockIdx.y * warps + warp) * kChains;  // the warp's first chain
  const int c = c0 + grp;
  const float* Bp = B + (size_t)p * n * n;
  for (int k = threadIdx.x; k < n * n; k += blockDim.x) B2[k] = Bp[k];
  // a chain slot past C runs chain 0's data and writes nothing
  const size_t chain = (size_t)p * C + (c < C ? c : 0);
  for (int j = gl; j < n; j += L) xc[j] = x0[chain * n + j];
  __syncthreads();

  float x[M], f[M];
#pragma unroll
  for (int k = 0; k < M; ++k) {
    const int j = k * L + gl;
    x[k] = 1.f;
    f[k] = 0.f;
    if (j < n) {
      x[k] = xc[j];
      float acc = 0.f;  // (B x)_j, summed in index order
      for (int i = 0; i < n; ++i) acc = __fadd_rn(acc, __fmul_rn(B2[j * n + i], xc[i]));
      f[k] = __fadd_rn(h[(size_t)p * n + j], __fmul_rn(2.f, acc));
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < n * n; k += blockDim.x) B2[k] = __fmul_rn(2.f, B2[k]);
  __syncthreads();
  if (c0 >= C) return;

  const float* thc = theta + chain * (size_t)S * n;
  const unsigned sb = anneal::shared_base(smem);   // 2B, read in the loop at shared addresses
  bool own[M];                             // spins k*L + gl that exist
#pragma unroll
  for (int k = 0; k < M; ++k) own[k] = k * L + gl < n;
  float th[M], tn[M];                      // this sweep's thresholds (uniforms), the next's
#pragma unroll
  for (int k = 0; k < M; ++k) {
    const int j = k * L + gl;
    tn[k] = j < n && S > 0 ? thc[j] : 0.f;
  }
  for (int s = 0; s < S; ++s) {
    const float t = DIRECT ? fmaxf(temps[(size_t)p * S + s], 1e-12f) : 0.f;
#pragma unroll
    for (int k = 0; k < M; ++k) {
      const int j = k * L + gl;
      th[k] = tn[k];
      tn[k] = j < n && s + 1 < S ? thc[(size_t)(s + 1) * n + j] : 0.f;
    }
#pragma unroll
    for (int slot = 0; slot < M; ++slot) {
      const int base = slot * L;
      if (base >= n) break;
      const int cnt = min(L, n - base);
      for (int o = 0; o < cnt; ++o) {
        const unsigned bi = sb + 4u * ((base + o) * n + gl);   // row i of 2B
        float b[M];
#pragma unroll
        for (int k = 0; k < M; ++k) b[k] = own[k] ? anneal::lds(bi + 4u * L * k) : 0.f;
        // every lane decides on its own slot; the owner's decision is the
        // chain's: accept <=> x_i f_i >= th (x_i = +-1, so the product is exact)
        const float v = __fmul_rn(x[slot], f[slot]);
        const bool accept = DIRECT ? anneal::accepts(v, th[slot], t) : v >= th[slot];
        const float dl = accept ? __fmul_rn(-2.f, x[slot]) : 0.f;
        const float delta = __shfl_sync(0xffffffffu, dl, (lane & ~(L - 1)) | o);
#pragma unroll
        for (int k = 0; k < M; ++k)
          if (own[k]) f[k] = __fadd_rn(f[k], __fmul_rn(b[k], delta));
        if (gl == o) x[slot] = __fadd_rn(x[slot], delta);
      }
    }
  }

  // energy: (x . h) + (x . (B x)), per chain a warp reduction over lanes
  // owning spins l, l+32, ...
#pragma unroll
  for (int k = 0; k < M; ++k) {
    const int j = k * L + gl;
    if (j < n) xc[j] = x[k];
  }
  __syncwarp();
  for (int cc = 0; cc < kChains && c0 + cc < C; ++cc) {
    const float* xv = xw + cc * n;
    const size_t ch = (size_t)p * C + c0 + cc;
    float eh = 0.f, eb = 0.f;
    for (int j = lane; j < n; j += 32) {
      float acc = 0.f;
      for (int i = 0; i < n; ++i) acc = __fadd_rn(acc, __fmul_rn(Bp[(size_t)j * n + i], xv[i]));
      eh = __fadd_rn(eh, __fmul_rn(xv[j], h[(size_t)p * n + j]));
      eb = __fadd_rn(eb, __fmul_rn(xv[j], acc));
      x_out[ch * n + j] = xv[j];
    }
    eh = warp_sum(eh);
    eb = warp_sum(eb);
    if (lane == 0) e_out[ch] = __fadd_rn(eh, eb);
  }
}

template <int L, int M, bool DIRECT>
cudaError_t launch_mode(const float* h, const float* B, const float* x0, const float* theta,
                        const float* temps, float* x_out, float* e_out, int P, int C, int S,
                        int n, cudaStream_t stream) {
  constexpr int kChains = 32 / L;
  const int need = (C + kChains - 1) / kChains;
  const int warps = anneal::block_warps(P, need, kMaxWarps);
  const dim3 grid(P, (need + warps - 1) / warps);
  const size_t smem = sizeof(float) * ((size_t)n * n + (size_t)warps * kChains * n);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(sa_sweep_kernel<L, M, DIRECT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  sa_sweep_kernel<L, M, DIRECT><<<grid, warps * 32, smem, stream>>>(h, B, x0, theta, temps,
                                                                    x_out, e_out, C, S, n);
  return cudaGetLastError();
}

template <int L, int M>
cudaError_t launch(const float* h, const float* B, const float* x0, const float* theta,
                   const float* temps, bool direct, float* x_out, float* e_out, int P, int C,
                   int S, int n, cudaStream_t st) {
  return direct ? launch_mode<L, M, true>(h, B, x0, theta, temps, x_out, e_out, P, C, S, n, st)
                : launch_mode<L, M, false>(h, B, x0, theta, temps, x_out, e_out, P, C, S, n, st);
}

template <int L>
cudaError_t launch_lanes(const float* h, const float* B, const float* x0, const float* theta,
                         const float* temps, bool direct, float* x_out, float* e_out, int P,
                         int C, int S, int n, cudaStream_t st) {
  switch ((n + L - 1) / L) {
#define K1_CASE(MM) return launch<L, MM>(h, B, x0, theta, temps, direct, x_out, e_out, P, C, S, n, st)
    case 1: K1_CASE(1);
    case 2: K1_CASE(2);
    case 3: K1_CASE(3);
    case 4: K1_CASE(4);
    case 5:
    case 6: K1_CASE(6);
    case 7:
    case 8: K1_CASE(8);
#undef K1_CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Largest supported spin count: 8 spins per lane at 32 lanes per chain, and
// B (n*n floats) plus one spin row per chain must fit the block's shared
// memory.
int sa_sweep_max_spins() { return 8 * 32; }

// All pointers are device pointers to contiguous float32 arrays:
// h (P, n), B (P, n, n), x0 (P, C, n), u (P, C, S, n), temps (P, S)
// -> x_out (P, C, n), e_out (P, C); theta (P, C, S, n) is scratch for the
// acceptance thresholds.  lanes (4, 8, 16 or 32) per chain, with at most 8
// spins per lane.  direct != 0: each step evaluates the acceptance on its
// uniform (theta unused); else the thresholds are launched first.  Returns
// the first nonzero cudaGetLastError() of the launches.
int sa_sweep_many_f32(const float* h, const float* B, const float* x0, const float* u,
                      const float* temps, float* theta, float* x_out, float* e_out, int P, int C,
                      int S, int n, int lanes, int direct, void* stream) {
  if (P <= 0 || C <= 0) return 0;
  if (n <= 0 || n > 8 * lanes) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (!direct) {
    cudaError_t err = anneal::launch_thresholds(u, temps, 0.f, theta, (long long)P * C, S * n,
                                                n, C, S, st);
    if (err != cudaSuccess) return (int)err;
  }
  const float* src = direct ? u : theta;
  switch (lanes) {
    case 4: return (int)launch_lanes<4>(h, B, x0, src, temps, direct, x_out, e_out, P, C, S, n, st);
    case 8: return (int)launch_lanes<8>(h, B, x0, src, temps, direct, x_out, e_out, P, C, S, n, st);
    case 16:
      return (int)launch_lanes<16>(h, B, x0, src, temps, direct, x_out, e_out, P, C, S, n, st);
    case 32:
      return (int)launch_lanes<32>(h, B, x0, src, temps, direct, x_out, e_out, P, C, S, n, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
