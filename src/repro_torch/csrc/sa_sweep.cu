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
//     per-chain kernel computed them, so its bits are kept on any data;
//   * above the shared-memory limit (anneal::sa_shared_body, the budget
//     allocator's QUBOs: one spin per hull point per tensor plus 6 slack
//     spins per constraint, a few hundred to ~1,000), sa_sweep_global_kernel:
//     a warp per chain (32 lanes, up to 32 spins per lane, x and f in
//     registers), row i of B read from device memory for each step i (six
//     problems of 1,024^2 floats are 25 MB: the L2 holds them) through a
//     per-warp ring of rows in shared memory, filled by 16-byte cp.async
//     three steps ahead.  Its thresholds, its field updates' order and its
//     initial field and energy are the shared body's at 32 lanes, so both
//     bodies give the same bits on any symmetric B.  Measured by
//     tools/torch_k1_global_ab.py on an H100 80GB HBM3 at 700 W (device
//     time, (6, 8, 96)): 5.0 ms at n = 238, 16.1 at 512, 55.5 at 1,024;
//     the next row's loads in registers one step ahead took 4.9, 22.9, 94.1
//     and a ring filled by 4-byte copies 6.1, 19.6, 97.5.  That is a lone
//     warp per SM (48 chains) updating 32 slots a lane, one dependent
//     latency after another, every step;
//   * so where the chains are few (anneal::sa_global_warps: while they
//     run in one wave of split blocks, one an SM at every n > 237, or in
//     two from 512 spins on; the allocator's 48 chains, a BBO chunk of 64
//     tiles x 4 reads at n >= 512), sa_sweep_split_kernel splits one chain
//     over the warps of a block, at most 8 (m = ceil(n / 256) slots a
//     lane), the owner of each range of 32 m steps running ahead and
//     posting its deltas to the other warps through shared memory: 3.66
//     ms at n = 238, 6.51 at 512, 13.9 at 1,024 by the same tool (~142 ns
//     a step at 1,024; ~86 with stale rows: fetching B's rows is still the
//     larger part), and (64, 4, 24) at 512 and 1,024 in two waves 3.59 and
//     7.67 against 4.64 and 15.9.  Past that a warp a chain, as above: two
//     waves at n = 256 took 2.04 ms against 1.78, and a pool of 2,048
//     tiles 92 against 11.8.
#include <cuda_runtime.h>
#include <stdint.h>

#include "anneal_step.cuh"

namespace {

constexpr int kMaxWarps = anneal::kSaMaxWarps;

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


// The global-memory body: a warp per chain, lane l owns spins l, l+32, ...
// (M = ceil(n / 32) slots, at most 32), x and f in registers.  Row i of B
// comes from device memory through a ring of kRing rows per warp in shared
// memory, filled kRing - 1 steps ahead by 16-byte cp.async copies of the
// row's span from the 16-byte boundary at or below it (B's base must be
// 16-byte aligned; the tail reads only the row, zero-filling the rest).  The
// same decisions, shuffles, field updates and sums as sa_sweep_kernel<32,
// M, DIRECT>, so the same bits on any symmetric B.
constexpr int kRing = 4;

// 16 bytes to shared memory from global memory, of which `bytes` are read
// (the rest zero-filled).
__device__ __forceinline__ void cp_async16(unsigned dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

// Floats a warp's slice of the global body's shared memory takes: its
// chain's n spins, then kRing rows of B, each n + 3 floats (a row's span
// from the 16-byte boundary below it), all rounded up to 4.
__host__ __device__ inline int global_spins_stride(int n) { return (n + 3) & ~3; }
__host__ __device__ inline int global_row_stride(int n) { return (n + 6) & ~3; }
__host__ __device__ inline size_t global_warp_floats(int n) {
  return (size_t)global_spins_stride(n) + (size_t)kRing * global_row_stride(n);
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// out[k] = (B x)_j at the lane's spins j = k*32 + lane, each summed over i
// in index order as the shared body sums row j.  B is symmetric, so row i
// is read in place of column i: coalesced across the lanes.
template <int M>
__device__ __forceinline__ void bmat_x(const float* __restrict__ Bp, const float* xc, int n,
                                       int lane, const bool (&own)[M], float (&out)[M]) {
#pragma unroll
  for (int k = 0; k < M; ++k) out[k] = 0.f;
  for (int i = 0; i < n; ++i) {
    const float xi = xc[i];
    const float* row = Bp + (size_t)i * n + lane;
#pragma unroll
    for (int k = 0; k < M; ++k)
      if (own[k]) out[k] = __fadd_rn(out[k], __fmul_rn(row[32 * k], xi));
  }
}

template <int M, bool DIRECT>
__global__ void __launch_bounds__(kMaxWarps * 32)
    sa_sweep_global_kernel(const float* __restrict__ h, const float* __restrict__ B,
                           const float* __restrict__ x0, const float* __restrict__ theta,
                           const float* __restrict__ temps, float* __restrict__ x_out,
                           float* __restrict__ e_out, int C, int S, int n) {
  extern __shared__ __align__(16) float smem[];   // per warp: global_warp_floats(n)
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x;
  const int c = blockIdx.y * warps + warp;
  if (c >= C) return;                      // no block-wide barrier below
  const int rs = global_row_stride(n);
  float* xc = smem + (size_t)warp * global_warp_floats(n);
  const unsigned ring = anneal::shared_base(xc + global_spins_stride(n));
  const size_t chain = (size_t)p * C + c;
  const float* Bp = B + (size_t)p * n * n;
  for (int j = lane; j < n; j += 32) xc[j] = x0[chain * n + j];
  __syncwarp();

  float x[M], f[M];
  bool own[M];
#pragma unroll
  for (int k = 0; k < M; ++k) {
    const int j = k * 32 + lane;
    own[k] = j < n;
    x[k] = own[k] ? xc[j] : 1.f;
  }
  bmat_x<M>(Bp, xc, n, lane, own, f);     // (B x)_j, summed in index order
#pragma unroll
  for (int k = 0; k < M; ++k)
    f[k] = own[k] ? __fadd_rn(h[(size_t)p * n + k * 32 + lane], __fmul_rn(2.f, f[k])) : 0.f;

  // the ring: row r sits in slot r % kRing from offset (p n^2 + r n) % 4;
  // `issue` is the next row to copy
  int issue = 0, put = 0, get = 0;
  auto row_offset = [&](int r) { return (int)(((size_t)p * n * n + (size_t)r * n) & 3); };
  auto copy_row = [&]() {
    const int off = row_offset(issue);
    const float* src = Bp + (size_t)issue * n - off;
    const unsigned dst = ring + 4u * (unsigned)(put * rs);
    for (int q = lane; 4 * q < off + n; q += 32)
      cp_async16(dst + 16u * q, src + 4 * q, 4 * min(4, off + n - 4 * q));
    cp_commit();
    issue = issue + 1 < n ? issue + 1 : 0;
    put = put + 1 < kRing ? put + 1 : 0;
  };
  for (int r = 0; r < kRing - 1; ++r) copy_row();

  const float* thc = theta + chain * (size_t)S * n;
  for (int s = 0; s < S; ++s) {
    const float t = DIRECT ? fmaxf(temps[(size_t)p * S + s], 1e-12f) : 0.f;
#pragma unroll
    for (int slot = 0; slot < M; ++slot) {
      const int base = slot * 32;
      if (base >= n) break;
      const int cnt = min(32, n - base);
      const float th = own[slot] ? thc[(size_t)s * n + base + lane] : 0.f;
      for (int o = 0; o < cnt; ++o) {
        __syncwarp();                      // every lane has read the slot refilled here
        copy_row();                        // row i + kRing - 1
        cp_wait<kRing - 1>();              // this lane's copies of row i have landed
        __syncwarp();                      // and every lane's
        const unsigned bi = ring + 4u * (unsigned)(get * rs + row_offset(base + o) + lane);
        float b[M];
#pragma unroll
        for (int k = 0; k < M; ++k) b[k] = own[k] ? __fmul_rn(2.f, anneal::lds(bi + 128u * k)) : 0.f;
        get = get + 1 < kRing ? get + 1 : 0;
        const float v = __fmul_rn(x[slot], f[slot]);
        const bool accept = DIRECT ? anneal::accepts(v, th, t) : v >= th;
        const float dl = accept ? __fmul_rn(-2.f, x[slot]) : 0.f;
        const float delta = __shfl_sync(0xffffffffu, dl, o);
#pragma unroll
        for (int k = 0; k < M; ++k)
          if (own[k]) f[k] = __fadd_rn(f[k], __fmul_rn(b[k], delta));
        if (lane == o) x[slot] = __fadd_rn(x[slot], delta);
      }
    }
  }
  cp_wait<0>();

#pragma unroll
  for (int k = 0; k < M; ++k) {
    const int j = k * 32 + lane;
    if (j < n) xc[j] = x[k];
  }
  __syncwarp();
  float bx[M];
  bmat_x<M>(Bp, xc, n, lane, own, bx);
  float eh = 0.f, eb = 0.f;
#pragma unroll
  for (int k = 0; k < M; ++k) {
    const int j = k * 32 + lane;
    if (j < n) {
      eh = __fadd_rn(eh, __fmul_rn(xc[j], h[(size_t)p * n + j]));
      eb = __fadd_rn(eb, __fmul_rn(xc[j], bx[k]));
      x_out[chain * n + j] = xc[j];
    }
  }
  eh = warp_sum(eh);
  eb = warp_sum(eb);
  if (lane == 0) e_out[chain] = __fadd_rn(eh, eb);
}

// The split form of the global-memory body, for chains too few to fill the
// card: one chain per block, its n spins split over the block's W compute
// warps (warp w owns spins w 32 m ... w 32 m + 32 m - 1, lane l of them l,
// l + 32, ... : m = sa_split_spins(n) slots a lane, x and f in registers).
// Only the warp that owns spin i needs f_i current at step i, so the owner
// of a range of 32 m steps runs ahead through them alone: it decides each
// step, updates its own fields, and posts the step's delta to shared memory
// stamped with the sweep (one 64-bit store); every other warp applies the
// posted deltas to its fields in step order, spinning on a stamp only when
// it has caught up, and takes over at its own range.  No block barrier
// inside the sweeps.  A producer warp streams B's rows, in step order over
// the sweeps, into a ring of whole rows shared by the block (as many as
// shared memory holds, 48 to 128): one bulk copy (TMA) a row, from the
// 16-byte boundary at or below it, rounded up (so up to 12 bytes past B's
// last row are read: B's base must be 16-byte aligned, as PyTorch's
// allocations are), with full and empty mbarriers a group of kSaSplitGroup
// rows (anneal_step.cuh sizes the block: sa_split_smem_bytes).  One copy a
// row for the block: a copy of each warp's slice (8 small copies a step,
// by 16-byte cp.async or by TMA) cost ~100 ns a step, more
// than the step itself.  The initial field and the final energy's B x are
// row-blocked over the warps (each warp its spins' columns, each sum in
// index order), the energy's sums then lane l over spins l, l + 32, ... and
// the xor-shuffle tree: every addition of sa_sweep_global_kernel's, in its
// order, so the same bits on any input.
__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}
// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
// `bytes` (a multiple of 16) from 16-byte aligned global src to shared dst,
// completing on the mbarrier `bar`
__device__ __forceinline__ void bulk_copy(unsigned dst, const void* src, unsigned bytes,
                                          unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// the 64-bit store where `mine` (a predicated store: no branch in the warp)
__device__ __forceinline__ void st_stamped(unsigned a, unsigned long long v, bool mine) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.u32 p, %2, 0;\n @p st.volatile.shared.u64 [%0], %1;\n}\n"
      ::"r"(a), "l"(v), "r"((unsigned)mine)
      : "memory");
}
__device__ __forceinline__ unsigned long long ld_stamped(unsigned a) {
  unsigned long long v;
  asm volatile("ld.volatile.shared.u64 %0, [%1];" : "=l"(v) : "r"(a) : "memory");
  return v;
}

template <int M, bool DIRECT>
__global__ void __launch_bounds__((anneal::kSaSplitWarps + 1) * 32)
    sa_sweep_split_kernel(const float* __restrict__ h, const float* __restrict__ B,
                          const float* __restrict__ x0, const float* __restrict__ theta,
                          const float* __restrict__ temps, float* __restrict__ x_out,
                          float* __restrict__ e_out, int C, int S, int n) {
  extern __shared__ __align__(16) float smem[];
  const int W = (blockDim.x >> 5) - 1;          // compute warps; warp W is the producer
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x, c = blockIdx.y;
  const size_t chain = (size_t)p * C + c;
  const float* Bp = B + (size_t)p * n * n;
  const int n4 = (n + 3) & ~3, rs = anneal::sa_split_row_stride(n),
            G = anneal::sa_split_groups(n);
  const int ring_rows = G * anneal::kSaSplitGroup;
  unsigned long long* deltas = reinterpret_cast<unsigned long long*>(smem);
  float* bars = smem + 2 * n4;                  // full[8], empty[8]
  float* xc = bars + 32;
  float* bx = xc + n4;
  const unsigned dsh = anneal::shared_base(reinterpret_cast<float*>(deltas));
  const unsigned full = anneal::shared_base(bars), empty = full + 64u;
  const unsigned ring = anneal::shared_base(bx + n4);
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    xc[j] = x0[chain * n + j];
    deltas[j] = 0ull;
  }
  if (threadIdx.x < G) {
    mbar_init(full + 8u * threadIdx.x, 1);
    mbar_init(empty + 8u * threadIdx.x, W);
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  __syncthreads();
  // row r's offset in its ring slot: (p n^2 + r n) % 4
  auto row_offset = [&](int r) { return (int)(((size_t)p * n * n + (size_t)r * n) & 3); };
  const long long steps = (long long)S * n;
  const int groups = (int)((steps + anneal::kSaSplitGroup - 1) / anneal::kSaSplitGroup);

  const int w0 = warp * 32 * M;                 // a compute warp's first spin
  const int wn = min(32 * M, n - w0);           // and its count
  float x[M];
  bool own[M];
#pragma unroll
  for (int k = 0; k < M; ++k) {
    own[k] = warp < W && 32 * k + lane < wn;
    x[k] = own[k] ? xc[w0 + 32 * k + lane] : 1.f;
  }
  if (warp == W) {
    // the producer: group g (steps g kSaSplitGroup ..., rows wrapping at n)
    // into ring slot g % G once every compute warp released its last use
    for (int g = 0; g < groups; ++g) {
      const int slot = g % G;
      if (g >= G) mbar_wait(empty + 8u * slot, (g / G - 1) & 1);
      const long long q = (long long)g * anneal::kSaSplitGroup + lane;
      const int r = (int)(q % n), off = row_offset(r);
      const unsigned bytes =
          lane < anneal::kSaSplitGroup && q < steps ? (unsigned)(4 * (off + n) + 15) & ~15u : 0u;
      const unsigned all = __reduce_add_sync(0xffffffffu, bytes);
      if (lane == 0) mbar_arrive_expect_tx(full + 8u * slot, all);
      __syncwarp();
      if (bytes)
        bulk_copy(ring + 4u * (unsigned)((slot * anneal::kSaSplitGroup + lane) * rs),
                  Bp + (size_t)r * n - off, bytes, full + 8u * slot);
    }
  } else {
    float f[M];
    bmat_x<M>(Bp + w0, xc, n, lane, own, f);     // (B x)_j, summed in index order
#pragma unroll
    for (int k = 0; k < M; ++k)
      f[k] = own[k] ? __fadd_rn(h[(size_t)p * n + w0 + 32 * k + lane], __fmul_rn(2.f, f[k]))
                    : 0.f;

    // 2 B's row i over the warp's spins, from the ring: at each group's
    // first step the warp releases the group before and waits for this one
    int step = 0, get = 0;
    auto row_b = [&](int i, float (&b)[M]) {
      if (step % anneal::kSaSplitGroup == 0) {
        const int g = step / anneal::kSaSplitGroup;
        __syncwarp();
        if (g > 0 && lane == 0) mbar_arrive(empty + 8u * (unsigned)((g - 1) % G));
        mbar_wait(full + 8u * (unsigned)(g % G), (g / G) & 1);
      }
      const unsigned bi = ring + 4u * (unsigned)(get * rs + row_offset(i) + w0 + lane);
#pragma unroll
      for (int k = 0; k < M; ++k)
        b[k] = own[k] ? __fmul_rn(2.f, anneal::lds(bi + 128u * k)) : 0.f;
      get = get + 1 < ring_rows ? get + 1 : 0;
      ++step;
    };

    const float* thc = theta + chain * (size_t)S * n;
    float th[M], tn[M];                    // this sweep's thresholds (uniforms), the next's
#pragma unroll
    for (int k = 0; k < M; ++k) tn[k] = own[k] && S > 0 ? thc[w0 + 32 * k + lane] : 0.f;
    for (int s = 0; s < S; ++s) {
      const float t = DIRECT ? fmaxf(temps[(size_t)p * S + s], 1e-12f) : 0.f;
      const unsigned long long stamp = (unsigned long long)(s + 1) << 32;
#pragma unroll
      for (int k = 0; k < M; ++k) {
        th[k] = tn[k];
        tn[k] = own[k] && s + 1 < S ? thc[(size_t)(s + 1) * n + w0 + 32 * k + lane] : 0.f;
      }
      for (int ow = 0; ow < W; ++ow) {
        const int r0 = ow * 32 * M, r1 = min(n, r0 + 32 * M);
        if (ow == warp) {
          // the owner: its steps, as sa_sweep_global_kernel takes them
#pragma unroll
          for (int slot = 0; slot < M; ++slot) {
            const int base = r0 + 32 * slot;
            if (base >= r1) break;
            const int cnt = min(32, r1 - base);
            for (int o = 0; o < cnt; ++o) {
              float b[M];
              row_b(base + o, b);
              const float v = __fmul_rn(x[slot], f[slot]);
              const bool accept = DIRECT ? anneal::accepts(v, th[slot], t) : v >= th[slot];
              const float dl = accept ? __fmul_rn(-2.f, x[slot]) : 0.f;
              const float delta = __shfl_sync(0xffffffffu, dl, o);
#pragma unroll
              for (int k = 0; k < M; ++k)
                if (own[k]) f[k] = __fadd_rn(f[k], __fmul_rn(b[k], delta));
              const float xs = __fadd_rn(x[slot], delta);
              x[slot] = lane == o ? xs : x[slot];
              st_stamped(dsh + 8u * (unsigned)(base + o), stamp | __float_as_uint(delta),
                         lane == o);
            }
          }
        } else {
          // the others: the owner's deltas, in step order
          for (int i = r0; i < r1; ++i) {
            float b[M];
            row_b(i, b);
            unsigned long long d = ld_stamped(dsh + 8u * (unsigned)i);
            while (d < stamp) d = ld_stamped(dsh + 8u * (unsigned)i);
            const float delta = __uint_as_float((unsigned)d);
#pragma unroll
            for (int k = 0; k < M; ++k)
              if (own[k]) f[k] = __fadd_rn(f[k], __fmul_rn(b[k], delta));
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < M; ++k)
      if (own[k]) xc[w0 + 32 * k + lane] = x[k];
  }
  __syncthreads();
  if (warp < W) {
    float bxk[M];
    bmat_x<M>(Bp + w0, xc, n, lane, own, bxk);
#pragma unroll
    for (int k = 0; k < M; ++k)
      if (own[k]) bx[w0 + 32 * k + lane] = bxk[k];
  }
  __syncthreads();
  if (warp == 0) {
    float eh = 0.f, eb = 0.f;
    for (int j = lane; j < n; j += 32) {
      eh = __fadd_rn(eh, __fmul_rn(xc[j], h[(size_t)p * n + j]));
      eb = __fadd_rn(eb, __fmul_rn(xc[j], bx[j]));
      x_out[chain * n + j] = xc[j];
    }
    eh = warp_sum(eh);
    eb = warp_sum(eb);
    if (lane == 0) e_out[chain] = __fadd_rn(eh, eb);
  }
}

template <int M, bool DIRECT>
cudaError_t launch_split_mode(const float* h, const float* B, const float* x0,
                              const float* theta, const float* temps, float* x_out, float* e_out,
                              int P, int C, int S, int n, cudaStream_t stream) {
  const int W = (n + 32 * M - 1) / (32 * M);
  const size_t smem = (size_t)anneal::sa_split_smem_bytes(n);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(sa_sweep_split_kernel<M, DIRECT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  sa_sweep_split_kernel<M, DIRECT><<<dim3(P, C), (W + 1) * 32, smem, stream>>>(
      h, B, x0, theta, temps, x_out, e_out, C, S, n);
  return cudaGetLastError();
}

template <int M>
cudaError_t launch_split_m(const float* h, const float* B, const float* x0, const float* theta,
                           const float* temps, bool direct, float* x_out, float* e_out, int P,
                           int C, int S, int n, cudaStream_t st) {
  return direct ? launch_split_mode<M, true>(h, B, x0, theta, temps, x_out, e_out, P, C, S, n, st)
                : launch_split_mode<M, false>(h, B, x0, theta, temps, x_out, e_out, P, C, S, n,
                                              st);
}

template <int M, bool DIRECT>
cudaError_t launch_global_mode(const float* h, const float* B, const float* x0,
                               const float* theta, const float* temps, float* x_out,
                               float* e_out, int P, int C, int S, int n, cudaStream_t stream) {
  // up to kMaxWarps warps a block, as many as the ring's shared memory allows
  const int fit = (int)(anneal::kSaSmemBytes / (sizeof(float) * global_warp_floats(n)));
  const int warps = anneal::block_warps(P, C, fit < kMaxWarps ? fit : kMaxWarps);
  const dim3 grid(P, (C + warps - 1) / warps);
  const size_t smem = sizeof(float) * (size_t)warps * global_warp_floats(n);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(sa_sweep_global_kernel<M, DIRECT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  sa_sweep_global_kernel<M, DIRECT><<<grid, warps * 32, smem, stream>>>(h, B, x0, theta, temps,
                                                                        x_out, e_out, C, S, n);
  return cudaGetLastError();
}

template <int M>
cudaError_t launch_global_m(const float* h, const float* B, const float* x0, const float* theta,
                            const float* temps, bool direct, float* x_out, float* e_out, int P,
                            int C, int S, int n, cudaStream_t st) {
  return direct ? launch_global_mode<M, true>(h, B, x0, theta, temps, x_out, e_out, P, C, S, n, st)
                : launch_global_mode<M, false>(h, B, x0, theta, temps, x_out, e_out, P, C, S, n,
                                               st);
}

// split: 1 splits each chain over a block's warps, 0 keeps a warp a chain,
// -1 takes anneal::sa_global_warps's rule
cudaError_t launch_global(const float* h, const float* B, const float* x0, const float* theta,
                          const float* temps, bool direct, float* x_out, float* e_out, int P,
                          int C, int S, int n, int split, cudaStream_t st) {
  if (split < 0) split = anneal::sa_global_warps((long long)P * C, n, anneal::device_sms()) > 1;
  if (split) {
    switch (anneal::sa_split_spins(n)) {
#define K1S_CASE(MM) \
  return launch_split_m<MM>(h, B, x0, theta, temps, direct, x_out, e_out, P, C, S, n, st)
      case 1: K1S_CASE(1);
      case 2: K1S_CASE(2);
      case 3: K1S_CASE(3);
      case 4: K1S_CASE(4);
#undef K1S_CASE
      default: return cudaErrorInvalidValue;
    }
  }
  const int m = (n + 31) / 32;
#define K1G_CASE(MM) \
  return launch_global_m<MM>(h, B, x0, theta, temps, direct, x_out, e_out, P, C, S, n, st)
  if (m <= 8) K1G_CASE(8);
  if (m <= 12) K1G_CASE(12);
  if (m <= 16) K1G_CASE(16);
  if (m <= 24) K1G_CASE(24);
  if (m <= 32) K1G_CASE(32);
#undef K1G_CASE
  return cudaErrorInvalidValue;
}

// The thresholds (unless direct), then the body: `global_body` picks the
// global-memory one, else the shared-memory one at `lanes`.
int run(const float* h, const float* B, const float* x0, const float* u, const float* temps,
        float* theta, float* x_out, float* e_out, int P, int C, int S, int n, int lanes,
        int direct, bool global_body, int split, cudaStream_t st) {
  if (!direct) {
    cudaError_t err = anneal::launch_thresholds(u, temps, 0.f, theta, (long long)P * C, S * n,
                                                n, C, S, st);
    if (err != cudaSuccess) return (int)err;
  }
  const float* src = direct ? u : theta;
  if (global_body)
    return (int)launch_global(h, B, x0, src, temps, direct, x_out, e_out, P, C, S, n, split,
                              st);
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

}  // namespace

extern "C" {

// Largest supported spin count (the global-memory body's).
int sa_sweep_max_spins() { return anneal::kSaGlobalMaxSpins; }

// 1 if a launch of `chains` chains of n spins runs the shared-memory body,
// else 0 (anneal::sa_shared_body).
int sa_sweep_shared_body(int n, int chains) { return anneal::sa_shared_body(n, chains) ? 1 : 0; }

// All pointers are device pointers to contiguous float32 arrays:
// h (P, n), B (P, n, n), x0 (P, C, n), u (P, C, S, n), temps (P, S)
// -> x_out (P, C, n), e_out (P, C); theta (P, C, S, n) is scratch for the
// acceptance thresholds.  Where anneal::sa_shared_body(n, C) holds, the
// shared-memory body at `lanes` (4, 8, 16 or 32) per chain with at most 8
// spins per lane; else, up to kSaGlobalMaxSpins spins, the global-memory
// body (lanes must be 32).  direct != 0: each step evaluates the acceptance
// on its uniform (theta unused); else the thresholds are launched first.
// Where `body` is not null the launch writes there the body it ran: 0 the
// shared-memory one, 1 the global-memory one a warp a chain, 2 that one
// with each chain split over a block's warps (anneal::sa_global_warps).
// Returns the first nonzero cudaGetLastError() of the launches.
int sa_sweep_many_f32(const float* h, const float* B, const float* x0, const float* u,
                      const float* temps, float* theta, float* x_out, float* e_out, int P, int C,
                      int S, int n, int lanes, int direct, void* stream, int* body) {
  if (P <= 0 || C <= 0) return 0;
  const bool global_body = !anneal::sa_shared_body(n, C);
  if (n <= 0 || n > anneal::kSaGlobalMaxSpins) return (int)cudaErrorInvalidValue;
  if (global_body ? lanes != 32 : n > 8 * lanes) return (int)cudaErrorInvalidValue;
  const int split =
      global_body && anneal::sa_global_warps((long long)P * C, n, anneal::device_sms()) > 1;
  if (body) *body = global_body ? 1 + split : 0;
  return run(h, B, x0, u, temps, theta, x_out, e_out, P, C, S, n, lanes, direct, global_body,
             split, reinterpret_cast<cudaStream_t>(stream));
}

// The global-memory body at any n up to kSaGlobalMaxSpins, whatever the
// rule would pick: for holding the two bodies to each other.
int sa_sweep_many_global_f32(const float* h, const float* B, const float* x0, const float* u,
                             const float* temps, float* theta, float* x_out, float* e_out, int P,
                             int C, int S, int n, int direct, void* stream) {
  if (P <= 0 || C <= 0) return 0;
  if (n <= 0 || n > anneal::kSaGlobalMaxSpins) return (int)cudaErrorInvalidValue;
  return run(h, B, x0, u, temps, theta, x_out, e_out, P, C, S, n, 32, direct, true, -1,
             reinterpret_cast<cudaStream_t>(stream));
}

// The same with the global body's form pinned: split 1 splits each chain
// over a block's warps, 0 keeps a warp a chain, -1 takes the rule
// (anneal::sa_global_warps).  For timing the two forms against each other.
int sa_sweep_many_global_split_f32(const float* h, const float* B, const float* x0,
                                   const float* u, const float* temps, float* theta,
                                   float* x_out, float* e_out, int P, int C, int S, int n,
                                   int split, int direct, void* stream) {
  if (P <= 0 || C <= 0) return 0;
  if (n <= 0 || n > anneal::kSaGlobalMaxSpins || split < -1 || split > 1)
    return (int)cudaErrorInvalidValue;
  return run(h, B, x0, u, temps, theta, x_out, e_out, P, C, S, n, 32, direct, true, split,
             reinterpret_cast<cudaStream_t>(stream));
}

// Warps a chain takes in the global-memory body at `chains` chains of n
// spins on a card of `sms` SMs (anneal::sa_global_warps).
int sa_sweep_global_warps(long long chains, int n, int sms) {
  return anneal::sa_global_warps(chains, n, sms);
}

}  // extern "C"
