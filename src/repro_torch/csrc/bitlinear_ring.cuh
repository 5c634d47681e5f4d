// What the hand-written ring schedules of kernel K3 (decode, stream) and K4
// (decode) share: mbarriers, bulk and tensor-map copies into shared memory,
// the lane-parallel body (z = x @ M with each bit decoded once for a group
// of rows, then y += z @ C with vector loads of C), and the deterministic
// reductions of partial y (a block's warps in warp order, then a cluster's
// ranks in rank order through distributed shared memory).  Included by
// bitlinear_decode.cuh and bitlinear_stream.cuh; what they compute is
// bitlinear.cuh's note, with bitlinear_common.cuh's scalar helpers.
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "bitlinear_common.cuh"

namespace bitlinear_impl {

// Rows of a register group: up to 8, else groups of 8.
__host__ __device__ __forceinline__ int ring_rows(int T) {
  return T <= 1 ? 1 : T <= 2 ? 2 : T <= 4 ? 4 : 8;
}

// Columns per lane: one 32-column chunk for narrow C tiles, else 128-column
// chunks of 4 contiguous columns per lane (blockIdx.z walks the chunks).
__host__ __device__ __forceinline__ int ring_cols(int td) { return td <= 32 ? 1 : 4; }

// z_batch's lanes: ns 16-byte slices of x per tile row, ls lanes per
// (tile, pair of k) unit (a power of two covering the slices, at most 32).
inline void z_lanes(int tn, size_t xsize, int* ns, int* ls) {
  *ns = (int)((tn + 16 / xsize - 1) / (16 / xsize));
  *ls = 1;
  while (*ls < *ns && *ls < 32) *ls <<= 1;
}

// --- mbarriers and bulk copies ---------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// --- the lane-parallel body --------------------------------------------------

// element i of a 16-byte vector of XT, as the accumulator type
template <typename XT>
__device__ __forceinline__ typename Acc<XT>::type vec_elem(const uint4& w, int i);
template <>
__device__ __forceinline__ float vec_elem<float>(const uint4& w, int i) {
  const uint32_t u = i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
  return __uint_as_float(u);
}
template <>
__device__ __forceinline__ float vec_elem<__nv_bfloat16>(const uint4& w, int i) {
  const uint32_t u = (i >> 1) == 0 ? w.x : (i >> 1) == 1 ? w.y : (i >> 1) == 2 ? w.z : w.w;
  return __uint_as_float((i & 1) ? u & 0xffff0000u : u << 16);
}
template <>
__device__ __forceinline__ int vec_elem<int8_t>(const uint4& w, int i) {
  const uint32_t u = (i >> 2) == 0 ? w.x : (i >> 2) == 1 ? w.y : (i >> 2) == 2 ? w.z : w.w;
  return static_cast<int>(u << (24 - 8 * (i & 3))) >> 24;
}

// The VX = 16 / sizeof(XT) bytes of M for the rows of one x slice (kb = 1),
// as one vector load; byte i is (w >> 8 (i % 4)) of word i / 4.
template <int VX>
__device__ __forceinline__ uint4 m_vec_load(const uint8_t* p) {
  if constexpr (VX == 16) return *reinterpret_cast<const uint4*>(p);
  if constexpr (VX == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    return make_uint4(v.x, v.y, 0u, 0u);
  }
  return make_uint4(*reinterpret_cast<const uint32_t*>(p), 0u, 0u, 0u);
}
__device__ __forceinline__ uint32_t vec_byte(const uint4& w, int i) {
  const uint32_t u = (i >> 2) == 0 ? w.x : (i >> 2) == 1 ? w.y : (i >> 2) == 2 ? w.z : w.w;
  return (u >> (8 * (i & 3))) & 0xffu;
}

// byte kbyte of the M rows n0 ... n0 + VX - 1 of a tile (n of them in it),
// packed as vec_byte reads them: one vector load where kb = 1 and the rows
// are aligned (vec), else byte loads
template <int VX>
__device__ __forceinline__ uint4 m_slice(const uint8_t* mt, int n0, int n, int kb, int kbyte,
                                         bool vec) {
  if (vec) return m_vec_load<VX>(mt + n0);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < VX; ++i)
    if (i < n) w[i >> 2] |= (uint32_t)mt[(size_t)(n0 + i) * kb + kbyte] << (8 * (i & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// 16 bytes of x at p (n elements of the tile row there) as vec_elem reads
// them: one vector load (vec), else element loads with zeros past n
template <typename XT>
__device__ __forceinline__ uint4 x_slice(const XT* p, int n, bool vec) {
  if (vec) return *reinterpret_cast<const uint4*>(p);
  constexpr int VX = 16 / sizeof(XT);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < VX; ++i) {
    if (i < n) {
      uint32_t b;
      if constexpr (sizeof(XT) == 4)
        b = reinterpret_cast<const uint32_t*>(p)[i];
      else if constexpr (sizeof(XT) == 2)
        b = reinterpret_cast<const uint16_t*>(p)[i];
      else
        b = reinterpret_cast<const uint8_t*>(p)[i];
      w[(i * (int)sizeof(XT)) >> 2] |= b << (8 * ((i * (int)sizeof(XT)) & 3));
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// bit b of m as +-1 (unpack) or {0, 1} (bitplane), so that z += x * sign is
// z +- x (or z + x, z) rounded once: the sign is formed once per (row of M,
// k) and serves all BT rows of x; nm = ~m
template <typename A, bool BP>
__device__ __forceinline__ A sign_of(uint32_t m, uint32_t nm, int b) {
  if constexpr (std::is_floating_point<A>::value) {
    return BP ? __uint_as_float((uint32_t)(static_cast<int>(m << (31 - b)) >> 31) & 0x3f800000u)
              : __uint_as_float(0x3f800000u | ((nm << (31 - b)) & 0x80000000u));
  } else {
    return BP ? static_cast<int>((m >> b) & 1u) : static_cast<int>(((m >> b) & 1u) << 1) - 1;
  }
}
__device__ __forceinline__ float madd(float x, float f, float z) { return fmaf(x, f, z); }
__device__ __forceinline__ int madd(int x, int f, int z) { return x * f + z; }

template <int BT>
__device__ __forceinline__ void store_z(float* zp, const float (&o)[BT]) {
  if constexpr (BT % 4 == 0) {
#pragma unroll
    for (int q = 0; q < BT / 4; ++q)
      reinterpret_cast<float4*>(zp)[q] = make_float4(o[4 * q], o[4 * q + 1], o[4 * q + 2],
                                                     o[4 * q + 3]);
  } else if constexpr (BT == 2) {
    *reinterpret_cast<float2*>(zp) = make_float2(o[0], o[1]);
  } else {
    zp[0] = o[0];
  }
}

// z of a batch of nb tiles x BT rows, rounded to C's dtype, into
// zbuf[(j K + k) BT + t].  xg: x at row 0 of the group and tile 0 (row
// stride x_row, tile stride tn); mg: M of tile 0 (tile stride m_str); p: the
// kernel's parameters (tn, kb, K, ls and ns of z_lanes, m_vec, x_vec).  The
// work is units (tile j, pair of k) of ls lanes each, 32 / ls units at a
// time: lane s0 of a unit takes the 16-byte slices s0, s0 + ls, ... of the
// tile's tn columns for all BT rows, decodes each of its M bits once into a
// factor for the BT rows, and the unit's lanes add their partials with xor
// shuffles.
template <typename XT, typename CT, int BT, bool BP, typename P>
__device__ __forceinline__ void z_batch(const XT* xg, size_t x_row, const uint8_t* mg,
                                        size_t m_str, int nb, int rows, const P& p, float* zbuf,
                                        int lane) {
  using A = typename Acc<XT>::type;
  constexpr int VX = 16 / sizeof(XT);
  const int tn = p.tn, K = p.K, LS = p.ls, NS = p.ns;
  const int pairs = (K + 1) >> 1, units = nb * pairs, s0 = lane & (LS - 1);
  for (int u = lane / LS; u - lane / LS < units; u += 32 / LS) {
    const int j = u / pairs, k0 = 2 * (u - j * pairs);
    const bool valid = u < units;
    const XT* xt = xg + (size_t)j * tn;
    const uint8_t* mt = mg + (size_t)j * m_str;
    A z[BT][2], srow[BT];
#pragma unroll
    for (int t = 0; t < BT; ++t) z[t][0] = z[t][1] = srow[t] = 0;
    if (valid) {
      for (int s = s0; s < NS; s += LS) {
        const int n0 = s * VX, n = tn - n0;
        const uint4 mw = m_slice<VX>(mt, n0, n, p.kb, k0 >> 3, p.m_vec);
        uint4 xw[BT];
#pragma unroll
        for (int t = 0; t < BT; ++t)
          xw[t] = t < rows ? x_slice<XT>(xt + (size_t)t * x_row + n0, n, p.x_vec)
                           : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int i = 0; i < VX; ++i) {
          const uint32_t m = vec_byte(mw, i) >> (k0 & 7), nm = ~m;
          A xv[BT];
#pragma unroll
          for (int t = 0; t < BT; ++t) xv[t] = vec_elem<XT>(xw[t], i);
          if (BP) {
#pragma unroll
            for (int t = 0; t < BT; ++t) srow[t] += xv[t];
          }
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            const A f = sign_of<A, BP>(m, nm, kk);
#pragma unroll
            for (int t = 0; t < BT; ++t) z[t][kk] = madd(xv[t], f, z[t][kk]);
          }
        }
      }
    }
    // the unit's lanes add their partials (all 32 lanes take part)
    for (int off = LS >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int t = 0; t < BT; ++t) {
        z[t][0] += __shfl_xor_sync(0xffffffffu, z[t][0], off);
        z[t][1] += __shfl_xor_sync(0xffffffffu, z[t][1], off);
        if (BP) srow[t] += __shfl_xor_sync(0xffffffffu, srow[t], off);
      }
    }
    if (s0 == 0 && valid) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        if (k0 + kk < K) {
          float o[BT];
#pragma unroll
          for (int t = 0; t < BT; ++t)
            o[t] = t < rows ? to_c<CT>(as_f32(BP ? A(2) * z[t][kk] - srow[t] : z[t][kk])) : 0.f;
          store_z<BT>(zbuf + (j * K + k0 + kk) * BT, o);
        }
      }
    }
  }
}

template <int BT>
__device__ __forceinline__ void load_z(float (&zt)[BT], const float* zp) {
  if constexpr (BT % 4 == 0) {
#pragma unroll
    for (int q = 0; q < BT / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(zp)[q];
      zt[4 * q] = v.x, zt[4 * q + 1] = v.y, zt[4 * q + 2] = v.z, zt[4 * q + 3] = v.w;
    }
  } else if constexpr (BT == 2) {
    const float2 v = *reinterpret_cast<const float2*>(zp);
    zt[0] = v.x, zt[1] = v.y;
  } else {
    zt[0] = zp[0];
  }
}

// V columns of C's row at p (n of them in the tile)
template <typename CT, int V>
__device__ __forceinline__ void load_c(float (&cv)[V], const CT* p, int n, bool vec) {
  if constexpr (V == 4) {
    if (vec) {
      if constexpr (sizeof(CT) == 4) {
        const float4 v = *reinterpret_cast<const float4*>(p);
        cv[0] = v.x, cv[1] = v.y, cv[2] = v.z, cv[3] = v.w;
      } else {
        const uint2 v = *reinterpret_cast<const uint2*>(p);
        cv[0] = __uint_as_float(v.x << 16), cv[1] = __uint_as_float(v.x & 0xffff0000u);
        cv[2] = __uint_as_float(v.y << 16), cv[3] = __uint_as_float(v.y & 0xffff0000u);
      }
      return;
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) cv[v] = v < n ? ld(p + v) : 0.f;
}

// acc[t][v] += z[j][k][t] * C[j][k][v] over the batch's tiles: cg is this
// lane's first column of tile 0's row 0 (tile stride c_str, row stride
// c_row), n the columns of the tile from there (<= 0: none)
template <typename CT, int BT, int V>
__device__ __forceinline__ void zc_batch(const CT* cg, size_t c_str, size_t c_row, int nb, int K,
                                         int n, bool c_vec, const float* zbuf,
                                         float (&acc)[BT][V]) {
  if (n <= 0) return;
  for (int j = 0; j < nb; ++j) {
    const CT* ct = cg + (size_t)j * c_str;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      float cv[V], zt[BT];
      load_c<CT, V>(cv, ct + (size_t)k * c_row, n, c_vec);
      load_z<BT>(zt, zbuf + (j * K + k) * BT);
#pragma unroll
      for (int t = 0; t < BT; ++t)
#pragma unroll
        for (int v = 0; v < V; ++v) acc[t][v] = fmaf(zt[t], cv[v], acc[t][v]);
    }
  }
}



// --- tensor-map copies (TMA): one box of a CUtensorMap into shared memory ---

__device__ __forceinline__ void tma_load_3d(void* dst, const void* map, uint64_t* bar, int c0,
                                            int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(void* dst, const void* map, uint64_t* bar, int c0,
                                            int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// --- deterministic reductions of partial y ---------------------------------

// The W warps' slots of n floats each (warp w's at slots + w n) added in
// warp order into the first slot; one barrier first, so every warp's slot
// is complete.
__device__ __forceinline__ void block_reduce(float* slots, int n, int W) {
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float s = slots[i];
    for (int w = 1; w < W; ++w) s += slots[(size_t)w * n + i];
    slots[i] = s;
  }
}

// Rank 0 of a cluster of S blocks (ranks along x) adds the ranks' n sums
// in rank order through distributed shared memory and hands each to
// store(i, sum); the other ranks keep their slots until rank 0 has read
// them.
template <typename Store>
__device__ __forceinline__ void cluster_reduce(float* slots, int n, int S, int rank,
                                               Store store) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  if (S > 1) cluster.sync();
  if (rank == 0) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      float s = slots[i];
      for (int k = 1; k < S; ++k) s += cluster.map_shared_rank(slots, k)[i];
      store(i, s);
    }
  }
  if (S > 1) cluster.sync();
}

inline bool aligned(const void* p, size_t n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

}  // namespace bitlinear_impl
