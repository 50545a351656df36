// What the Hopper designs of the hyper-connection width connection share: the
// forward K5 / K3 (hyper_conn_sm90.cuh) and the adjoints K5b / K4 with their
// save variants K5bs / K4s (hyper_conn_bwd_sm90.cuh), both on bf16 at 4
// streams. A team of warps owns
// a row, one 8-column chunk a thread (two past d = 2048); both take the team
// geometry below, so a row's rms statistic sums in the same order in both
// (K3s / K5s save, by construction, the inv that K4 / K5b recompute). Here: the
// geometry, 16-, 8- and 4-byte cp.async copies of a chunk into a per-thread
// ring slot (a masked tail zero-filled), chunk stores, bf16 packing and the
// warp reduce-scatter.
#pragma once

#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace {
namespace hc_sm90 {

using bf16 = __nv_bfloat16;

constexpr int NS = 4;                     // streams
constexpr int NC = NS + 2;                // alpha columns 0..NS, beta at NS + 1
constexpr int NV = NS * NC;               // values of the first two reductions
constexpr int J1_MAX_D = 2048;            // one chunk a thread up to here, two beyond
constexpr int MIN_BLOCK_WARPS = 4;        // narrow rows: several teams a block
constexpr int MAX_THREADS = 320;          // two chunks a thread: 5120 columns

// the geometry of width d
__host__ __device__ constexpr int chunks(int d) { return (d + 7) / 8; }
__host__ __device__ constexpr int per_thread(int d) { return d <= J1_MAX_D ? 1 : 2; }
__host__ __device__ constexpr int team_warps(int d) { return (chunks(d) + 32 * per_thread(d) - 1) / (32 * per_thread(d)); }
__host__ __device__ constexpr int teams(int d) { return team_warps(d) >= MIN_BLOCK_WARPS ? 1 : MIN_BLOCK_WARPS / team_warps(d); }
__host__ __device__ constexpr int block_warps(int d) { return teams(d) * team_warps(d); }

// ---------------------------------------------------------------- helpers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// global -> shared, BYTES of 16, 8 or 4; src_size 0 writes zeros, reads nothing
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "n"(BYTES), "r"(valid ? BYTES : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the threads of one team (id 1..4; 0 is __syncthreads')
__device__ __forceinline__ void team_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ float lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

__device__ __forceinline__ float round_bf16(float x) { return __bfloat162float(__float2bfloat16(x)); }

__device__ __forceinline__ uint32_t pack(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  f[0] = lo(u.x), f[1] = hi(u.x), f[2] = lo(u.y), f[3] = hi(u.y);
  f[4] = lo(u.z), f[5] = hi(u.z), f[6] = lo(u.w), f[7] = hi(u.w);
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  return make_uint4(pack(f[0], f[1]), pack(f[2], f[3]), pack(f[4], f[5]), pack(f[6], f[7]));
}

// f rounded to bf16 (round to nearest even), in place
__device__ __forceinline__ void round8(float (&f)[8]) {
  uint4 u = pack8(f);
  unpack8(u, f);
}

// this thread's chunk (8 columns from src, `valid` of them < d) into its ring
// slot, in pieces of VEC columns; pieces past d are zero
__device__ __forceinline__ void copy_chunk(uint4* dst, const bf16* src, int valid, int vec) {
  if (vec == 8) {
    cp_async<16>(dst, src, true);
  } else if (vec == 4) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      cp_async<8>(reinterpret_cast<uint2*>(dst) + h, src + (4 * h < valid ? 4 * h : 0), 4 * h < valid);
  } else if (vec == 2) {
#pragma unroll
    for (int h = 0; h < 4; ++h)
      cp_async<4>(reinterpret_cast<uint32_t*>(dst) + h, src + (2 * h < valid ? 2 * h : 0),
                  2 * h < valid);
  } else {
    unsigned short e[8];
    const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
#pragma unroll
    for (int i = 0; i < 8; ++i) e[i] = i < valid ? s[i] : 0;
    *dst = make_uint4(e[0] | (uint32_t)e[1] << 16, e[2] | (uint32_t)e[3] << 16,
                      e[4] | (uint32_t)e[5] << 16, e[6] | (uint32_t)e[7] << 16);
  }
}

// the first `valid` columns of a chunk to dst, in pieces of VEC columns
__device__ __forceinline__ void store_chunk(bf16* dst, const uint4& v, int valid, int vec) {
  if (vec == 8) {
    *reinterpret_cast<uint4*>(dst) = v;
  } else if (vec == 4) {
    uint2* d2 = reinterpret_cast<uint2*>(dst);
    d2[0] = make_uint2(v.x, v.y);
    if (valid > 4) d2[1] = make_uint2(v.z, v.w);
  } else {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    if (vec == 2) {
      uint32_t* d1 = reinterpret_cast<uint32_t*>(dst);
#pragma unroll
      for (int h = 0; h < 4; ++h)
        if (2 * h < valid) d1[h] = w[h];
    } else {
      unsigned short* d0 = reinterpret_cast<unsigned short*>(dst);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (i < valid) d0[i] = (unsigned short)(w[i / 2] >> (16 * (i & 1)));
    }
  }
}

// Reduce-scatter of N values (a power of 2) over a warp: halving steps at
// lane offsets OFF, OFF / 2, ... leave lane l the warp's sum of value
// (l / (32 / N)) in v[0]; then butterflies give it to every lane of the group.
template <int N, int OFF>
__device__ __forceinline__ void halve(float* v, int lane) {
  if constexpr (N > 1) {
    const bool up = lane & OFF;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float send = up ? v[i] : v[i + N / 2];
      const float keep = up ? v[i + N / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
    }
    halve<N / 2, OFF / 2>(v, lane);
  } else {
#pragma unroll
    for (int off = OFF; off > 0; off >>= 1) v[0] += __shfl_xor_sync(0xffffffffu, v[0], off);
  }
}

inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

}  // namespace hc_sm90
}  // namespace
