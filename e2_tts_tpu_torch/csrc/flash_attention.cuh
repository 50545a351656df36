// The wmma design of the flash-attention kernels: the forward (K1 on the
// packed (b, n, h*dh) projection, K8 on (b, h, n, dh)) and the backward
// (K2, K9). It runs f32 K1 / K2 / K8 / K9 and bf16 K8 / K9 on heads wider
// than 128; bf16 heads up to 128 (K1 / K2 at dim_head 32, 64, 128, and K8 /
// K9) and the cost-floor probe run the Hopper design of
// flash_attention_sm90.cuh, which takes this header's parameter structs.
// On the H100 the two layouts differ only in their strides, so one
// template serves both: every operand is addressed as base + batch * s.b +
// head * s.h + row * s.r + column.
//
// A head is dh columns, any multiple of 8 up to 256. The tiles in shared
// memory are DHP = dh rounded up to 16 columns wide (the depth of a bf16
// wmma product), the columns past dh zero-filled by the loads, so both
// products contract over zeros there; nothing past a head's dh columns is
// read from or written to device memory. Rows past n are zero too, and keys
// past n get the -1e30 bias (probability exactly 0).
//
// A head wider than 128 (SPLIT = 2) is two column chunks of DHP = dh rounded
// up to 32, halved (136 -> 80 + 80, 256 -> 128 + 128), and the grid gets two
// blocks per (tile, head, batch row), one per chunk of the output columns:
// each block sums the scores over both chunks (the other chunk first, its
// own last, so its own q / k / v / do stay in shared memory) and keeps only
// its own chunk's accumulators (the forward's p v, the backward's dk, dv
// and dq). The score products run twice, the rest once: 1.4x the work of one
// block for the whole head, and every tile, register accumulator and
// shared-memory layout stays that of a 128-wide head.
//
// The definitions sit in an anonymous namespace: each translation unit
// that includes this header compiles its own instantiations.
#pragma once

#include <mma.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int BQ = 64;  // query rows per tile
constexpr int BK = 64;  // keys per tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_INF = -1e30f;

constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

// element strides of a (b, h, n, dh) operand; its column stride is 1
struct Strides {
  long long b, h, r;
};

// CUDA caps gridDim.z at 65535. Each launcher puts the batch on z and
// launches it in chunks of at most that many z-blocks; a chunk's blocks
// read their batch row as b0 + blockIdx.z (/ SPLIT), b0 its first row. The
// frequency attention's batch, b * (n + registers) sequences of f tokens,
// passes 65535 at N = 4096 frames with B = 16. b0 is a memory offset only:
// the dropout hash takes the row's place in the global batch, hash_b0 + bi
// (hash_b0 the caller's: a data-parallel rank's first row), never b0 alone,
// and the head's among a row's hash_heads, hash_h0 + h (a tensor-parallel
// rank's first head).
constexpr int kMaxGridZ = 65535;

__device__ __forceinline__ long long offset(const Strides& s, int bi, int h) {
  return (long long)bi * s.b + (long long)h * s.h;
}

// rows [r0, r0 + 64) of a (n, dh) slab with row stride rs -> smem (pitch
// LDT), DHP columns: columns past dh and rows past n are zero.
template <typename T, int DHP, int LDT>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long rs, int r0, int n,
                                          int dh, int tid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = DHP / VEC;
  for (int idx = tid; idx < 64 * VPR; idx += NTHREADS) {
    const int r = idx / VPR, cv = idx % VPR;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n && cv * VEC < dh)
      val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * rs + cv * VEC);
    const T* e = reinterpret_cast<const T*>(&val);
#pragma unroll
    for (int t = 0; t < VEC; ++t) dst[r * LDT + cv * VEC + t] = e[t];
  }
}

// ---------------------------------------------------------------- forward

struct FwdParams {
  const void* q;
  const void* k;
  const void* v;
  Strides qs, ks, vs, os;
  const unsigned char* mask;  // (b, n) bool or null
  const void* gate;           // (b, n, heads) logits or null
  void* o;
  float* lse;                 // (b*heads, n)
  int b, n, heads, dh;
  float scale, softclamp, inv_keep;
  unsigned seed, threshold;
  int dropping;
  int b0 = 0;                 // the launch chunk's first batch row
  int hash_b0 = 0;            // the first row's place in the global batch, the
  int hash_h0 = 0;            // first head's place among the hash_heads heads of a
  int hash_heads = 0;         // row: the dropout hash reads global head
                              // (hash_b0 + bi) * hash_heads + hash_h0 + h
  unsigned hash_rc = 0;       // row0 * 0x9E3779B1 + col0 * 0x85EBCA77 (mod 2^32): the
                              // launch's first query row and key column in the
                              // global sequence (a ring block's), added to the
                              // per-head seed: the row / column hash is linear
};

template <typename T, int DHP, int SPLIT = 1>
struct FwdLayout {
  static constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  // row pitches (elements); bf16 pitches keep wmma's 16-byte/32-byte rules,
  // f32 pitches are odd so FMA loops read shared memory without conflicts
  static constexpr int LDT = kBf16 ? DHP + 8 : DHP + 1;  // q / k / v tiles
  static constexpr int LDS = BK + 4;                    // f32 scores
  static constexpr int LDO = DHP + 4;                   // f32 p@v tile
  static constexpr int LDF = LDS > LDO ? LDS : LDO;
  static constexpr int LDP = kBf16 ? BK + 8 : BK + 1;   // probabilities
  static constexpr size_t tile = (size_t)BQ * LDT;
  // SPLIT q tiles (one per column chunk), then k and v
  static constexpr size_t f_off = align128((2 + SPLIT) * tile * sizeof(T));
  static constexpr size_t p_off = f_off + align128((size_t)BQ * LDF * sizeof(float));
  static constexpr size_t bias_off = p_off + align128((size_t)BQ * LDP * sizeof(T));
  static constexpr size_t bytes = bias_off + BK * sizeof(float);
};

// scores of this warp's 16 q rows against the 64 keys of the tile -> sF
// (added to what sF holds with `accumulate`: a wide head's second chunk)
template <typename T, int DHP>
__device__ __forceinline__ void warp_scores(const T* sQw, const T* sK, float* sFw, int dh,
                                            int lane, bool accumulate = false) {
  using L = FwdLayout<T, DHP>;
  if constexpr (L::kBf16) {
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      if (accumulate) wmma::load_matrix_sync(c, sFw + j * 16, L::LDS, wmma::mem_row_major);
      else wmma::fill_fragment(c, 0.f);
#pragma unroll
      for (int kk = 0; kk < DHP / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
        wmma::load_matrix_sync(a, sQw + kk * 16, L::LDT);
        wmma::load_matrix_sync(b, sK + j * 16 * L::LDT + kk * 16, L::LDT);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(sFw + j * 16, c, L::LDS, wmma::mem_row_major);
    }
  } else {
    for (int r = 0; r < 16; ++r) {
      float s0 = accumulate ? sFw[r * L::LDS + lane] : 0.f;
      float s1 = accumulate ? sFw[r * L::LDS + lane + 32] : 0.f;
#pragma unroll 8
      for (int d = 0; d < dh; ++d) {
        const float qv = sQw[r * L::LDT + d];
        s0 = fmaf(qv, sK[lane * L::LDT + d], s0);
        s1 = fmaf(qv, sK[(lane + 32) * L::LDT + d], s1);
      }
      sFw[r * L::LDS + lane] = s0;
      sFw[r * L::LDS + lane + 32] = s1;
    }
  }
}

// this warp's 16 x DHP slice of p @ v -> sF (pitch LDO)
template <typename T, int DHP>
__device__ __forceinline__ void warp_pv(const T* sPw, const T* sV, float* sFw, int dh, int lane) {
  using L = FwdLayout<T, DHP>;
  if constexpr (L::kBf16) {
#pragma unroll
    for (int j = 0; j < DHP / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::fill_fragment(c, 0.f);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(a, sPw + kk * 16, L::LDP);
        wmma::load_matrix_sync(b, sV + kk * 16 * L::LDT + j * 16, L::LDT);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(sFw + j * 16, c, L::LDO, wmma::mem_row_major);
    }
  } else {
    for (int col = lane; col < dh; col += 32) {
      for (int r = 0; r < 16; ++r) {
        float acc = 0.f;
#pragma unroll 8
        for (int kk = 0; kk < BK; ++kk) acc = fmaf(sPw[r * L::LDP + kk], sV[kk * L::LDT + col], acc);
        sFw[r * L::LDO + col] = acc;
      }
    }
  }
}

// One block per (64 query rows, head, batch row[, column chunk]): s = c
// tanh(scale q k^T / c) + bias, online softmax over 64-key tiles,
// post-softmax hash dropout, o = (p v) / l * sigmoid(gate), lse = m + log(l).
template <typename T, int DHP, int SPLIT = 1>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_kernel(FwdParams p) {
  using L = FwdLayout<T, DHP, SPLIT>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);  // chunk c of the q rows at sQ + c * tile
  T* sK = sQ + SPLIT * L::tile;
  T* sV = sK + L::tile;
  float* sF = reinterpret_cast<float*>(smem + L::f_off);
  T* sP = reinterpret_cast<T*>(smem + L::p_off);
  float* sBias = reinterpret_cast<float*>(smem + L::bias_off);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y;
  const int bi = p.b0 + blockIdx.z / SPLIT, split = blockIdx.z % SPLIT;
  const int n = p.n, dh = p.dh;
  const int c0 = split * DHP, dh_own = min(DHP, dh - c0);  // this block's output columns
  const T* qg = static_cast<const T*>(p.q) + offset(p.qs, bi, h);
  const T* kg = static_cast<const T*>(p.k) + offset(p.ks, bi, h);
  const T* vg = static_cast<const T*>(p.v) + offset(p.vs, bi, h);

#pragma unroll
  for (int ch = 0; ch < SPLIT; ++ch)
    load_tile<T, DHP, L::LDT>(sQ + ch * L::tile, qg + ch * DHP, p.qs.r, q0, n, dh - ch * DHP,
                              tid);

  // a lane pair owns one q row: `half` picks its 32 score columns and its
  // DHP/2 output columns
  const int row_local = warp * 16 + (lane >> 1);
  const int half = lane & 1;
  const int row_abs = q0 + row_local;
  constexpr int OPL = DHP / 2;
  float acc[OPL];
#pragma unroll
  for (int i = 0; i < OPL; ++i) acc[i] = 0.f;
  float m_i = NEG_INF, l_i = 0.f;

  const unsigned hseed =
      e2::fmix32(p.seed ^ (((unsigned)(p.hash_b0 + bi) * p.hash_heads + p.hash_h0 + h)
                           * 0x27D4EB2Fu), 2) + p.hash_rc;
  float* sFw = sF + warp * 16 * L::LDF;
  T* sPw = sP + warp * 16 * L::LDP;
  float* srow = sFw + (lane >> 1) * L::LDS;
  T* prow = sPw + (lane >> 1) * L::LDP;
  const float* orow = sFw + (lane >> 1) * L::LDO + half * OPL;

  const int num_kt = (n + BK - 1) / BK;
  for (int kt = 0; kt < num_kt; ++kt) {
    const int k0 = kt * BK;
    // the score chunks: a wide head's other chunk first, this block's own last
#pragma unroll
    for (int j = 0; j < SPLIT; ++j) {
      const int ch = (split + 1 + j) % SPLIT;
      __syncthreads();  // every warp is done with the previous k (and v) tile
      load_tile<T, DHP, L::LDT>(sK, kg + ch * DHP, p.ks.r, k0, n, dh - ch * DHP, tid);
      if (j == SPLIT - 1) {
        load_tile<T, DHP, L::LDT>(sV, vg + c0, p.vs.r, k0, n, dh_own, tid);
        if (tid < BK) {
          const int col = k0 + tid;
          float bias = NEG_INF;  // keys past n: probability exactly 0
          if (col < n)
            bias = (p.mask == nullptr || p.mask[(long long)bi * n + col]) ? 0.f : NEG_INF;
          sBias[tid] = bias;
        }
      }
      __syncthreads();
      warp_scores<T, DHP>(sQ + ch * L::tile + warp * 16 * L::LDT, sK, sFw,
                          min(DHP, dh - ch * DHP), lane, j > 0);
      __syncwarp();
    }

    float mx = NEG_INF;
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const int c = half * 32 + j;
      float s = srow[c] * p.scale;
      if (p.softclamp > 0.f) s = tanhf(s / p.softclamp) * p.softclamp;
      s += sBias[c];
      srow[c] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_i, mx);
    float sum = 0.f;
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const int c = half * 32 + j;
      float pr = expf(srow[c] - m_new);
      sum += pr;  // the denominator counts un-dropped probabilities
      if (p.dropping) {
        const unsigned u = e2::fmix32(
            hseed + (unsigned)row_abs * 0x9E3779B1u + (unsigned)(k0 + c) * 0x85EBCA77u, 1);
        pr = (u >= p.threshold) ? pr * p.inv_keep : 0.f;
      }
      prow[c] = e2::from_float<T>(pr);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float alpha = expf(m_i - m_new);
    l_i = l_i * alpha + sum;
    m_i = m_new;
    __syncwarp();

    warp_pv<T, DHP>(sPw, sV, sFw, dh_own, lane);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < OPL; ++i) acc[i] = acc[i] * alpha + orow[i];
    __syncwarp();
  }

  if (row_abs < n) {
    const float l_fin = fmaxf(l_i, 1e-30f);
    float sc = 1.f / l_fin;
    if (p.gate != nullptr) {
      const float g = e2::to_float<T>(
          static_cast<const T*>(p.gate)[((long long)bi * n + row_abs) * p.heads + h]);
      sc *= 1.f / (1.f + expf(-g));
    }
    T* og = static_cast<T*>(p.o) + offset(p.os, bi, h) + (long long)row_abs * p.os.r + c0 +
            half * OPL;
#pragma unroll
    for (int i = 0; i < OPL; ++i)
      if (half * OPL + i < dh_own) og[i] = e2::from_float<T>(acc[i] * sc);
    if (half == 0 && split == 0)
      p.lse[((long long)bi * p.heads + h) * n + row_abs] = m_i + logf(l_fin);
  }
}

template <typename T, int DHP, int SPLIT = 1>
cudaError_t launch_fwd(const FwdParams& p, cudaStream_t stream) {
  using L = FwdLayout<T, DHP, SPLIT>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, DHP, SPLIT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)L::bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  for (int b0 = 0; b0 < p.b; b0 += kMaxGridZ / SPLIT) {
    FwdParams chunk = p;
    chunk.b0 = b0;
    dim3 grid((p.n + BQ - 1) / BQ, p.heads, std::min(p.b - b0, kMaxGridZ / SPLIT) * SPLIT);
    flash_fwd_kernel<T, DHP, SPLIT><<<grid, NTHREADS, L::bytes, stream>>>(chunk);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// --------------------------------------------------------------- backward

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  Strides qs, ks, vs, dos;
  const unsigned char* mask;  // (b, n) bool or null
  const float* lse;           // (b*heads, n), from the forward
  const float* delta;         // rowsum(do * o) per (batch, head, row)
  Strides deltas;             // its strides (column stride unused)
  float* dq;                  // f32, zeroed
  void* dk;
  void* dv;
  Strides dqs, dks, dvs;
  int b, n, heads, dh;
  float scale, softclamp, inv_keep;
  unsigned seed, threshold;
  int dropping;
  int b0 = 0;                 // the launch chunk's first batch row
  int hash_b0 = 0;            // the first row's place in the global batch, the
  int hash_h0 = 0;            // first head's place among the hash_heads heads of a
  int hash_heads = 0;         // row: the dropout hash reads global head
                              // (hash_b0 + bi) * hash_heads + hash_h0 + h
  unsigned hash_rc = 0;       // row0 * 0x9E3779B1 + col0 * 0x85EBCA77 (mod 2^32): the
                              // launch's first query row and key column in the
                              // global sequence (a ring block's), added to the
                              // per-head seed: the row / column hash is linear
};

template <typename T, int DHP>
struct BwdLayout {
  static constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int LDT = kBf16 ? DHP + 8 : DHP + 1;  // q / k / v / do tiles
  static constexpr int LDS = BQ + 4;                    // f32 score tiles (per warp)
  static constexpr int LDO = DHP + 4;                   // f32 staging of dq/dk/dv rows
  static constexpr int LDP = kBf16 ? BQ + 8 : BQ + 1;   // p^T and ds^T (keys x queries)
  // per-warp f32 region: s^T and dp^T (16 x LDS each), reused as dq staging
  static constexpr int FW0 = 2 * 16 * LDS > 16 * LDO ? 2 * 16 * LDS : 16 * LDO;
  static constexpr int FW = (FW0 + 7) / 8 * 8;
  static constexpr size_t tile = (size_t)64 * LDT;
  static constexpr size_t f_off = align128(4 * tile * sizeof(T));
  static constexpr size_t p_off = f_off + align128((size_t)NWARPS * FW * sizeof(float));
  static constexpr size_t ds_off = p_off + align128((size_t)BK * LDP * sizeof(T));
  static constexpr size_t vec_off = ds_off + align128((size_t)BK * LDP * sizeof(T));
  static constexpr size_t bytes = vec_off + (BK + 2 * BQ) * sizeof(float);
};

// C (16 x 64, f32, pitch LDS) = A (16 x DHP rows of pitch LDT) . B^T, B = 64 rows x DHP
// (C += with `accumulate`: a wide head's second chunk)
template <typename T, int DHP>
__device__ __forceinline__ void warp_abt(const T* A, const T* B, float* C, int dh, int lane,
                                         bool accumulate = false) {
  using L = BwdLayout<T, DHP>;
  if constexpr (L::kBf16) {
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      if (accumulate) wmma::load_matrix_sync(c, C + j * 16, L::LDS, wmma::mem_row_major);
      else wmma::fill_fragment(c, 0.f);
#pragma unroll
      for (int kk = 0; kk < DHP / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
        wmma::load_matrix_sync(a, A + kk * 16, L::LDT);
        wmma::load_matrix_sync(b, B + j * 16 * L::LDT + kk * 16, L::LDT);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(C + j * 16, c, L::LDS, wmma::mem_row_major);
    }
  } else {
    for (int r = 0; r < 16; ++r) {
      float s0 = accumulate ? C[r * L::LDS + lane] : 0.f;
      float s1 = accumulate ? C[r * L::LDS + lane + 32] : 0.f;
#pragma unroll 8
      for (int d = 0; d < dh; ++d) {
        const float av = A[r * L::LDT + d];
        s0 = fmaf(av, B[lane * L::LDT + d], s0);
        s1 = fmaf(av, B[(lane + 32) * L::LDT + d], s1);
      }
      C[r * L::LDS + lane] = s0;
      C[r * L::LDS + lane + 32] = s1;
    }
  }
}

// A warp's 16 x DHP f32 accumulator: wmma fragments (bf16) or per-lane
// registers (f32: lane owns columns lane + 32 i of all 16 rows).
template <typename T, int DHP, bool BF16 = BwdLayout<T, DHP>::kBf16>
struct WarpAcc;

template <typename T, int DHP>
struct WarpAcc<T, DHP, true> {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> f[DHP / 16];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < DHP / 16; ++j) wmma::fill_fragment(f[j], 0.f);
  }
  // += A (16 x 64; A_COL: element (r, c) at A[c * lda + r]) . B (64 x DHP, pitch ldb)
  template <bool A_COL>
  __device__ __forceinline__ void mma(const T* A, int lda, const T* B, int ldb, int lane) {
#pragma unroll
    for (int kk = 0; kk < 64 / 16; ++kk) {
      using ALayout = typename std::conditional<A_COL, wmma::col_major, wmma::row_major>::type;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, ALayout> a;
      wmma::load_matrix_sync(a, A_COL ? A + kk * 16 * lda : A + kk * 16, lda);
#pragma unroll
      for (int j = 0; j < DHP / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(b, B + kk * 16 * ldb + j * 16, ldb);
        wmma::mma_sync(f[j], a, b, f[j]);
      }
    }
  }
  __device__ __forceinline__ void store(float* dst, int ld, int lane) {
#pragma unroll
    for (int j = 0; j < DHP / 16; ++j) wmma::store_matrix_sync(dst + j * 16, f[j], ld, wmma::mem_row_major);
  }
};

template <typename T, int DHP>
struct WarpAcc<T, DHP, false> {
  static constexpr int CPL = (DHP + 31) / 32;  // columns per lane
  float f[16][CPL];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int r = 0; r < 16; ++r)
#pragma unroll
      for (int i = 0; i < CPL; ++i) f[r][i] = 0.f;
  }
  template <bool A_COL>
  __device__ __forceinline__ void mma(const T* A, int lda, const T* B, int ldb, int lane) {
    for (int kk = 0; kk < 64; ++kk) {
      float bv[CPL];
#pragma unroll
      for (int i = 0; i < CPL; ++i)
        bv[i] = lane + 32 * i < DHP ? e2::to_float<T>(B[kk * ldb + lane + 32 * i]) : 0.f;
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float av = e2::to_float<T>(A_COL ? A[kk * lda + r] : A[r * lda + kk]);
#pragma unroll
        for (int i = 0; i < CPL; ++i) f[r][i] = fmaf(av, bv[i], f[r][i]);
      }
    }
  }
  __device__ __forceinline__ void store(float* dst, int ld, int lane) {
#pragma unroll
    for (int r = 0; r < 16; ++r)
#pragma unroll
      for (int i = 0; i < CPL; ++i)
        if (lane + 32 * i < DHP) dst[r * ld + lane + 32 * i] = f[r][i];
  }
};

// a warp's 16 x DHP accumulator -> rows [row0, row0 + 16) (< n), columns
// < dh of dst (row stride ld), rounded to T, through the warp's f32 staging
template <typename T, int DHP>
__device__ __forceinline__ void store_rows(WarpAcc<T, DHP>& acc, float* stage, T* dst,
                                           long long ld, int row0, int n, int dh, int lane) {
  using L = BwdLayout<T, DHP>;
  __syncwarp();
  acc.store(stage, L::LDO, lane);
  __syncwarp();
  for (int idx = lane; idx < 16 * DHP; idx += 32) {
    const int r = idx / DHP, c = idx % DHP;
    if (row0 + r < n && c < dh)
      dst[(long long)(row0 + r) * ld + c] = e2::from_float<T>(stage[r * L::LDO + c]);
  }
}

// One block per (64-key tile, head, batch row): loops over the query tiles
// and recomputes, as the TPU kernels do in _recompute_p_ds / _bwd_keep_scaled,
//   s  = scale * q k^T;  th = tanh(s / c);  s = c * th  (softclamp c, jac = 1 - th^2)
//   p  = exp(s + bias[key] - lse[row])
//   dp = do v^T  (a gated layer's do arrives gated: K10 writes it)
//   ks = keep(seed, (hash_b0 + b)*hash_heads + hash_h0 + h, row, key) / (1 - rate)
//        (the forward's bits)
//   ds = p * (ks * dp - delta[row]) * jac * scale,  p_drop = p * ks
//   dv += p_drop^T do,  dk += ds^T q,  dq += ds k
// p_drop and ds are rounded to T before the three products, as the TPU
// kernels round them. dk and dv stay on chip until the end; dq, a sum over
// key tiles, goes to the zeroed f32 buffer by atomicAdd. A wide head's block
// (SPLIT = 2) loads both column chunks of k, v, q and do for each query tile
// (its own last) to sum s and dp, then accumulates its own chunk of dk, dv
// and dq.
template <typename T, int DHP, int SPLIT = 1>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_kernel(BwdParams p) {
  using L = BwdLayout<T, DHP>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + L::tile;
  T* sQ = sV + L::tile;
  T* sDO = sQ + L::tile;
  float* sF = reinterpret_cast<float*>(smem + L::f_off);
  T* sP = reinterpret_cast<T*>(smem + L::p_off);    // p_drop^T: keys x queries
  T* sDS = reinterpret_cast<T*>(smem + L::ds_off);  // ds^T: keys x queries
  float* sBias = reinterpret_cast<float*>(smem + L::vec_off);
  float* sLse = sBias + BK;
  float* sDelta = sLse + BQ;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k0 = blockIdx.x * BK, h = blockIdx.y;
  const int bi = p.b0 + blockIdx.z / SPLIT, split = blockIdx.z % SPLIT;
  const int n = p.n, H = p.heads, dh = p.dh;
  const int c0 = split * DHP, dh_own = min(DHP, dh - c0);  // this block's grad columns
  const T* qg = static_cast<const T*>(p.q) + offset(p.qs, bi, h);
  const T* kg = static_cast<const T*>(p.k) + offset(p.ks, bi, h);
  const T* vg = static_cast<const T*>(p.v) + offset(p.vs, bi, h);
  const T* dog = static_cast<const T*>(p.dout) + offset(p.dos, bi, h);
  const float* deltag = p.delta + offset(p.deltas, bi, h);

  if constexpr (SPLIT == 1) {
    load_tile<T, DHP, L::LDT>(sK, kg, p.ks.r, k0, n, dh, tid);
    load_tile<T, DHP, L::LDT>(sV, vg, p.vs.r, k0, n, dh, tid);
  }
  if (tid < BK) {
    const int col = k0 + tid;
    float bias = NEG_INF;  // keys past n: probability exactly 0
    if (col < n) bias = (p.mask == nullptr || p.mask[(long long)bi * n + col]) ? 0.f : NEG_INF;
    sBias[tid] = bias;
  }

  WarpAcc<T, DHP> dk_acc, dv_acc;
  dk_acc.zero();
  dv_acc.zero();

  const unsigned hseed =
      e2::fmix32(p.seed ^ (((unsigned)(p.hash_b0 + bi) * p.hash_heads + p.hash_h0 + h)
                           * 0x27D4EB2Fu), 2) + p.hash_rc;
  const T* sKw = sK + warp * 16 * L::LDT;
  const T* sVw = sV + warp * 16 * L::LDT;
  float* sFw = sF + warp * L::FW;
  float* sSw = sFw;                  // s^T of this warp's 16 keys
  float* sDPw = sFw + 16 * L::LDS;   // dp^T
  const int key_local = warp * 16 + (lane >> 1);
  const int key_abs = k0 + key_local;
  const int half = lane & 1;

  const int num_qt = (n + BQ - 1) / BQ;
  for (int qt = 0; qt < num_qt; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // every warp is done with the previous query tile
    if (tid < BQ) {
      const int row = q0 + tid;
      // rows past n: p = exp(... - 1e30) = 0 and delta 0, so they add nothing
      sLse[tid] = row < n ? p.lse[((long long)bi * H + h) * n + row] : -NEG_INF;
      sDelta[tid] = row < n ? deltag[(long long)row * p.deltas.r] : 0.f;
    }
    // the score chunks: a wide head's other chunk first, this block's own last
#pragma unroll
    for (int j = 0; j < SPLIT; ++j) {
      const int ch = (split + 1 + j) % SPLIT, cc = ch * DHP;
      if (j > 0) __syncthreads();  // every warp is done with the other chunk's tiles
      if constexpr (SPLIT > 1) {
        load_tile<T, DHP, L::LDT>(sK, kg + cc, p.ks.r, k0, n, dh - cc, tid);
        load_tile<T, DHP, L::LDT>(sV, vg + cc, p.vs.r, k0, n, dh - cc, tid);
      }
      load_tile<T, DHP, L::LDT>(sQ, qg + cc, p.qs.r, q0, n, dh - cc, tid);
      load_tile<T, DHP, L::LDT>(sDO, dog + cc, p.dos.r, q0, n, dh - cc, tid);
      __syncthreads();

      const int dh_ch = min(DHP, dh - cc);
      warp_abt<T, DHP>(sKw, sQ, sSw, dh_ch, lane, j > 0);   // s^T = k q^T
      warp_abt<T, DHP>(sVw, sDO, sDPw, dh_ch, lane, j > 0);  // dp^T = v do^T
      __syncwarp();
    }

    // a lane pair owns one key row; `half` picks its 32 query columns
    const float bias = sBias[key_local];
    const float* srow = sSw + (lane >> 1) * L::LDS + half * 32;
    const float* dprow = sDPw + (lane >> 1) * L::LDS + half * 32;
    T* prow = sP + key_local * L::LDP + half * 32;
    T* dsrow = sDS + key_local * L::LDP + half * 32;
#pragma unroll 4
    for (int j = 0; j < 32; ++j) {
      const int c = half * 32 + j;
      float s = srow[j] * p.scale;
      float jac = 1.f;
      if (p.softclamp > 0.f) {
        const float th = tanhf(s / p.softclamp);
        s = th * p.softclamp;
        jac = 1.f - th * th;
      }
      s += bias;
      float pr = expf(s - sLse[c]);
      const float dp = dprow[j];
      float ds;
      if (p.dropping) {
        const unsigned u = e2::fmix32(
            hseed + (unsigned)(q0 + c) * 0x9E3779B1u + (unsigned)key_abs * 0x85EBCA77u, 1);
        const float ks = (u >= p.threshold) ? p.inv_keep : 0.f;
        ds = pr * (ks * dp - sDelta[c]);
        pr = pr * ks;
      } else {
        ds = pr * (dp - sDelta[c]);
      }
      ds = ds * jac;
      ds = ds * p.scale;
      prow[j] = e2::from_float<T>(pr);
      dsrow[j] = e2::from_float<T>(ds);
    }
    __syncwarp();

    // this warp's keys: dv += p_drop^T do, dk += ds^T q
    dv_acc.template mma<false>(sP + warp * 16 * L::LDP, L::LDP, sDO, L::LDT, lane);
    dk_acc.template mma<false>(sDS + warp * 16 * L::LDP, L::LDP, sQ, L::LDT, lane);
    __syncthreads();  // ds^T complete for all 64 keys

    // this warp's 16 query rows: dq = ds k, ds read transposed from ds^T
    {
      WarpAcc<T, DHP> dq_acc;
      dq_acc.zero();
      dq_acc.template mma<true>(sDS + warp * 16, L::LDP, sK, L::LDT, lane);
      dq_acc.store(sFw, L::LDO, lane);  // s^T / dp^T of this warp are consumed
    }
    __syncwarp();
    float* dqg = p.dq + offset(p.dqs, bi, h) + c0;
    for (int idx = lane; idx < 16 * DHP; idx += 32) {
      const int r = idx / DHP, c = idx % DHP;
      const int row = q0 + warp * 16 + r;
      if (row < n && c < dh_own)
        atomicAdd(dqg + (long long)row * p.dqs.r + c, sFw[r * L::LDO + c]);
    }
    __syncwarp();
  }

  // dk, dv rows of this warp's 16 keys
  store_rows<T, DHP>(dk_acc, sFw, static_cast<T*>(p.dk) + offset(p.dks, bi, h) + c0, p.dks.r,
                     k0 + warp * 16, n, dh_own, lane);
  store_rows<T, DHP>(dv_acc, sFw, static_cast<T*>(p.dv) + offset(p.dvs, bi, h) + c0, p.dvs.r,
                     k0 + warp * 16, n, dh_own, lane);
}

template <typename T, int DHP, int SPLIT = 1>
cudaError_t launch_bwd(const BwdParams& p, cudaStream_t stream) {
  using L = BwdLayout<T, DHP>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_kernel<T, DHP, SPLIT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)L::bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  for (int b0 = 0; b0 < p.b; b0 += kMaxGridZ / SPLIT) {
    BwdParams chunk = p;
    chunk.b0 = b0;
    dim3 grid((p.n + BK - 1) / BK, p.heads, std::min(p.b - b0, kMaxGridZ / SPLIT) * SPLIT);
    flash_bwd_kernel<T, DHP, SPLIT><<<grid, NTHREADS, L::bytes, stream>>>(chunk);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace
