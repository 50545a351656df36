// K1 / K2 and K8 / K9 for Hopper: flash attention on bf16 operands with
// dim_head up to 128, products on wgmma with the scores kept in registers,
// operand tiles brought in by cp.async while the previous tile computes.
// K8 / K9 enter from flash_attention_bhnd.cu ((b, h, n, dh) operands, any
// multiple of 8 up to 128), K1 from flash_attention.cu and K2 from
// flash_attention_bwd.cu (the packed (b, n, h*dh) projection, dim_head 32,
// 64, 128): the same kernels, the packed layout being only other strides.
// f32 operands and heads wider than 128 keep the wmma templates of
// flash_attention.cuh. The entry points pick the design from the dtype and
// dim_head.
//
// K1's per-head sigmoid output gate (gate: bf16 (b, n, heads) logits, or
// null) is folded into the forward's epilogue: each row's 1 / l is
// multiplied by sigmoid(gate[b, row, h]), taken in f32, so o = (p v) / l *
// g, and lse stays gate-free, as the TPU kernel folds it. K2's gate is not
// in this file: K10 writes do_g = bf16(do * g) while it reads do for delta
// (the point where the TPU kernel rounds it), and the backward reads do_g
// as its do. Scaling the do tile here instead would redo it once per key
// block, add a barrier and an async-proxy fence per query tile.
//
// What bounds them at the DiT training shape (16, 16 heads, 1056, 72): the
// tensor cores (K8's two n x n x dh products, K9's five; far above the
// card's FLOP/byte ridge) and, for K8, the softclamp's two transcendentals
// per score (tanh, exp2) on the special-function units, 16 a clock per SM.
// The wmma design lost most of its time around the products: scores went
// to shared memory and back, one lane pair walked a row in series with an
// accurate tanhf, and the tiles came in by synchronous loads through
// registers. Here:
//  - A warpgroup (128 threads) owns 64 rows: K8 64 query rows, K9 64 keys.
//    Every product is one wgmma.m64nNk16 chain; the f32 accumulators stay
//    in registers, and a score tile's probabilities are turned into bf16
//    A fragments in place (the accumulator's layout is the A operand's), so
//    no score, probability or partial output touches shared memory. K9's
//    ds goes to shared memory once, for dq = ds k.
//  - K / V (K8) and q / do / lse / delta (K9) tiles ride a two-stage ring:
//    cp.async with src-size 0 zero-fills rows past n and columns past dh,
//    tile t + 1 is in flight while tile t computes. cp.async rather than
//    TMA: the operands are strided views of the packed projection (any
//    16-byte batch / head / row strides), which cp.async reads where they
//    lie with no tensor map to encode per call, and a tile is only 10 KiB.
//  - Per score: one multiply (scale / c folded), tanh.approx, one FMA into
//    the log2 domain (c log2e), ex2.approx; the mask / ragged-tail bias
//    only on tiles that need it, the dropout hash only when dropping. The
//    row max and sum take two quad shuffles (the sum once, at the end).
//  - No named-barrier ping-pong inside a block: several blocks share an SM
//    (K8 four one-warpgroup blocks at dh 72, 51 KiB of shared memory and
//    120-128 registers a thread; K9 two or three) and the warp schedulers
//    run one block's softmax under another's wgmma. K8 at a large grid
//    takes two warpgroups a block (128 query rows) that share the K / V
//    ring, halving the key tiles read from L2; at the sampler's shape
//    (1, 16, 1056, 72) it keeps one, so the 17 x 16 = 272 blocks are all
//    resident at once on 132 SMs: one wave.
//  - K9 reduces each 64 x DHP dq tile into the f32 buffer with
//    red.global.add.v4.f32 (a quad shuffle pairs two column pairs into four
//    consecutive columns): DHP / 8 vector reductions a thread a tile
//    instead of 16 DHP / 32 scalar atomicAdds a lane.
//
// Shared-memory tiles use wgmma's no-swizzle canonical layout: 8 x 8 bf16
// core matrices of 128 contiguous bytes (8 rows of 16 bytes), core matrix
// (row / 8, col / 8) of an R x DHP tile at ((row / 8) * (DHP / 8) + col / 8)
// * 128 bytes. Read along its columns (K-major: q, k in q k^T) the
// descriptor's leading offset (K direction) is 128 B and its stride offset
// (M / N direction) DHP * 16 B; read along its rows (MN-major, the
// transpose bit: v in p v, do / q in dv / dk, k in dq) the leading offset is
// DHP * 16 B and the stride offset 128 B.
//
// The semantics are those of flash_attention.cuh: s = c tanh(scale q k^T /
// c) + bias (0 or -1e30 for masked keys and keys past n), online softmax,
// post-softmax counter-hash dropout with the same keep bits, o = (p v) /
// max(l, 1e-30) (times the gate), lse = m + log l; the backward's p_drop
// and ds rounded to bf16 before the three products. Scores are kept in log2
// units (s log2e); the backward recomputes p with the same tanh.approx /
// ex2.approx from the forward's lse.
#pragma once

#include <cstdint>

#include "common.cuh"
#include "flash_attention.cuh"
#include "wgmma_sm90.cuh"

namespace {
namespace sm90 {

using bf16 = __nv_bfloat16;
constexpr int ROWS = 64;     // rows a warpgroup owns (and keys / queries per tile)
constexpr int THREADS = 128;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// ---------------------------------------------------------------- helpers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_size 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// this thread's generic-proxy writes to shared memory (cp.async, st.shared)
// become visible to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from touching registers an in-flight wgmma owns
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// makes `x` computed here: work placed between a wgmma's commit and its
// wait then runs while the tensor cores do
__device__ __forceinline__ void pin(uint32_t& x) { asm volatile("" : "+r"(x)::"memory"); }

// no-swizzle matrix descriptor: start address, leading byte offset (between
// core matrices along K), stride byte offset (along M / N)
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void red_add_v4(float* dst, float a, float b, float c, float d) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(dst), "f"(a), "f"(b),
               "f"(c), "f"(d)
               : "memory");
}

// element offset of (row, col) in a tile of KC = DHP / 8 core-matrix columns
template <int KC>
__device__ __forceinline__ int cm_offset(int row, int col) {
  return ((row >> 3) * KC + (col >> 3)) * 64 + (row & 7) * 8 + (col & 7);
}

// rows [r0, r0 + 64) of an (n, dh) slab with row stride rs -> a 64 x DHP
// tile in the core-matrix layout; rows past n and columns past dh are zero.
// Consecutive threads take consecutive rows of one 16-byte column chunk, so
// a warp's stores fill whole core matrices.
template <int DHP>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src, long long rs, int r0,
                                                int n, int dh, int tid) {
  constexpr int KC = DHP / 8;
#pragma unroll
  for (int idx = tid; idx < ROWS * KC; idx += THREADS) {
    const int r = idx & (ROWS - 1), c8 = idx >> 6;
    const bool valid = r0 + r < n && c8 * 8 < dh;
    const bf16* s = valid ? src + (long long)(r0 + r) * rs + c8 * 8 : src;
    cp_async16(dst + cm_offset<KC>(r, c8 * 8), s, valid);
  }
}

// a score accumulator (64 columns: 8 n8 chunks) -> the A fragments of the
// four k16 steps of the product that contracts over those columns
__device__ __forceinline__ void to_a_frags(const float (&s)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    a[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    a[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    a[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// S (64 x 64, f32 registers) = A (64 x DHP) B^T (64 x DHP), both K-major tiles
template <int DHP>
__device__ __forceinline__ void scores(float (&s)[32], const bf16* a, const bf16* b) {
  constexpr uint32_t LBO = 128, SBO = DHP * 16;
#pragma unroll
  for (int kk = 0; kk < DHP / 16; ++kk)
    wg::Mma<64>::ss<0, 0>(s, desc(a + kk * 128, LBO, SBO), desc(b + kk * 128, LBO, SBO), kk > 0);
}

// D (64 x DHP) += A (64 x 64 keys / queries, register fragments) B, B the
// 64 x DHP tile read MN-major
template <int DHP>
__device__ __forceinline__ void product_rs(float (&d)[DHP / 2], const uint32_t (&a)[4][4],
                                           const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wg::Mma<DHP>::template rs<1>(d, a[kk], desc(b + kk * 16 * DHP, DHP * 16, 128), 1);
}

// ---------------------------------------------------------------- forward

// NWG warpgroups a block, each owning 64 query rows; they share the K / V
// ring, so a wider block reads each key tile once for 64 NWG rows.
template <int DHP, int NWG>
struct FwdLayout {
  static constexpr int TILE = ROWS * DHP;  // elements
  static constexpr size_t bytes = (size_t)(NWG + 4) * TILE * sizeof(bf16);  // q, 2 x (k, v)
  // warpgroups an SM holds, as 128-thread blocks: shared memory allows 4 up
  // to DHP 80 (128 registers a thread; DHP 80 spills a few bytes), 3 up to
  // 112, 2 at 128
  static constexpr int kBlocksPerSM = DHP <= 80 ? 4 / NWG : DHP <= 112 ? 3 : 2;
};

// One block per (64 NWG query rows, head, batch row). PROBE < 0: K1 / K8.
// PROBE 0, 1, 2: the cost-floor probe on this kernel's ring, products and
// fragments, at q = k = v and with the softclamp, bias, dropout, online
// softmax and normalisation compiled out: per 64-key tile p = s (0), exp(s)
// (1, ex2.approx of s log2e), or exp(s) - (max + sum) over the tile's keys
// (2, the row statistics by K8's quad shuffles; keys past n are zero rows,
// s = 0, and count), o += bf16(p) v, bf16(o) out, no lse.
template <int DHP, int NWG, int PROBE = -1>
__global__ void __launch_bounds__(THREADS * NWG, FwdLayout<DHP, NWG>::kBlocksPerSM)
    flash_fwd_kernel(FwdParams p) {
  constexpr bool K8 = PROBE < 0;
  using L = FwdLayout<DHP, NWG>;
  constexpr int ND = DHP / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & (THREADS - 1);
  const int warp = wtid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  bf16* sQ = reinterpret_cast<bf16*>(smem) + wg * L::TILE;  // this warpgroup's rows
  bf16* sK = reinterpret_cast<bf16*>(smem) + NWG * L::TILE;  // stage st at sK + st * TILE
  bf16* sV = sK + 2 * L::TILE;

  const int q0 = blockIdx.x * ROWS * NWG + wg * ROWS, h = blockIdx.y, bi = p.b0 + blockIdx.z;
  const int n = p.n, dh = p.dh;
  const bf16* qg = static_cast<const bf16*>(p.q) + offset(p.qs, bi, h);
  const bf16* kg = static_cast<const bf16*>(p.k) + offset(p.ks, bi, h);
  const bf16* vg = static_cast<const bf16*>(p.v) + offset(p.vs, bi, h);
  // the K / V tiles of stage st (with two warpgroups, one loads each)
  auto load_kv = [&](int st, int k0) {
    if (NWG == 1 || wg == 0) load_tile_async<DHP>(sK + st * L::TILE, kg, p.ks.r, k0, n, dh, wtid);
    if (NWG == 1 || wg == 1) load_tile_async<DHP>(sV + st * L::TILE, vg, p.vs.r, k0, n, dh, wtid);
  };

  load_tile_async<DHP>(sQ, qg, p.qs.r, q0, n, dh, wtid);
  load_kv(0, 0);
  cp_commit();

  // score in log2 units = c2 * th, th = tanh(c1 * acc) (c1 * acc without the
  // softclamp): the row max is taken over th, so c2 rides in the exponent's FMA
  const bool clamp = p.softclamp > 0.f;
  const float c1 = clamp ? p.scale / p.softclamp : p.scale * LOG2E;
  const float c2 = clamp ? p.softclamp * LOG2E : 1.f;
  const unsigned hseed =
      e2::fmix32(p.seed ^ (((unsigned)(p.hash_b0 + bi) * p.hash_heads + p.hash_h0 + h)
                           * 0x27D4EB2Fu), 2) + p.hash_rc;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0 and row0 + 8
  const unsigned rhash[2] = {hseed + (unsigned)row0 * 0x9E3779B1u,
                             hseed + (unsigned)(row0 + 8) * 0x9E3779B1u};

  float o[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  const int num_kt = (n + ROWS - 1) / ROWS;
  for (int kt = 0; kt < num_kt; ++kt) {
    const int st = kt & 1, k0 = kt * ROWS;
    if (kt + 1 < num_kt) {
      load_kv(st ^ 1, k0 + ROWS);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    fence_async_smem();
    __syncthreads();

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wg_fence();
    scores<DHP>(s, sQ, sK + st * L::TILE);
    wg_commit();
    uint32_t a[4][4];
    if constexpr (!K8) {
      wg_wait<0>();
      fence_regs(s);
      if constexpr (PROBE >= 1) {
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = ex2(s[i] * LOG2E);
      }
      if constexpr (PROBE == 2) {
        // s[i] is row (i >> 1) & 1 of this thread's pair: rows row0, row0 + 8
        float mx[2] = {NEG_INF, NEG_INF}, sum[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
          sum[(i >> 1) & 1] += s[i];
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
          sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
          mx[r] += sum[r];
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] -= mx[(i >> 1) & 1];
      }
      to_a_frags(s, a);
    } else {
      // while the product runs: the bias where a key is masked or past n
      // (kept as 16 floats: a bit set ran slower at the training shape), and
      // the tile's keep bits (bit 4 j + e for s[4 j + e])
      const bool biased = p.mask != nullptr || k0 + ROWS > n;
      float kbias[16];
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int key = k0 + 8 * (c >> 1) + 2 * t + (c & 1);
        kbias[c] = 0.f;
        if (biased && (key >= n || (p.mask != nullptr && !p.mask[(long long)bi * n + key])))
          kbias[c] = NEG_INF;
      }
      fence_regs(kbias);
      uint32_t keep = 0;
      if (p.dropping) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const unsigned key = k0 + 8 * j + 2 * t + (e & 1);
            const unsigned u = e2::fmix32(rhash[e >> 1] + key * 0x85EBCA77u, 1);
            keep |= (uint32_t)(u >= p.threshold) << (4 * j + e);
          }
        pin(keep);
      }
      wg_wait<0>();
      fence_regs(s);

      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float th = s[4 * j + e] * c1;
          if (clamp) th = tanh_approx(th);
          if (biased) th += kbias[2 * j + (e & 1)];
          s[4 * j + e] = th;
          mx[e >> 1] = fmaxf(mx[e >> 1], th);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * c2);
        alpha[r] = ex2(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pr = ex2(fmaf(s[4 * j + e], c2, -m[e >> 1]));
          l[e >> 1] += pr;  // the denominator counts un-dropped probabilities
          if (p.dropping) pr = (keep >> (4 * j + e)) & 1u ? pr * p.inv_keep : 0.f;
          s[4 * j + e] = pr;
        }
      to_a_frags(s, a);
#pragma unroll
      for (int j = 0; j < DHP / 8; ++j) {
        o[4 * j + 0] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }
    }
    fence_regs(o);
    fence_regs(a);
    wg_fence();
    product_rs<DHP>(o, a, sV + st * L::TILE);
    wg_commit();
    wg_wait<0>();
    fence_regs(o);
    fence_regs(a);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  bf16* og = static_cast<bf16*>(p.o) + offset(p.os, bi, h);
  if constexpr (!K8) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= n) continue;
      bf16* orow = og + (long long)row * p.os.r;
#pragma unroll
      for (int j = 0; j < DHP / 8; ++j)
        if (8 * j < dh)
          *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t) =
              pack_bf16(o[4 * j + 2 * r], o[4 * j + 2 * r + 1]);
    }
  } else {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= n) continue;
      const float l_fin = fmaxf(l[r], 1e-30f);
      float inv = 1.f / l_fin;
      if (p.gate != nullptr) {
        const bf16* gate = static_cast<const bf16*>(p.gate);
        const float gl = __bfloat162float(gate[((long long)bi * n + row) * p.heads + h]);
        inv *= 1.f / (1.f + expf(-gl));
      }
      bf16* orow = og + (long long)row * p.os.r;
#pragma unroll
      for (int j = 0; j < DHP / 8; ++j)
        if (8 * j < dh)
          *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t) =
              pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
      if (t == 0)
        p.lse[((long long)bi * p.heads + h) * n + row] = (m[r] + __log2f(l_fin)) * LN2;
    }
  }
}

template <int DHP, int NWG, int PROBE>
cudaError_t launch_fwd_nwg(const FwdParams& p, cudaStream_t stream) {
  using L = FwdLayout<DHP, NWG>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<DHP, NWG, PROBE>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)L::bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  for (int b0 = 0; b0 < p.b; b0 += kMaxGridZ) {   // z chunks: flash_attention.cuh
    FwdParams chunk = p;
    chunk.b0 = b0;
    dim3 grid((p.n + ROWS * NWG - 1) / (ROWS * NWG), p.heads, std::min(p.b - b0, kMaxGridZ));
    flash_fwd_kernel<DHP, NWG, PROBE><<<grid, THREADS * NWG, L::bytes, stream>>>(chunk);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
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

// Heads up to 80 wide: 128-row blocks (two warpgroups sharing the K / V
// ring) when there are enough of them for two waves of the card (two
// blocks an SM), else 64-row blocks, so a short sequence still spreads
// over every SM. Wider heads: 64-row blocks. The probe (PROBE >= 0) takes
// the same choice.
template <int DHP, int PROBE = -1>
cudaError_t launch_fwd(const FwdParams& p, cudaStream_t stream) {
  if constexpr (DHP <= 80) {
    const long long wide = (long long)((p.n + 2 * ROWS - 1) / (2 * ROWS)) * p.heads * p.b;
    if (wide >= 4LL * sm_count()) return launch_fwd_nwg<DHP, 2, PROBE>(p, stream);
  }
  return launch_fwd_nwg<DHP, 1, PROBE>(p, stream);
}

// --------------------------------------------------------------- backward

// One warpgroup a block. (Two warpgroups sharing the q / do ring, 128 keys a
// block, each computing half of dq's columns over all 128 keys, ran slower:
// one 256-thread block an SM, both warpgroups held at every barrier.)
template <int DHP>
struct BwdLayout {
  static constexpr int TILE = ROWS * DHP;
  // k, v resident; 2 x (q, do); ds^T (64 x 64); 2 x (lse, delta) f32
  static constexpr size_t ds_off = (size_t)6 * TILE * sizeof(bf16);
  static constexpr size_t vec_off = ds_off + (size_t)ROWS * ROWS * sizeof(bf16);
  static constexpr size_t bytes = vec_off + (size_t)4 * ROWS * sizeof(float);
  // 3 blocks an SM up to DHP 64 (168 registers, no spills); wider heads
  // spill at 168 and keep 2
  static constexpr int kBlocksPerSM = DHP <= 64 ? 3 : 2;
};

// One block per (64 keys, head, batch row), looping over the query
// tiles: recomputes s^T = k q^T and p^T from K8's lse, dp^T = v do^T,
// ds^T = p^T (ks dp^T - delta) jac scale; dv += p_drop^T do and dk += ds^T q
// from register fragments; ds^T to shared memory for dq = ds k, reduced into
// the zeroed f32 dq by red.global.add.v4.f32.
template <int DHP>
__global__ void __launch_bounds__(THREADS, BwdLayout<DHP>::kBlocksPerSM)
    flash_bwd_kernel(BwdParams p) {
  using L = BwdLayout<DHP>;
  constexpr int ND = DHP / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + L::TILE;
  bf16* sQ = sV + L::TILE;       // stage st at sQ + st * TILE
  bf16* sDO = sQ + 2 * L::TILE;  // stage st at sDO + st * TILE
  bf16* sDS = reinterpret_cast<bf16*>(smem + L::ds_off);       // ds^T: keys x queries
  float* sLse = reinterpret_cast<float*>(smem + L::vec_off);  // stage st at sLse + st * 64
  float* sDelta = sLse + 2 * ROWS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * ROWS, h = blockIdx.y, bi = p.b0 + blockIdx.z;
  const int n = p.n, H = p.heads, dh = p.dh;
  const bf16* qg = static_cast<const bf16*>(p.q) + offset(p.qs, bi, h);
  const bf16* kg = static_cast<const bf16*>(p.k) + offset(p.ks, bi, h);
  const bf16* vg = static_cast<const bf16*>(p.v) + offset(p.vs, bi, h);
  const bf16* dog = static_cast<const bf16*>(p.dout) + offset(p.dos, bi, h);
  const float* lseg = p.lse + ((long long)bi * H + h) * n;
  const float* deltag = p.delta + offset(p.deltas, bi, h);

  // stage st's q / do tiles and lse / delta vectors
  auto load_queries = [&](int st, int q0) {
    load_tile_async<DHP>(sQ + st * L::TILE, qg, p.qs.r, q0, n, dh, tid);
    load_tile_async<DHP>(sDO + st * L::TILE, dog, p.dos.r, q0, n, dh, tid);
    if (tid < ROWS) {
      const bool valid = q0 + tid < n;
      cp_async4(sLse + st * ROWS + tid, valid ? lseg + q0 + tid : lseg, valid);
    } else {
      const int r = tid - ROWS;
      const bool valid = q0 + r < n;
      cp_async4(sDelta + st * ROWS + r, valid ? deltag + (long long)(q0 + r) * p.deltas.r : deltag,
                valid);
    }
  };
  load_tile_async<DHP>(sK, kg, p.ks.r, k0, n, dh, tid);
  load_tile_async<DHP>(sV, vg, p.vs.r, k0, n, dh, tid);
  load_queries(0, 0);
  cp_commit();

  // as K8: p = exp2(c2 (th + bias) - lse log2e), th = tanh(c1 * acc)
  const bool clamp = p.softclamp > 0.f;
  const float c1 = clamp ? p.scale / p.softclamp : p.scale * LOG2E;
  const float c2 = clamp ? p.softclamp * LOG2E : 1.f;
  const unsigned hseed =
      e2::fmix32(p.seed ^ (((unsigned)(p.hash_b0 + bi) * p.hash_heads + p.hash_h0 + h)
                           * 0x27D4EB2Fu), 2) + p.hash_rc;
  const int krow0 = warp * 16 + g;  // this thread's keys in the block: krow0 and krow0 + 8
  const int key0 = k0 + krow0;
  const unsigned khash[2] = {hseed + (unsigned)key0 * 0x85EBCA77u,
                             hseed + (unsigned)(key0 + 8) * 0x85EBCA77u};
  float bias[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    bias[r] = (key < n && (p.mask == nullptr || p.mask[(long long)bi * n + key])) ? 0.f : NEG_INF;
  }

  float dk[ND], dv[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) dk[i] = dv[i] = 0.f;
  float* dqg = p.dq + offset(p.dqs, bi, h);

  const int num_qt = (n + ROWS - 1) / ROWS;
  for (int qt = 0; qt < num_qt; ++qt) {
    const int st = qt & 1, q0 = qt * ROWS;
    if (qt + 1 < num_qt) {
      load_queries(st ^ 1, q0 + ROWS);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    fence_async_smem();
    __syncthreads();
    const bf16* sQs = sQ + st * L::TILE;
    const bf16* sDOs = sDO + st * L::TILE;
    const float* lse = sLse + st * ROWS;
    const float* delta = sDelta + st * ROWS;

    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wg_fence();
    scores<DHP>(s, sK, sQs);    // s^T = k q^T: rows keys, columns queries
    scores<DHP>(dp, sV, sDOs);  // dp^T = v do^T
    wg_commit();
    // while the products run: the tile's keep bits (bit 4 j + e for s[4 j + e])
    uint32_t keep = 0;
    if (p.dropping) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const unsigned q = q0 + 8 * j + 2 * t + (e & 1);
          const unsigned u = e2::fmix32(khash[e >> 1] + q * 0x9E3779B1u, 1);
          keep |= (uint32_t)(u >= p.threshold) << (4 * j + e);
        }
      pin(keep);
    }
    wg_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    const bool ragged = q0 + ROWS > n;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, qi = 8 * j + 2 * t + (e & 1);
        float th = s[4 * j + e] * c1, jac = 1.f;
        if (clamp) {
          th = tanh_approx(th);
          jac = 1.f - th * th;
        }
        float pr = ex2(fmaf(th + bias[r], c2, -lse[qi] * LOG2E));
        if (ragged && q0 + qi >= n) pr = 0.f;
        float ds;
        if (p.dropping) {
          const float ks = (keep >> (4 * j + e)) & 1u ? p.inv_keep : 0.f;
          ds = pr * (ks * dp[4 * j + e] - delta[qi]);
          pr = pr * ks;
        } else {
          ds = pr * (dp[4 * j + e] - delta[qi]);
        }
        s[4 * j + e] = pr;
        dp[4 * j + e] = ds * jac * p.scale;
      }
    uint32_t pa[4][4], dsa[4][4];
    to_a_frags(s, pa);
    to_a_frags(dp, dsa);
    // ds^T -> shared memory (keys x queries, core-matrix layout, 8 columns of cores)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<uint32_t*>(sDS + cm_offset<8>(krow0 + 8 * r, 8 * j + 2 * t)) =
            dsa[j >> 1][(j & 1) * 2 + r];

    fence_regs(dv);
    fence_regs(dk);
    fence_regs(pa);
    fence_regs(dsa);
    wg_fence();
    product_rs<DHP>(dv, pa, sDOs);  // dv += p_drop^T do
    product_rs<DHP>(dk, dsa, sQs);  // dk += ds^T q
    wg_commit();
    wg_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(pa);
    fence_regs(dsa);
    fence_async_smem();
    __syncthreads();  // ds^T complete for all 64 keys

    float dq[ND];
#pragma unroll
    for (int i = 0; i < ND; ++i) dq[i] = 0.f;
    fence_regs(dq);
    wg_fence();
    // dq (queries x DHP) = ds k: A = ds^T read MN-major, B = k read MN-major
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg::Mma<DHP>::template ss<1, 1>(dq, desc(sDS + kk * 16 * ROWS, ROWS * 16, 128),
                                      desc(sK + kk * 16 * DHP, DHP * 16, 128), kk > 0);
    wg_commit();
    wg_wait<0>();
    fence_regs(dq);

    // four consecutive columns a thread: even lanes of a pair take row g,
    // odd lanes row g + 8
    const bool odd = t & 1;
    const int row = q0 + warp * 16 + g + (odd ? 8 : 0);
    const int col_base = 2 * (t & ~1);
#pragma unroll
    for (int j = 0; j < DHP / 8; ++j) {
      const float x0 = dq[4 * j + 0], x1 = dq[4 * j + 1], y0 = dq[4 * j + 2], y1 = dq[4 * j + 3];
      const float r0 = __shfl_xor_sync(0xffffffffu, odd ? x0 : y0, 1);
      const float r1 = __shfl_xor_sync(0xffffffffu, odd ? x1 : y1, 1);
      const int col = 8 * j + col_base;
      if (row < n && col < dh) {
        float* dst = dqg + (long long)row * p.dqs.r + col;
        if (odd) red_add_v4(dst, r0, r1, y0, y1);
        else red_add_v4(dst, x0, x1, r0, r1);
      }
    }
    __syncthreads();  // this stage and ds^T are consumed before they are refilled
  }

  bf16* dkg = static_cast<bf16*>(p.dk) + offset(p.dks, bi, h);
  bf16* dvg = static_cast<bf16*>(p.dv) + offset(p.dvs, bi, h);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= n) continue;
#pragma unroll
    for (int j = 0; j < DHP / 8; ++j)
      if (8 * j < dh) {
        const int c = 8 * j + 2 * t;
        *reinterpret_cast<uint32_t*>(dkg + (long long)key * p.dks.r + c) =
            pack_bf16(dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dvg + (long long)key * p.dvs.r + c) =
            pack_bf16(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
      }
  }
}

template <int DHP>
cudaError_t launch_bwd(const BwdParams& p, cudaStream_t stream) {
  using L = BwdLayout<DHP>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_kernel<DHP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)L::bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  for (int b0 = 0; b0 < p.b; b0 += kMaxGridZ) {   // z chunks: flash_attention.cuh
    BwdParams chunk = p;
    chunk.b0 = b0;
    dim3 grid((p.n + ROWS - 1) / ROWS, p.heads, std::min(p.b - b0, kMaxGridZ));
    flash_bwd_kernel<DHP><<<grid, THREADS, L::bytes, stream>>>(chunk);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace sm90
}  // namespace
