// K1 / K2 for sequences of at most N_SHORT tokens: the frequency attention
// (num_freq_tokens f: b (n + registers) sequences of f tokens, 16,896 of
// them at the flagship's training batch, 66,048 at N = 4096 frames), and
// any other launch that short. The entry points (flash_attention.cu,
// flash_attention_bwd.cu) launch these kernels for every n <= N_SHORT and
// the tiled designs (flash_attention_sm90.cuh for bf16,
// flash_attention.cuh for f32) above it.
//
// Replaces, for such n, the TPU kernels
// e2_tts_tpu/ops/flash_attention.py::_packed_fwd_kernel (forward, K1) and
// ::_packed_bwd_kernel (backward, K2); the JAX package itself sends
// sequences under 128 tokens to XLA (ops/attention.py), and the port has no
// plain route on the card. The function is K1's and K2's whole: scaled
// logits with the tanh softclamp, the key-padding bias (0 or -1e30),
// softmax with lse = m + log(l) to (b*h, n) f32, post-softmax counter-hash
// dropout with the tiled designs' keep bits (the global head (hash_b0 + b)
// * hash_heads + hash_h0 + h, hash_rc added to its seed), K1's folded
// sigmoid gate; K2 reads K10's delta and do_g, ADDS its dq into the f32
// buffer and writes dk and dv.
//
// What bounds it: bytes. At (16,896, 2, 8 x 64) bf16 the products are
// 4 b h f^2 dh ~ 138 MFLOP against ~140 MB moved, about one FLOP a byte,
// some 300x below the H100's ridge. The tiled designs give each (sequence,
// head) pair a block with a 64-row tile: at n = 2, 135,168 blocks whose
// tiles are ~97% padding, ~80 GB/s. So no tensor cores here: every score,
// probability, dropout and product is f32 on the CUDA cores, and each
// output is rounded once, at its store.
//  - A group of G = dh / VEC lanes owns one (sequence, head) pair; lane c
//    holds 16-byte chunk c (VEC = 8 bf16 or 4 f32 values) of every row of
//    q, k, v (do, dq, dk, dv). Consecutive groups take consecutive heads
//    of one sequence, so a warp reads 512 contiguous bytes of each row of
//    the packed (b, n, h*dh) projection.
//  - A score is the group's xor-shuffle sum of its lanes' chunk products;
//    every lane of the group then holds it and runs the softmax, the hash
//    and the probability's products on its own chunk.
//  - Rows stay in registers, as loaded (16 bytes a row), so that a pair's
//    loads go out together: the forward holds every k and v row up to 4
//    tokens and takes 2 query rows a pass (8 tokens: k and v streamed once
//    a pass of 4 rows), each row's scores against every key, an exact max
//    and sum, then p v. The backward up to 2 bf16 (4 f32) tokens holds
//    every row's q, do, lse, delta and f32 dq (read once, written once) and
//    walks the keys, each key's dk and dv finished before the next; past
//    that it takes 2 (4 f32) keys a pass against every row, the rows coming
//    again from L1 / L2 and dq read, added and written each pass (the group
//    owns those elements: no atomics).
//  - A 1-D grid-stride loop over the b * heads pairs, a few blocks per SM
//    (the occupancy calculator's count): 66,048 x 8 pairs are one launch.
//  - 16-byte loads where every pointer and stride allows them, element
//    loads otherwise (any view: the scalar path, as K6's).
// The compile-time bound NMAX (a power of two, the smallest >= n) sizes
// the register arrays; loops run to n.
#pragma once

#include "flash_attention.cuh"
#include "flash_attention_sm90.cuh"  // sm90::sm_count

namespace {
namespace short_seq {

// The largest n these kernels take: the crossover with the tiled designs
// that chip_ab.py measures at 16,896 sequences of 8 x 64 bf16 (PERF.md):
// this design is the faster at n = 8 (K1 3.6x, K2 with K10 1.16x) and the
// slower at 16 (K1 1.5x, K2 2.4x; measured with this bound at 64).
constexpr int N_SHORT = 8;
constexpr int THREADS = 256;

template <typename T>
struct Geom {
  static constexpr int VEC = 16 / sizeof(T);  // elements a lane holds of a row
};

// a row's 16-byte chunk of T at p as it lies in memory: one 16-byte load,
// or VEC element loads (the scalar path)
template <typename T>
__device__ __forceinline__ uint4 load_raw(const T* p, bool vec16) {
  if (vec16) return __ldg(reinterpret_cast<const uint4*>(p));
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < Geom<T>::VEC; ++i) e[i] = p[i];
  return raw;
}

template <typename T>
__device__ __forceinline__ void unpack(const uint4& raw, float* dst) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Geom<T>::VEC; ++i) dst[i] = e2::to_float<T>(e[i]);
}

// VEC f32 values rounded to T at p (16-byte aligned: an output the
// wrapper allocated contiguous)
template <typename T>
__device__ __forceinline__ void store_row(T* p, const float* src, float scale) {
  constexpr int VEC = Geom<T>::VEC;
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC; ++i) e[i] = e2::from_float<T>(src[i] * scale);
  *reinterpret_cast<uint4*>(p) = raw;
}

template <typename T>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < Geom<T>::VEC; ++i) s = fmaf(a[i], b[i], s);
  return s;
}

// the sum over the group's G lanes (a power of two, aligned in the warp);
// every lane of the warp calls it
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ unsigned head_seed(unsigned seed, int hash_b0, int hash_heads,
                                              int hash_h0, int bi, int h, unsigned hash_rc) {
  return e2::fmix32(seed ^ (((unsigned)(hash_b0 + bi) * hash_heads + hash_h0 + h) * 0x27D4EB2Fu),
                    2) + hash_rc;
}

// the keep bit of (row, key), as the tiled designs draw it
__device__ __forceinline__ bool keep(unsigned hseed, int row, int key, unsigned threshold) {
  return e2::fmix32(hseed + (unsigned)row * 0x9E3779B1u + (unsigned)key * 0x85EBCA77u, 1) >=
         threshold;
}

// The pairs a warp walks: its groups take pairs base + g, base advancing by
// every group of the grid. `base` is the same for every lane of a warp, so
// all 32 lanes run every iteration (the shuffles need them); a group past
// the last pair reads the last pair and stores nothing.
struct PairWalk {
  long long base, stride, pairs;
  int group;
  template <int G>
  __device__ __forceinline__ static PairWalk make(long long pairs) {
    constexpr int GW = 32 / G;  // groups a warp
    const long long warp = ((long long)blockIdx.x * THREADS + threadIdx.x) / 32;
    const long long warps = (long long)gridDim.x * (THREADS / 32);
    return {warp * GW, warps * GW, pairs, (int)(threadIdx.x % 32) / G};
  }
};

// ---------------------------------------------------------------- forward

template <typename T, int DH, int NMAX>
__global__ void __launch_bounds__(THREADS, 2) fwd_kernel(FwdParams p, bool vec16) {
  constexpr int VEC = Geom<T>::VEC, G = DH / VEC;
  // up to 4 keys: every k and v row in registers (as loaded, 16 bytes a
  // row), brought in with the q rows; longer: streamed once a query pass
  constexpr bool KV_REGS = NMAX <= 4;
  constexpr int NKV = KV_REGS ? NMAX : 1;
  // query rows a pass: 2 with k and v in registers, else <= 32 scores a lane
  constexpr int QT = KV_REGS ? (NMAX < 2 ? NMAX : 2) : (32 / NMAX > 0 ? 32 / NMAX : 1);
  const int lane = threadIdx.x % G;
  const int n = p.n, H = p.heads;
  const PairWalk w = PairWalk::make<G>((long long)p.b * H);
  for (long long base = w.base; base < w.pairs; base += w.stride) {
    const long long pair = min(base + w.group, w.pairs - 1);
    const bool owner = base + w.group < w.pairs;
    const int bi = (int)(pair / H), h = (int)(pair % H);
    const T* qg = static_cast<const T*>(p.q) + offset(p.qs, bi, h) + lane * VEC;
    const T* kg = static_cast<const T*>(p.k) + offset(p.ks, bi, h) + lane * VEC;
    const T* vg = static_cast<const T*>(p.v) + offset(p.vs, bi, h) + lane * VEC;
    T* og = static_cast<T*>(p.o) + offset(p.os, bi, h) + lane * VEC;
    const unsigned char* mask = p.mask == nullptr ? nullptr : p.mask + (long long)bi * n;
    const unsigned hseed =
        head_seed(p.seed, p.hash_b0, p.hash_heads, p.hash_h0, bi, h, p.hash_rc);
    uint4 kraw[NKV], vraw[NKV];
    if constexpr (KV_REGS) {
#pragma unroll
      for (int j = 0; j < NMAX; ++j) {
        if (j < n) {
          kraw[j] = load_raw<T>(kg + (long long)j * p.ks.r, vec16);
          vraw[j] = load_raw<T>(vg + (long long)j * p.vs.r, vec16);
        }
      }
    }

    for (int i0 = 0; i0 < n; i0 += QT) {
      float q[QT][VEC], s[QT][NMAX];
#pragma unroll
      for (int r = 0; r < QT; ++r) {
        if (i0 + r < n) {
          unpack<T>(load_raw<T>(qg + (long long)(i0 + r) * p.qs.r, vec16), q[r]);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) q[r][e] = 0.f;
        }
      }
      // scores: each lane's chunk products, then the group's sums
#pragma unroll
      for (int j = 0; j < NMAX; ++j) {
        if (j < n) {
          float kr[VEC];
          if constexpr (KV_REGS) unpack<T>(kraw[j], kr);
          else unpack<T>(load_raw<T>(kg + (long long)j * p.ks.r, vec16), kr);
#pragma unroll
          for (int r = 0; r < QT; ++r) s[r][j] = group_sum<G>(dot<T>(q[r], kr));
        }
      }
      // softmax of each row, dropout after it; s becomes the kept p
      float inv_l[QT];
#pragma unroll
      for (int r = 0; r < QT; ++r) {
        float m = NEG_INF;
#pragma unroll
        for (int j = 0; j < NMAX; ++j) {
          if (j < n) {
            float x = s[r][j] * p.scale;
            if (p.softclamp > 0.f) x = tanhf(x / p.softclamp) * p.softclamp;
            if (mask != nullptr && !mask[j]) x += NEG_INF;
            s[r][j] = x;
            m = fmaxf(m, x);
          }
        }
        float l = 0.f;
#pragma unroll
        for (int j = 0; j < NMAX; ++j) {
          if (j < n) {
            float pr = expf(s[r][j] - m);
            l += pr;  // the denominator counts un-dropped probabilities
            if (p.dropping) pr = keep(hseed, i0 + r, j, p.threshold) ? pr * p.inv_keep : 0.f;
            s[r][j] = pr;
          }
        }
        const float l_fin = fmaxf(l, 1e-30f);
        inv_l[r] = 1.f / l_fin;
        if (owner && lane == 0 && i0 + r < n)
          p.lse[((long long)bi * H + h) * n + i0 + r] = m + logf(l_fin);
      }
      // o = p v / l (* sigmoid(gate))
      float acc[QT][VEC];
#pragma unroll
      for (int r = 0; r < QT; ++r)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[r][e] = 0.f;
#pragma unroll
      for (int j = 0; j < NMAX; ++j) {
        if (j < n) {
          float vr[VEC];
          if constexpr (KV_REGS) unpack<T>(vraw[j], vr);
          else unpack<T>(load_raw<T>(vg + (long long)j * p.vs.r, vec16), vr);
#pragma unroll
          for (int r = 0; r < QT; ++r)
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[r][e] = fmaf(s[r][j], vr[e], acc[r][e]);
        }
      }
#pragma unroll
      for (int r = 0; r < QT; ++r) {
        const int row = i0 + r;
        if (owner && row < n) {
          float sc = inv_l[r];
          if (p.gate != nullptr) {
            const float g =
                e2::to_float<T>(static_cast<const T*>(p.gate)[((long long)bi * n + row) * H + h]);
            sc *= 1.f / (1.f + expf(-g));
          }
          store_row<T>(og + (long long)row * p.os.r, acc[r], sc);
        }
      }
    }
  }
}

// --------------------------------------------------------------- backward

// For each key j and query row i, recomputed as the tiled K2 does:
//   s = scale q k^T; th = tanh(s / c); s = c th (jac = 1 - th^2); s += bias
//   p = exp(s - lse[i]);  dp = do_g[i] . v[j]
//   ks = keep / (1 - rate);  ds = p (ks dp - delta[i]) jac scale;  p_drop = p ks
//   dv[j] += p_drop do_g[i],  dk[j] += ds q[i],  dq[i] += ds k[j]
// all in f32 (the tiled designs round p_drop and ds to the compute dtype
// before their products). prob_grad returns p_drop and ds of one (row, key)
// from its score s and dp.
__device__ __forceinline__ void prob_grad(const BwdParams& p, unsigned hseed, float s, float dp,
                                          float bias, float lse, float delta, int row, int key,
                                          float& pr, float& ds) {
  float x = s * p.scale, jac = 1.f;
  if (p.softclamp > 0.f) {
    const float th = tanhf(x / p.softclamp);
    x = th * p.softclamp;
    jac = 1.f - th * th;
  }
  pr = expf(x + bias - lse);
  if (p.dropping) {
    const float ks = keep(hseed, row, key, p.threshold) ? p.inv_keep : 0.f;
    ds = pr * (ks * dp - delta);
    pr *= ks;
  } else {
    ds = pr * (dp - delta);
  }
  ds = ds * jac * p.scale;
}

template <typename T, int DH, int NMAX>
__global__ void __launch_bounds__(THREADS, 2) bwd_kernel(BwdParams p, bool vec16) {
  constexpr int VEC = Geom<T>::VEC, G = DH / VEC;
  // Rows in registers (bf16 up to 2 tokens, f32 up to 4): every row's q, do
  // (as loaded), lse, delta and f32 dq (read once, summed over the keys,
  // written once) brought in together, then one key at a time against every
  // row, its dk and dv finished before the next key. Longer: KT keys a pass
  // (k, v as loaded, f32 dk, dv: 16 values of each a lane) against every
  // row, a row's operands coming again each pass (L1 / L2) and its dq read,
  // added and written each pass.
  constexpr bool ROWS_REGS = NMAX * VEC <= 16;
  constexpr int NR = ROWS_REGS ? NMAX : 1;
  constexpr int KT = 16 / VEC;
  const int lane = threadIdx.x % G;
  const int n = p.n, H = p.heads;
  const PairWalk w = PairWalk::make<G>((long long)p.b * H);
  for (long long base = w.base; base < w.pairs; base += w.stride) {
    const long long pair = min(base + w.group, w.pairs - 1);
    const bool owner = base + w.group < w.pairs;
    const int bi = (int)(pair / H), h = (int)(pair % H);
    const T* qg = static_cast<const T*>(p.q) + offset(p.qs, bi, h) + lane * VEC;
    const T* kg = static_cast<const T*>(p.k) + offset(p.ks, bi, h) + lane * VEC;
    const T* vg = static_cast<const T*>(p.v) + offset(p.vs, bi, h) + lane * VEC;
    const T* dog = static_cast<const T*>(p.dout) + offset(p.dos, bi, h) + lane * VEC;
    float* dqg = p.dq + offset(p.dqs, bi, h) + lane * VEC;
    T* dkg = static_cast<T*>(p.dk) + offset(p.dks, bi, h) + lane * VEC;
    T* dvg = static_cast<T*>(p.dv) + offset(p.dvs, bi, h) + lane * VEC;
    const float* lseg = p.lse + ((long long)bi * H + h) * n;
    const float* deltag = p.delta + offset(p.deltas, bi, h);
    const unsigned char* mask = p.mask == nullptr ? nullptr : p.mask + (long long)bi * n;
    const unsigned hseed =
        head_seed(p.seed, p.hash_b0, p.hash_heads, p.hash_h0, bi, h, p.hash_rc);
    const auto dq_row = [&](int i) {
      return reinterpret_cast<float4*>(dqg + (long long)i * p.dqs.r);
    };

    if constexpr (ROWS_REGS) {
      uint4 qraw[NR], doraw[NR];
      float lse[NR], delta[NR], dq[NR][VEC];
#pragma unroll
      for (int i = 0; i < NMAX; ++i) {
        if (i < n) {
          qraw[i] = load_raw<T>(qg + (long long)i * p.qs.r, vec16);
          doraw[i] = load_raw<T>(dog + (long long)i * p.dos.r, true);
          lse[i] = lseg[i];
          delta[i] = deltag[(long long)i * p.deltas.r];
#pragma unroll
          for (int c = 0; c < VEC / 4; ++c) {
            const float4 d = dq_row(i)[c];
            dq[i][4 * c] = d.x;
            dq[i][4 * c + 1] = d.y;
            dq[i][4 * c + 2] = d.z;
            dq[i][4 * c + 3] = d.w;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < NMAX; ++j) {
        if (j < n) {
          float kr[VEC], vr[VEC], dk[VEC], dv[VEC];
          unpack<T>(load_raw<T>(kg + (long long)j * p.ks.r, vec16), kr);
          unpack<T>(load_raw<T>(vg + (long long)j * p.vs.r, vec16), vr);
          const float bias = (mask != nullptr && !mask[j]) ? NEG_INF : 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) dk[e] = dv[e] = 0.f;
#pragma unroll
          for (int i = 0; i < NMAX; ++i) {
            if (i < n) {
              float qr[VEC], dor[VEC], pr, ds;
              unpack<T>(qraw[i], qr);
              unpack<T>(doraw[i], dor);
              prob_grad(p, hseed, group_sum<G>(dot<T>(qr, kr)), group_sum<G>(dot<T>(dor, vr)),
                        bias, lse[i], delta[i], i, j, pr, ds);
#pragma unroll
              for (int e = 0; e < VEC; ++e) {
                dv[e] = fmaf(pr, dor[e], dv[e]);
                dk[e] = fmaf(ds, qr[e], dk[e]);
                dq[i][e] = fmaf(ds, kr[e], dq[i][e]);
              }
            }
          }
          if (owner) {
            store_row<T>(dkg + (long long)j * p.dks.r, dk, 1.f);
            store_row<T>(dvg + (long long)j * p.dvs.r, dv, 1.f);
          }
        }
      }
      if (owner) {  // the group owns these dq elements: read above, added, written
#pragma unroll
        for (int i = 0; i < NMAX; ++i)
          if (i < n)
#pragma unroll
            for (int c = 0; c < VEC / 4; ++c)
              dq_row(i)[c] = make_float4(dq[i][4 * c], dq[i][4 * c + 1], dq[i][4 * c + 2],
                                         dq[i][4 * c + 3]);
      }
    } else {
      for (int j0 = 0; j0 < n; j0 += KT) {
        uint4 kraw[KT], vraw[KT];
        float dk[KT][VEC], dv[KT][VEC], bias[KT];
#pragma unroll
        for (int t = 0; t < KT; ++t) {
          if (j0 + t < n) {
            kraw[t] = load_raw<T>(kg + (long long)(j0 + t) * p.ks.r, vec16);
            vraw[t] = load_raw<T>(vg + (long long)(j0 + t) * p.vs.r, vec16);
            bias[t] = (mask != nullptr && !mask[j0 + t]) ? NEG_INF : 0.f;
          }
#pragma unroll
          for (int e = 0; e < VEC; ++e) dk[t][e] = dv[t][e] = 0.f;
        }
        for (int i = 0; i < n; ++i) {
          float qr[VEC], dor[VEC], dq[VEC];
          unpack<T>(load_raw<T>(qg + (long long)i * p.qs.r, vec16), qr);
          unpack<T>(load_raw<T>(dog + (long long)i * p.dos.r, true), dor);
          const float lse = lseg[i], delta = deltag[(long long)i * p.deltas.r];
#pragma unroll
          for (int e = 0; e < VEC; ++e) dq[e] = 0.f;
#pragma unroll
          for (int t = 0; t < KT; ++t) {
            if (j0 + t < n) {
              float kr[VEC], vr[VEC], pr, ds;
              unpack<T>(kraw[t], kr);
              unpack<T>(vraw[t], vr);
              prob_grad(p, hseed, group_sum<G>(dot<T>(qr, kr)), group_sum<G>(dot<T>(dor, vr)),
                        bias[t], lse, delta, i, j0 + t, pr, ds);
#pragma unroll
              for (int e = 0; e < VEC; ++e) {
                dv[t][e] = fmaf(pr, dor[e], dv[t][e]);
                dk[t][e] = fmaf(ds, qr[e], dk[t][e]);
                dq[e] = fmaf(ds, kr[e], dq[e]);
              }
            }
          }
          if (owner) {  // the group owns these dq elements: read, add, write
#pragma unroll
            for (int c = 0; c < VEC / 4; ++c) {
              float4 d = dq_row(i)[c];
              d.x += dq[4 * c]; d.y += dq[4 * c + 1]; d.z += dq[4 * c + 2]; d.w += dq[4 * c + 3];
              dq_row(i)[c] = d;
            }
          }
        }
#pragma unroll
        for (int t = 0; t < KT; ++t) {
          if (owner && j0 + t < n) {
            store_row<T>(dkg + (long long)(j0 + t) * p.dks.r, dk[t], 1.f);
            store_row<T>(dvg + (long long)(j0 + t) * p.dvs.r, dv[t], 1.f);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------- launch

// a persistent grid: as many blocks as fit on the card at once (per_sm,
// the caller's count for its kernel), fewer when the pairs fill less
template <typename Kernel>
cudaError_t grid_size(Kernel kernel, int& per_sm, long long pairs, int G, int* blocks) {
  if (per_sm == 0) {
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) per_sm = 1;
  }
  const long long need = (pairs + THREADS / G - 1) / (THREADS / G);
  const long long most = (long long)per_sm * sm90::sm_count();
  *blocks = (int)(need < most ? need : most);
  return cudaSuccess;
}

template <typename T, int DH, int NMAX = 2>
cudaError_t launch_fwd_n(const FwdParams& p, bool vec16, cudaStream_t stream) {
  if constexpr (NMAX < N_SHORT) {
    if (p.n > NMAX) return launch_fwd_n<T, DH, 2 * NMAX>(p, vec16, stream);
  }
  static int per_sm = 0;
  int blocks = 0;
  cudaError_t err = grid_size(fwd_kernel<T, DH, NMAX>, per_sm, (long long)p.b * p.heads,
                              DH / Geom<T>::VEC, &blocks);
  if (err != cudaSuccess) return err;
  fwd_kernel<T, DH, NMAX><<<blocks, THREADS, 0, stream>>>(p, vec16);
  return cudaGetLastError();
}

template <typename T, int DH, int NMAX = 2>
cudaError_t launch_bwd_n(const BwdParams& p, bool vec16, cudaStream_t stream) {
  if constexpr (NMAX < N_SHORT) {
    if (p.n > NMAX) return launch_bwd_n<T, DH, 2 * NMAX>(p, vec16, stream);
  }
  static int per_sm = 0;
  int blocks = 0;
  cudaError_t err = grid_size(bwd_kernel<T, DH, NMAX>, per_sm, (long long)p.b * p.heads,
                              DH / Geom<T>::VEC, &blocks);
  if (err != cudaSuccess) return err;
  bwd_kernel<T, DH, NMAX><<<blocks, THREADS, 0, stream>>>(p, vec16);
  return cudaGetLastError();
}

// 16-byte access to a (b, n, h*dh) operand of T: an aligned start and batch
// / row strides in whole 16-byte chunks
template <typename T>
inline bool vec16_ok(const void* ptr, const Strides& s) {
  constexpr long long VEC = Geom<T>::VEC;
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && s.b % VEC == 0 && s.r % VEC == 0;
}

template <typename T, int DH>
cudaError_t launch_fwd_t(const FwdParams& p, cudaStream_t stream) {
  if (p.b == 0 || p.n == 0) return cudaSuccess;
  const bool vec16 =
      vec16_ok<T>(p.q, p.qs) && vec16_ok<T>(p.k, p.ks) && vec16_ok<T>(p.v, p.vs);
  return launch_fwd_n<T, DH>(p, vec16, stream);
}

// dout, dq, dk and dv are the wrapper's contiguous buffers: 16-byte access
template <typename T, int DH>
cudaError_t launch_bwd_t(const BwdParams& p, cudaStream_t stream) {
  if (p.b == 0 || p.n == 0) return cudaSuccess;
  if (!vec16_ok<T>(p.dout, p.dos) || reinterpret_cast<uintptr_t>(p.dq) % 16 != 0 ||
      !vec16_ok<T>(p.dk, p.dks) || !vec16_ok<T>(p.dv, p.dvs))
    return cudaErrorMisalignedAddress;
  const bool vec16 =
      vec16_ok<T>(p.q, p.qs) && vec16_ok<T>(p.k, p.ks) && vec16_ok<T>(p.v, p.vs);
  return launch_bwd_n<T, DH>(p, vec16, stream);
}

template <typename T>
cudaError_t launch_fwd_dh(const FwdParams& p, cudaStream_t stream) {
  switch (p.dh) {
    case 32: return launch_fwd_t<T, 32>(p, stream);
    case 64: return launch_fwd_t<T, 64>(p, stream);
    case 128: return launch_fwd_t<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_bwd_dh(const BwdParams& p, cudaStream_t stream) {
  switch (p.dh) {
    case 32: return launch_bwd_t<T, 32>(p, stream);
    case 64: return launch_bwd_t<T, 64>(p, stream);
    case 128: return launch_bwd_t<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

// the entry points' few-token branch: bf16 or f32, dim_head 32, 64 or 128
// (templates, so that each entry point's file compiles only its own kernels)
template <typename Params>
cudaError_t launch_fwd(const Params& p, bool bf16, cudaStream_t stream) {
  return bf16 ? launch_fwd_dh<__nv_bfloat16>(p, stream) : launch_fwd_dh<float>(p, stream);
}

template <typename Params>
cudaError_t launch_bwd(const Params& p, bool bf16, cudaStream_t stream) {
  return bf16 ? launch_bwd_dh<__nv_bfloat16>(p, stream) : launch_bwd_dh<float>(p, stream);
}

}  // namespace short_seq
}  // namespace
