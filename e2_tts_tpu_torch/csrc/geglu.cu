// K6 and K7: GEGLU + counter-hash dropout, forward and backward, for the
// H100 (sm_90a).
//
// K6 replaces the TPU kernel e2_tts_tpu/ops/geglu_kernel.py::_fwd_kernel
// (driven by _fwd_pallas). For h2 (b, n, 2*inner) with halves h = h2[..., :inner] and
// g = h2[..., inner:]:
//   out = h * 0.5 * g * (1 + erf(g / sqrt(2)))    (f32 math, exact erff)
// then dropout whose keep bit is fmix32(seed + b*P0 + row*P1 + col*P2) >=
// threshold, bit-identical to ops/dropout.py::hash_keep over (b, n, inner).
// The TPU kernel only took inner % 128 == 0; this one takes any inner
// (1408 and 704 on the flagship).
//
// K7 replaces the TPU kernel ::_bwd_kernel (driven by _bwd_pallas): from the
// saved projection output h2 and the incoming grad gout (b, n, inner) it
// regenerates the same keep bits, and with Phi(g) = 0.5 (1 + erf(g / sqrt 2)),
// gelu(g) = g Phi(g) and gelu'(g) = Phi(g) + g phi(g) writes
//   g_h = gout' gelu(g),  g_g = gout' h gelu'(g),  gout' = gout * keep / (1 - rate)
// into the two halves of a (b, n, 2*inner) grad. Exact erff and expf, like
// K6 (the TPU kernel used a rational erf approximation because Mosaic has
// none).
//
// What bounds both: bytes. K6 reads 2*inner and writes inner values a row
// (6 bytes an element in bf16), K7 reads 3*inner and writes 2*inner (10
// bytes), each with ~20-30 f32 operations an element; neither keeps an
// intermediate in device memory. At 3.35 TB/s that leaves ~53 (K6) and
// ~88 (K7) issued instructions an element across the card's 132 SMs x 4
// schedulers, and exact erff alone costs ~25 of them, so the design has to
// keep the per-element overhead small as well as keep enough bytes in flight.
//
// Two designs; the C entry points choose by shape and alignment:
// - The vector design (geglu_*_vec_kernel): every load and store moves 16
//   bytes (8 bf16 or 4 f32) through ld.global.nc. A 2-D grid: blockIdx.y is
//   the batch index, and each thread of a batch takes UNROLL vectors,
//   THREADS apart, issuing all their loads before it uses any. One 32-bit
//   division a vector maps it to its row and first column; the (b, row,
//   column) part of the hash counter is formed once a vector and advanced by
//   P2 an element. Dropout is a template flag, so a kernel holds one path.
//   The grid covers the work (no grid-stride cap). Needs
//   inner % (8 bf16, 4 f32) == 0, every pointer 16-byte aligned and a
//   batch's n * inner <= INT_MAX (32-bit vector indices). In flight: UNROLL x
//   32 (K6) or 48 (K7) bytes a thread, 80 KB / 96 KB an SM at the 1280 /
//   1024 resident threads their 47-48 / 57-64 registers allow.
// - The scalar design (geglu_*_kernel): one element a thread and iteration
//   of a grid-stride loop over (b, n, inner), 64-bit index arithmetic. It
//   takes what the vector design cannot: an inner that is not a multiple of
//   the vector width, or a view whose data pointer is not 16-byte aligned.
#include <climits>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 2;         // vectors a thread in the vector design
constexpr int MAX_GRID_Y = 65535;
constexpr unsigned P0 = 0x9E3779B1u, P1 = 0x85EBCA77u, P2 = 0xC2B2AE3Du;

// elements in one 16-byte vector: 8 bf16, 4 f32
template <typename T> constexpr int kVec = 16 / sizeof(T);

struct GegluParams {
  const void* h2;
  void* out;
  long long total;  // b * n * inner
  int b, n, inner;
  float inv_keep;
  unsigned seed, threshold;
  int dropping;
};

struct GegluBwdParams {
  const void* h2;
  const void* gout;
  void* gh2;
  long long total;  // b * n * inner
  int b, n, inner;
  float inv_keep;
  unsigned seed, threshold;
  int dropping;
};

// ---- the scalar design --------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS) geglu_fwd_kernel(GegluParams p) {
  const T* h2 = static_cast<const T*>(p.h2);
  T* out = static_cast<T*>(p.out);
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long idx = (long long)blockIdx.x * THREADS + threadIdx.x; idx < p.total;
       idx += stride) {
    const int col = (int)(idx % p.inner);
    const long long rb = idx / p.inner;  // b * n + row
    const float h = e2::to_float<T>(h2[rb * 2 * p.inner + col]);
    const float g = e2::to_float<T>(h2[rb * 2 * p.inner + p.inner + col]);
    float act = h * (0.5f * g * (1.f + erff(g * 0.70710678118654752f)));
    if (p.dropping) {
      const unsigned row = (unsigned)(rb % p.n), bi = (unsigned)(rb / p.n);
      const unsigned u = e2::fmix32(p.seed + bi * P0 + row * P1 + (unsigned)col * P2, 2);
      act = (u >= p.threshold) ? act * p.inv_keep : 0.f;
    }
    out[idx] = e2::from_float<T>(act);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) geglu_bwd_kernel(GegluBwdParams p) {
  const T* h2 = static_cast<const T*>(p.h2);
  const T* gout = static_cast<const T*>(p.gout);
  T* gh2 = static_cast<T*>(p.gh2);
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long idx = (long long)blockIdx.x * THREADS + threadIdx.x; idx < p.total;
       idx += stride) {
    const int col = (int)(idx % p.inner);
    const long long rb = idx / p.inner;  // b * n + row
    const float h = e2::to_float<T>(h2[rb * 2 * p.inner + col]);
    const float g = e2::to_float<T>(h2[rb * 2 * p.inner + p.inner + col]);
    float go = e2::to_float<T>(gout[idx]);
    if (p.dropping) {
      const unsigned row = (unsigned)(rb % p.n), bi = (unsigned)(rb / p.n);
      const unsigned u = e2::fmix32(p.seed + bi * P0 + row * P1 + (unsigned)col * P2, 2);
      go = (u >= p.threshold) ? go * p.inv_keep : 0.f;
    }
    const float phi = 0.5f * (1.f + erff(g * 0.70710678118654752f));
    const float dgelu = phi + g * expf(-0.5f * g * g) * 0.3989422804014327f;
    gh2[rb * 2 * p.inner + col] = e2::from_float<T>(go * (g * phi));
    gh2[rb * 2 * p.inner + p.inner + col] = e2::from_float<T>(go * h * dgelu);
  }
}

// ---- the vector design --------------------------------------------------

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(static_cast<const uint4*>(p));
}

__device__ __forceinline__ void store16(void* p, uint4 v) { *static_cast<uint4*>(p) = v; }

__device__ __forceinline__ unsigned word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// element j of a 16-byte vector as f32 (j is a constant once unrolled)
template <typename T> __device__ __forceinline__ float element(const uint4& v, int j);
template <> __device__ __forceinline__ float element<float>(const uint4& v, int j) {
  return __uint_as_float(word(v, j));
}
template <> __device__ __forceinline__ float element<__nv_bfloat16>(const uint4& v, int j) {
  const unsigned w = word(v, j >> 1);  // element 2i in the low half of word i
  return __uint_as_float((j & 1) ? (w & 0xFFFF0000u) : (w << 16));
}

// kVec<T> f32 values rounded to T, as one 16-byte vector
template <typename T> __device__ __forceinline__ uint4 pack(const float* f);
template <> __device__ __forceinline__ uint4 pack<float>(const float* f) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}
template <> __device__ __forceinline__ uint4 pack<__nv_bfloat16>(const float* f) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 two = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);  // RNE
    w[i] = *reinterpret_cast<const unsigned*>(&two);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ float drop(float x, unsigned ctr, unsigned threshold, float inv_keep) {
  return (e2::fmix32(ctr, 2) >= threshold) ? x * inv_keep : 0.f;
}

template <typename T, bool DROP>
__global__ void __launch_bounds__(THREADS) geglu_fwd_vec_kernel(GegluParams p) {
  constexpr int V = kVec<T>;
  const unsigned nv = (unsigned)p.inner / V;          // vectors in a row of one half
  const unsigned per_batch = (unsigned)p.n * nv;
  const unsigned row_len = 2u * (unsigned)p.inner;    // elements in a row of h2
  const unsigned first = blockIdx.x * (THREADS * UNROLL) + threadIdx.x;
  for (int bi = blockIdx.y; bi < p.b; bi += gridDim.y) {
    const T* h2 = static_cast<const T*>(p.h2) + (size_t)bi * p.n * row_len;
    T* out = static_cast<T*>(p.out) + (size_t)bi * p.n * p.inner;
    const unsigned ctr_b = p.seed + (unsigned)bi * P0;
    uint4 hv[UNROLL] = {}, gv[UNROLL] = {};
    unsigned row[UNROLL], col[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const unsigned w = first + u * THREADS;
      row[u] = w / nv;                                // the one division a vector
      col[u] = (w - row[u] * nv) * V;
      if (w < per_batch) {
        const T* src = h2 + (size_t)row[u] * row_len + col[u];
        hv[u] = load16(src);
        gv[u] = load16(src + p.inner);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (first + u * THREADS >= per_batch) break;
      const unsigned ctr = ctr_b + row[u] * P1 + col[u] * P2;
      float a[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float h = element<T>(hv[u], j), g = element<T>(gv[u], j);
        a[j] = h * (0.5f * g * (1.f + erff(g * 0.70710678118654752f)));
      }
      if constexpr (DROP) {
#pragma unroll
        for (int j = 0; j < V; ++j)
          a[j] = drop(a[j], ctr + (unsigned)j * P2, p.threshold, p.inv_keep);
      }
      store16(out + (size_t)row[u] * p.inner + col[u], pack<T>(a));
    }
  }
}

template <typename T, bool DROP>
__global__ void __launch_bounds__(THREADS) geglu_bwd_vec_kernel(GegluBwdParams p) {
  constexpr int V = kVec<T>;
  const unsigned nv = (unsigned)p.inner / V;
  const unsigned per_batch = (unsigned)p.n * nv;
  const unsigned row_len = 2u * (unsigned)p.inner;
  const unsigned first = blockIdx.x * (THREADS * UNROLL) + threadIdx.x;
  for (int bi = blockIdx.y; bi < p.b; bi += gridDim.y) {
    const T* h2 = static_cast<const T*>(p.h2) + (size_t)bi * p.n * row_len;
    const T* gout = static_cast<const T*>(p.gout) + (size_t)bi * p.n * p.inner;
    T* gh2 = static_cast<T*>(p.gh2) + (size_t)bi * p.n * row_len;
    const unsigned ctr_b = p.seed + (unsigned)bi * P0;
    uint4 hv[UNROLL] = {}, gv[UNROLL] = {}, ov[UNROLL] = {};
    unsigned row[UNROLL], col[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const unsigned w = first + u * THREADS;
      row[u] = w / nv;
      col[u] = (w - row[u] * nv) * V;
      if (w < per_batch) {
        const T* src = h2 + (size_t)row[u] * row_len + col[u];
        hv[u] = load16(src);
        gv[u] = load16(src + p.inner);
        ov[u] = load16(gout + (size_t)row[u] * p.inner + col[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (first + u * THREADS >= per_batch) break;
      const unsigned ctr = ctr_b + row[u] * P1 + col[u] * P2;
      float go[V], gh[V], gg[V];
#pragma unroll
      for (int j = 0; j < V; ++j) go[j] = element<T>(ov[u], j);
      if constexpr (DROP) {
#pragma unroll
        for (int j = 0; j < V; ++j)
          go[j] = drop(go[j], ctr + (unsigned)j * P2, p.threshold, p.inv_keep);
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float h = element<T>(hv[u], j), g = element<T>(gv[u], j);
        const float phi = 0.5f * (1.f + erff(g * 0.70710678118654752f));
        const float dgelu = phi + g * expf(-0.5f * g * g) * 0.3989422804014327f;
        gh[j] = go[j] * (g * phi);
        gg[j] = go[j] * h * dgelu;
      }
      T* dst = gh2 + (size_t)row[u] * row_len + col[u];
      store16(dst, pack<T>(gh));
      store16(dst + p.inner, pack<T>(gg));
    }
  }
}

// ---- launch -------------------------------------------------------------

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

template <typename Params> dim3 scalar_grid(const Params& p) {
  long long blocks = (p.total + THREADS - 1) / THREADS;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks < 1) blocks = 1;
  return dim3((unsigned)blocks);
}

// x: a batch's vectors, UNROLL a thread; y: the batch (strided past 65535)
template <typename T, typename Params> dim3 vector_grid(const Params& p) {
  const long long per_batch = (long long)p.n * (p.inner / kVec<T>);
  const long long x = (per_batch + THREADS * UNROLL - 1) / (THREADS * UNROLL);
  const int y = p.b < 1 ? 1 : (p.b > MAX_GRID_Y ? MAX_GRID_Y : p.b);
  return dim3(x < 1 ? 1u : (unsigned)x, (unsigned)y);
}

template <typename Params>
int launch(void (*kernel)(Params), dim3 grid, const Params& p, void* stream) {
  kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// the vector design with dropout chosen at compile time: one path a kernel
template <typename T> int fwd_vector(const GegluParams& p, void* stream) {
  return launch(p.dropping ? geglu_fwd_vec_kernel<T, true> : geglu_fwd_vec_kernel<T, false>,
                vector_grid<T>(p), p, stream);
}

template <typename T> int bwd_vector(const GegluBwdParams& p, void* stream) {
  return launch(p.dropping ? geglu_bwd_vec_kernel<T, true> : geglu_bwd_vec_kernel<T, false>,
                vector_grid<T>(p), p, stream);
}

}  // namespace

extern "C" int e2_geglu_fwd(const void* h2, void* out, int b, int n, int inner, float inv_keep,
                            unsigned seed, unsigned threshold, int dropping, int dtype,
                            void* stream) {
  const GegluParams p{h2, out, (long long)b * n * inner, b, n, inner, inv_keep, seed, threshold,
                      dropping};
  const bool vec = aligned16(h2) && aligned16(out) && (long long)n * inner <= INT_MAX;
  if (dtype == e2::kBFloat16 && vec && inner % kVec<__nv_bfloat16> == 0)
    return fwd_vector<__nv_bfloat16>(p, stream);
  if (dtype == e2::kBFloat16)
    return launch(geglu_fwd_kernel<__nv_bfloat16>, scalar_grid(p), p, stream);
  if (dtype == e2::kFloat32 && vec && inner % kVec<float> == 0)
    return fwd_vector<float>(p, stream);
  if (dtype == e2::kFloat32)
    return launch(geglu_fwd_kernel<float>, scalar_grid(p), p, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int e2_geglu_bwd(const void* h2, const void* gout, void* gh2, int b, int n, int inner,
                            float inv_keep, unsigned seed, unsigned threshold, int dropping,
                            int dtype, void* stream) {
  const GegluBwdParams p{h2, gout, gh2, (long long)b * n * inner, b, n, inner, inv_keep, seed,
                         threshold, dropping};
  const bool vec = aligned16(h2) && aligned16(gout) && aligned16(gh2) &&
                   (long long)n * inner <= INT_MAX;
  if (dtype == e2::kBFloat16 && vec && inner % kVec<__nv_bfloat16> == 0)
    return bwd_vector<__nv_bfloat16>(p, stream);
  if (dtype == e2::kBFloat16)
    return launch(geglu_bwd_kernel<__nv_bfloat16>, scalar_grid(p), p, stream);
  if (dtype == e2::kFloat32 && vec && inner % kVec<float> == 0)
    return bwd_vector<float>(p, stream);
  if (dtype == e2::kFloat32)
    return launch(geglu_bwd_kernel<float>, scalar_grid(p), p, stream);
  return (int)cudaErrorInvalidValue;
}
