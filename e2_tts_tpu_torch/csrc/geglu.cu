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
// What bounds it: bytes. It reads 2*inner and writes inner values per row
// for ~20 flops per output: a pure elementwise pass. The design reads the
// projection output once and writes the gated hidden once, with no
// intermediate in device memory. Simple first: one element per thread and
// iteration of a grid-stride loop, scalar loads.
//
// K7 replaces the TPU kernel ::_bwd_kernel (driven by _bwd_pallas): from the
// saved projection output h2 and the incoming grad gout (b, n, inner) it
// regenerates the same keep bits, and with Phi(g) = 0.5 (1 + erf(g / sqrt 2)),
// gelu(g) = g Phi(g) and gelu'(g) = Phi(g) + g phi(g) writes
//   g_h = gout' gelu(g),  g_g = gout' h gelu'(g),  gout' = gout * keep / (1 - rate)
// into the two halves of a (b, n, 2*inner) grad. Bytes bound as K6 (reads
// 3 inner, writes 2 inner values per row, ~30 flops per element); the same
// one-pass grid-stride design, exact erff like K6 (the TPU kernel used a
// rational erf approximation because Mosaic has none).
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr unsigned P0 = 0x9E3779B1u, P1 = 0x85EBCA77u, P2 = 0xC2B2AE3Du;

struct GegluParams {
  const void* h2;
  void* out;
  long long total;  // b * n * inner
  int n, inner;
  float inv_keep;
  unsigned seed, threshold;
  int dropping;
};

struct GegluBwdParams {
  const void* h2;
  const void* gout;
  void* gh2;
  long long total;  // b * n * inner
  int n, inner;
  float inv_keep;
  unsigned seed, threshold;
  int dropping;
};

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

}  // namespace

extern "C" int e2_geglu_fwd(const void* h2, void* out, int b, int n, int inner, float inv_keep,
                            unsigned seed, unsigned threshold, int dropping, int dtype,
                            void* stream) {
  GegluParams p{h2, out, (long long)b * n * inner, n, inner, inv_keep, seed, threshold, dropping};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  long long blocks = (p.total + THREADS - 1) / THREADS;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks < 1) blocks = 1;
  if (dtype == e2::kBFloat16)
    geglu_fwd_kernel<__nv_bfloat16><<<(unsigned)blocks, THREADS, 0, st>>>(p);
  else if (dtype == e2::kFloat32)
    geglu_fwd_kernel<float><<<(unsigned)blocks, THREADS, 0, st>>>(p);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int e2_geglu_bwd(const void* h2, const void* gout, void* gh2, int b, int n, int inner,
                            float inv_keep, unsigned seed, unsigned threshold, int dropping,
                            int dtype, void* stream) {
  GegluBwdParams p{h2, gout, gh2, (long long)b * n * inner, n, inner, inv_keep, seed, threshold,
                   dropping};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  long long blocks = (p.total + THREADS - 1) / THREADS;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks < 1) blocks = 1;
  if (dtype == e2::kBFloat16)
    geglu_bwd_kernel<__nv_bfloat16><<<(unsigned)blocks, THREADS, 0, st>>>(p);
  else if (dtype == e2::kFloat32)
    geglu_bwd_kernel<float><<<(unsigned)blocks, THREADS, 0, st>>>(p);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
