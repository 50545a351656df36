// K5 and K3: the hyper-connection width connection for the H100 (sm_90a).
//
// Replaces the TPU kernels e2_tts_tpu/ops/hyper_conn_kernel.py::_width_kernel
// (K5, driven by _width_pallas) and ::_width_fused_kernel (K3, driven by
// _width_fused_pallas). Per row m of the s residual streams r_s (s, M, d):
//   inv_s   = rsqrt(max(sum_d r_s^2 / d, 1e-12))           (f32)
//   normed  = r_s * inv_s, rounded to the compute dtype
//   proj_s  = normed @ [dyn_alpha_w | dyn_beta_w]           (d x (s+2), f32 acc)
//   alpha_s = tanh(proj_s[:s+1]) * alpha_scale + static_alpha[s]  (rounded)
//   beta_s  = tanh(proj_s[s+1]) * beta_scale + static_beta[s]     (rounded)
//   mixed_t = sum_s alpha_s[t] * r_s                        (f32 acc), t = 0..s
// and writes branch_input = mixed_0 (M, d), carried = mixed_1..s (s, M, d) and
// beta (s, M). K3 first forms r_s = carried_s + branch * beta_s, the depth
// connection of the previous branch, in registers: the (s, M, d) streams it
// stands for are never written to device memory.
//
// What bounds it: bytes. Per row it reads s*d (K3: s*d + d + s) values and
// writes (s+1)*d + s, against ~(s+2)*d*s*2 + (s+1)*s*d*2 flops: ~10
// FLOP/byte, far below the H100's ridge. The design reads every input once
// and writes every output once: one warp holds one row of all s streams in
// registers (d/32 values per stream per lane), the reductions are warp
// shuffles, and the (d, s+2) weights sit in shared memory for the whole
// block. Simple first: scalar (2- or 4-byte) loads and stores.
#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

struct HcParams {
  const void* in0;    // K5: residuals (s, M, d); K3: carried (s, M, d)
  const void* in1;    // K3: branch (M, d)
  const void* in2;    // K3: beta of the previous branch (s, M)
  const float* sa;    // static_alpha (s, s+1)
  const float* sb;    // static_beta (s,)
  const float* aw;    // dynamic_alpha_fn (d, s+1)
  const float* bw;    // dynamic_beta_fn (d,)
  const float* ascale;
  const float* bscale;
  void* out_branch;   // (M, d)
  void* out_carried;  // (s, M, d)
  void* out_beta;     // (s, M)
  long long m;
};

template <typename T, int NS, int VPL, bool FUSED>
__global__ void __launch_bounds__(THREADS) hc_width_kernel(HcParams p) {
  constexpr int D = VPL * 32;
  constexpr int NC = NS + 2;  // alpha columns 0..NS, beta at NS+1
  __shared__ float sW[D * NC];
  for (int i = threadIdx.x; i < D * NC; i += THREADS) {
    const int d = i / NC, c = i % NC;
    const float w = c <= NS ? p.aw[d * (NS + 1) + c] : p.bw[d];
    sW[i] = e2::round_to<T>(w);  // the weights enter the product in the compute dtype
  }
  __syncthreads();

  const float a_scale = *p.ascale, b_scale = *p.bscale;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long M = p.m;
  const T* in0 = static_cast<const T*>(p.in0);
  const T* in1 = static_cast<const T*>(p.in1);
  const T* in2 = static_cast<const T*>(p.in2);
  T* out_branch = static_cast<T*>(p.out_branch);
  T* out_carried = static_cast<T*>(p.out_carried);
  T* out_beta = static_cast<T*>(p.out_beta);

  for (long long row = (long long)blockIdx.x * WARPS + warp; row < M;
       row += (long long)gridDim.x * WARPS) {
    float r[NS][VPL];
    if constexpr (FUSED) {
      float br[VPL];
#pragma unroll
      for (int i = 0; i < VPL; ++i) br[i] = e2::to_float<T>(in1[row * D + i * 32 + lane]);
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const float bt = e2::to_float<T>(in2[s * M + row]);
#pragma unroll
        for (int i = 0; i < VPL; ++i) {
          const float c = e2::to_float<T>(in0[(s * M + row) * D + i * 32 + lane]);
          // carried + branch * beta, each step rounded as in the compute dtype
          r[s][i] = e2::round_to<T>(c + e2::round_to<T>(br[i] * bt));
        }
      }
    } else {
#pragma unroll
      for (int s = 0; s < NS; ++s)
#pragma unroll
        for (int i = 0; i < VPL; ++i)
          r[s][i] = e2::to_float<T>(in0[(s * M + row) * D + i * 32 + lane]);
    }

    float alpha[NS][NS + 1];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      float sq = 0.f;
#pragma unroll
      for (int i = 0; i < VPL; ++i) sq = fmaf(r[s][i], r[s][i], sq);
      sq = e2::warp_sum(sq);
      const float inv = e2::round_to<T>(rsqrtf(fmaxf(sq / D, 1e-12f)));
      float proj[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) proj[c] = 0.f;
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const float nv = e2::round_to<T>(r[s][i] * inv);
        const float* w = sW + (i * 32 + lane) * NC;
#pragma unroll
        for (int c = 0; c < NC; ++c) proj[c] = fmaf(nv, w[c], proj[c]);
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) proj[c] = e2::warp_sum(proj[c]);
#pragma unroll
      for (int c = 0; c <= NS; ++c)
        alpha[s][c] = e2::round_to<T>(tanhf(proj[c]) * a_scale + p.sa[s * (NS + 1) + c]);
      if (lane == 0)
        out_beta[s * M + row] = e2::from_float<T>(tanhf(proj[NS + 1]) * b_scale + p.sb[s]);
    }

#pragma unroll
    for (int t = 0; t <= NS; ++t) {
      T* dst = t == 0 ? out_branch + row * D : out_carried + ((t - 1) * M + row) * D;
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        float acc = 0.f;
#pragma unroll
        for (int s = 0; s < NS; ++s) acc = fmaf(alpha[s][t], r[s][i], acc);
        dst[i * 32 + lane] = e2::from_float<T>(acc);
      }
    }
  }
}

template <typename T, int NS, int VPL>
cudaError_t launch(const HcParams& p, bool fused, cudaStream_t stream) {
  long long blocks = (p.m + WARPS - 1) / WARPS;
  if (blocks > 65535) blocks = 65535;  // grid-stride loop covers the rest
  if (blocks < 1) blocks = 1;
  if (fused) hc_width_kernel<T, NS, VPL, true><<<(unsigned)blocks, THREADS, 0, stream>>>(p);
  else hc_width_kernel<T, NS, VPL, false><<<(unsigned)blocks, THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int NS>
cudaError_t dispatch_d(const HcParams& p, int d, bool fused, cudaStream_t stream) {
  switch (d) {
    case 256: return launch<T, NS, 8>(p, fused, stream);
    case 512: return launch<T, NS, 16>(p, fused, stream);
    case 576: return launch<T, NS, 18>(p, fused, stream);   // DiT-XL's text stream
    case 1152: return launch<T, NS, 36>(p, fused, stream);  // DiT-XL's speech stream
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_s(const HcParams& p, int s, int d, bool fused, cudaStream_t stream) {
  switch (s) {
    case 4: return dispatch_d<T, 4>(p, d, fused, stream);
    default: return cudaErrorInvalidValue;
  }
}

int run(const HcParams& p, int s, int d, bool fused, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == e2::kBFloat16) err = dispatch_s<__nv_bfloat16>(p, s, d, fused, st);
  else if (dtype == e2::kFloat32) err = dispatch_s<float>(p, s, d, fused, st);
  else err = cudaErrorInvalidValue;
  return (int)err;
}

}  // namespace

// K5: residuals (s, M, d) -> branch_input (M, d), carried (s, M, d), beta (s, M)
extern "C" int e2_hc_width(const void* residuals, const void* sa, const void* sb,
                           const void* aw, const void* bw, const void* ascale,
                           const void* bscale, void* out_branch, void* out_carried,
                           void* out_beta, int s, long long m, int d, int dtype, void* stream) {
  HcParams p{residuals, nullptr, nullptr,
             static_cast<const float*>(sa), static_cast<const float*>(sb),
             static_cast<const float*>(aw), static_cast<const float*>(bw),
             static_cast<const float*>(ascale), static_cast<const float*>(bscale),
             out_branch, out_carried, out_beta, m};
  return run(p, s, d, false, dtype, stream);
}

// K3: carried (s, M, d) + branch (M, d) * beta (s, M) -> the same three outputs
extern "C" int e2_hc_width_fused(const void* carried, const void* branch, const void* beta,
                                 const void* sa, const void* sb, const void* aw,
                                 const void* bw, const void* ascale, const void* bscale,
                                 void* out_branch, void* out_carried, void* out_beta, int s,
                                 long long m, int d, int dtype, void* stream) {
  HcParams p{carried, branch, beta,
             static_cast<const float*>(sa), static_cast<const float*>(sb),
             static_cast<const float*>(aw), static_cast<const float*>(bw),
             static_cast<const float*>(ascale), static_cast<const float*>(bscale),
             out_branch, out_carried, out_beta, m};
  return run(p, s, d, true, dtype, stream);
}
