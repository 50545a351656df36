// K5 and K3 (and their save-state variants K5s and K3s): the
// hyper-connection width connection for the H100 (sm_90a).
//
// Replaces the TPU kernels e2_tts_tpu/ops/hyper_conn_kernel.py::_width_kernel
// (K5, driven by _width_pallas), ::_width_fused_kernel (K3, driven by
// _width_fused_pallas) and their save-state bodies ::_width_kernel_save (K5s)
// and ::_width_fused_kernel_save (K3s). Per row m of the s residual streams
// r_s (s, M, d):
//   inv_s   = rsqrt(max(sum_d r_s^2 / d, 1e-12))           (f32)
//   normed  = r_s * round(inv_s), rounded to the compute dtype
//   proj_s  = normed @ [dyn_alpha_w | dyn_beta_w]           (d x (s+2), f32 acc)
//   alpha_s = tanh(proj_s[:s+1]) * alpha_scale + static_alpha[s]  (rounded)
//   beta_s  = tanh(proj_s[s+1]) * beta_scale + static_beta[s]     (rounded)
//   mixed_t = sum_s alpha_s[t] * r_s                        (f32 acc), t = 0..s
// and writes branch_input = mixed_0 (M, d), carried = mixed_1..s (s, M, d) and
// beta (s, M). K3 first forms r_s = carried_s + branch * beta_s, the depth
// connection of the previous branch, in registers: the (s, M, d) streams it
// stands for are never written to device memory. The save-state variants
// (template flag SAVE) also write what the adjoint would recompute: ta
// (s, M, s+2) f32 = tanh(proj_s) before the affine, and inv_s (s, M) in f32
// before it is rounded to the compute dtype (the adjoint needs the unrounded
// value for g_n * inv and inv^3). Their public outputs are the same
// instructions on the same values: bit-identical to K5 / K3.
//
// These templates run f32 and bf16 at 2, 3 and 5-8 streams; bf16 at 4
// streams, the count every configuration of the repo runs, takes the Hopper
// design of hyper_conn_sm90.cuh (`width_run` there chooses). Any stream count
// s from 2 to 8 (a template argument) and any width d: one warp owns one row
// of all s streams and streams it in chunks of V values per lane per stream
// (V = 8, or 4 for f32 and more than 4 streams), columns 32 i + lane, masked
// past d: each stream is read once for its rms statistic, once for its
// projection (unless the row is one chunk) and once for the mix (the
// re-reads hit L1 / L2).
//
// The save-state instantiations are built in hyper_conn_save.cu, the others
// in hyper_conn.cu (one nvcc each, in parallel).
//
// What bounds it: bytes. Per row it reads s*d (K3: s*d + d + s) values and
// writes (s+1)*d + s, against ~(s+2)*d*s*2 + (s+1)*s*d*2 flops: ~10
// FLOP/byte, far below the H100's ridge. The reductions are warp shuffles,
// and the (d, s+2) weights sit in shared memory for the whole block. Simple
// first: scalar (2- or 4-byte) loads and stores.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_SMEM = 232448;  // what a block may have on the H100

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
  float* ta;          // SAVE: (s, M, s+2)
  float* inv;         // SAVE: (s, M)
  long long m;
  int d;
};

template <typename T, int NS, int V, bool FUSED, bool SAVE>
__global__ void __launch_bounds__(THREADS) hc_width_kernel(HcParams p) {
  constexpr int NC = NS + 2;  // alpha columns 0..NS, beta at NS+1
  constexpr int CW = 32 * V;  // columns per chunk
  extern __shared__ float sW[];  // (d, NC): the weights, rounded to T
  const int d = p.d;
  for (int i = threadIdx.x; i < d * NC; i += THREADS) {
    const int col = i / NC, c = i % NC;
    const float w = c <= NS ? p.aw[col * (NS + 1) + c] : p.bw[col];
    sW[i] = e2::round_to<T>(w);  // the weights enter the product in the compute dtype
  }
  __syncthreads();

  const float a_scale = *p.ascale, b_scale = *p.bscale;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long M = p.m;
  const int nch = (d + CW - 1) / CW;
  const T* in0 = static_cast<const T*>(p.in0);
  const T* in1 = static_cast<const T*>(p.in1);
  const T* in2 = static_cast<const T*>(p.in2);
  T* out_branch = static_cast<T*>(p.out_branch);
  T* out_carried = static_cast<T*>(p.out_carried);
  T* out_beta = static_cast<T*>(p.out_beta);

  for (long long row = (long long)blockIdx.x * WARPS + warp; row < M;
       row += (long long)gridDim.x * WARPS) {
    float bt[NS];
    if constexpr (FUSED) {
#pragma unroll
      for (int s = 0; s < NS; ++s) bt[s] = e2::to_float<T>(in2[s * M + row]);
    }
    // stream s (or all streams), columns ch * CW + 32 i + lane, into
    // registers; columns past d read as 0. K3 forms carried + branch * beta,
    // each step rounded as in the compute dtype.
    float r[NS][V];
    auto stream_at = [&](int s, int col, float br) -> float {
      const float c = e2::to_float<T>(in0[(s * M + row) * d + col]);
      if constexpr (FUSED) return e2::round_to<T>(c + e2::round_to<T>(br * bt[s]));
      return c;
    };
    auto load_all = [&](int ch) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int col = ch * CW + i * 32 + lane;
        const bool ok = col < d;
        const float br = FUSED && ok ? e2::to_float<T>(in1[row * d + col]) : 0.f;
#pragma unroll
        for (int s = 0; s < NS; ++s) r[s][i] = ok ? stream_at(s, col, br) : 0.f;
      }
    };
    auto load_stream = [&](int s, int ch) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int col = ch * CW + i * 32 + lane;
        const bool ok = col < d;
        const float br = FUSED && ok ? e2::to_float<T>(in1[row * d + col]) : 0.f;
        r[s][i] = ok ? stream_at(s, col, br) : 0.f;
      }
    };

    // per stream: the rms statistic, then the projection, its tanh, alpha
    // and beta (a streamed row is re-read for each)
    float alpha[NS][NS + 1];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      float sq = 0.f;
      for (int ch = 0; ch < nch; ++ch) {
        load_stream(s, ch);
#pragma unroll
        for (int i = 0; i < V; ++i) sq = fmaf(r[s][i], r[s][i], sq);
      }
      const float inv = rsqrtf(fmaxf(e2::warp_sum(sq) / d, 1e-12f));
      const float inv_r = e2::round_to<T>(inv);
      float proj[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) proj[c] = 0.f;
      for (int ch = 0; ch < nch; ++ch) {
        if (nch > 1) load_stream(s, ch);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const int col = ch * CW + i * 32 + lane;
          if (col < d) {
            const float nv = e2::round_to<T>(r[s][i] * inv_r);
            const float* w = sW + col * NC;
#pragma unroll
            for (int c = 0; c < NC; ++c) proj[c] = fmaf(nv, w[c], proj[c]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) proj[c] = tanhf(e2::warp_sum(proj[c]));
#pragma unroll
      for (int c = 0; c <= NS; ++c)
        alpha[s][c] = e2::round_to<T>(proj[c] * a_scale + p.sa[s * (NS + 1) + c]);
      if (lane == 0) {
        out_beta[s * M + row] = e2::from_float<T>(proj[NS + 1] * b_scale + p.sb[s]);
        if constexpr (SAVE) {
          p.inv[s * M + row] = inv;
#pragma unroll
          for (int c = 0; c < NC; ++c) p.ta[(s * M + row) * NC + c] = proj[c];
        }
      }
    }

    for (int ch = 0; ch < nch; ++ch) {
      load_all(ch);
#pragma unroll
      for (int t = 0; t <= NS; ++t) {
        T* dst = t == 0 ? out_branch + row * d : out_carried + ((t - 1) * M + row) * d;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const int col = ch * CW + i * 32 + lane;
          if (col < d) {
            float acc = 0.f;
#pragma unroll
            for (int s = 0; s < NS; ++s) acc = fmaf(alpha[s][t], r[s][i], acc);
            dst[col] = e2::from_float<T>(acc);
          }
        }
      }
    }
  }
}

template <typename T, int NS, bool FUSED, bool SAVE>
cudaError_t launch(const HcParams& p, cudaStream_t stream) {
  constexpr int V = std::is_same<T, float>::value || NS > 4 ? 4 : 8;
  const size_t smem = (size_t)p.d * (NS + 2) * sizeof(float);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  auto kernel = hc_width_kernel<T, NS, V, FUSED, SAVE>;
  // set once, outside any CUDA-graph capture that later launches replay
  static bool configured = false;
  if (!configured) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  long long blocks = (p.m + WARPS - 1) / WARPS;
  if (blocks > 65535) blocks = 65535;  // grid-stride loop covers the rest
  if (blocks < 1) blocks = 1;
  kernel<<<(unsigned)blocks, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, bool FUSED, bool SAVE>
cudaError_t dispatch_s(const HcParams& p, int s, cudaStream_t st) {
  switch (s) {
    case 2: return launch<T, 2, FUSED, SAVE>(p, st);
    case 3: return launch<T, 3, FUSED, SAVE>(p, st);
    case 4:  // bf16 at 4 streams runs hyper_conn_sm90.cuh
      if constexpr (std::is_same<T, float>::value) return launch<T, 4, FUSED, SAVE>(p, st);
      return cudaErrorInvalidValue;
    case 5: return launch<T, 5, FUSED, SAVE>(p, st);
    case 6: return launch<T, 6, FUSED, SAVE>(p, st);
    case 7: return launch<T, 7, FUSED, SAVE>(p, st);
    case 8: return launch<T, 8, FUSED, SAVE>(p, st);
    default: return cudaErrorInvalidValue;
  }
}

// the templates: every (dtype, fused) variant with the SAVE flag of this
// translation unit but bf16 at 4 streams
template <bool SAVE>
int fwd_run(const HcParams& p, int s, bool fused, int dtype, void* stream) {
  if (p.d < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == e2::kBFloat16)
    err = fused ? dispatch_s<__nv_bfloat16, true, SAVE>(p, s, st)
                : dispatch_s<__nv_bfloat16, false, SAVE>(p, s, st);
  else if (dtype == e2::kFloat32)
    err = fused ? dispatch_s<float, true, SAVE>(p, s, st) : dispatch_s<float, false, SAVE>(p, s, st);
  return (int)err;
}

}  // namespace
