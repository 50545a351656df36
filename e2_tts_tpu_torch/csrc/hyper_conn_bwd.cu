// K5b and K4: adjoints of the hyper-connection width connection for the H100
// (sm_90a).
//
// Replace the TPU kernels e2_tts_tpu/ops/hyper_conn_kernel.py::
// _width_bwd_kernel (K5b, driven by _width_bwd_pallas) and
// ::_width_fused_bwd_kernel (K4, driven by _width_fused_bwd_pallas). Both
// port the hand-derived chain rule of _width_bwd_core_tall (not its tall
// tiling). Per row m and stream s, with c = 0..s+1 (the alpha columns, then
// beta at s+1), and the incoming grads gm_0 (branch input), gm_1..s
// (carried) and g_beta:
//   recompute: inv_s = rsqrt(max(sum r^2 / d, 1e-12)), n_s = round(r * round(inv_s)),
//              ta_s = tanh(n_s @ W), alpha_s = round(ta_s * scale + static)
//   ga_s[t]  = gm_t . r_s (t <= s),  ga_s[s+1] = g_beta_s
//   g_p_s    = ga_s * scale * (1 - ta_s^2);  gp_s = round(g_p_s)
//   g_n_s    = W gp_s;  g_inv_s = g_n_s . r_s
//   g_r_s    = sum_t alpha_s[t] gm_t + g_n_s inv_s
//              + 2 r_s (g_inv_s * -0.5 inv_s^3 / d if var_s > 1e-12)
// and the parameter grads, f32 sums over all M rows:
//   gW += n_s^T gp_s,  g_static += ga_s,  g_scale += sum ga_s * ta_s
// (alpha columns to the alpha scale, column s+1 to the beta scale). K4
// first forms r_s = round(carried_s + round(branch * beta_s)) in registers,
// then splits g_r by the depth connection:
//   g_carried_s = g_r_s, g_branch = sum_s g_r_s beta_s, g_beta_s = g_r_s . branch.
//
// The TPU summed the parameter grads into an output block that its
// sequential grid revisited. Here each warp keeps its own (s+2, d) f32
// weight-grad partials in shared memory (a lane owns its d columns, so no
// atomics), the block sums its warps at the end and writes one partial row,
// and a second small launch sums the blocks' rows in a fixed order: the
// result is the same every run.
//
// What bounds it: bytes. Per row K5b reads (2s+1) d + s values and writes
// s d; K4 reads (2s+2) d + 2s and writes (s+1) d + s; ~40 s d flops: far
// below the H100's ridge. The design reads every input once from device
// memory (the incoming grads a second time, from cache, in the last pass)
// and writes every output once: one warp holds one row of all s streams in
// registers, reductions are warp shuffles, the weights sit in shared
// memory. Simple first: scalar loads and stores.
#include "common.cuh"

namespace {

// warps per block: 8, or 4 where 8 warps' weight-grad partials would not
// fit in the 227 KB of shared memory a block can have (d = 1152)
constexpr int bwd_warps(int ns, int d) {
  return (size_t)9 * (ns + 2) * d * sizeof(float) <= 232448 ? 8 : 4;
}

struct HcBwdParams {
  const void* in0;     // K5b: residuals (s, M, d); K4: carried (s, M, d)
  const void* in1;     // K4: branch (M, d)
  const void* in2;     // K4: beta of the previous branch (s, M)
  const void* g_b0;    // grad of the branch input (M, d)
  const void* g_car;   // grad of the carried streams (s, M, d)
  const void* g_beta;  // grad of beta (s, M)
  const float* sa;     // static_alpha (s, s+1)
  const float* sb;     // static_beta (s,)
  const float* aw;     // dynamic_alpha_fn (d, s+1)
  const float* bw;     // dynamic_beta_fn (d,)
  const float* ascale;
  const float* bscale;
  void* out0;          // K5b: g_residuals (s, M, d); K4: g_carried (s, M, d)
  void* out1;          // K4: g_branch (M, d)
  void* out2;          // K4: g_beta of the previous branch (s, M)
  float* partials;     // (gridDim.x, NP) per-block parameter-grad rows
  long long m;
};

// parameter-grad row: gW (s+2, d) column-major by head column, g_static
// (s, s+2), then the alpha and beta scales
template <int NS, int D>
struct ParamLayout {
  static constexpr int NC = NS + 2;
  static constexpr int W = NC * D;
  static constexpr int STATIC = W;
  static constexpr int SCALES = W + NS * NC;
  static constexpr int NP = SCALES + 2;
};

template <typename T, int NS, int VPL, bool FUSED, int WARPS = bwd_warps(NS, VPL * 32)>
__global__ void __launch_bounds__(WARPS * 32) hc_width_bwd_kernel(HcBwdParams p) {
  constexpr int THREADS = WARPS * 32;
  constexpr int D = VPL * 32;
  constexpr int NC = NS + 2;
  using PL = ParamLayout<NS, D>;
  extern __shared__ float smem[];
  float* sW = smem;                  // (D, NC): the weights, rounded to T
  float* sGW = smem + D * NC;        // (WARPS, NC, D): per-warp gW partials
  __shared__ float sSmall[WARPS][NS * NC + 2];  // per-warp g_static / scale partials

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < D * NC; i += THREADS) {
    const int d = i / NC, c = i % NC;
    sW[i] = e2::round_to<T>(c <= NS ? p.aw[d * (NS + 1) + c] : p.bw[d]);
  }
  for (int i = threadIdx.x; i < WARPS * NC * D; i += THREADS) sGW[i] = 0.f;
  for (int i = lane; i < NS * NC + 2; i += 32) sSmall[warp][i] = 0.f;
  __syncthreads();

  const float a_scale = *p.ascale, b_scale = *p.bscale;
  float* gw = sGW + warp * NC * D;
  const long long M = p.m;
  const T* in0 = static_cast<const T*>(p.in0);
  const T* in1 = static_cast<const T*>(p.in1);
  const T* in2 = static_cast<const T*>(p.in2);
  const T* g_b0 = static_cast<const T*>(p.g_b0);
  const T* g_car = static_cast<const T*>(p.g_car);
  const T* g_beta = static_cast<const T*>(p.g_beta);
  T* out0 = static_cast<T*>(p.out0);
  T* out1 = static_cast<T*>(p.out1);
  T* out2 = static_cast<T*>(p.out2);

  // incoming grad of mix column t at (row, column index i)
  auto gm_at = [&](int t, long long row, int i) -> float {
    const T* src = t == 0 ? g_b0 + row * D : g_car + ((t - 1) * M + row) * D;
    return e2::to_float<T>(src[i * 32 + lane]);
  };

  for (long long row = (long long)blockIdx.x * WARPS + warp; row < M;
       row += (long long)gridDim.x * WARPS) {
    float r[NS][VPL];
    float bprev[NS];
    if constexpr (FUSED) {
#pragma unroll
      for (int s = 0; s < NS; ++s) bprev[s] = e2::to_float<T>(in2[s * M + row]);
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const float br = e2::to_float<T>(in1[row * D + i * 32 + lane]);
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          const float c = e2::to_float<T>(in0[(s * M + row) * D + i * 32 + lane]);
          r[s][i] = e2::round_to<T>(c + e2::round_to<T>(br * bprev[s]));
        }
      }
    } else {
#pragma unroll
      for (int s = 0; s < NS; ++s)
#pragma unroll
        for (int i = 0; i < VPL; ++i) r[s][i] = e2::to_float<T>(in0[(s * M + row) * D + i * 32 + lane]);
    }

    // forward recompute: inv, alpha (columns 0..s) and tanh for the adjoint
    float inv[NS], inv_r[NS], alpha[NS][NS + 1], ta[NS][NC];
    bool var_ok[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      float sq = 0.f;
#pragma unroll
      for (int i = 0; i < VPL; ++i) sq = fmaf(r[s][i], r[s][i], sq);
      const float var = e2::warp_sum(sq) / D;
      var_ok[s] = var > 1e-12f;
      inv[s] = rsqrtf(fmaxf(var, 1e-12f));
      inv_r[s] = e2::round_to<T>(inv[s]);
      float proj[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) proj[c] = 0.f;
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const float nv = e2::round_to<T>(r[s][i] * inv_r[s]);
        const float* w = sW + (i * 32 + lane) * NC;
#pragma unroll
        for (int c = 0; c < NC; ++c) proj[c] = fmaf(nv, w[c], proj[c]);
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) ta[s][c] = tanhf(e2::warp_sum(proj[c]));
#pragma unroll
      for (int c = 0; c <= NS; ++c)
        alpha[s][c] = e2::round_to<T>(ta[s][c] * a_scale + p.sa[s * (NS + 1) + c]);
    }

    // mix adjoint: ga[s][t] = gm_t . r_s
    float gp[NS][NC];
#pragma unroll
    for (int t = 0; t <= NS; ++t) {
      float part[NS];
#pragma unroll
      for (int s = 0; s < NS; ++s) part[s] = 0.f;
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const float g = gm_at(t, row, i);
#pragma unroll
        for (int s = 0; s < NS; ++s) part[s] = fmaf(g, r[s][i], part[s]);
      }
#pragma unroll
      for (int s = 0; s < NS; ++s) gp[s][t] = e2::warp_sum(part[s]);
    }
#pragma unroll
    for (int s = 0; s < NS; ++s) gp[s][NS + 1] = e2::to_float<T>(g_beta[s * M + row]);

    // both heads at once: parameter partials, then gp = round(g_p)
    float g_as = 0.f, g_bs = 0.f;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float ga = gp[s][c];
        const float sc = c == NS + 1 ? b_scale : a_scale;
        if (c == NS + 1) g_bs += ga * ta[s][c];
        else g_as += ga * ta[s][c];
        if (lane == 0) sSmall[warp][s * NC + c] += ga;
        gp[s][c] = e2::round_to<T>(ga * sc * (1.f - ta[s][c] * ta[s][c]));
      }
    }
    if (lane == 0) {
      sSmall[warp][NS * NC] += g_as;
      sSmall[warp][NS * NC + 1] += g_bs;
    }

    // g_n = W gp, its rms-norm adjoint g_inv, and gW += n^T gp
    float ginv[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) ginv[s] = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const float* w = sW + (i * 32 + lane) * NC;
      float gwc[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) gwc[c] = 0.f;
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        float gn = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) gn = fmaf(gp[s][c], w[c], gn);
        ginv[s] = fmaf(gn, r[s][i], ginv[s]);
        const float nv = e2::round_to<T>(r[s][i] * inv_r[s]);
#pragma unroll
        for (int c = 0; c < NC; ++c) gwc[c] = fmaf(nv, gp[s][c], gwc[c]);
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) gw[c * D + i * 32 + lane] += gwc[c];
    }
    float gsq[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const float g_inv = e2::warp_sum(ginv[s]);
      gsq[s] = var_ok[s] ? g_inv * (-0.5f) * inv[s] * inv[s] * inv[s] / D : 0.f;
    }

    // g_r, written out (K5b) or split by the depth connection (K4)
    float gbeta_part[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) gbeta_part[s] = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      float gmv[NS + 1];
#pragma unroll
      for (int t = 0; t <= NS; ++t) gmv[t] = gm_at(t, row, i);
      const float* w = sW + (i * 32 + lane) * NC;
      float gbr = 0.f, br = 0.f;
      if constexpr (FUSED) br = e2::to_float<T>(in1[row * D + i * 32 + lane]);
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        float mix = alpha[s][0] * gmv[0];
#pragma unroll
        for (int t = 1; t <= NS; ++t) mix = fmaf(alpha[s][t], gmv[t], mix);
        float gn = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) gn = fmaf(gp[s][c], w[c], gn);
        const float g_r = mix + (gn * inv[s] + 2.f * r[s][i] * gsq[s]);
        out0[(s * M + row) * D + i * 32 + lane] = e2::from_float<T>(g_r);
        if constexpr (FUSED) {
          gbr = fmaf(g_r, bprev[s], gbr);
          gbeta_part[s] = fmaf(g_r, br, gbeta_part[s]);
        }
      }
      if constexpr (FUSED) out1[row * D + i * 32 + lane] = e2::from_float<T>(gbr);
    }
    if constexpr (FUSED) {
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const float gb = e2::warp_sum(gbeta_part[s]);
        if (lane == 0) out2[s * M + row] = e2::from_float<T>(gb);
      }
    }
  }

  // this block's parameter-grad row: the sum of its warps, in warp order
  __syncthreads();
  float* out = p.partials + (long long)blockIdx.x * PL::NP;
  for (int i = threadIdx.x; i < NC * D; i += THREADS) {
    float acc = 0.f;
    for (int w = 0; w < WARPS; ++w) acc += sGW[w * NC * D + i];
    out[i] = acc;
  }
  for (int i = threadIdx.x; i < NS * NC + 2; i += THREADS) {
    float acc = 0.f;
    for (int w = 0; w < WARPS; ++w) acc += sSmall[w][i];
    out[PL::STATIC + i] = acc;
  }
}

// out[j] = sum over blocks of partials[block, j], in block order
__global__ void hc_param_reduce_kernel(const float* partials, int blocks, int np, float* out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= np) return;
  float acc = 0.f;
  for (int b = 0; b < blocks; ++b) acc += partials[(long long)b * np + j];
  out[j] = acc;
}

template <typename T, int NS, int VPL>
cudaError_t launch(const HcBwdParams& p, bool fused, int blocks, float* params_out,
                   cudaStream_t stream) {
  constexpr int D = VPL * 32;
  constexpr int NC = NS + 2;
  constexpr int WARPS = bwd_warps(NS, D);
  const size_t smem = (size_t)(D * NC + WARPS * NC * D) * sizeof(float);
  auto kernel = fused ? hc_width_bwd_kernel<T, NS, VPL, true> : hc_width_bwd_kernel<T, NS, VPL, false>;
  // set once, outside any CUDA-graph capture that later launches replay
  static bool configured[2] = {false, false};
  cudaError_t err;
  if (!configured[fused]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured[fused] = true;
  }
  kernel<<<blocks, WARPS * 32, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int NP = ParamLayout<NS, D>::NP;
  hc_param_reduce_kernel<<<(NP + 255) / 256, 256, 0, stream>>>(p.partials, blocks, NP, params_out);
  return cudaGetLastError();
}

template <typename T, int NS>
cudaError_t dispatch_d(const HcBwdParams& p, int d, bool fused, int blocks, float* out,
                       cudaStream_t stream) {
  switch (d) {
    case 256: return launch<T, NS, 8>(p, fused, blocks, out, stream);
    case 512: return launch<T, NS, 16>(p, fused, blocks, out, stream);
    case 576: return launch<T, NS, 18>(p, fused, blocks, out, stream);
    case 1152: return launch<T, NS, 36>(p, fused, blocks, out, stream);
    default: return cudaErrorInvalidValue;
  }
}

int run(const HcBwdParams& p, int s, int d, bool fused, int blocks, void* params_out, int dtype,
        void* stream) {
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(params_out);
  cudaError_t err = cudaErrorInvalidValue;
  if (s == 4) {
    if (dtype == e2::kBFloat16) err = dispatch_d<__nv_bfloat16, 4>(p, d, fused, blocks, out, st);
    else if (dtype == e2::kFloat32) err = dispatch_d<float, 4>(p, d, fused, blocks, out, st);
  }
  return (int)err;
}

}  // namespace

// K5b: residuals (s, M, d), grads of (branch input, carried, beta) -> g_residuals
// (s, M, d) and the parameter-grad row (NP) via `partials` (blocks, NP)
extern "C" int e2_hc_width_bwd(const void* residuals, const void* g_b0, const void* g_car,
                               const void* g_beta, const void* sa, const void* sb,
                               const void* aw, const void* bw, const void* ascale,
                               const void* bscale, void* g_res, void* partials,
                               void* params_out, int blocks, int s, long long m, int d,
                               int dtype, void* stream) {
  HcBwdParams p{residuals, nullptr, nullptr, g_b0, g_car, g_beta,
                static_cast<const float*>(sa), static_cast<const float*>(sb),
                static_cast<const float*>(aw), static_cast<const float*>(bw),
                static_cast<const float*>(ascale), static_cast<const float*>(bscale),
                g_res, nullptr, nullptr, static_cast<float*>(partials), m};
  return run(p, s, d, false, blocks, params_out, dtype, stream);
}

// K4: carried (s, M, d), branch (M, d), beta (s, M) and the same incoming
// grads -> g_carried (s, M, d), g_branch (M, d), g_beta (s, M) and the row
extern "C" int e2_hc_width_fused_bwd(const void* carried, const void* branch, const void* beta,
                                     const void* g_b0, const void* g_car, const void* g_beta,
                                     const void* sa, const void* sb, const void* aw,
                                     const void* bw, const void* ascale, const void* bscale,
                                     void* g_carried, void* g_branch, void* g_beta_prev,
                                     void* partials, void* params_out, int blocks, int s,
                                     long long m, int d, int dtype, void* stream) {
  HcBwdParams p{carried, branch, beta, g_b0, g_car, g_beta,
                static_cast<const float*>(sa), static_cast<const float*>(sb),
                static_cast<const float*>(aw), static_cast<const float*>(bw),
                static_cast<const float*>(ascale), static_cast<const float*>(bscale),
                g_carried, g_branch, g_beta_prev, static_cast<float*>(partials), m};
  return run(p, s, d, true, blocks, params_out, dtype, stream);
}
