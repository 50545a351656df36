// K5b and K4 (and their save-state variants K5bs and K4s): adjoints of the
// hyper-connection width connection for the H100 (sm_90a). These templates
// run f32 and bf16 at 2, 3 and 5-8 streams; on bf16 at 4 streams all four
// run the design of hyper_conn_bwd_sm90.cuh, which the entry points of
// hyper_conn_bwd.cu and hyper_conn_bwd_save.cu choose.
//
// Replace the TPU kernels e2_tts_tpu/ops/hyper_conn_kernel.py::
// _width_bwd_kernel (K5b, driven by _width_bwd_pallas),
// ::_width_fused_bwd_kernel (K4, driven by _width_fused_bwd_pallas) and their
// save-state bodies ::_width_bwd_kernel_save (K5bs) and
// ::_width_fused_bwd_kernel_save (K4s). All port the hand-derived chain rule
// of _width_bwd_core (not the TPU's tall or per-stream tilings). Per row m
// and stream s, with c = 0..s+1 (the alpha columns, then beta at s+1), and
// the incoming grads gm_0 (branch input), gm_1..s (carried) and g_beta:
//   recompute: inv_s = rsqrt(max(sum r^2 / d, 1e-12)), n_s = round(r * round(inv_s)),
//              ta_s = tanh(n_s @ W), var_ok_s = var_s > 1e-12
//   or, SAVE:  inv_s and ta_s read from the forward's state (K5s / K3s),
//              var_ok_s = inv_s < 1e6, n_s = round(r * round(inv_s))
//   alpha_s  = round(ta_s * scale + static)
//   ga_s[t]  = gm_t . r_s (t <= s),  ga_s[s+1] = g_beta_s
//   g_p_s    = ga_s * scale * (1 - ta_s^2);  gp_s = round(g_p_s)
//   g_n_s    = W gp_s;  g_inv_s = g_n_s . r_s
//   g_r_s    = sum_t alpha_s[t] gm_t + g_n_s inv_s
//              + 2 r_s (g_inv_s * -0.5 inv_s^3 / d if var_ok_s)
// and the parameter grads, f32 sums over all M rows:
//   gW += n_s^T gp_s,  g_static += ga_s,  g_scale += sum ga_s * ta_s
// (alpha columns to the alpha scale, column s+1 to the beta scale). K4
// first forms r_s = round(carried_s + round(branch * beta_s)) in registers,
// then splits g_r by the depth connection:
//   g_carried_s = g_r_s, g_branch = sum_s g_r_s beta_s, g_beta_s = g_r_s . branch.
// The save variants skip the rms statistic, the d x (s+2) projection with
// its s+2 warp sums per stream, and the tanh; everything else is the same
// code.
//
// Any stream count s from 2 to 8 (a template argument) and any width d: a
// warp owns a row, a register tile holds V values per lane per stream (V =
// 8 for bf16 at 2 and 3 streams, 4 for f32 and more than 4 streams), masked
// past d and re-read once per pass (rms statistic, projection, mix adjoint,
// back-projection, residual grad) from L1 / L2. Two sources build them, one
// nvcc each, in parallel: bf16 at the stream counts other than 4
// (hyper_conn_bwd_streams.cu) and f32 (hyper_conn_bwd_f32.cu).
//
// The TPU summed the parameter grads into an output block that its
// sequential grid revisited. Here each warp keeps its own (s+2, d) f32
// weight-grad partials in shared memory (a lane owns its columns, so no
// atomics), the block sums its warps at the end and writes one partial row,
// and a second small launch sums the blocks' rows in a fixed order: the
// result is the same every run. The block has as many warps (1 to 8) as
// partials fit beside the (d, s+2) weights in the 227 KB a block may have:
// 8 up to d = 1024 at 4 streams, 7 at 1152, 1 at 8 streams and d = 2048.
//
// What bounds it: bytes. Per row K5b reads (2s+1) d + s values and writes
// s d; K4 reads (2s+2) d + 2s and writes (s+1) d + s; the save variants read
// s (s+3) f32 more; ~40 s d flops: far below the H100's ridge. The design
// writes every output once and re-reads a row's inputs from cache in each
// pass; reductions are warp shuffles, the weights sit in shared memory.
// Simple first: scalar loads and stores.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int MAX_SMEM = 232448;  // what a block may have on the H100

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
  const float* ta;     // SAVE: the forward's tanh (s, M, s+2)
  const float* inv;    // SAVE: the forward's unrounded inv (s, M)
  void* out0;          // K5b: g_residuals (s, M, d); K4: g_carried (s, M, d)
  void* out1;          // K4: g_branch (M, d)
  void* out2;          // K4: g_beta of the previous branch (s, M)
  float* partials;     // (gridDim.x, NP) per-block parameter-grad rows
  long long m;
  int d;
};

// The parameter-grad row (NP values): gW (s+2, d) by head column, g_static
// (s, s+2), then the alpha and beta scales.
__host__ __device__ constexpr int n_small(int ns) { return ns * (ns + 2) + 2; }

// shared memory of a block: the weights, then per warp the gW partials and
// the g_static / scale partials
inline size_t bwd_smem_bytes(int ns, int d, int warps) {
  const size_t nc = ns + 2;
  return (nc * d + (size_t)warps * (nc * d + n_small(ns))) * sizeof(float);
}

// `warps`, a block's warps, comes from the wrapper
// (ops/hyper_conn_kernel.py::_bwd_warps): as many (up to 8) as per-warp
// partials fit beside the weights
template <typename T, int NS, int V, bool FUSED, bool SAVE>
__global__ void __launch_bounds__(256) hc_width_bwd_kernel(HcBwdParams p) {
  constexpr int NC = NS + 2;
  constexpr int CW = 32 * V;
  constexpr int NSM = n_small(NS);
  const int warps = blockDim.x >> 5;
  const int d = p.d;  // masked and streamed in chunks of CW columns
  extern __shared__ float smem[];
  float* sW = smem;                       // (d, NC): the weights, rounded to T
  float* sGW = smem + d * NC;             // (warps, NC, d): per-warp gW partials
  float* sSmall = sGW + warps * NC * d;   // (warps, NSM): g_static / scale partials

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < d * NC; i += blockDim.x) {
    const int col = i / NC, c = i % NC;
    sW[i] = e2::round_to<T>(c <= NS ? p.aw[col * (NS + 1) + c] : p.bw[col]);
  }
  for (int i = threadIdx.x; i < warps * (NC * d + NSM); i += blockDim.x) sGW[i] = 0.f;
  __syncthreads();

  const float a_scale = *p.ascale, b_scale = *p.bscale;
  float* gw = sGW + warp * NC * d;
  float* small = sSmall + warp * NSM;
  const long long M = p.m;
  const int nch = (d + CW - 1) / CW;
  const T* in0 = static_cast<const T*>(p.in0);
  const T* in1 = static_cast<const T*>(p.in1);
  const T* in2 = static_cast<const T*>(p.in2);
  const T* g_b0 = static_cast<const T*>(p.g_b0);
  const T* g_car = static_cast<const T*>(p.g_car);
  const T* g_beta = static_cast<const T*>(p.g_beta);
  T* out0 = static_cast<T*>(p.out0);
  T* out1 = static_cast<T*>(p.out1);
  T* out2 = static_cast<T*>(p.out2);

  for (long long row = (long long)blockIdx.x * warps + warp; row < M;
       row += (long long)gridDim.x * warps) {
    // incoming grad of mix column t at column col (< d) of this row
    auto gm_at = [&](int t, int col) -> float {
      const T* src = t == 0 ? g_b0 + row * d : g_car + ((t - 1) * M + row) * d;
      return e2::to_float<T>(src[col]);
    };
    float bprev[NS];
    if constexpr (FUSED) {
#pragma unroll
      for (int s = 0; s < NS; ++s) bprev[s] = e2::to_float<T>(in2[s * M + row]);
    }
    // stream s (or all streams), columns ch * CW + 32 i + lane, into
    // registers; columns past d read as 0
    float r[NS][V];
    auto stream_at = [&](int s, int col, float br) -> float {
      const float c = e2::to_float<T>(in0[(s * M + row) * d + col]);
      if constexpr (FUSED) return e2::round_to<T>(c + e2::round_to<T>(br * bprev[s]));
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

    // the forward's intermediates: inv, its rounding, tanh of the
    // projection, alpha (columns 0..s)
    float inv[NS], inv_r[NS], alpha[NS][NS + 1], ta[NS][NC];
    bool var_ok[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      if constexpr (SAVE) {
        inv[s] = p.inv[s * M + row];
        var_ok[s] = inv[s] < 1e6f;  // inv = rsqrt(max(var, 1e-12)): var > 1e-12
        inv_r[s] = e2::round_to<T>(inv[s]);
#pragma unroll
        for (int c = 0; c < NC; ++c) ta[s][c] = p.ta[(s * M + row) * NC + c];
      } else {
        float sq = 0.f;
        for (int ch = 0; ch < nch; ++ch) {
          load_stream(s, ch);
#pragma unroll
          for (int i = 0; i < V; ++i) sq = fmaf(r[s][i], r[s][i], sq);
        }
        const float var = e2::warp_sum(sq) / d;
        var_ok[s] = var > 1e-12f;
        inv[s] = rsqrtf(fmaxf(var, 1e-12f));
        inv_r[s] = e2::round_to<T>(inv[s]);
        float proj[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) proj[c] = 0.f;
        for (int ch = 0; ch < nch; ++ch) {
          if (nch > 1) load_stream(s, ch);
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const int col = ch * CW + i * 32 + lane;
            if (col < d) {
              const float nv = e2::round_to<T>(r[s][i] * inv_r[s]);
              const float* w = sW + col * NC;
#pragma unroll
              for (int c = 0; c < NC; ++c) proj[c] = fmaf(nv, w[c], proj[c]);
            }
          }
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) ta[s][c] = tanhf(e2::warp_sum(proj[c]));
      }
#pragma unroll
      for (int c = 0; c <= NS; ++c)
        alpha[s][c] = e2::round_to<T>(ta[s][c] * a_scale + p.sa[s * (NS + 1) + c]);
    }

    // mix adjoint: ga[s][t] = gm_t . r_s
    float gp[NS][NC];
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int t = 0; t <= NS; ++t) gp[s][t] = 0.f;
    for (int ch = 0; ch < nch; ++ch) {
      load_all(ch);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int col = ch * CW + i * 32 + lane;
        if (col < d) {
#pragma unroll
          for (int t = 0; t <= NS; ++t) {
            const float g = gm_at(t, col);
#pragma unroll
            for (int s = 0; s < NS; ++s) gp[s][t] = fmaf(g, r[s][i], gp[s][t]);
          }
        }
      }
    }
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int t = 0; t <= NS; ++t) gp[s][t] = e2::warp_sum(gp[s][t]);
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
        if (lane == 0) small[s * NC + c] += ga;
        gp[s][c] = e2::round_to<T>(ga * sc * (1.f - ta[s][c] * ta[s][c]));
      }
    }
    if (lane == 0) {
      small[NS * NC] += g_as;
      small[NS * NC + 1] += g_bs;
    }

    // g_n = W gp, its rms-norm adjoint g_inv, and gW += n^T gp
    float ginv[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) ginv[s] = 0.f;
    for (int ch = 0; ch < nch; ++ch) {
      load_all(ch);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int col = ch * CW + i * 32 + lane;
        if (col < d) {
          const float* w = sW + col * NC;
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
          for (int c = 0; c < NC; ++c) gw[c * d + col] += gwc[c];
        }
      }
    }
    float gsq[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const float g_inv = e2::warp_sum(ginv[s]);
      gsq[s] = var_ok[s] ? g_inv * (-0.5f) * inv[s] * inv[s] * inv[s] / d : 0.f;
    }

    // g_r, written out (K5b) or split by the depth connection (K4)
    float gbeta_part[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) gbeta_part[s] = 0.f;
    for (int ch = 0; ch < nch; ++ch) {
      load_all(ch);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int col = ch * CW + i * 32 + lane;
        if (col < d) {
          float gmv[NS + 1];
#pragma unroll
          for (int t = 0; t <= NS; ++t) gmv[t] = gm_at(t, col);
          const float* w = sW + col * NC;
          float gbr = 0.f, br = 0.f;
          if constexpr (FUSED) br = e2::to_float<T>(in1[row * d + col]);
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            float mix = alpha[s][0] * gmv[0];
#pragma unroll
            for (int t = 1; t <= NS; ++t) mix = fmaf(alpha[s][t], gmv[t], mix);
            float gn = 0.f;
#pragma unroll
            for (int c = 0; c < NC; ++c) gn = fmaf(gp[s][c], w[c], gn);
            const float g_r = mix + (gn * inv[s] + 2.f * r[s][i] * gsq[s]);
            out0[(s * M + row) * d + col] = e2::from_float<T>(g_r);
            if constexpr (FUSED) {
              gbr = fmaf(g_r, bprev[s], gbr);
              gbeta_part[s] = fmaf(g_r, br, gbeta_part[s]);
            }
          }
          if constexpr (FUSED) out1[row * d + col] = e2::from_float<T>(gbr);
        }
      }
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
  float* out = p.partials + (long long)blockIdx.x * (NC * d + NSM);
  for (int i = threadIdx.x; i < NC * d; i += blockDim.x) {
    float acc = 0.f;
    for (int w = 0; w < warps; ++w) acc += sGW[w * NC * d + i];
    out[i] = acc;
  }
  for (int i = threadIdx.x; i < NSM; i += blockDim.x) {
    float acc = 0.f;
    for (int w = 0; w < warps; ++w) acc += sSmall[w * NSM + i];
    out[NC * d + i] = acc;
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

template <typename T, int NS, bool FUSED, bool SAVE>
cudaError_t launch_bwd(const HcBwdParams& p, int blocks, int warps, float* params_out,
                       cudaStream_t stream) {
  constexpr int V = std::is_same<T, float>::value || NS > 4 ? 4 : 8;
  const size_t smem = bwd_smem_bytes(NS, p.d, warps);
  if (warps < 1 || warps > 8 || smem > MAX_SMEM) return cudaErrorInvalidValue;
  auto kernel = hc_width_bwd_kernel<T, NS, V, FUSED, SAVE>;
  // set once, outside any CUDA-graph capture that later launches replay
  static bool configured = false;
  cudaError_t err;
  if (!configured) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  kernel<<<blocks, warps * 32, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int np = (NS + 2) * p.d + n_small(NS);
  hc_param_reduce_kernel<<<(np + 255) / 256, 256, 0, stream>>>(p.partials, blocks, np, params_out);
  return cudaGetLastError();
}

// which stream counts a translation unit builds
enum class Streams { kAll, kNot4 };

template <typename T, bool FUSED, bool SAVE, Streams SET>
cudaError_t bwd_dispatch_s(const HcBwdParams& p, int s, int blocks, int warps, float* out,
                           cudaStream_t st) {
  if constexpr (SET == Streams::kAll) {
    if (s == 4) return launch_bwd<T, 4, FUSED, SAVE>(p, blocks, warps, out, st);
  }
  switch (s) {
    case 2: return launch_bwd<T, 2, FUSED, SAVE>(p, blocks, warps, out, st);
    case 3: return launch_bwd<T, 3, FUSED, SAVE>(p, blocks, warps, out, st);
    case 5: return launch_bwd<T, 5, FUSED, SAVE>(p, blocks, warps, out, st);
    case 6: return launch_bwd<T, 6, FUSED, SAVE>(p, blocks, warps, out, st);
    case 7: return launch_bwd<T, 7, FUSED, SAVE>(p, blocks, warps, out, st);
    case 8: return launch_bwd<T, 8, FUSED, SAVE>(p, blocks, warps, out, st);
    default: return cudaErrorInvalidValue;
  }
}

// both fused variants of one dtype, SAVE flag and set of stream counts
template <typename T, bool SAVE, Streams SET>
int bwd_run(const HcBwdParams& p, int s, bool fused, int blocks, int warps, void* params_out,
            void* stream) {
  if (blocks < 1 || p.d < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(params_out);
  return (int)(fused ? bwd_dispatch_s<T, true, SAVE, SET>(p, s, blocks, warps, out, st)
                     : bwd_dispatch_s<T, false, SAVE, SET>(p, s, blocks, warps, out, st));
}

}  // namespace

// bf16 at stream counts other than 4 (hyper_conn_bwd_streams.cu) and all
// f32 instantiations (hyper_conn_bwd_f32.cu); params points at this header's
// HcBwdParams
int e2_hc_bwd_streams_run(const void* params, int save, int s, int fused, int blocks,
                          int warps, void* params_out, void* stream);
int e2_hc_bwd_f32_run(const void* params, int save, int s, int fused, int blocks, int warps,
                      void* params_out, void* stream);

namespace {

// what the entry points do not send to hyper_conn_bwd_sm90.cuh (bf16 at 4
// streams): the templates, where they are built
template <bool SAVE>
int bwd_route(const HcBwdParams& p, int s, bool fused, int blocks, int warps, void* params_out,
              int dtype, void* stream) {
  if (dtype == e2::kBFloat16)
    return e2_hc_bwd_streams_run(&p, SAVE, s, fused, blocks, warps, params_out, stream);
  if (dtype == e2::kFloat32)
    return e2_hc_bwd_f32_run(&p, SAVE, s, fused, blocks, warps, params_out, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
