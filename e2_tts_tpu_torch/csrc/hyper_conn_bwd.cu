// K5b and K4: the recomputing adjoints of the hyper-connection width
// connection. The entry points choose the design from the dtype and the
// stream count: bf16 at 4 streams runs the Hopper design of
// hyper_conn_bwd_sm90.cuh (built here with SAVE = false), everything else
// the templates of hyper_conn_bwd.cuh (f32 in hyper_conn_bwd_f32.cu, bf16 at
// the other stream counts in hyper_conn_bwd_streams.cu; one nvcc each, in
// parallel). The save-state variants K5bs / K4s are in hyper_conn_bwd_save.cu,
// which builds the same Hopper design with SAVE = true.
// `blocks` is the partial rows the caller allocated; `warps`, a block's
// warps, is the templates' (the Hopper design takes block_warps(d)).
#include "hyper_conn_bwd_sm90.cuh"

// K5b: residuals (s, M, d), grads of (branch input, carried, beta) -> g_residuals
// (s, M, d) and the parameter-grad row (NP) via `partials` (blocks, NP)
extern "C" int e2_hc_width_bwd(const void* residuals, const void* g_b0, const void* g_car,
                               const void* g_beta, const void* sa, const void* sb,
                               const void* aw, const void* bw, const void* ascale,
                               const void* bscale, void* g_res, void* partials,
                               void* params_out, int blocks, int warps, int s, long long m,
                               int d, int dtype, void* stream) {
  HcBwdParams p{residuals, nullptr, nullptr, g_b0, g_car, g_beta,
                static_cast<const float*>(sa), static_cast<const float*>(sb),
                static_cast<const float*>(aw), static_cast<const float*>(bw),
                static_cast<const float*>(ascale), static_cast<const float*>(bscale),
                nullptr, nullptr, g_res, nullptr, nullptr, static_cast<float*>(partials), m, d};
  if (dtype == e2::kBFloat16 && s == 4) return hc_sm90::bwd_run<false>(p, false, blocks, params_out, stream);
  return bwd_route<false>(p, s, false, blocks, warps, params_out, dtype, stream);
}

// K4: carried (s, M, d), branch (M, d), beta (s, M) and the same incoming
// grads -> g_carried (s, M, d), g_branch (M, d), g_beta (s, M) and the row
extern "C" int e2_hc_width_fused_bwd(const void* carried, const void* branch, const void* beta,
                                     const void* g_b0, const void* g_car, const void* g_beta,
                                     const void* sa, const void* sb, const void* aw,
                                     const void* bw, const void* ascale, const void* bscale,
                                     void* g_carried, void* g_branch, void* g_beta_prev,
                                     void* partials, void* params_out, int blocks, int warps,
                                     int s, long long m, int d, int dtype, void* stream) {
  HcBwdParams p{carried, branch, beta, g_b0, g_car, g_beta,
                static_cast<const float*>(sa), static_cast<const float*>(sb),
                static_cast<const float*>(aw), static_cast<const float*>(bw),
                static_cast<const float*>(ascale), static_cast<const float*>(bscale),
                nullptr, nullptr, g_carried, g_branch, g_beta_prev,
                static_cast<float*>(partials), m, d};
  if (dtype == e2::kBFloat16 && s == 4) return hc_sm90::bwd_run<false>(p, true, blocks, params_out, stream);
  return bwd_route<false>(p, s, true, blocks, warps, params_out, dtype, stream);
}
