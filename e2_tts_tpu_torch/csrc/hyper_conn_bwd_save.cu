// K5bs and K4s: the save-state adjoints of the hyper-connection width
// connection, replacing the TPU kernels e2_tts_tpu/ops/hyper_conn_kernel.py::
// _width_bwd_kernel_save and ::_width_fused_bwd_kernel_save. They are
// K5b / K4 with the SAVE flag: they read the forward's ta (s, M, s+2) and
// unrounded inv (s, M), written by K5s / K3s, instead of recomputing the rms
// statistic, the projection and the tanh. The entry points choose the design
// from the dtype and the stream count, as hyper_conn_bwd.cu's do: bf16 at 4
// streams runs the Hopper design of hyper_conn_bwd_sm90.cuh (built here with
// SAVE = true), everything else the templates of hyper_conn_bwd.cuh (built
// in hyper_conn_bwd_f32.cu and hyper_conn_bwd_streams.cu).
#include "hyper_conn_bwd_sm90.cuh"

// K5bs: K5b's arguments plus ta and inv
extern "C" int e2_hc_width_bwd_save(const void* residuals, const void* g_b0, const void* g_car,
                                    const void* g_beta, const void* sa, const void* sb,
                                    const void* aw, const void* bw, const void* ascale,
                                    const void* bscale, const void* ta, const void* inv,
                                    void* g_res, void* partials, void* params_out, int blocks,
                                    int warps, int s, long long m, int d, int dtype,
                                    void* stream) {
  HcBwdParams p{residuals, nullptr, nullptr, g_b0, g_car, g_beta,
                static_cast<const float*>(sa), static_cast<const float*>(sb),
                static_cast<const float*>(aw), static_cast<const float*>(bw),
                static_cast<const float*>(ascale), static_cast<const float*>(bscale),
                static_cast<const float*>(ta), static_cast<const float*>(inv),
                g_res, nullptr, nullptr, static_cast<float*>(partials), m, d};
  if (!ta || !inv) return (int)cudaErrorInvalidValue;
  if (dtype == e2::kBFloat16 && s == 4) return hc_sm90::bwd_run<true>(p, false, blocks, params_out, stream);
  return bwd_route<true>(p, s, false, blocks, warps, params_out, dtype, stream);
}

// K4s: K4's arguments plus ta and inv
extern "C" int e2_hc_width_fused_bwd_save(const void* carried, const void* branch,
                                          const void* beta, const void* g_b0, const void* g_car,
                                          const void* g_beta, const void* sa, const void* sb,
                                          const void* aw, const void* bw, const void* ascale,
                                          const void* bscale, const void* ta, const void* inv,
                                          void* g_carried, void* g_branch, void* g_beta_prev,
                                          void* partials, void* params_out, int blocks,
                                          int warps, int s, long long m, int d, int dtype,
                                          void* stream) {
  HcBwdParams p{carried, branch, beta, g_b0, g_car, g_beta,
                static_cast<const float*>(sa), static_cast<const float*>(sb),
                static_cast<const float*>(aw), static_cast<const float*>(bw),
                static_cast<const float*>(ascale), static_cast<const float*>(bscale),
                static_cast<const float*>(ta), static_cast<const float*>(inv),
                g_carried, g_branch, g_beta_prev, static_cast<float*>(partials), m, d};
  if (!ta || !inv) return (int)cudaErrorInvalidValue;
  if (dtype == e2::kBFloat16 && s == 4) return hc_sm90::bwd_run<true>(p, true, blocks, params_out, stream);
  return bwd_route<true>(p, s, true, blocks, warps, params_out, dtype, stream);
}
