// K5bs and K4s: the save-state adjoints of the hyper-connection width
// connection, replacing the TPU kernels e2_tts_tpu/ops/hyper_conn_kernel.py::
// _width_bwd_kernel_save and ::_width_fused_bwd_kernel_save. They are
// K5b / K4 (hyper_conn_bwd.cuh) with the SAVE flag: they read the forward's
// ta (s, M, s+2) and unrounded inv (s, M), written by K5s / K3s, instead of
// recomputing the rms statistic, the projection and the tanh.
#include "hyper_conn_bwd.cuh"

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
  return bwd_route<true>(p, s, true, blocks, warps, params_out, dtype, stream);
}
