// The f32 instantiations of K5b / K4 and of their save-state variants K5bs /
// K4s (hyper_conn_bwd.cuh), entered from the C entry points of
// hyper_conn_bwd.cu and hyper_conn_bwd_save.cu for f32 streams: f32 is the
// port's checking dtype, built with small register tiles in a source of its
// own so that nvcc builds it beside the bf16 ones.
#include "hyper_conn_bwd.cuh"

int e2_hc_bwd_f32_run(const void* params, int save, int s, int fused, int blocks, int warps,
                      void* params_out, void* stream) {
  const HcBwdParams& p = *static_cast<const HcBwdParams*>(params);
  return save ? bwd_run<float, true, Streams::kAll>(p, s, fused != 0, blocks, warps,
                                                    params_out, stream)
              : bwd_run<float, false, Streams::kAll>(p, s, fused != 0, blocks, warps,
                                                     params_out, stream);
}
