// The bf16 instantiations of K5b / K4 and of their save-state variants K5bs /
// K4s (hyper_conn_bwd.cuh) at stream counts other than 4 (2, 3, 5-8),
// entered from the C entry points of hyper_conn_bwd.cu and
// hyper_conn_bwd_save.cu: small streaming register tiles, in a source of
// their own so that nvcc builds it beside the others.
#include "hyper_conn_bwd.cuh"

int e2_hc_bwd_streams_run(const void* params, int save, int s, int fused, int blocks,
                          int warps, void* params_out, void* stream) {
  const HcBwdParams& p = *static_cast<const HcBwdParams*>(params);
  return save ? bwd_run<__nv_bfloat16, true, Streams::kNot4>(p, s, fused != 0, blocks, warps,
                                                             params_out, stream)
              : bwd_run<__nv_bfloat16, false, Streams::kNot4>(p, s, fused != 0, blocks, warps,
                                                              params_out, stream);
}
