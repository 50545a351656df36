// K5 and K3: the hyper-connection width connection. The entry points choose
// the design from the dtype and the stream count (`width_run`): bf16 at 4
// streams runs the Hopper design of hyper_conn_sm90.cuh, everything else the
// templates of hyper_conn.cuh. The save-state variants K5s / K3s are the same
// designs' SAVE flag, built in hyper_conn_save.cu.
#include "hyper_conn_sm90.cuh"

// K5s / K3s (hyper_conn_save.cu); params points at hyper_conn.cuh's HcParams
int e2_hc_width_save_run(const void* params, int s, int fused, int dtype, void* stream);

namespace {

int run(const HcParams& p, int s, bool fused, int dtype, void* stream) {
  if ((p.ta == nullptr) != (p.inv == nullptr)) return (int)cudaErrorInvalidValue;
  if (p.ta != nullptr) return e2_hc_width_save_run(&p, s, fused, dtype, stream);
  return width_run<false>(p, s, fused, dtype, stream);
}

}  // namespace

// K5 (K5s when ta and inv are given): residuals (s, M, d) -> branch_input
// (M, d), carried (s, M, d), beta (s, M) [, ta (s, M, s+2), inv (s, M)]
extern "C" int e2_hc_width(const void* residuals, const void* sa, const void* sb,
                           const void* aw, const void* bw, const void* ascale,
                           const void* bscale, void* out_branch, void* out_carried,
                           void* out_beta, void* ta, void* inv, int s, long long m, int d,
                           int dtype, void* stream) {
  HcParams p{residuals, nullptr, nullptr,
             static_cast<const float*>(sa), static_cast<const float*>(sb),
             static_cast<const float*>(aw), static_cast<const float*>(bw),
             static_cast<const float*>(ascale), static_cast<const float*>(bscale),
             out_branch, out_carried, out_beta,
             static_cast<float*>(ta), static_cast<float*>(inv), m, d};
  return run(p, s, false, dtype, stream);
}

// K3 (K3s when ta and inv are given): carried (s, M, d) + branch (M, d) *
// beta (s, M) -> the same outputs
extern "C" int e2_hc_width_fused(const void* carried, const void* branch, const void* beta,
                                 const void* sa, const void* sb, const void* aw,
                                 const void* bw, const void* ascale, const void* bscale,
                                 void* out_branch, void* out_carried, void* out_beta, void* ta,
                                 void* inv, int s, long long m, int d, int dtype, void* stream) {
  HcParams p{carried, branch, beta,
             static_cast<const float*>(sa), static_cast<const float*>(sb),
             static_cast<const float*>(aw), static_cast<const float*>(bw),
             static_cast<const float*>(ascale), static_cast<const float*>(bscale),
             out_branch, out_carried, out_beta,
             static_cast<float*>(ta), static_cast<float*>(inv), m, d};
  return run(p, s, true, dtype, stream);
}
