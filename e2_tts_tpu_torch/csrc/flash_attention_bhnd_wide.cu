// K8 and K9 for heads of 136 to 256 columns: the templates of
// flash_attention.cuh with SPLIT = 2 (two column chunks of dh rounded up to
// 32, halved: 80, 96, 112 or 128 wide; two blocks per tile, one per chunk
// of the output columns). Entered from e2_flash_fwd_bhnd /
// e2_flash_bwd_bhnd (flash_attention_bhnd.cu) with their parameters; a
// source of its own so that nvcc builds it beside the narrow heads'.
#include "flash_attention.cuh"

namespace {

template <typename T>
cudaError_t fwd_wide(const FwdParams& p, cudaStream_t s) {
  switch ((p.dh + 31) / 32 * 16) {
    case 80: return launch_fwd<T, 80, 2>(p, s);
    case 96: return launch_fwd<T, 96, 2>(p, s);
    case 112: return launch_fwd<T, 112, 2>(p, s);
    case 128: return launch_fwd<T, 128, 2>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t bwd_wide(const BwdParams& p, cudaStream_t s) {
  switch ((p.dh + 31) / 32 * 16) {
    case 80: return launch_bwd<T, 80, 2>(p, s);
    case 96: return launch_bwd<T, 96, 2>(p, s);
    case 112: return launch_bwd<T, 112, 2>(p, s);
    case 128: return launch_bwd<T, 128, 2>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

int e2_flash_bhnd_wide(const void* params, int backward, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (backward) {
    const BwdParams& p = *static_cast<const BwdParams*>(params);
    if (p.dh <= 128 || p.dh > 256 || p.dh % 8) return (int)cudaErrorInvalidValue;
    if (dtype == e2::kBFloat16) err = bwd_wide<__nv_bfloat16>(p, s);
    else if (dtype == e2::kFloat32) err = bwd_wide<float>(p, s);
  } else {
    const FwdParams& p = *static_cast<const FwdParams*>(params);
    if (p.dh <= 128 || p.dh > 256 || p.dh % 8) return (int)cudaErrorInvalidValue;
    if (dtype == e2::kBFloat16) err = fwd_wide<__nv_bfloat16>(p, s);
    else if (dtype == e2::kFloat32) err = fwd_wide<float>(p, s);
  }
  return (int)err;
}
