// K1: packed flash-attention forward for the H100 (sm_90a).
//
// Replaces the TPU kernel e2_tts_tpu/ops/flash_attention.py::_packed_fwd_kernel
// (driven by _flash_packed_forward). Computes, per batch row b and head h,
//   s = 50 * tanh(scale * q k^T / 50) + bias(key mask),
//   online softmax over key tiles (running max m, denominator l),
//   post-softmax counter-hash dropout (keep bits identical to _keep_tile),
//   o = (p v) / max(l, 1e-30) * sigmoid(gate[b, row, h]),  lse = m + log(l).
// q/k/v are read straight from the (b, n, h*dh) projection layout: a row
// stride and a head offset, no transpose in or out. The kernel itself is
// flash_fwd_kernel in flash_attention.cuh, shared with K8.
//
// What bounds it: at the sampler's shapes (b=1, n=1056, 8 heads of 64) the
// work is ~2.3 GFLOP of matrix products against ~3 MB of q/k/v, far above
// the H100's ~295 FLOP/byte ridge: the tensor cores bound it. The design
// keeps the n x n scores out of device memory (one 64 x 64 tile at a time in
// shared memory) and runs both products on the tensor cores through wmma
// (bf16 in, f32 accumulate); the f32 variant uses FMA loops. Simple first:
// no TMA, no wgmma, no pipelining of the k/v loads yet.
#include "flash_attention.cuh"

namespace {

template <typename T>
cudaError_t dispatch_dh(const FwdParams& p, cudaStream_t stream) {
  switch (p.dh) {
    case 32: return launch_fwd<T, 32>(p, stream);
    case 64: return launch_fwd<T, 64>(p, stream);
    case 128: return launch_fwd<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v: (b, n, heads * dh) with batch / row strides; o contiguous
extern "C" int e2_flash_fwd(const void* q, const void* k, const void* v, long long q_bs,
                            long long q_rs, long long k_bs, long long k_rs, long long v_bs,
                            long long v_rs, const void* mask, const void* gate, void* o,
                            void* lse, int b, int n, int heads, int dh, float scale,
                            float softclamp, float inv_keep, unsigned seed, unsigned threshold,
                            int dropping, int dtype, void* stream) {
  FwdParams p;
  p.q = q; p.k = k; p.v = v;
  p.qs = {q_bs, dh, q_rs};
  p.ks = {k_bs, dh, k_rs};
  p.vs = {v_bs, dh, v_rs};
  const long long D = (long long)heads * dh;
  p.os = {(long long)n * D, dh, D};
  p.mask = static_cast<const unsigned char*>(mask);
  p.gate = gate;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.b = b; p.n = n; p.heads = heads; p.dh = dh;
  p.scale = scale; p.softclamp = softclamp; p.inv_keep = inv_keep;
  p.seed = seed; p.threshold = threshold; p.dropping = dropping;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == e2::kBFloat16) err = dispatch_dh<__nv_bfloat16>(p, s);
  else if (dtype == e2::kFloat32) err = dispatch_dh<float>(p, s);
  else err = cudaErrorInvalidValue;
  return (int)err;
}
