// K1: packed flash-attention forward for the H100 (sm_90a).
//
// Replaces the TPU kernel e2_tts_tpu/ops/flash_attention.py::_packed_fwd_kernel
// (driven by _flash_packed_forward). Computes, per batch row b and head h,
//   s = 50 * tanh(scale * q k^T / 50) + bias(key mask),
//   online softmax over key tiles (running max m, denominator l),
//   post-softmax counter-hash dropout (keep bits identical to _keep_tile),
//   o = (p v) / max(l, 1e-30) * sigmoid(gate[b, row, h]),  lse = m + log(l).
// q/k/v are read straight from the (b, n, h*dh) projection layout: a row
// stride and a head offset, no transpose in or out.
//
// The design, chosen here: a sequence of at most N_SHORT tokens (the
// frequency attention's) runs the few-token kernels of
// flash_attention_short.cuh, bf16 or f32 (many (sequence, head) pairs a
// block, f32 on the CUDA cores); a longer one, by the dtype:
//   bf16: flash_fwd_kernel of flash_attention_sm90.cuh, K8's Hopper
//     design (wgmma products on register-resident scores, a cp.async K/V
//     ring; the gate folded into its epilogue);
//   f32: flash_fwd_kernel of flash_attention.cuh (wmma's f32 variant:
//     FMA loops over shared-memory tiles).
//
// What bounds it: at the sampler's shape (b=1, n=1056, 8 heads of 64) the
// work is ~2.3 GFLOP of matrix products against ~3 MB of q/k/v, far above
// the H100's ~295 FLOP/byte ridge, and the softclamp adds two
// transcendentals a score, which this design evaluates on the
// special-function units (16 a clock per SM): at this shape they take longer
// than the products on the tensor cores. The 17 x 8 =
// 136 blocks of one warpgroup fill the 132 SMs in one wave.
#include "flash_attention.cuh"
#include "flash_attention_sm90.cuh"
#include "flash_attention_short.cuh"

namespace {

template <int DH>
cudaError_t launch(const FwdParams& p, bool bf16, cudaStream_t stream) {
  return bf16 ? sm90::launch_fwd<DH>(p, stream) : launch_fwd<float, DH>(p, stream);
}

cudaError_t dispatch_dh(const FwdParams& p, bool bf16, cudaStream_t stream) {
  switch (p.dh) {
    case 32: return launch<32>(p, bf16, stream);
    case 64: return launch<64>(p, bf16, stream);
    case 128: return launch<128>(p, bf16, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v: (b, n, heads * dh) with batch / row strides; o contiguous; gate
// (b, n, heads) logits of q's dtype or null; for the dropout hash, hash_b0 the
// first row's place in the global batch, hash_h0 the first head's among a
// row's hash_heads heads, hash_rc the first query row's and key column's
// places in the global sequence as row0 * 0x9E3779B1 + col0 * 0x85EBCA77
// (mod 2^32; 0 for a launch over the whole sequence)
extern "C" int e2_flash_fwd(const void* q, const void* k, const void* v, long long q_bs,
                            long long q_rs, long long k_bs, long long k_rs, long long v_bs,
                            long long v_rs, const void* mask, const void* gate, void* o,
                            void* lse, int b, int n, int heads, int dh, float scale,
                            float softclamp, float inv_keep, unsigned seed, unsigned threshold,
                            int dropping, int hash_b0, int hash_h0, int hash_heads,
                            unsigned hash_rc, int dtype, void* stream) {
  if (dtype != e2::kBFloat16 && dtype != e2::kFloat32) return (int)cudaErrorInvalidValue;
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
  p.hash_b0 = hash_b0; p.hash_h0 = hash_h0; p.hash_heads = hash_heads;
  p.hash_rc = hash_rc;
  // the design: the few-token kernels up to N_SHORT tokens, the tiled ones above
  if (n <= short_seq::N_SHORT)
    return (int)short_seq::launch_fwd(p, dtype == e2::kBFloat16,
                                         static_cast<cudaStream_t>(stream));
  return (int)dispatch_dh(p, dtype == e2::kBFloat16, static_cast<cudaStream_t>(stream));
}
