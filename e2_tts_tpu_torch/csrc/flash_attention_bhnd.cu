// K8 and K9: flash attention on (b, h, n, dh) operands for the H100
// (sm_90a).
//
// K8 replaces the TPU kernel e2_tts_tpu/ops/flash_attention.py::_fwd_kernel
// (driven by _flash_forward): s = c tanh(scale q k^T / c) + bias(key mask),
// online softmax over key tiles, post-softmax counter-hash dropout (keep
// bits identical to _keep_tile for the global head (hash_b0 + b) * hash_heads +
// hash_h0 + h),
// o = (p v) / max(l, 1e-30), lse = m + log(l). No gate.
// K9 replaces the TPU kernels _bwd_merged_kernel / _dq_kernel / _dkv_kernel
// (driven by _flash_backward) with one design: dq, dk, dv from q, k, v, the
// output grad, K8's lse and delta = rowsum(do * o) (a plain PyTorch sum
// before the launch, as the JAX package leaves it to XLA).
// Every operand is entered with (batch, head, row) strides: a (b, h, n, dh)
// tensor, or a strided view of the packed (b, n, h*dh) projection, is read
// and written where it lies, with no copies. dim_head is any multiple of 8
// up to 256; the tiles are padded to the next multiple of 16 in shared
// memory (72 -> 80), never past a head's own columns in device memory.
// Two designs, chosen here by the dtype and dim_head:
//   bf16, dim_head up to 128: flash_attention_sm90.cuh, wgmma products
//     on register-resident scores and cp.async tile rings;
//   f32, and every head wider than 128: the wmma templates of
//     flash_attention.cuh (f32 K1 / K2 use them too); a head wider than
//     128 runs as two column chunks (SPLIT = 2), built in
//     flash_attention_bhnd_wide.cu (another nvcc, in parallel).
// The wrapper zero-pads a head that is not a multiple of 8.
//
// What bounds them: at the DiT-width training shape (16, 16 heads, 1056, 72)
// K8's two n x n x dh products are 82 GFLOP against 78 MB of q, k, v, o; K9's
// five are 206 GFLOP against ~160 MB: both far above the H100's ~295
// FLOP/byte ridge, so the tensor cores bound them, and K8's softclamp adds
// two transcendentals a score on the special-function units. The padding of
// dh = 72 to 80 costs 11% of the products.
//
// The cost-floor probe is K8's Hopper forward with its PROBE flag set; its
// entry point is in flash_probe.cu (another nvcc, in parallel).
#include "flash_attention.cuh"
#include "flash_attention_sm90.cuh"

namespace {

constexpr int round16(int dh) { return (dh + 15) / 16 * 16; }

}  // namespace

// heads of 136 to 256 columns (flash_attention_bhnd_wide.cu); params points
// at this header's FwdParams / BwdParams
int e2_flash_bhnd_wide(const void* params, int backward, int dtype, void* stream);

namespace {

// f32 heads up to 128: the wmma templates
cudaError_t dispatch_fwd_f32(const FwdParams& p, cudaStream_t stream) {
  switch (round16(p.dh)) {
    case 16: return launch_fwd<float, 16>(p, stream);
    case 32: return launch_fwd<float, 32>(p, stream);
    case 48: return launch_fwd<float, 48>(p, stream);
    case 64: return launch_fwd<float, 64>(p, stream);
    case 80: return launch_fwd<float, 80>(p, stream);
    case 96: return launch_fwd<float, 96>(p, stream);
    case 112: return launch_fwd<float, 112>(p, stream);
    case 128: return launch_fwd<float, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

// f32 heads up to 128: the wmma templates
cudaError_t dispatch_bwd_f32(const BwdParams& p, cudaStream_t stream) {
  switch (round16(p.dh)) {
    case 16: return launch_bwd<float, 16>(p, stream);
    case 32: return launch_bwd<float, 32>(p, stream);
    case 48: return launch_bwd<float, 48>(p, stream);
    case 64: return launch_bwd<float, 64>(p, stream);
    case 80: return launch_bwd<float, 80>(p, stream);
    case 96: return launch_bwd<float, 96>(p, stream);
    case 112: return launch_bwd<float, 112>(p, stream);
    case 128: return launch_bwd<float, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_sm90_fwd(const FwdParams& p, cudaStream_t stream) {
  switch (round16(p.dh)) {
    case 16: return sm90::launch_fwd<16>(p, stream);
    case 32: return sm90::launch_fwd<32>(p, stream);
    case 48: return sm90::launch_fwd<48>(p, stream);
    case 64: return sm90::launch_fwd<64>(p, stream);
    case 80: return sm90::launch_fwd<80>(p, stream);
    case 96: return sm90::launch_fwd<96>(p, stream);
    case 112: return sm90::launch_fwd<112>(p, stream);
    case 128: return sm90::launch_fwd<128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_sm90_bwd(const BwdParams& p, cudaStream_t stream) {
  switch (round16(p.dh)) {
    case 16: return sm90::launch_bwd<16>(p, stream);
    case 32: return sm90::launch_bwd<32>(p, stream);
    case 48: return sm90::launch_bwd<48>(p, stream);
    case 64: return sm90::launch_bwd<64>(p, stream);
    case 80: return sm90::launch_bwd<80>(p, stream);
    case 96: return sm90::launch_bwd<96>(p, stream);
    case 112: return sm90::launch_bwd<112>(p, stream);
    case 128: return sm90::launch_bwd<128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool valid_dh(int dh) { return dh >= 8 && dh <= 256 && dh % 8 == 0; }

Strides strides(const long long* s) { return {s[0], s[1], s[2]}; }

}  // namespace

// K8. Strides are (batch, head, row) triples in elements; o may be any
// (b, h, n, dh) layout with unit column stride; lse is (b*heads, n) f32;
// hash_b0, hash_h0, hash_heads and hash_rc as in e2_flash_fwd.
extern "C" int e2_flash_fwd_bhnd(const void* q, const void* k, const void* v, const long long* qs,
                                 const long long* ks, const long long* vs, const void* mask,
                                 void* o, const long long* os, void* lse, int b, int n,
                                 int heads, int dh, float scale, float softclamp, float inv_keep,
                                 unsigned seed, unsigned threshold, int dropping, int hash_b0,
                                 int hash_h0, int hash_heads, unsigned hash_rc, int dtype,
                                 void* stream) {
  if (!valid_dh(dh)) return (int)cudaErrorInvalidValue;
  FwdParams p;
  p.q = q; p.k = k; p.v = v;
  p.qs = strides(qs); p.ks = strides(ks); p.vs = strides(vs); p.os = strides(os);
  p.mask = static_cast<const unsigned char*>(mask);
  p.gate = nullptr;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.b = b; p.n = n; p.heads = heads; p.dh = dh;
  p.scale = scale; p.softclamp = softclamp; p.inv_keep = inv_keep;
  p.seed = seed; p.threshold = threshold; p.dropping = dropping;
  p.hash_b0 = hash_b0; p.hash_h0 = hash_h0; p.hash_heads = hash_heads;
  p.hash_rc = hash_rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh > 128) return e2_flash_bhnd_wide(&p, 0, dtype, stream);
  if (dtype == e2::kBFloat16) return (int)dispatch_sm90_fwd(p, s);
  if (dtype == e2::kFloat32) return (int)dispatch_fwd_f32(p, s);
  return (int)cudaErrorInvalidValue;
}

// K9. delta is f32 with strides ds; dq a zeroed f32 buffer with strides dqs
// (bf16 heads up to 128: 16-byte aligned rows, for the vector reductions).
extern "C" int e2_flash_bwd_bhnd(const void* q, const void* k, const void* v, const void* dout,
                                 const long long* qs, const long long* ks, const long long* vs,
                                 const long long* dos, const void* mask, const void* lse,
                                 const void* delta, const long long* ds, void* dq,
                                 const long long* dqs, void* dk, const long long* dks, void* dv,
                                 const long long* dvs, int b, int n, int heads, int dh,
                                 float scale, float softclamp, float inv_keep, unsigned seed,
                                 unsigned threshold, int dropping, int hash_b0, int hash_h0,
                                 int hash_heads, unsigned hash_rc, int dtype, void* stream) {
  if (!valid_dh(dh)) return (int)cudaErrorInvalidValue;
  BwdParams p;
  p.q = q; p.k = k; p.v = v; p.dout = dout;
  p.qs = strides(qs); p.ks = strides(ks); p.vs = strides(vs); p.dos = strides(dos);
  p.mask = static_cast<const unsigned char*>(mask);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.deltas = strides(ds);
  p.dq = static_cast<float*>(dq);
  p.dk = dk; p.dv = dv;
  p.dqs = strides(dqs); p.dks = strides(dks); p.dvs = strides(dvs);
  p.b = b; p.n = n; p.heads = heads; p.dh = dh;
  p.scale = scale; p.softclamp = softclamp; p.inv_keep = inv_keep;
  p.seed = seed; p.threshold = threshold; p.dropping = dropping;
  p.hash_b0 = hash_b0; p.hash_h0 = hash_h0; p.hash_heads = hash_heads;
  p.hash_rc = hash_rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh > 128) return e2_flash_bhnd_wide(&p, 1, dtype, stream);
  if (dtype == e2::kBFloat16) return (int)dispatch_sm90_bwd(p, s);
  if (dtype == e2::kFloat32) return (int)dispatch_bwd_f32(p, s);
  return (int)cudaErrorInvalidValue;
}
