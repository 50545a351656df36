// K2: packed flash-attention backward for the H100 (sm_90a).
//
// Replaces the TPU kernel e2_tts_tpu/ops/flash_attention.py::_packed_bwd_kernel
// (driven by _flash_packed_backward). For one batch row b, head h and a
// 64-key tile, it loops over the 64-row query tiles and recomputes, as the
// TPU kernel does in _recompute_p_ds / _bwd_keep_scaled,
//   s  = scale * q k^T;  th = tanh(s / c);  s = c * th  (softclamp c, jac = 1 - th^2)
//   p  = exp(s + bias[key] - lse[row])                   (lse from K1)
//   dp = do_g v^T,  do_g = do * sigmoid(gate[b, row, h]) (rounded to the compute dtype)
//   ks = keep(seed, (hash_b0 + b)*hash_heads + hash_h0 + h, row, key) / (1 - rate)
//        (K1's bits)
//   ds = p * (ks * dp - delta[b, row, h]) * jac * scale,  p_drop = p * ks
//   dv += p_drop^T do_g,  dk += ds^T q,  dq += ds k
// with delta = rowsum(do * o) per head. Both delta and do_g come from K10
// (below), launched by the wrapper just before K2 on the same stream: it
// reads do and o once, writes delta and, for a gated layer, do_g, which
// K2 then reads as its do (without a gate K2 reads do itself). p_drop and
// ds are rounded to the compute dtype before the three products, as the
// TPU kernel rounds them.
//
// The design, chosen here: a sequence of at most N_SHORT tokens (the
// frequency attention's) runs the few-token kernels of
// flash_attention_short.cuh, bf16 or f32 (dq added by plain read-add-write:
// one lane group owns each element); a longer one, by the dtype:
//   bf16: flash_bwd_kernel of flash_attention_sm90.cuh, K9's Hopper
//     design: one warpgroup a block owns 64 keys with dk and dv in
//     registers, wgmma products on register-resident scores, q / do /
//     lse / delta tiles on a cp.async ring, dq reduced into a zeroed f32
//     (b, n, h*dh) buffer by red.global.add.v4.f32;
//   f32: flash_bwd_kernel of flash_attention.cuh (FMA loops, dq by
//     atomicAdd).
// In the tiled designs the summation order of dq over key tiles changes from
// run to run, so dq agrees with a fixed-order sum to f32 rounding, not bit
// for bit.
//
// What bounds it: at the training shape (16, 1056, 8 heads x 64) the five
// n x n x dh products are ~36 GFLOP against ~70 MB of q, k, v, do, dq, dk,
// dv: the tensor cores bound it (the softclamp's tanh and exp2, recomputed
// per score on the special-function units in this design, take a little
// less time than the products).
#include "flash_attention.cuh"
#include "flash_attention_sm90.cuh"
#include "flash_attention_short.cuh"

namespace {

template <int DH>
cudaError_t launch(const BwdParams& p, bool bf16, cudaStream_t stream) {
  return bf16 ? sm90::launch_bwd<DH>(p, stream) : launch_bwd<float, DH>(p, stream);
}

cudaError_t dispatch_dh(const BwdParams& p, bool bf16, cudaStream_t stream) {
  switch (p.dh) {
    case 32: return launch<32>(p, bf16, stream);
    case 64: return launch<64>(p, bf16, stream);
    case 128: return launch<128>(p, bf16, stream);
    default: return cudaErrorInvalidValue;
  }
}

// K10: K2's pre-pass delta = rowsum(do * o) per head and, for a gated
// layer, do_g = do * sigmoid(gate) rounded to the compute dtype. Replaces
// the TPU kernel e2_tts_tpu/ops/flash_attention.py::_delta_kernel (driven by
// _delta_bnh_pallas) and the gating of do inside _packed_bwd_kernel. o, do
// and do_g are contiguous (rows, heads * dh); gate (rows, heads) logits of
// the same dtype, or null; delta is (rows, heads) f32. delta takes the
// ungated do against the gated o: rowsum(do * o) = rowsum(do_g * o / g) is
// gate-invariant, as the TPU package computes it.
//
// What bounds it: bytes. It reads o and do once (two bf16 values per product,
// 2 flops) and writes one f32 per (row, head), and do_g when gated: at the
// trainer's shape (16, 1056, 8 x 64) bf16 that is ~35 MB (~10.5 us at
// 3.35 TB/s) ungated, ~52 MB gated. Design: one thread per 16-byte chunk of
// a row (8 bf16 or 4 f32 lanes), the chunk's products summed in f32, then
// the dh / VEC lanes of a head (consecutive lanes of one warp, a power of
// two) summed by xor shuffles; the head's first lane writes delta. A gated
// chunk's thread reads its head's logit and writes its 16 bytes of do_g.
// Loads and stores are 16 bytes a thread on neighbouring addresses. The
// TPU kernel's lane contraction on the MXU (a 0/1 segment matrix) has no
// point here: a shuffle tree is the warp's native segmented sum.
template <typename T>
__global__ void __launch_bounds__(256)
    flash_delta_kernel(const T* o, const T* dout, const T* gate, T* dout_g, float* delta,
                       long long chunks, int chunks_per_row, int lanes_per_head, int heads) {
  constexpr int VEC = 16 / sizeof(T);
  // every lane of a warp runs the same iterations, so the shuffles see all 32
  const long long padded = (chunks + 31) / 32 * 32;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x; c < padded; c += stride) {
    float sum = 0.f;
    const long long row = c / chunks_per_row;
    const int head = (int)(c % chunks_per_row) / lanes_per_head;
    if (c < chunks) {
      const uint4 ov = reinterpret_cast<const uint4*>(o)[c];
      const uint4 dv = reinterpret_cast<const uint4*>(dout)[c];
      const T* oe = reinterpret_cast<const T*>(&ov);
      const T* de = reinterpret_cast<const T*>(&dv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) sum = fmaf(e2::to_float<T>(de[e]), e2::to_float<T>(oe[e]), sum);
      if (gate != nullptr) {
        const float g = 1.f / (1.f + expf(-e2::to_float<T>(gate[row * heads + head])));
        uint4 gv;
        T* ge = reinterpret_cast<T*>(&gv);
#pragma unroll
        for (int e = 0; e < VEC; ++e) ge[e] = e2::from_float<T>(e2::to_float<T>(de[e]) * g);
        reinterpret_cast<uint4*>(dout_g)[c] = gv;
      }
    }
    for (int off = lanes_per_head / 2; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (c < chunks && c % lanes_per_head == 0) delta[row * heads + head] = sum;
  }
}

template <typename T>
cudaError_t launch_delta(const void* o, const void* dout, const void* gate, void* dout_g,
                         void* delta, long long rows, int heads, int dh, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int lanes_per_head = dh / VEC;
  if (dh % VEC != 0 || lanes_per_head < 1 || 32 % lanes_per_head != 0 ||
      (gate != nullptr && dout_g == nullptr))
    return cudaErrorInvalidValue;
  const int chunks_per_row = heads * lanes_per_head;
  const long long chunks = rows * chunks_per_row;
  if (chunks == 0) return cudaSuccess;
  long long blocks = (chunks + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  flash_delta_kernel<T><<<(unsigned)blocks, 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), static_cast<const T*>(gate),
      static_cast<T*>(dout_g), static_cast<float*>(delta), chunks, chunks_per_row,
      lanes_per_head, heads);
  return cudaGetLastError();
}

}  // namespace

// gate null: delta only (dout_g unused)
extern "C" int e2_flash_delta(const void* o, const void* dout, const void* gate, void* dout_g,
                              void* delta, long long rows, int heads, int dh, int dtype,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == e2::kBFloat16)
    err = launch_delta<__nv_bfloat16>(o, dout, gate, dout_g, delta, rows, heads, dh, s);
  else if (dtype == e2::kFloat32)
    err = launch_delta<float>(o, dout, gate, dout_g, delta, rows, heads, dh, s);
  else err = cudaErrorInvalidValue;
  return (int)err;
}

// q, k, v: (b, n, heads * dh) with batch / row strides; dout (K10's do_g
// for a gated layer), dk, dv contiguous (b, n, heads * dh), dq a zeroed f32
// buffer likewise; delta (b, n, heads); hash_b0, hash_h0, hash_heads and
// hash_rc as e2_flash_fwd's
extern "C" int e2_flash_bwd(const void* q, const void* k, const void* v, long long q_bs,
                            long long q_rs, long long k_bs, long long k_rs, long long v_bs,
                            long long v_rs, const void* dout, const void* mask, const void* lse,
                            const void* delta, void* dq, void* dk, void* dv, int b, int n,
                            int heads, int dh, float scale, float softclamp, float inv_keep,
                            unsigned seed, unsigned threshold, int dropping, int hash_b0,
                            int hash_h0, int hash_heads, unsigned hash_rc, int dtype,
                            void* stream) {
  if (dtype != e2::kBFloat16 && dtype != e2::kFloat32) return (int)cudaErrorInvalidValue;
  BwdParams p;
  p.q = q; p.k = k; p.v = v; p.dout = dout;
  p.qs = {q_bs, dh, q_rs};
  p.ks = {k_bs, dh, k_rs};
  p.vs = {v_bs, dh, v_rs};
  const long long D = (long long)heads * dh;
  const Strides packed = {(long long)n * D, dh, D};
  p.dos = p.dqs = p.dks = p.dvs = packed;
  p.mask = static_cast<const unsigned char*>(mask);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.deltas = {(long long)n * heads, 1, heads};
  p.dq = static_cast<float*>(dq);
  p.dk = dk; p.dv = dv;
  p.b = b; p.n = n; p.heads = heads; p.dh = dh;
  p.scale = scale; p.softclamp = softclamp; p.inv_keep = inv_keep;
  p.seed = seed; p.threshold = threshold; p.dropping = dropping;
  p.hash_b0 = hash_b0; p.hash_h0 = hash_h0; p.hash_heads = hash_heads;
  p.hash_rc = hash_rc;
  // the design: the few-token kernels up to N_SHORT tokens, the tiled ones above
  if (n <= short_seq::N_SHORT)
    return (int)short_seq::launch_bwd(p, dtype == e2::kBFloat16,
                                         static_cast<cudaStream_t>(stream));
  return (int)dispatch_dh(p, dtype == e2::kBFloat16, static_cast<cudaStream_t>(stream));
}
