// The cost-floor probe for the H100 (sm_90a).
//
// Replaces the TPU kernel scripts/_kernel_floor.py::kern: flash attention's
// forward stripped to its products, in three modes that add the softmax's
// pieces one at a time, at q = k = v = x (bf16 (b, h, n, dh), dh a multiple
// of 8 up to 128): per 64-key tile s = x x^T; mode 0 takes s, mode 1 exp(s),
// mode 2 exp(s) - (max + sum) over the tile's keys; acc += bf16(.) v in f32,
// bf16 out.
//
// What bounds it: the tensor cores (two n x n x dh products, as K8's). It is
// a floor of K8 because it is K8: flash_attention_sm90.cuh's forward kernel
// with its PROBE template flag, the same cp.async ring, wgmma products,
// in-register fragments and block geometry (one or two warpgroups a block,
// as launch_fwd chooses for K8 at the same shape), with the softclamp, mask
// bias, dropout, online softmax, normalisation and lse compiled out. Mode 0
// against K8 without softclamp and dropout at one shape measures what the
// softmax costs over the products and the data movement; modes 1 and 2 add
// the exponentials and the row statistics.
#include "flash_attention_sm90.cuh"

namespace {

constexpr int round16(int dh) { return (dh + 15) / 16 * 16; }

template <int MODE>
cudaError_t launch_probe(const FwdParams& p, cudaStream_t s) {
  switch (round16(p.dh)) {
    case 16: return sm90::launch_fwd<16, MODE>(p, s);
    case 32: return sm90::launch_fwd<32, MODE>(p, s);
    case 48: return sm90::launch_fwd<48, MODE>(p, s);
    case 64: return sm90::launch_fwd<64, MODE>(p, s);
    case 80: return sm90::launch_fwd<80, MODE>(p, s);
    case 96: return sm90::launch_fwd<96, MODE>(p, s);
    case 112: return sm90::launch_fwd<112, MODE>(p, s);
    case 128: return sm90::launch_fwd<128, MODE>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (b, h, n, dh) bf16 with (batch, head, row) strides xs, o with strides
// os (both in whole 16-byte chunks, 16-byte aligned starts).
extern "C" int e2_flash_probe(const void* x, const long long* xs, void* o, const long long* os,
                              int b, int n, int heads, int dh, int mode, void* stream) {
  if (dh < 8 || dh > 128 || dh % 8 != 0 || mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
  FwdParams p;
  const Strides x_strides{xs[0], xs[1], xs[2]};
  p.q = p.k = p.v = x;
  p.qs = p.ks = p.vs = x_strides;
  p.os = Strides{os[0], os[1], os[2]};
  p.mask = nullptr;
  p.gate = nullptr;
  p.o = o;
  p.lse = nullptr;
  p.b = b; p.n = n; p.heads = heads; p.dh = dh;
  p.scale = 1.f; p.softclamp = 0.f; p.inv_keep = 1.f;
  p.seed = 0; p.threshold = 0; p.dropping = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0) return (int)launch_probe<0>(p, s);
  if (mode == 1) return (int)launch_probe<1>(p, s);
  return (int)launch_probe<2>(p, s);
}
