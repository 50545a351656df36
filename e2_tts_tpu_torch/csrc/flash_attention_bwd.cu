// K2: packed flash-attention backward for the H100 (sm_90a).
//
// Replaces the TPU kernel e2_tts_tpu/ops/flash_attention.py::_packed_bwd_kernel
// (driven by _flash_packed_backward). For one batch row b, head h and a
// 64-key tile, it loops over the 64-row query tiles and recomputes, as the
// TPU kernel does in _recompute_p_ds / _bwd_keep_scaled,
//   s  = scale * q k^T;  th = tanh(s / c);  s = c * th  (softclamp c, jac = 1 - th^2)
//   p  = exp(s + bias[key] - lse[row])                   (lse from K1)
//   dp = do_g v^T,  do_g = do * sigmoid(gate[b, row, h]) (rounded to the compute dtype)
//   ks = keep(seed, b*heads + h, row, key) / (1 - rate)  (K1's dropout bits)
//   ds = p * (ks * dp - delta[b, row, h]) * jac * scale,  p_drop = p * ks
//   dv += p_drop^T do_g,  dk += ds^T q,  dq += ds k
// with delta = rowsum(do * o) per head (K10 below, launched by the wrapper
// just before K2 on the same stream). p_drop and ds are rounded to the
// compute dtype before the three products, as the TPU kernel rounds them.
//
// Hopper layout: the TPU carried dk/dv/dq scratch across a sequential grid.
// Here blocks run in no order, so one block owns a (b, h, key tile), loops
// over the query tiles and keeps dk and dv on chip (wmma accumulator
// fragments, or registers in the f32 variant) until the end; dq, which sums
// over key tiles, goes to a zeroed f32 (b, n, h*dh) buffer by atomicAdd
// (one launch; the summation order over key tiles changes from run to run,
// so dq agrees with a fixed-order sum to f32 rounding, not bit for bit).
//
// What bounds it: at the training shape (16, 1056, 8 heads x 64) the five
// n x n x dh products are ~36 GFLOP against ~70 MB of q, k, v, do, dq, dk,
// dv: the tensor cores bound it. The design keeps every n x n tile (scores,
// probabilities, their gradients) in shared memory and runs all five
// products on the tensor cores (wmma, bf16 in / f32 accumulate); the f32
// variant uses FMA loops. Simple first: no TMA, no wgmma, no pipelining.
#include <mma.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int BQ = 64;  // query rows per tile
constexpr int BK = 64;  // keys per block (16 per warp)
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_INF = -1e30f;

struct FlashBwdParams {
  const void* q;
  const void* k;
  const void* v;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs;  // batch / row strides (elements)
  const void* dout;                                // (b, n, heads*dh) contiguous
  const unsigned char* mask;                       // (b, n) bool or null
  const void* gate;                                // (b, n, heads) logits or null
  const float* lse;                                // (b*heads, n), from K1
  const float* delta;                              // (b, n, heads) rowsum(do * o)
  float* dq;                                       // (b, n, heads*dh) f32, zeroed
  void* dk;                                        // (b, n, heads*dh)
  void* dv;
  int b, n, heads;
  float scale, softclamp, inv_keep;
  unsigned seed, threshold;
  int dropping;
};

constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

template <typename T, int DH>
struct Layout {
  static constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int LDT = kBf16 ? DH + 8 : DH + 1;  // q / k / v / do tiles
  static constexpr int LDS = BQ + 4;                   // f32 score tiles (per warp)
  static constexpr int LDO = DH + 4;                   // f32 staging of dq/dk/dv rows
  static constexpr int LDP = kBf16 ? BQ + 8 : BQ + 1;  // p^T and ds^T (keys x queries)
  // per-warp f32 region: s^T and dp^T (16 x LDS each), reused as dq staging
  static constexpr int FW0 = 2 * 16 * LDS > 16 * LDO ? 2 * 16 * LDS : 16 * LDO;
  static constexpr int FW = (FW0 + 7) / 8 * 8;
  static constexpr size_t tile = (size_t)64 * LDT;
  static constexpr size_t f_off = align128(4 * tile * sizeof(T));
  static constexpr size_t p_off = f_off + align128((size_t)NWARPS * FW * sizeof(float));
  static constexpr size_t ds_off = p_off + align128((size_t)BK * LDP * sizeof(T));
  static constexpr size_t vec_off = ds_off + align128((size_t)BK * LDP * sizeof(T));
  static constexpr size_t bytes = vec_off + (BK + 2 * BQ) * sizeof(float);
};

// rows [r0, r0 + 64) of a (n, DH) slab with row stride rs -> smem (pitch LDT);
// rows past n are zero. `gate` (optional, per row) scales each row first and
// the product is rounded to T, as the TPU kernel gates do.
template <typename T, int DH, int LDT>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long rs, int r0, int n,
                                          int tid, const float* row_gate = nullptr) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = DH / VEC;
  for (int idx = tid; idx < 64 * VPR; idx += NTHREADS) {
    const int r = idx / VPR, cv = idx % VPR;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n) val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * rs + cv * VEC);
    const T* e = reinterpret_cast<const T*>(&val);
    const float g = row_gate != nullptr ? row_gate[r] : 1.f;
#pragma unroll
    for (int t = 0; t < VEC; ++t)
      dst[r * LDT + cv * VEC + t] =
          row_gate != nullptr ? e2::from_float<T>(e2::to_float<T>(e[t]) * g) : e[t];
  }
}

// C (16 x 64, f32, pitch LDS) = A (16 x DH rows of pitch LDT) . B^T, B = 64 rows x DH
template <typename T, int DH>
__device__ __forceinline__ void warp_abt(const T* A, const T* B, float* C, int lane) {
  using L = Layout<T, DH>;
  if constexpr (L::kBf16) {
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::fill_fragment(c, 0.f);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
        wmma::load_matrix_sync(a, A + kk * 16, L::LDT);
        wmma::load_matrix_sync(b, B + j * 16 * L::LDT + kk * 16, L::LDT);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(C + j * 16, c, L::LDS, wmma::mem_row_major);
    }
  } else {
    for (int r = 0; r < 16; ++r) {
      float s0 = 0.f, s1 = 0.f;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) {
        const float av = A[r * L::LDT + d];
        s0 = fmaf(av, B[lane * L::LDT + d], s0);
        s1 = fmaf(av, B[(lane + 32) * L::LDT + d], s1);
      }
      C[r * L::LDS + lane] = s0;
      C[r * L::LDS + lane + 32] = s1;
    }
  }
}

// A warp's 16 x DH f32 accumulator: wmma fragments (bf16) or per-lane
// registers (f32: lane owns columns lane + 32 i of all 16 rows).
template <typename T, int DH, bool BF16 = Layout<T, DH>::kBf16>
struct WarpAcc;

template <typename T, int DH>
struct WarpAcc<T, DH, true> {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> f[DH / 16];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < DH / 16; ++j) wmma::fill_fragment(f[j], 0.f);
  }
  // += A (16 x 64, element (r, c) at A[r * ars + c * acs]) . B (64 x DH, pitch ldb)
  template <bool A_COL>
  __device__ __forceinline__ void mma(const T* A, int lda, const T* B, int ldb, int lane) {
#pragma unroll
    for (int kk = 0; kk < 64 / 16; ++kk) {
      using ALayout = typename std::conditional<A_COL, wmma::col_major, wmma::row_major>::type;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, ALayout> a;
      wmma::load_matrix_sync(a, A_COL ? A + kk * 16 * lda : A + kk * 16, lda);
#pragma unroll
      for (int j = 0; j < DH / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(b, B + kk * 16 * ldb + j * 16, ldb);
        wmma::mma_sync(f[j], a, b, f[j]);
      }
    }
  }
  __device__ __forceinline__ void store(float* dst, int ld, int lane) {
#pragma unroll
    for (int j = 0; j < DH / 16; ++j) wmma::store_matrix_sync(dst + j * 16, f[j], ld, wmma::mem_row_major);
  }
};

template <typename T, int DH>
struct WarpAcc<T, DH, false> {
  float f[16][DH / 32];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int r = 0; r < 16; ++r)
#pragma unroll
      for (int i = 0; i < DH / 32; ++i) f[r][i] = 0.f;
  }
  template <bool A_COL>
  __device__ __forceinline__ void mma(const T* A, int lda, const T* B, int ldb, int lane) {
    for (int kk = 0; kk < 64; ++kk) {
      float bv[DH / 32];
#pragma unroll
      for (int i = 0; i < DH / 32; ++i) bv[i] = e2::to_float<T>(B[kk * ldb + lane + 32 * i]);
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float av = e2::to_float<T>(A_COL ? A[kk * lda + r] : A[r * lda + kk]);
#pragma unroll
        for (int i = 0; i < DH / 32; ++i) f[r][i] = fmaf(av, bv[i], f[r][i]);
      }
    }
  }
  __device__ __forceinline__ void store(float* dst, int ld, int lane) {
#pragma unroll
    for (int r = 0; r < 16; ++r)
#pragma unroll
      for (int i = 0; i < DH / 32; ++i) dst[r * ld + lane + 32 * i] = f[r][i];
  }
};

// a warp's 16 x DH accumulator -> rows [row0, row0 + 16) (< n) of dst (row
// stride ld), rounded to T, through the warp's f32 staging area
template <typename T, int DH>
__device__ __forceinline__ void store_rows(WarpAcc<T, DH>& acc, float* stage, T* dst,
                                           long long ld, int row0, int n, int lane) {
  using L = Layout<T, DH>;
  __syncwarp();
  acc.store(stage, L::LDO, lane);
  __syncwarp();
  for (int idx = lane; idx < 16 * DH; idx += 32) {
    const int r = idx / DH, c = idx % DH;
    if (row0 + r < n) dst[(long long)(row0 + r) * ld + c] = e2::from_float<T>(stage[r * L::LDO + c]);
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_kernel(FlashBwdParams p) {
  using L = Layout<T, DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + L::tile;
  T* sQ = sV + L::tile;
  T* sDO = sQ + L::tile;
  float* sF = reinterpret_cast<float*>(smem + L::f_off);
  T* sP = reinterpret_cast<T*>(smem + L::p_off);    // p_drop^T: keys x queries
  T* sDS = reinterpret_cast<T*>(smem + L::ds_off);  // ds^T: keys x queries
  float* sBias = reinterpret_cast<float*>(smem + L::vec_off);
  float* sLse = sBias + BK;
  float* sDelta = sLse + BQ;
  __shared__ float sGate[BQ];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k0 = blockIdx.x * BK, h = blockIdx.y, bi = blockIdx.z;
  const int n = p.n, H = p.heads;
  const long long D = (long long)H * DH;
  const T* qg = static_cast<const T*>(p.q) + bi * p.q_bs + (long long)h * DH;
  const T* kg = static_cast<const T*>(p.k) + bi * p.k_bs + (long long)h * DH;
  const T* vg = static_cast<const T*>(p.v) + bi * p.v_bs + (long long)h * DH;
  const T* dog = static_cast<const T*>(p.dout) + (long long)bi * n * D + (long long)h * DH;

  load_tile<T, DH, L::LDT>(sK, kg, p.k_rs, k0, n, tid);
  load_tile<T, DH, L::LDT>(sV, vg, p.v_rs, k0, n, tid);
  if (tid < BK) {
    const int col = k0 + tid;
    float bias = NEG_INF;  // keys past n: probability exactly 0
    if (col < n) bias = (p.mask == nullptr || p.mask[(long long)bi * n + col]) ? 0.f : NEG_INF;
    sBias[tid] = bias;
  }

  WarpAcc<T, DH> dk_acc, dv_acc;
  dk_acc.zero();
  dv_acc.zero();

  const unsigned hseed = e2::fmix32(p.seed ^ ((unsigned)(bi * H + h) * 0x27D4EB2Fu), 2);
  const T* sKw = sK + warp * 16 * L::LDT;
  const T* sVw = sV + warp * 16 * L::LDT;
  float* sFw = sF + warp * L::FW;
  float* sSw = sFw;                  // s^T of this warp's 16 keys
  float* sDPw = sFw + 16 * L::LDS;   // dp^T
  const int key_local = warp * 16 + (lane >> 1);
  const int key_abs = k0 + key_local;
  const int half = lane & 1;

  const int num_qt = (n + BQ - 1) / BQ;
  for (int qt = 0; qt < num_qt; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // every warp is done with the previous query tile
    if (tid < BQ) {
      const int row = q0 + tid;
      float g = 1.f;
      if (p.gate != nullptr && row < n) {
        g = e2::to_float<T>(static_cast<const T*>(p.gate)[((long long)bi * n + row) * H + h]);
        g = 1.f / (1.f + expf(-g));
      }
      sGate[tid] = g;
      // rows past n: p = exp(... - 1e30) = 0 and delta 0, so they add nothing
      sLse[tid] = row < n ? p.lse[((long long)bi * H + h) * n + row] : -NEG_INF;
      sDelta[tid] = row < n ? p.delta[((long long)bi * n + row) * H + h] : 0.f;
    }
    load_tile<T, DH, L::LDT>(sQ, qg, p.q_rs, q0, n, tid);
    __syncthreads();  // sGate ready for the gated do load
    load_tile<T, DH, L::LDT>(sDO, dog, D, q0, n, tid, p.gate != nullptr ? sGate : nullptr);
    __syncthreads();

    warp_abt<T, DH>(sKw, sQ, sSw, lane);   // s^T = k q^T
    warp_abt<T, DH>(sVw, sDO, sDPw, lane);  // dp^T = v do^T
    __syncwarp();

    // a lane pair owns one key row; `half` picks its 32 query columns
    const float bias = sBias[key_local];
    const float* srow = sSw + (lane >> 1) * L::LDS + half * 32;
    const float* dprow = sDPw + (lane >> 1) * L::LDS + half * 32;
    T* prow = sP + key_local * L::LDP + half * 32;
    T* dsrow = sDS + key_local * L::LDP + half * 32;
#pragma unroll 4
    for (int j = 0; j < 32; ++j) {
      const int c = half * 32 + j;
      float s = srow[j] * p.scale;
      float jac = 1.f;
      if (p.softclamp > 0.f) {
        const float th = tanhf(s / p.softclamp);
        s = th * p.softclamp;
        jac = 1.f - th * th;
      }
      s += bias;
      float pr = expf(s - sLse[c]);
      const float dp = dprow[j];
      float ds;
      if (p.dropping) {
        const unsigned u = e2::fmix32(
            hseed + (unsigned)(q0 + c) * 0x9E3779B1u + (unsigned)key_abs * 0x85EBCA77u, 1);
        const float ks = (u >= p.threshold) ? p.inv_keep : 0.f;
        ds = pr * (ks * dp - sDelta[c]);
        pr = pr * ks;
      } else {
        ds = pr * (dp - sDelta[c]);
      }
      ds = ds * jac;
      ds = ds * p.scale;
      prow[j] = e2::from_float<T>(pr);
      dsrow[j] = e2::from_float<T>(ds);
    }
    __syncwarp();

    // this warp's keys: dv += p_drop^T do, dk += ds^T q
    dv_acc.template mma<false>(sP + warp * 16 * L::LDP, L::LDP, sDO, L::LDT, lane);
    dk_acc.template mma<false>(sDS + warp * 16 * L::LDP, L::LDP, sQ, L::LDT, lane);
    __syncthreads();  // ds^T complete for all 64 keys

    // this warp's 16 query rows: dq = ds k, ds read transposed from ds^T
    {
      WarpAcc<T, DH> dq_acc;
      dq_acc.zero();
      dq_acc.template mma<true>(sDS + warp * 16, L::LDP, sK, L::LDT, lane);
      dq_acc.store(sFw, L::LDO, lane);  // s^T / dp^T of this warp are consumed
    }
    __syncwarp();
    for (int idx = lane; idx < 16 * DH; idx += 32) {
      const int r = idx / DH, c = idx % DH;
      const int row = q0 + warp * 16 + r;
      if (row < n) atomicAdd(p.dq + ((long long)bi * n + row) * D + (long long)h * DH + c, sFw[r * L::LDO + c]);
    }
    __syncwarp();
  }

  // dk, dv rows of this warp's 16 keys
  const long long base = (long long)bi * n * D + (long long)h * DH;
  store_rows<T, DH>(dk_acc, sFw, static_cast<T*>(p.dk) + base, D, k0 + warp * 16, n, lane);
  store_rows<T, DH>(dv_acc, sFw, static_cast<T*>(p.dv) + base, D, k0 + warp * 16, n, lane);
}

template <typename T, int DH>
cudaError_t launch(const FlashBwdParams& p, cudaStream_t stream) {
  using L = Layout<T, DH>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_kernel<T, DH>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)L::bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((p.n + BK - 1) / BK, p.heads, p.b);
  flash_bwd_kernel<T, DH><<<grid, NTHREADS, L::bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(const FlashBwdParams& p, int dh, cudaStream_t stream) {
  switch (dh) {
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

// K10: K2's pre-pass delta = rowsum(do * o) per head. Replaces the TPU
// kernel e2_tts_tpu/ops/flash_attention.py::_delta_kernel (driven by
// _delta_bnh_pallas). o and do are contiguous (rows, heads * dh); delta is
// (rows, heads) f32.
//
// What bounds it: bytes. It reads o and do once (two bf16 values per product,
// 2 flops) and writes one f32 per (row, head): at the trainer's shape
// (16, 1056, 8 x 64) bf16 that is ~35 MB, ~10.5 us at 3.35 TB/s. Design: one
// thread per 16-byte chunk of a row (8 bf16 or 4 f32 lanes), the chunk's
// products summed in f32, then the dh / VEC lanes of a head (consecutive
// lanes of one warp, a power of two) summed by xor shuffles; the head's
// first lane writes. Loads are 16 bytes a thread on neighbouring addresses.
// The TPU kernel's lane contraction on the MXU (a 0/1 segment matrix) has
// no point here: a shuffle tree is the warp's native segmented sum.
template <typename T>
__global__ void __launch_bounds__(256) flash_delta_kernel(const T* o, const T* dout, float* delta,
                                                          long long chunks, int chunks_per_row,
                                                          int lanes_per_head, int heads) {
  constexpr int VEC = 16 / sizeof(T);
  // every lane of a warp runs the same iterations, so the shuffles see all 32
  const long long padded = (chunks + 31) / 32 * 32;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x; c < padded; c += stride) {
    float sum = 0.f;
    if (c < chunks) {
      const uint4 ov = reinterpret_cast<const uint4*>(o)[c];
      const uint4 dv = reinterpret_cast<const uint4*>(dout)[c];
      const T* oe = reinterpret_cast<const T*>(&ov);
      const T* de = reinterpret_cast<const T*>(&dv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) sum = fmaf(e2::to_float<T>(de[e]), e2::to_float<T>(oe[e]), sum);
    }
    for (int off = lanes_per_head / 2; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (c < chunks && c % lanes_per_head == 0) {
      const long long row = c / chunks_per_row;
      delta[row * heads + (int)(c % chunks_per_row) / lanes_per_head] = sum;
    }
  }
}

template <typename T>
cudaError_t launch_delta(const void* o, const void* dout, void* delta, long long rows, int heads,
                         int dh, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int lanes_per_head = dh / VEC;
  if (dh % VEC != 0 || lanes_per_head < 1 || 32 % lanes_per_head != 0)
    return cudaErrorInvalidValue;
  const int chunks_per_row = heads * lanes_per_head;
  const long long chunks = rows * chunks_per_row;
  if (chunks == 0) return cudaSuccess;
  long long blocks = (chunks + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  flash_delta_kernel<T><<<(unsigned)blocks, 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), static_cast<float*>(delta), chunks,
      chunks_per_row, lanes_per_head, heads);
  return cudaGetLastError();
}

}  // namespace

extern "C" int e2_flash_delta(const void* o, const void* dout, void* delta, long long rows,
                              int heads, int dh, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == e2::kBFloat16) err = launch_delta<__nv_bfloat16>(o, dout, delta, rows, heads, dh, s);
  else if (dtype == e2::kFloat32) err = launch_delta<float>(o, dout, delta, rows, heads, dh, s);
  else err = cudaErrorInvalidValue;
  return (int)err;
}

extern "C" int e2_flash_bwd(const void* q, const void* k, const void* v, long long q_bs,
                            long long q_rs, long long k_bs, long long k_rs, long long v_bs,
                            long long v_rs, const void* dout, const void* mask, const void* gate,
                            const void* lse, const void* delta, void* dq, void* dk, void* dv,
                            int b, int n, int heads, int dh, float scale, float softclamp,
                            float inv_keep, unsigned seed, unsigned threshold, int dropping,
                            int dtype, void* stream) {
  FlashBwdParams p;
  p.q = q; p.k = k; p.v = v;
  p.q_bs = q_bs; p.q_rs = q_rs; p.k_bs = k_bs; p.k_rs = k_rs; p.v_bs = v_bs; p.v_rs = v_rs;
  p.dout = dout;
  p.mask = static_cast<const unsigned char*>(mask);
  p.gate = gate;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = static_cast<float*>(dq);
  p.dk = dk; p.dv = dv;
  p.b = b; p.n = n; p.heads = heads;
  p.scale = scale; p.softclamp = softclamp; p.inv_keep = inv_keep;
  p.seed = seed; p.threshold = threshold; p.dropping = dropping;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == e2::kBFloat16) err = dispatch_dh<__nv_bfloat16>(p, dh, s);
  else if (dtype == e2::kFloat32) err = dispatch_dh<float>(p, dh, s);
  else err = cudaErrorInvalidValue;
  return (int)err;
}
