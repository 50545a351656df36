// K5 and K3 for Hopper (and their save-state variants K5s / K3s, the SAVE
// flag): the hyper-connection width connection on bf16 streams at 4 streams,
// the count every configuration of the repo runs, at any width from 1 to
// 5120. The math (and what each TPU kernel it replaces computes) is written
// out in hyper_conn.cuh, whose templates keep f32 and the other stream
// counts; `width_run` below, which hyper_conn.cu's and hyper_conn_save.cu's
// entry points call, chooses this design from the dtype and the stream count.
//
// What bounds it: bytes. Per row K5 reads 4 d bf16 values and writes 5 d + 4,
// K3 reads 5 d + 4 and writes the same; ~100 f32 operations per column. The
// template of hyper_conn.cuh gave one warp a whole row in registers (128
// floats a lane at d = 1024, one 8-warp block an SM), read and wrote 2-byte
// scalars, read its weights from shared memory per element and ran seven
// dependent warp sums per stream. Here, as in the adjoint's Hopper design
// (hyper_conn_bwd_sm90.cuh, whose geometry and helpers it shares):
//  - A team of warps owns a row, each thread one 8-column chunk (two past d
//    = 2048): 128 threads at d = 1024, 160 (144 chunks) at 1152. Narrow rows
//    put several teams in a block of at least four warps; each team
//    synchronises on its own named barrier.
//  - A thread copies its chunks of a row's streams (and K3's branch) with
//    16-byte cp.async into its own slots of a three-stage shared-memory
//    ring: two rows are in flight while one computes, and no barrier guards
//    the ring. Other widths or alignments copy 8-, 4- or 2-byte pieces, a
//    chunk past d zero-filled. K3 forms round(carried + round(branch beta))
//    once, with bf16x2 multiplies and adds rounded to nearest (the f32
//    product and sum of two bf16 values are exact, so this is the
//    reference's rounding), and writes it back into its ring slots.
//  - Two reductions a row over the team. The four sums of squares: f32 FMAs,
//    a warp reduce-scatter by shuffles, the team's warps in shared memory.
//    The 24 projections n_s W, n_s = round(r_s round(inv_s)) (a bf16x2
//    multiply a pair), on the tensor cores: each thread writes its normed
//    chunks to the team's rows in shared memory (a stream's row one chunk
//    on from the last, so ldmatrix meets no bank conflict), and each warp
//    runs mma.m16n8k16 over its own 256 columns, the streams as A's rows
//    and the weights, rounded to bf16, as B fragments held in registers for
//    the whole kernel. The products are exact, the sums f32: the warp's sums
//    come out of the accumulators with no shuffles, and the team's warps
//    meet in shared memory. On f32 FMAs the projection took half of a
//    thread's instructions a row, with a 31-shuffle reduce-scatter, and
//    spilled at 128 registers. The tensor cores sum in another order than
//    the adjoint's recompute: K3s / K5s save the inv that K4 / K5b
//    recompute (by construction), not their ta.
//  - Lane s (s+2) + c evaluates tanh, alpha and beta of its (stream,
//    column) once for the warp and hands the alphas on through shared
//    memory. The mix goes out in 16-byte stores of the branch input and the
//    four carried rows; beta (and K3s / K5s's ta and inv) once a row.
//  - `__launch_bounds__(256, 2)`: 128 registers, no spill, at one chunk a
//    thread (every width to 2048): four 128-thread blocks an SM at d = 1024,
//    three 160-thread ones at 1152. The grid is what the SMs hold at once,
//    each block walking rows with a stride of the grid.
// Rounding is the reference's (bf16 at the depth connection, inv, n, alpha,
// beta and the outputs), sums in f32.
#pragma once

#include "hyper_conn.cuh"
#include "hyper_conn_sm90_common.cuh"

namespace {
namespace hc_sm90 {

constexpr int FWD_STAGES = 3;       // ring stages: two rows in flight
constexpr int FWD_RED = NS + NV;    // floats a warp hands its team: sums of squares, projections
constexpr int NA = NS * (NS + 1);   // a row's alphas

// round(a b) and round(a + b) on bf16 pairs, each rounded to nearest (an
// explicit rounding: never contracted into one fma)
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// d += a b on the tensor cores: A 16 x 16 (rows 8-15 zero), B 16 x 8, bf16, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a2, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

// two 8 x 8 bf16 matrices from shared memory, rows addressed by lanes 0-15
__device__ __forceinline__ void ldmatrix_x2(uint32_t& r0, uint32_t& r1, const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_addr(row)));
}

__device__ __forceinline__ uint32_t word(const uint4& u, int k) {
  return k == 0 ? u.x : k == 1 ? u.y : k == 2 ? u.z : u.w;
}

// One block: `teams(d)` teams of `tw` warps; team i walks rows blockIdx.x *
// teams + i + k * gridDim.x * teams. J chunks of 8 columns a thread.
template <bool FUSED, bool SAVE, int J>
__global__ void __launch_bounds__(J == 1 ? 256 : MAX_THREADS, J == 1 ? 2 : 1)
    hc_fwd_sm90_kernel(HcParams p, int tw, int vec) {
  constexpr int NSLOT = FUSED ? NS + 1 : NS;  // the streams, K3's branch
  const int d = p.d;
  const int M = (int)p.m;  // rows are ints (fwd_run refuses 2^31 - 2^16 or more)
  const int T = tw * 32;
  const int R = blockDim.x / T;
  const int team = threadIdx.x / T, tt = threadIdx.x % T;
  const int wt = tt >> 5, lane = threadIdx.x & 31;
  const int slots = J * T;
  const int nchunk = chunks(d);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint4* ring = reinterpret_cast<uint4*>(smem_raw);  // (R, stages, NSLOT, slots)
  float* red = reinterpret_cast<float*>(ring + (size_t)R * FWD_STAGES * NSLOT * slots);
  float* red1 = red + team * tw * FWD_RED;  // the team's (tw, NS) sums of squares
  float* red2 = red1 + tw * NS;             // and (tw, NV) projections
  float* wb = red + R * tw * FWD_RED + (threadIdx.x >> 5) * NA;  // the warp's alphas (t, s)
  // the team's normed rows, (NS, slots + 1) chunks: a stream's row one chunk
  // on from the last, so the four rows of an ldmatrix sit in other banks
  const int nstride = slots + 1;
  uint4* nrm = reinterpret_cast<uint4*>(red + R * tw * FWD_RED + (blockDim.x >> 5) * NA) +
               (size_t)team * NS * nstride;

  const bf16* in0 = static_cast<const bf16*>(p.in0);
  const bf16* in1 = static_cast<const bf16*>(p.in1);
  const bf16* in2 = static_cast<const bf16*>(p.in2);
  bf16* out_branch = static_cast<bf16*>(p.out_branch);
  bf16* out_carried = static_cast<bf16*>(p.out_carried);
  bf16* out_beta = static_cast<bf16*>(p.out_beta);

  // this thread's chunks: columns 8 q .. 8 q + 7 of chunk q = j T + tt
  int col0[J], nval[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int q = j * T + tt;
    col0[j] = 8 * q;
    nval[j] = q < nchunk ? min(8, d - 8 * q) : 0;
  }
  // the weights, rounded to bf16, as the tensor cores' B fragments: k-block
  // i of chunk set j covers the warp's chunks 2 i, 2 i + 1 (columns c0 ..
  // c0 + 15); lane (g, t) holds W[c0 + 2t, +1][g] and W[c0 + 8 + 2t, +1][g],
  // zero for g >= NC or a column past d
  auto weight = [&](int col, int c) {
    return col < d && c < NC ? (c <= NS ? p.aw[col * (NS + 1) + c] : p.bw[col]) : 0.f;
  };
  uint32_t wf[J][16][2];
  {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int c0 = 8 * (j * T + wt * 32 + 2 * i) + 2 * t;
        wf[j][i][0] = pack(weight(c0, g), weight(c0 + 1, g));
        wf[j][i][1] = pack(weight(c0 + 8, g), weight(c0 + 9, g));
      }
  }
  // chunks past d read as zero normed values
#pragma unroll
  for (int j = 0; j < J; ++j)
    if (nval[j] == 0)
#pragma unroll
      for (int s = 0; s < NS; ++s) nrm[s * nstride + j * T + tt] = make_uint4(0, 0, 0, 0);

  // lane s NC + c of each warp evaluates (stream s, column c) of the scalar
  // stage: its scale and static
  const int ls = lane / NC, lc = lane % NC;
  const bool lval = lane < NV;
  const float scl = lc == NS + 1 ? *p.bscale : *p.ascale;
  const float stat = !lval ? 0.f : lc <= NS ? p.sa[ls * (NS + 1) + lc] : p.sb[ls];

  const int team_id = blockIdx.x * R + team;
  const int nteams = gridDim.x * R;
  auto slot = [&](int st) {  // this thread's slots of ring stage st
    return ring + (size_t)(team * FWD_STAGES + st) * NSLOT * slots + tt;
  };
  // this thread's chunks of the row's streams (and branch) into stage st
  auto issue = [&](int row, int st) {
    uint4* base = slot(st);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (nval[j] == 0) continue;
      uint4* dst = base + j * T;
#pragma unroll
      for (int s = 0; s < NS; ++s)
        copy_chunk(dst + s * slots, in0 + ((long long)s * M + row) * d + col0[j], nval[j], vec);
      if constexpr (FUSED)
        copy_chunk(dst + NS * slots, in1 + (long long)row * d + col0[j], nval[j], vec);
    }
    cp_commit();
  };
  // K3: the row's previous betas as two bf16 pairs (s, s+1)
  auto betas = [&](int row, uint32_t (&bp)[NS / 2]) {
#pragma unroll
    for (int s = 0; s < NS; s += 2)
      bp[s / 2] = (uint32_t)__bfloat16_as_ushort(in2[(long long)s * M + row]) |
                  (uint32_t)__bfloat16_as_ushort(in2[(long long)(s + 1) * M + row]) << 16;
  };

  int row = team_id;
#pragma unroll
  for (int k = 0; k < FWD_STAGES - 1; ++k) {
    if (row + k * nteams < M) issue(row + k * nteams, k);
    else cp_commit();
  }
  uint32_t bprev[NS / 2] = {};
  if (FUSED && row < M) betas(row, bprev);

  for (int k = 0; row < M; ++k, row += nteams) {
    const int ahead = row + (FWD_STAGES - 1) * nteams;
    if (ahead < M) issue(ahead, (k + FWD_STAGES - 1) % FWD_STAGES);
    else cp_commit();
    cp_wait<FWD_STAGES - 1>();
    uint4* buf = slot(k % FWD_STAGES);  // chunk j's slot i: buf[i * slots + j * T]

    // round 1: the sums of squares; K3 first forms r in place
    float sq[NS] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (nval[j] == 0) continue;
      uint4 br;
      if constexpr (FUSED) br = buf[NS * slots + j * T];
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        uint4 u = buf[s * slots + j * T];
        if constexpr (FUSED) {
          const uint32_t b = (s & 1) ? (bprev[s / 2] >> 16) * 0x10001u
                                     : (bprev[s / 2] & 0xffffu) * 0x10001u;
          u.x = add_bf16x2(u.x, mul_bf16x2(br.x, b));
          u.y = add_bf16x2(u.y, mul_bf16x2(br.y, b));
          u.z = add_bf16x2(u.z, mul_bf16x2(br.z, b));
          u.w = add_bf16x2(u.w, mul_bf16x2(br.w, b));
          buf[s * slots + j * T] = u;
        }
#pragma unroll
        for (int k2 = 0; k2 < 4; ++k2) {
          const float a = lo(word(u, k2)), b2 = hi(word(u, k2));
          sq[s] = fmaf(a, a, sq[s]);
          sq[s] = fmaf(b2, b2, sq[s]);
        }
      }
    }
    halve<NS, 16>(sq, lane);  // lanes 8 s .. 8 s + 7: stream s's warp sum
    if ((lane & 7) == 0) red1[wt * NS + (lane >> 3)] = sq[0];
    team_sync(team + 1, T);
    // the rms reciprocal of stream (lane & 3), in the adjoint's order, then
    // to every lane
    float inv_l;
    {
      float tot = 0.f;
      for (int i = 0; i < tw; ++i) tot += red1[i * NS + (lane & 3)];
      inv_l = rsqrtf(fmaxf(tot / d, 1e-12f));
    }
    float inv[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) inv[s] = __shfl_sync(0xffffffffu, inv_l, s);

    // round 2: the projection n_s W on the tensor cores, n_s = round(r_s
    // round(inv_s)) (one bf16x2 multiply a pair) through the warp's normed
    // rows in shared memory: A rows 0-3 the streams (4-7 the same again,
    // 8-15 zero), k 16 columns, B the weights; lane (g < 4, t < 3) ends with
    // the warp's sums of (stream g, columns 2t, 2t + 1)
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (nval[j] == 0) continue;
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const uint4 u = buf[s * slots + j * T];
        const uint32_t ir = pack(inv[s], inv[s]);
        nrm[s * nstride + j * T + tt] = make_uint4(mul_bf16x2(u.x, ir), mul_bf16x2(u.y, ir),
                                                   mul_bf16x2(u.z, ir), mul_bf16x2(u.w, ir));
      }
    }
    __syncwarp();
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    {
      // lane l < 16 addresses row (l & 3) of matrix l >> 3 (chunk 2 i + l >> 3)
      const uint4* arow = nrm + (lane & 3) * nstride + wt * 32 + ((lane >> 3) & 1);
#pragma unroll
      for (int j = 0; j < J; ++j)
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          uint32_t a0, a2;
          ldmatrix_x2(a0, a2, arow + j * T + 2 * i);
          mma_bf16(acc, a0, a2, wf[j][i][0], wf[j][i][1]);
        }
    }
    if (lane < 16 && (lane & 3) < 3)
      *reinterpret_cast<float2*>(red2 + wt * NV + (lane >> 2) * NC + 2 * (lane & 3)) =
          make_float2(acc[0], acc[1]);
    team_sync(team + 1, T);
    float tot2 = 0.f;
    for (int i = 0; i < tw; ++i) tot2 += lval ? red2[i * NV + lane] : 0.f;

    // the next row's betas, in flight while this row finishes
    uint32_t bnext[NS / 2] = {};
    if (FUSED && row + nteams < M) betas(row + nteams, bnext);

    // the scalar stage of lane s NC + c: tanh, alpha or beta (and the state)
    {
      const float ta = tanhf(tot2);
      const float y = ta * scl + stat;
      if (lval) {
        if (lc <= NS) wb[lc * NS + ls] = round_bf16(y);
        if (wt == 0) {
          if (lc == NS + 1) out_beta[(long long)ls * M + row] = __float2bfloat16(y);
          if constexpr (SAVE) p.ta[((long long)ls * M + row) * NC + lc] = ta;
        }
      }
      if constexpr (SAVE) {
        if (wt == 0 && lane < NS) p.inv[(long long)lane * M + row] = inv_l;
      }
      __syncwarp();
    }

    // the mix: output t = sum_s alpha_s[t] r_s, 16-byte stores
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (nval[j] == 0) continue;
      float r[NS][8];
#pragma unroll
      for (int s = 0; s < NS; ++s) unpack8(buf[s * slots + j * T], r[s]);
#pragma unroll
      for (int t = 0; t <= NS; ++t) {
        const float4 a4 = *reinterpret_cast<const float4*>(wb + t * NS);
        const float al[NS] = {a4.x, a4.y, a4.z, a4.w};
        float o[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          o[e] = 0.f;
#pragma unroll
          for (int s = 0; s < NS; ++s) o[e] = fmaf(al[s], r[s][e], o[e]);
        }
        bf16* dst = t == 0 ? out_branch + (long long)row * d
                           : out_carried + ((long long)(t - 1) * M + row) * d;
        store_chunk(dst + col0[j], pack8(o), nval[j], vec);
      }
    }
#pragma unroll
    for (int s = 0; s < NS / 2; ++s) bprev[s] = bnext[s];
  }
}

// ---------------------------------------------------------------- launch

// shared memory of a block: the teams' rings and reductions, the warps' alphas and
// the teams' normed rows
inline size_t fwd_smem_bytes(bool fused, int d) {
  const int tw = team_warps(d), r = teams(d), slots = per_thread(d) * tw * 32;
  const size_t nslot = fused ? NS + 1 : NS;
  return (size_t)r * FWD_STAGES * nslot * slots * sizeof(uint4) +
         ((size_t)r * tw * FWD_RED + (size_t)r * tw * NA) * sizeof(float) +
         (size_t)r * NS * (slots + 1) * sizeof(uint4);
}

// the widest piece (8, 4, 2 or 1 columns) every row read or written in
// chunks is aligned to
inline int fwd_vec_width(const HcParams& p, bool fused) {
  uintptr_t a = (uintptr_t)p.in0 | (uintptr_t)p.out_branch | (uintptr_t)p.out_carried;
  if (fused) a |= (uintptr_t)p.in1;
  int v = 8;
  while (v > 1 && (p.d % v != 0 || a % (2 * v) != 0)) v >>= 1;
  return v;
}

template <bool FUSED, bool SAVE, int J>
cudaError_t fwd_launch(const HcParams& p, cudaStream_t stream) {
  auto kernel = hc_fwd_sm90_kernel<FUSED, SAVE, J>;
  const size_t smem = fwd_smem_bytes(FUSED, p.d);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  // set once, outside any CUDA-graph capture that later launches replay
  static bool configured = false;
  cudaError_t err;
  if (!configured) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int threads = block_warps(p.d) * 32;
  // blocks an SM holds at this width, asked once per width
  static int known_d[16], known_blocks[16], nknown = 0;
  int per_sm = 0;
  for (int i = 0; i < nknown; ++i)
    if (known_d[i] == p.d) per_sm = known_blocks[i];
  if (per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    if (nknown < 16) known_d[nknown] = p.d, known_blocks[nknown++] = per_sm;
  }
  const long long rows = (p.m + teams(p.d) - 1) / teams(p.d);
  const int grid = (int)std::max(1LL, std::min((long long)per_sm * sm_count(), rows));
  kernel<<<grid, threads, smem, stream>>>(p, team_warps(p.d), fwd_vec_width(p, FUSED));
  return cudaGetLastError();
}

// bf16 at 4 streams: block_warps(d) warps a block
template <bool SAVE>
int fwd_run(const HcParams& p, bool fused, void* stream) {
  if (p.d < 1 || block_warps(p.d) * 32 > MAX_THREADS || p.m < 0 ||
      p.m >= (1LL << 31) - (1LL << 16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (per_thread(p.d) == 1)
    return (int)(fused ? fwd_launch<true, SAVE, 1>(p, st) : fwd_launch<false, SAVE, 1>(p, st));
  return (int)(fused ? fwd_launch<true, SAVE, 2>(p, st) : fwd_launch<false, SAVE, 2>(p, st));
}

}  // namespace hc_sm90

// K5 / K3 (K5s / K3s with SAVE): the design from the dtype and the stream
// count; bf16 at 4 streams runs the Hopper design above, the rest the
// templates of hyper_conn.cuh
template <bool SAVE>
int width_run(const HcParams& p, int s, bool fused, int dtype, void* stream) {
  if (dtype == e2::kBFloat16 && s == 4) return hc_sm90::fwd_run<SAVE>(p, fused, stream);
  return fwd_run<SAVE>(p, s, fused, dtype, stream);
}

}  // namespace
