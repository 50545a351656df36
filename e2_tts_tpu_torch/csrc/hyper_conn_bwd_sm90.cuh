// K5b and K4 for Hopper, and with the SAVE flag their save-state variants
// K5bs and K4s: the adjoints of the hyper-connection width connection on
// bf16 streams at 4 streams, the count every configuration of the repo runs,
// at any width from 1 to 5120. They port the chain rule of
// e2_tts_tpu/ops/hyper_conn_kernel.py::_width_bwd_core and
// ::_fused_bwd_epilogue, and the save path's state reads (the math is
// written out in hyper_conn_bwd.cuh, whose templates keep f32 and the other
// stream counts); the entry points of hyper_conn_bwd.cu (SAVE = false) and
// hyper_conn_bwd_save.cu (SAVE = true) choose this design from the dtype and
// the stream count.
//
// What bounds them: bytes (per row K5b moves 13 d bf16 values, K4 15 d + 12)
// and, close behind, the f32 arithmetic: ~36 FMAs per element and stream, a
// third of them in the three small products n W, W gp and n^T gp. The
// template of hyper_conn_bwd.cuh gave one warp a whole row in registers
// (128 floats a lane at d = 1024, 255 registers and 2.1-2.3 KB of spill),
// kept a (s+2, d) weight-grad partial per warp in shared memory (one
// 8-warp block an SM), loaded 2-byte scalars, read the incoming grads twice
// and formed W gp twice. Here:
//  - A team of warps owns a row, each thread one 8-column chunk (two past d
//    = 2048): 128 threads at d = 1024, 160 at 1152. Narrow rows put several
//    teams (rows at once) in a block of at least four warps; each team
//    synchronises on its own named barrier.
//  - A thread copies its own chunks of every input of a row (the streams,
//    the five incoming grads, K4's branch) with 16-byte cp.async into its
//    own slots of a two-stage shared-memory ring: the next row is in flight
//    while this one computes, and no barrier guards the ring, since no
//    thread reads another's slots. Widths that are not a multiple of 8 (or
//    rows not 16-byte aligned) copy 8-, 4- or 2-byte pieces, the widest the
//    rows allow, and a chunk past d is zero-filled: a masked tail.
//  - Every input is read from device memory once and every output written
//    once; K4 forms r = round(carried + round(branch beta)) once, in place
//    in its ring slots.
//  - Three reductions a row over the team: (rms statistic, mix adjoint;
//    K4 also the previous row's g_beta), projection, rms adjoint; two with
//    SAVE, which reads the forward's tanh (ta, (s, M, s+2) f32) and
//    unrounded rms reciprocal (inv, (s, M) f32) instead of the statistic and
//    the projection. Those 28 values a row are plain loads, issued with the
//    next row's other scalars while this row finishes. A warp
//    reduce-scatters its 24-28 partials in 31 shuffles (lane l ends with
//    value l), the team's warps meet in shared memory, and each lane of
//    every warp sums the warps' values in the same order. Lane s (s+2) + c
//    then evaluates the row's rms reciprocal (c = s+1), tanh, alpha and gp
//    for its (stream, column) once for the warp, and hands them on by
//    shuffles or as vectors in shared memory. The sign of inv carries the
//    clamp test: var > 1e-12, or with SAVE the reference's inv < 1e6.
//  - W gp is formed once per element. The weights (rounded to bf16, kept
//    as f32) sit in shared memory, which the block's teams share; gW = n^T
//    gp accumulates in each thread's registers for its own columns. The
//    block writes one partial row at the end; the second launch sums the
//    blocks' rows in block order: the same result every run. Rows wider
//    than 2048 (two chunks a thread) keep the weights in registers as bf16
//    pairs and gW in shared memory, with a one-stage ring.
//  - Registers are capped at 168 a thread (one chunk): three 128-thread
//    blocks an SM at d = 1024, two 160-thread blocks at 1152, four
//    96-thread blocks at 576. The grid is what the SMs hold at once (the
//    occupancy API, at most the blocks the wrapper allocated partial rows
//    for), each block walking rows with a stride of the grid.
// Rounding is the reference's (round to bf16 at n, inv, alpha, gp and the
// depth connection), sums in f32; only the order of the sums differs.
#pragma once

#include "hyper_conn_bwd.cuh"
#include "hyper_conn_sm90_common.cuh"

namespace {
namespace hc_sm90 {

constexpr int MAX_BLOCKS = 1056;          // partial rows the wrapper may allocate
constexpr int BCAST = 80;                 // floats of a warp's gp / alpha broadcast
constexpr int MAX_REGS = 168;             // three warps of a quadrant's 16K registers

// ---------------------------------------------------------------- kernel

// One block: `teams(d)` teams of `tw` warps; team i walks rows blockIdx.x *
// teams + i + k * gridDim.x * teams. J chunks of 8 columns a thread. SAVE
// (K5bs / K4s) reads the forward's ta and inv instead of the rms statistic,
// the projection and the tanh: two team reductions a row instead of three.
template <bool FUSED, bool SAVE, int J>
__global__ void __maxnreg__(MAX_REGS)
    hc_bwd_sm90_kernel(HcBwdParams p, int tw, int stages, int vec) {
  constexpr int NSLOT = FUSED ? 2 * NS + 2 : 2 * NS + 1;  // streams, grads, branch
  constexpr int BR = 2 * NS + 1;                          // K4: the branch's slot
  const int d = p.d;
  const int M = (int)p.m;  // rows are ints (bwd_run refuses 2^31 - 2^16 or more)
  const int T = tw * 32;
  const int R = blockDim.x / T;
  const int team = threadIdx.x / T, tt = threadIdx.x % T;
  const int wt = tt >> 5, lane = threadIdx.x & 31;
  const int slots = J * T;
  const int nchunk = chunks(d);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint4* ring = reinterpret_cast<uint4*>(smem_raw);  // (R, stages, NSLOT, slots)
  const size_t ring_bytes = (size_t)R * stages * NSLOT * slots * sizeof(uint4);
  float4* sW = reinterpret_cast<float4*>(smem_raw + ring_bytes);  // J == 1: (NC, 2, slots)
  float* red = reinterpret_cast<float*>(sW + (J == 1 ? NC * 2 * slots : 0));  // (R, 4, tw, 32)
  float* bcast = red + R * 4 * T;                                // (block warps, BCAST)
  float* sacc = bcast + R * tw * BCAST;                          // (R, 2, 32): g_static, ga ta
  float* sgw = sacc + R * 64;                                    // J == 2: (NC, d) gW
  float* myred = red + team * 4 * T;
  float* wb = bcast + (threadIdx.x >> 5) * BCAST;  // gp (c, s) | gp (s, 8) | alpha (t, s)

  const bf16* in0 = static_cast<const bf16*>(p.in0);
  const bf16* in1 = static_cast<const bf16*>(p.in1);
  const bf16* in2 = static_cast<const bf16*>(p.in2);
  const bf16* g_b0 = static_cast<const bf16*>(p.g_b0);
  const bf16* g_car = static_cast<const bf16*>(p.g_car);
  const bf16* g_beta = static_cast<const bf16*>(p.g_beta);
  bf16* out0 = static_cast<bf16*>(p.out0);
  bf16* out1 = static_cast<bf16*>(p.out1);
  bf16* out2 = static_cast<bf16*>(p.out2);

  // this thread's chunks: columns 8 q .. 8 q + 7 of chunk q = j T + tt
  int col0[J], nval[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int q = j * T + tt;
    col0[j] = 8 * q;
    nval[j] = q < nchunk ? min(8, d - 8 * q) : 0;
  }
  auto weight = [&](int col, int c) {
    return col < d ? __bfloat162float(__float2bfloat16(c <= NS ? p.aw[col * (NS + 1) + c]
                                                               : p.bw[col]))
                   : 0.f;
  };

  // The weights rounded to bf16: one chunk a thread, in shared memory as f32
  // (the block's teams share them), float4 (c, half, chunk); two chunks, in
  // registers as bf16 pairs w[j][c][k] (columns 2k, 2k+1 of chunk j).
  uint32_t w[J == 1 ? 1 : J][NC][4];
  float gw[J == 1 ? NC : 1][8];  // one chunk: this thread's gW columns
#pragma unroll
  for (int c = 0; c < (J == 1 ? NC : 1); ++c)
#pragma unroll
    for (int e = 0; e < 8; ++e) gw[c][e] = 0.f;
  if constexpr (J == 1) {
    for (int i = threadIdx.x; i < NC * 2 * slots; i += blockDim.x) {
      const int q = i % slots, h = (i / slots) % 2, c = i / (2 * slots), c0 = 8 * q + 4 * h;
      sW[i] = make_float4(weight(c0, c), weight(c0 + 1, c), weight(c0 + 2, c), weight(c0 + 3, c));
    }
  } else {
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          w[j][c][k] = pack(weight(col0[j] + 2 * k, c), weight(col0[j] + 2 * k + 1, c));
    for (int i = threadIdx.x; i < NC * d; i += blockDim.x) sgw[i] = 0.f;
  }
  __syncthreads();
  // chunk j's weights of head column c
  auto wload = [&](int j, int c, float (&x)[8]) {
    if constexpr (J == 1) {
      const float4 a = sW[2 * c * slots + tt], b = sW[(2 * c + 1) * slots + tt];
      x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w, x[4] = b.x, x[5] = b.y, x[6] = b.z,
      x[7] = b.w;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = e & 1 ? hi(w[j][c][e >> 1]) : lo(w[j][c][e >> 1]);
    }
  };
  // gW += n^T gp for chunk j: n (8 columns) times gp (NC)
  auto add_gw = [&](int j, const float (&n)[8], const float (&gp)[NC]) {
    if constexpr (J == 1) {
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 8; ++e) gw[c][e] = fmaf(n[e], gp[c], gw[c][e]);
    } else {
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (e < nval[j]) sgw[c * d + col0[j] + e] = fmaf(n[e], gp[c], sgw[c * d + col0[j] + e]);
    }
  };

  // lane s NC + c of each warp evaluates (stream s, column c) of the scalar stage
  const int ls = lane / NC, lc = lane % NC;
  const bool lval = lane < NV;
  float* acc = sacc + team * 64;  // the team's warp 0 lanes: g_static at l, ga ta at 32 + l
  if (wt == 0) acc[lane] = acc[32 + lane] = 0.f;

  const int team_id = blockIdx.x * R + team;
  const int nteams = gridDim.x * R;

  // this thread's chunks of every input of `row` into ring stage st
  auto issue = [&](int row, int st) {
    uint4* base = ring + (size_t)(team * stages + st) * NSLOT * slots + tt;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (nval[j] == 0) continue;
      uint4* dst = base + j * T;
      const int c0 = col0[j], nv = nval[j];
#pragma unroll
      for (int s = 0; s < NS; ++s)
        copy_chunk(dst + s * slots, in0 + ((long long)s * M + row) * d + c0, nv, vec);
      copy_chunk(dst + NS * slots, g_b0 + (long long)row * d + c0, nv, vec);
#pragma unroll
      for (int t = 1; t <= NS; ++t)
        copy_chunk(dst + (NS + t) * slots, g_car + ((long long)(t - 1) * M + row) * d + c0, nv, vec);
      if constexpr (FUSED) copy_chunk(dst + BR * slots, in1 + (long long)row * d + c0, nv, vec);
    }
    cp_commit();
  };
  // the row's scalars: K4's previous beta (bf16 pairs); g_beta (bf16) in
  // lane s NC + NS + 1; SAVE, the saved ta of (s, c) in lane s NC + c and
  // the saved inv of stream s in lane s (f32)
  struct Scalars {
    uint32_t bp[NS / 2];
    bf16 gb;
    float ta, inv;
  };
  auto scalars = [&](int row, Scalars& x) {
    if constexpr (FUSED) {
#pragma unroll
      for (int s = 0; s < NS; s += 2)
        x.bp[s / 2] = (uint32_t)__bfloat16_as_ushort(in2[(long long)s * M + row]) |
                      (uint32_t)__bfloat16_as_ushort(in2[(long long)(s + 1) * M + row]) << 16;
    }
    x.gb = lval && lc == NS + 1 ? g_beta[(long long)ls * M + row] : __float2bfloat16(0.f);
    if constexpr (SAVE) {
      x.ta = lval ? p.ta[((long long)ls * M + row) * NC + lc] : 0.f;
      x.inv = lane < NS ? p.inv[(long long)lane * M + row] : 1.f;
    }
  };

  int row = team_id;
  Scalars sc_r = {};
  float gb[NS] = {};                    // K4: this thread's g_beta partials of row - nteams
  if (row < M) {
    if (stages == 2) issue(row, 0);
    scalars(row, sc_r);
  }
  for (int k = 0; row < M; ++k, row += nteams) {
    const int next = row + nteams;
    int st = 0;
    if (stages == 2) {
      st = k & 1;
      if (next < M) issue(next, st ^ 1);
      else cp_commit();
      cp_wait<1>();
    } else {
      issue(row, 0);
      cp_wait<0>();
    }
    auto bprev = [&](int s) { return s & 1 ? hi(sc_r.bp[s / 2]) : lo(sc_r.bp[s / 2]); };
    // chunk j's slot i: buf[i * slots + j * T]
    uint4* buf = ring + (size_t)(team * stages + st) * NSLOT * slots + tt;

    if constexpr (FUSED) {  // r = round(carried + round(branch beta)), in place
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (nval[j] == 0) continue;
        float br[8];
        unpack8(buf[BR * slots + j * T], br);
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          float c[8], x[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) x[e] = br[e] * bprev(s);
          round8(x);
          unpack8(buf[s * slots + j * T], c);
#pragma unroll
          for (int e = 0; e < 8; ++e) c[e] += x[e];
          buf[s * slots + j * T] = pack8(c);
        }
      }
    }

    // round 1: ga_s[t] = gm_t . r_s at value s NC + t, sum r_s^2 at s NC +
    // NS + 1 (not SAVE); K4 also the previous row's g_beta partials at NV + s
    float v[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) v[i] = FUSED && i >= NV && i < NV + NS ? gb[i - NV] : 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (nval[j] == 0) continue;
#pragma unroll
      for (int h = 0; h < NS; h += 2) {  // two streams at a time: fewer registers live
        float r[2][8];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int s = h + i;
          unpack8(buf[s * slots + j * T], r[i]);
          if constexpr (!SAVE) {
#pragma unroll
            for (int e = 0; e < 8; ++e)
              v[s * NC + NS + 1] = fmaf(r[i][e], r[i][e], v[s * NC + NS + 1]);
          }
        }
#pragma unroll
        for (int t = 0; t <= NS; ++t) {
          float g[8];
          unpack8(buf[(NS + t) * slots + j * T], g);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int e = 0; e < 8; ++e) v[(h + i) * NC + t] = fmaf(g[e], r[i][e], v[(h + i) * NC + t]);
        }
      }
    }
    halve<32, 16>(v, lane);
    myred[wt * 32 + lane] = v[0];
    team_sync(team + 1, T);
    float tot1 = 0.f;
    for (int i = 0; i < tw; ++i) tot1 += myred[i * 32 + lane];
    if constexpr (FUSED) {
      if (k > 0 && wt == 0 && lane >= NV && lane < NV + NS)
        out2[(long long)(lane - NV) * M + row - nteams] = __float2bfloat16(tot1);
    }

    // the rms reciprocal of every stream in every lane: recomputed from the
    // statistic in lane s NC + NS + 1 (the sign carries var > 1e-12) or,
    // SAVE, the forward's from lane s (the sign carries the reference's
    // test inv < 1e6)
    float inv[NS];  // negative where the clamp holds; rounded where n is formed
    if constexpr (SAVE) {
#pragma unroll
      for (int s = 0; s < NS; ++s)
        inv[s] = __shfl_sync(0xffffffffu, sc_r.inv < 1e6f ? sc_r.inv : -sc_r.inv, s);
    } else {
      const float var = tot1 / d;
      const float inv_l = rsqrtf(fmaxf(var, 1e-12f));
#pragma unroll
      for (int s = 0; s < NS; ++s)
        inv[s] = __shfl_sync(0xffffffffu, var > 1e-12f ? inv_l : -inv_l, s * NC + NS + 1);
    }

    // round 2 (not SAVE): the projection n_s W, n_s = round(r_s round(inv_s))
    float tot2 = 0.f;
    if constexpr (!SAVE) {
#pragma unroll
      for (int i = 0; i < 32; ++i) v[i] = 0.f;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (nval[j] == 0) continue;
#pragma unroll
        for (int h = 0; h < NS; h += 2) {  // two streams at a time
          float n[2][8];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            unpack8(buf[(h + i) * slots + j * T], n[i]);
            const float ir = round_bf16(fabsf(inv[h + i]));
#pragma unroll
            for (int e = 0; e < 8; ++e) n[i][e] *= ir;
            round8(n[i]);
          }
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            float x[8];
            wload(j, c, x);
#pragma unroll
            for (int e = 0; e < 8; ++e)
#pragma unroll
              for (int i = 0; i < 2; ++i) v[(h + i) * NC + c] = fmaf(n[i][e], x[e], v[(h + i) * NC + c]);
          }
        }
      }
      halve<32, 16>(v, lane);
      myred[T + wt * 32 + lane] = v[0];
      team_sync(team + 1, T);
      for (int i = 0; i < tw; ++i) tot2 += myred[T + i * 32 + lane];
    }

    // the scalar stage of lane s NC + c: tanh (or the saved one), alpha, gp,
    // the parameter partials
    {
      const float ta = SAVE ? sc_r.ta : tanhf(tot2);
      const float ga = lc == NS + 1 ? __bfloat162float(sc_r.gb) : tot1;
      if (lval) {
        const float a_scale = *p.ascale, sc = lc == NS + 1 ? *p.bscale : a_scale;
        const float gp = round_bf16(ga * sc * (1.f - ta * ta));
        wb[lc * NS + ls] = gp;
        wb[NV + ls * 8 + lc] = gp;
        if (lc <= NS)
          wb[NV + 32 + lc * NS + ls] = round_bf16(ta * a_scale + p.sa[ls * (NS + 1) + lc]);
        if (wt == 0) {
          acc[lane] += ga;
          acc[32 + lane] += ga * ta;
        }
      }
      __syncwarp();
    }

    // round 3: g_n = W gp once per element; g_inv = g_n . r, gW += n^T gp;
    // pre = g_n inv + sum_t alpha[t] gm_t (pre is g_n's registers)
    float pre[J][NS][8];
    float v4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (nval[j] == 0) continue;
#pragma unroll
      for (int s = 0; s < NS; ++s)
#pragma unroll
        for (int e = 0; e < 8; ++e) pre[j][s][e] = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 g4 = *reinterpret_cast<const float4*>(wb + c * NS);
        const float gpc[NS] = {g4.x, g4.y, g4.z, g4.w};
        float x[8];
        wload(j, c, x);
#pragma unroll
        for (int e = 0; e < 8; ++e)
#pragma unroll
          for (int s = 0; s < NS; ++s) pre[j][s][e] = fmaf(gpc[s], x[e], pre[j][s][e]);
      }
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        float r[8], n[8], gp[NC];
        unpack8(buf[s * slots + j * T], r);
        const float4 a = *reinterpret_cast<const float4*>(wb + NV + s * 8);
        const float2 b = *reinterpret_cast<const float2*>(wb + NV + s * 8 + 4);
        gp[0] = a.x, gp[1] = a.y, gp[2] = a.z, gp[3] = a.w, gp[4] = b.x, gp[5] = b.y;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          v4[s] = fmaf(pre[j][s][e], r[e], v4[s]);
          n[e] = r[e] * round_bf16(fabsf(inv[s]));
          pre[j][s][e] *= fabsf(inv[s]);
        }
        round8(n);
        add_gw(j, n, gp);
      }
#pragma unroll
      for (int t = 0; t <= NS; ++t) {
        float g[8];
        unpack8(buf[(NS + t) * slots + j * T], g);
        const float4 a4 = *reinterpret_cast<const float4*>(wb + NV + 32 + t * NS);
        const float al[NS] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
        for (int s = 0; s < NS; ++s)
#pragma unroll
          for (int e = 0; e < 8; ++e) pre[j][s][e] = fmaf(al[s], g[e], pre[j][s][e]);
      }
    }
    halve<4, 16>(v4, lane);
    if ((lane & 7) == 0) myred[2 * T + wt * 4 + (lane >> 3)] = v4[0];
    team_sync(team + 1, T);
    // g_sq of stream s in lane s, then to every lane
    float gsq[NS];
    {
      const int s = lane & (NS - 1);
      float g_inv = 0.f;
      for (int i = 0; i < tw; ++i) g_inv += myred[2 * T + i * 4 + s];
      float x = inv[0];
#pragma unroll
      for (int t = 1; t < NS; ++t) x = s == t ? inv[t] : x;
      const float iv = fabsf(x);
      const float g = x > 0.f ? g_inv * (-0.5f) * iv * iv * iv / d : 0.f;
#pragma unroll
      for (int t = 0; t < NS; ++t) gsq[t] = __shfl_sync(0xffffffffu, g, t);
    }
    // the next row's scalars, in flight while this row finishes
    Scalars sc_n = {};
    if (next < M) scalars(next, sc_n);

    // g_r = pre + 2 r g_sq (in pre's registers), written out (K5b) or split
    // by the depth connection (K4: g_branch = sum_s g_r_s beta_s, g_beta_s =
    // g_r_s . branch)
#pragma unroll
    for (int s = 0; s < NS; ++s) gb[s] = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (nval[j] == 0) continue;
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        float r[8];
        unpack8(buf[s * slots + j * T], r);
#pragma unroll
        for (int e = 0; e < 8; ++e) pre[j][s][e] += 2.f * r[e] * gsq[s];
        store_chunk(out0 + ((long long)s * M + row) * d + col0[j], pack8(pre[j][s]), nval[j], vec);
      }
      if constexpr (FUSED) {
        float br[8], gbr[8];
        unpack8(buf[BR * slots + j * T], br);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          gbr[e] = 0.f;
#pragma unroll
          for (int s = 0; s < NS; ++s) gbr[e] = fmaf(pre[j][s][e], bprev(s), gbr[e]);
        }
#pragma unroll
        for (int s = 0; s < NS; ++s)
#pragma unroll
          for (int e = 0; e < 8; ++e) gb[s] = fmaf(pre[j][s][e], br[e], gb[s]);
        store_chunk(out1 + (long long)row * d + col0[j], pack8(gbr), nval[j], vec);
      }
    }
    sc_r = sc_n;
  }
  // K4: the last row's g_beta (the others went with the next row's round 1)
  if constexpr (FUSED) {
    if (team_id < M) {
      halve<4, 16>(gb, lane);
      if ((lane & 7) == 0) myred[3 * T + wt * 4 + (lane >> 3)] = gb[0];
      team_sync(team + 1, T);
      if (tt < NS) {
        float acc = 0.f;
        for (int i = 0; i < tw; ++i) acc += myred[3 * T + i * 4 + tt];
        out2[(long long)tt * M + row - nteams] = __float2bfloat16(acc);
      }
    }
  }

  // this block's parameter-grad row: gW summed over its teams in team order,
  // then g_static and the two scale grads
  __syncthreads();
  float* out = p.partials + (long long)blockIdx.x * (NC * d + n_small(NS));
  if constexpr (J == 1) {
    if (R == 1) {
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (e < nval[0]) out[c * d + col0[0] + e] = gw[c][e];
    } else {
      float* sg = reinterpret_cast<float*>(smem_raw);  // the ring (free now) holds NC d floats
      for (int i = 0; i < R; ++i) {
        if (team == i) {
#pragma unroll
          for (int c = 0; c < NC; ++c)
#pragma unroll
            for (int e = 0; e < 8; ++e)
              if (e < nval[0]) {
                float* dst = sg + c * d + col0[0] + e;
                *dst = i == 0 ? gw[c][e] : *dst + gw[c][e];
              }
        }
        __syncthreads();
      }
      for (int i = threadIdx.x; i < NC * d; i += blockDim.x) out[i] = sg[i];
    }
  } else {
    for (int i = threadIdx.x; i < NC * d; i += blockDim.x) out[i] = sgw[i];
  }
  // the teams' g_static (s, c) and ga * ta partials, summed in team order
  if (threadIdx.x < NV) {
    float a = 0.f;
    for (int i = 0; i < R; ++i) a += sacc[i * 64 + threadIdx.x];
    out[NC * d + threadIdx.x] = a;
  } else if (threadIdx.x == NV) {
    float g_as = 0.f, g_bs = 0.f;
    for (int i = 0; i < R; ++i)
      for (int l = 0; l < NV; ++l) {
        const float x = sacc[i * 64 + 32 + l];
        if (l % NC == NS + 1) g_bs += x;
        else g_as += x;
      }
    out[NC * d + NV] = g_as;
    out[NC * d + NV + 1] = g_bs;
  }
}

// ---------------------------------------------------------------- launch

// shared memory of a block: the ring (several teams: d <= 512 and at least
// 2 x 9 x 64 slots of 16 bytes, more than the NC d floats of the gW sum
// that reuses it), one chunk a thread the f32 weights, the reductions, the
// warps' broadcasts and, two chunks a thread, the (NC, d) gW
inline size_t smem_bytes(bool fused, int d, int stages) {
  const int tw = team_warps(d), r = teams(d), slots = per_thread(d) * tw * 32;
  const size_t nslot = fused ? 2 * NS + 2 : 2 * NS + 1;
  const size_t ring = (size_t)r * stages * nslot * slots * sizeof(uint4);
  const size_t weights = per_thread(d) == 1 ? (size_t)NC * 2 * slots * sizeof(float4) : 0;
  return ring + weights +
         ((size_t)r * 4 * tw * 32 + (size_t)r * tw * BCAST + (size_t)r * 64) * sizeof(float) +
         (per_thread(d) > 1 ? (size_t)NC * d * sizeof(float) : 0);
}

// the widest piece (8, 4, 2 or 1 columns) every row of every tensor read or
// written in chunks is aligned to
inline int vec_width(const HcBwdParams& p, bool fused) {
  uintptr_t a = (uintptr_t)p.in0 | (uintptr_t)p.g_b0 | (uintptr_t)p.g_car | (uintptr_t)p.out0;
  if (fused) a |= (uintptr_t)p.in1 | (uintptr_t)p.out1;
  int v = 8;
  while (v > 1 && (p.d % v != 0 || a % (2 * v) != 0)) v >>= 1;
  return v;
}

template <bool FUSED, bool SAVE, int J>
cudaError_t launch(const HcBwdParams& p, int blocks, float* params_out, cudaStream_t stream) {
  auto kernel = hc_bwd_sm90_kernel<FUSED, SAVE, J>;
  // set once, outside any CUDA-graph capture that later launches replay
  static bool configured = false;
  cudaError_t err;
  if (!configured) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int stages = smem_bytes(FUSED, p.d, 2) <= MAX_SMEM ? 2 : 1;
  const size_t smem = smem_bytes(FUSED, p.d, stages);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  const int threads = block_warps(p.d) * 32;
  // blocks an SM holds at this width, asked once per width (the launches
  // of one width repeat, and may be captured in a CUDA graph)
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
  const int grid = (int)std::max(1LL, std::min({(long long)blocks, (long long)per_sm * sm_count(), rows}));
  kernel<<<grid, threads, smem, stream>>>(p, team_warps(p.d), stages, vec_width(p, FUSED));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int np = NC * p.d + n_small(NS);
  hc_param_reduce_kernel<<<(np + 255) / 256, 256, 0, stream>>>(p.partials, grid, np, params_out);
  return cudaGetLastError();
}

// bf16 at 4 streams, K5b / K4 or (SAVE) K5bs / K4s: block_warps(d) warps a
// block; `blocks` the partial rows the wrapper allocated (the grid is at
// most that)
template <bool SAVE>
inline int bwd_run(const HcBwdParams& p, bool fused, int blocks, void* params_out,
                   void* stream) {
  if (p.d < 1 || block_warps(p.d) * 32 > MAX_THREADS || blocks < 1 || blocks > MAX_BLOCKS ||
      p.m < 0 || p.m >= (1LL << 31) - (1LL << 16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(params_out);
  if (per_thread(p.d) == 1)
    return (int)(fused ? launch<true, SAVE, 1>(p, blocks, out, st)
                       : launch<false, SAVE, 1>(p, blocks, out, st));
  return (int)(fused ? launch<true, SAVE, 2>(p, blocks, out, st)
                     : launch<false, SAVE, 2>(p, blocks, out, st));
}

}  // namespace hc_sm90
}  // namespace
