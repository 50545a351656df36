// K11: fused log-mel spectrogram for the H100 (sm_90a).
//
// Replaces the TPU kernel e2_tts_tpu/ops/mel_kernel.py::_mel_kernel (driven
// by fused_log_mel). For each frame row r of the (un-windowed) framed audio
// and the window-folded real DFT bases cos, sin (n_fft, n_freqs):
//   re = frame_r @ cos,  im = frame_r @ sin
//   spec = sqrt(re^2 + im^2) (power 1) | re^2 + im^2 (power 2)
//        | (re^2 + im^2)^(power / 2) (any other power)
//   out_r = log(max(spec @ fbanks, 1e-5))                 (fbanks (n_freqs, n_mels))
// The frames are read by index from a strided view: frame t of batch row b
// starts at frames + b * batch_stride + t * frame_stride. With the
// reflect-padded wave and frame_stride = hop that view is the wave itself
// (frames overlap n_fft / hop = 4 times); no (rows, n_fft) frame tensor is
// materialised. The bases are arbitrary inputs: no FFT.
//
// What bounds it: operations. Per frame the two DFT products are 4 n_fft
// n_freqs = 2.1 MFLOP against 4 hop = 1 KB of new wave. One TF32 product is
// too coarse (the log amplifies its 2^-11 relative error in quiet bins: 7.5x
// the 2e-3 + 1e-3 |ref| tolerance on chip_smoke.py's prompt of a tone, noise
// and a silent tail, where this kernel reads 0.11 of it), so each
// product is three TF32 tensor-core products in split precision: every f32
// operand x is split as it is read into a fragment, hi = tf32_rna(x), lo =
// tf32_rna(x - hi) (tf32_rna: cvt.rna.tf32's rounding, to nearest with ties
// away), and lo_a hi_b + hi_a lo_b + hi_a hi_b accumulate in f32 (the
// dropped lo_a lo_b is ~2^-22 relative): f32 grade at 495 / 3 = 165 TFLOP/s,
// against the FMA pipes' 67. tests/test_torch_mel_design.py models
// this arithmetic on the CPU against an f64 reference.
//
// Design. mma.sync.m16n8k8.row.col.f32.tf32 takes the bases' row-major
// (n_fft, n_freqs) layout from shared memory as they are (its B fragment is
// a column of samples at one bin), where wgmma's tf32 form needs both
// operands K-major in shared memory and so a transposing stage and a split
// pass through shared memory for the bases: mma.sync was taken (a wgmma
// form is not measured). The split rounds on the bits (an add and a mask);
// cvt.rna.tf32.f32, which also screens NaN and infinity, takes 1.13x
// (prompt) and 1.16x (16 x 1024 frames) the time. A block owns BM frame
// rows and walks a range of BF-bin frequency tiles; each warp computes an
// (MT m16) x (NT n8) tile of re and of im. Per tile, BK-sample slices of
// the frames and of both bases ride a two-stage cp.async ring (frames in
// 16-byte copies when the view allows, else 4-byte copies; the bases row by
// row in 4-byte copies: 513 bins leave their rows unaligned), zero-filled
// past n_fft, past n_freqs and past the last row.
// Within a k8 step the samples are relabelled (the mma's k = t stands for
// sample 2t and k = t + 4 for 2t + 1, in both operands) so that a thread's
// two A values of a row are one 8-byte shared load; with pitches of 8 mod
// 16 words (frames, magnitudes) and 4 mod 16 (bases, filterbank rows) every
// fragment read is conflict-free. The tile's magnitudes go to shared memory
// and are multiplied, again in split TF32 on the tensor cores, into the
// block's (BM, 128-mel) accumulator against the tile's filterbank rows
// (copied with the tile's first stage), so the (rows, n_freqs) spectrum
// never leaves the SM. The mel accumulator lives in shared memory between
// tiles (each thread its own fragment slots), so the DFT keeps only re / im
// in registers. An n8 column chunk past n_freqs (the 513th bin is one chunk
// of the last tile: 8 columns, not a whole tile), a k8 step past n_fft and
// a mel chunk past n_mels are skipped, warp-uniformly. More than 128 mels
// run as mel groups of 128 (the grid's third dimension), each group
// recomputing the DFT of its rows.
//
// Two geometries of this one kernel, chosen in e2_mel_fwd by the row count
// (the wrapper's GEOMETRIES and frequency_splits mirror the choice). Each
// mechanism below was measured by taking it out (chip_mel_variants.py;
// device time on an H100 SXM at 700 W, in PERF.md section 6):
//   Small (rows < LARGE_ROWS): 32 rows x 64-bin tiles, 16 warps as four
//     k-groups, each running its own ring over a quarter of the samples, so
//     a block has four times the warps and a quarter of the serial ring
//     stages. The 3-s prompt (282 frames) is 9 row blocks x 9 tiles (8 of
//     64 bins and the Nyquist bin), one tile a block: 81 blocks of 16
//     warps. One k-group of 4 warps takes 1.55x the time there; 32-bin
//     tiles (153 blocks of 8 or 16 warps) 1.2-1.3x.
//   Large: 128 rows x 64-bin tiles, 16 warps, so each base slice read from
//     L2 serves 128 rows (16 x 1024 frames: 128 blocks, one an SM, each
//     walking all 9 tiles). Small there takes 1.34x; Large at the prompt
//     2.8x. LARGE_ROWS = 1152 from a sweep of the row count: Small is
//     faster up to 1024 rows, Large at 1152 and from 1536 rows on by
//     1.01-1.74x (Small 4% faster at 1280 and 1408).
// Few row blocks split a row block's frequency tiles over `nsplit` blocks
// (the wrapper's frequency_splits): each writes its partial mel sums to a
// scratch (nsplit, rows, n_mels) buffer and a second pass sums the splits
// in a fixed order and takes the log (the same result every run). With
// nsplit = 1 the first pass writes the log-mel itself; unsplit, the prompt
// takes 7.6x the time.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int MAXM = 128;           // mels a group (the grid's third dimension)
constexpr int MEL_LD = MAXM + 4;    // filterbank tile pitch (4 mod 16 words)
constexpr int LARGE_ROWS = 1152;    // from this many rows on, the Large geometry

// A warp computes MT x NT m16n8 tiles (32 rows x 16 bins) of re and of im,
// WN warps side by side span a tile's BF = 64 bins, WM such rows of warps a
// k-group's BM rows; KG k-groups a block, each running its own NSTAGE-deep
// ring of BK-sample stages over its share of the samples, their re / im
// partials summed in group order before the magnitudes. (Three stages take
// 1.02x at the prompt and 1.06x at 16 x 1024 frames, where Large spills.)
template <int WM_, int KG_, int BK_>
struct Geometry {
  static constexpr int MT = 2, NT = 2, WN = 4, NSTAGE = 2;
  static constexpr int WM = WM_, KG = KG_, BK = BK_;
  static constexpr int TEAM = 32 * WM * WN;     // threads of a k-group
  static constexpr int THREADS = TEAM * KG;
  static constexpr int BM = 16 * MT * WM;       // frame rows a block
  static constexpr int BF = 8 * NT * WN;        // frequency bins a tile
  static constexpr int NTM = MAXM / 8 / (WN * KG);   // mel n8 tiles a warp
  static constexpr int LDA = BK + 8;            // frames slice pitch (8 mod 16 words)
  static constexpr int LDB = BF + 4;            // bases slice pitch (4 mod 16)
  static constexpr int LDM = BF + 8;            // magnitudes pitch (8 mod 16)
  static constexpr int STAGE = BM * LDA + 2 * BK * LDB;          // floats
  static constexpr int RINGS = KG * NSTAGE * STAGE;              // a ring a k-group
  static constexpr int PART = (KG - 1) * MT * NT * 8 * TEAM;     // k-group partials
  static constexpr int MAG = BM * LDM;
  static constexpr int WORK = RINGS > MAG + PART ? RINGS : MAG + PART;  // mel phase aliases
  static constexpr int FB = BF * MEL_LD;                         // the tile's filterbank rows
  static constexpr int MEL_ACC = MT * NTM * 4 * THREADS;         // thread-private slots
  static constexpr size_t bytes = BM * sizeof(long long) + (size_t)(WORK + FB + MEL_ACC) * 4;
  static_assert(TEAM % BF == 0 && (BK * BF) % TEAM == 0 && BK % 8 == 0 &&
                (MAXM / 8) % (WN * KG) == 0, "staging and mel tiles map evenly");
};
using Small = Geometry<1, 4, 16>;   // 32 rows, 4 k-groups of 4 warps
using Large = Geometry<4, 1, 32>;   // 128 rows, 16 warps

struct MelParams {
  const float* frames;
  long long batch_stride, frame_stride;  // elements
  int frames_per_batch, rows, n_fft;
  const float* cos_b;                    // (n_fft, n_freqs)
  const float* sin_b;
  int n_freqs;
  const float* fbanks;                   // (n_freqs, n_mels)
  int n_mels;
  float* out;                            // (rows, n_mels) log-mel, or
  float* partial;                        // (nsplit, rows, n_mels) partial sums
  int tiles, tiles_per_split;
  int vec;                               // frames in 16-byte copies
  float half_power;
  int power_mode;                        // 1: sqrt, 2: square, 0: pow(., half_power)
};

__device__ __forceinline__ float spectrum(float re, float im, int mode, float half_power) {
  const float sq = re * re + im * im;
  if (mode == 2) return sq;
  if (mode == 1) return sqrtf(fmaxf(sq, 0.f));
  return powf(fmaxf(sq, 0.f), half_power);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// global -> shared; a src-size of 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// cvt.rna.tf32.f32's rounding (to nearest, ties away from zero) on
// the bits, for finite x
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to ~2^-22: both TF32 values (x - hi is exact in f32)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b at f32 grade: the two cross terms, then hi hi
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma(d, al, bh[0], bh[1]);
  mma(d, ah, bl[0], bl[1]);
  mma(d, ah, bh[0], bh[1]);
}

// The fragments of one k8 step, with the step's samples relabelled: the
// mma's k index t (t < 4) stands for sample 2t and t + 4 for sample 2t + 1,
// in both operands, so a thread's two A values of a row are adjacent (one
// 8-byte shared load) and the product is the same sum.
// A (16 x 8, row-major at pitch LD): rows g and g + 8, samples 2t, 2t + 1
template <int LD>
__device__ __forceinline__ void a_frag(const float* a, int g, int t, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  const float2 r0 = *reinterpret_cast<const float2*>(a + g * LD + 2 * t);
  const float2 r1 = *reinterpret_cast<const float2*>(a + (g + 8) * LD + 2 * t);
  split(r0.x, hi[0], lo[0]);
  split(r1.x, hi[1], lo[1]);
  split(r0.y, hi[2], lo[2]);
  split(r1.y, hi[3], lo[3]);
}

// B (8 x 8 at pitch LD): samples 2t and 2t + 1 (rows), column g
template <int LD>
__device__ __forceinline__ void b_frag(const float* b, int g, int t, uint32_t (&hi)[2],
                                       uint32_t (&lo)[2]) {
  split(b[2 * t * LD + g], hi[0], lo[0]);
  split(b[(2 * t + 1) * LD + g], hi[1], lo[1]);
}

template <class G>
__global__ void __launch_bounds__(G::THREADS, 1) mel_fwd_kernel(MelParams p) {
  constexpr int MT = G::MT, NT = G::NT, WN = G::WN, KG = G::KG, NTM = G::NTM;
  constexpr int BM = G::BM, BF = G::BF, BK = G::BK, NSTAGE = G::NSTAGE;
  constexpr int THREADS = G::THREADS, TEAM = G::TEAM;
  extern __shared__ __align__(16) unsigned char smem[];
  long long* row_off = reinterpret_cast<long long*>(smem);   // [BM], -1 past the last row
  float* work = reinterpret_cast<float*>(smem + BM * sizeof(long long));
  float* fb_s = work + G::WORK;                              // [BF][MEL_LD]
  float* mel_acc = fb_s + G::FB;                             // [MT * NTM * 4][THREADS]
  // after the k-loop (aliasing the rings): magnitudes [BM][LDM], partials
  float* mag_s = work;
  float* part_s = work + G::MAG;         // [KG - 1][MT * NT * 8][TEAM]

  const int tid = threadIdx.x, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kg = tid / TEAM, ttid = tid % TEAM, warp = ttid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int mwn = kg * WN + wn;          // this warp's mel column block
  const int row0 = blockIdx.x * BM;
  const int mel0 = blockIdx.z * MAXM;
  const int n_here = min(MAXM, p.n_mels - mel0);
  float* ring = work + kg * NSTAGE * G::STAGE;
  // this k-group's stages: [s_begin, s_end) of the nk BK-sample slices
  const int nk = (p.n_fft + BK - 1) / BK;
  const int s_per = (nk + KG - 1) / KG;
  const int s_begin = min(nk, kg * s_per), s_end = min(nk, s_begin + s_per);
  const int n_stages = s_end - s_begin;
  auto team_sync = [&]() {
    if constexpr (KG == 1) __syncthreads();
    else asm volatile("bar.sync %0, %1;\n" ::"r"(1 + kg), "n"(TEAM) : "memory");
  };

  for (int r = tid; r < BM; r += THREADS) {
    const int row = row0 + r;
    const int b = row / p.frames_per_batch, tf = row - b * p.frames_per_batch;
    row_off[r] = row < p.rows ? b * p.batch_stride + tf * p.frame_stride : -1;
  }
  for (int i = 0; i < MT * NTM * 4; ++i) mel_acc[i * THREADS + tid] = 0.f;
  __syncthreads();

  // samples [k0, k0 + BK) of the frames and of the bases' tile columns, by
  // this k-group's threads
  auto load_stage = [&](float* stage, int k0, int f0) {
    float* fr_s = stage;
    float* cos_s = stage + BM * G::LDA;
    float* sin_s = cos_s + BK * G::LDB;
    if (p.vec) {
      constexpr int N = BM * BK / 4;
#pragma unroll
      for (int l = 0; l < (N + TEAM - 1) / TEAM; ++l) {
        const int idx = ttid + l * TEAM, r = idx / (BK / 4), c = 4 * (idx % (BK / 4));
        if (N % TEAM != 0 && idx >= N) break;
        const long long off = row_off[r];
        const bool ok = off >= 0 && k0 + c < p.n_fft;
        cp_async16(fr_s + r * G::LDA + c, ok ? p.frames + off + k0 + c : p.frames, ok);
      }
    } else {
      constexpr int N = BM * BK;
#pragma unroll
      for (int l = 0; l < (N + TEAM - 1) / TEAM; ++l) {
        const int idx = ttid + l * TEAM, r = idx / BK, c = idx % BK;
        if (N % TEAM != 0 && idx >= N) break;
        const long long off = row_off[r];
        const bool ok = off >= 0 && k0 + c < p.n_fft;
        cp_async4(fr_s + r * G::LDA + c, ok ? p.frames + off + k0 + c : p.frames, ok);
      }
    }
    const int j = ttid % BF;
    const bool col_ok = f0 + j < p.n_freqs;
#pragma unroll
    for (int l = 0; l < BK * BF / TEAM; ++l) {
      const int kk = ttid / BF + l * (TEAM / BF);
      const bool ok = col_ok && k0 + kk < p.n_fft;
      const long long off = ok ? (long long)(k0 + kk) * p.n_freqs + f0 + j : 0;
      cp_async4(cos_s + kk * G::LDB + j, p.cos_b + off, ok);
      cp_async4(sin_s + kk * G::LDB + j, p.sin_b + off, ok);
    }
  };

  // the tile's filterbank rows (each thread its share) join the cp.async
  // group of stage 0, so the first stage waits for them too: issued beside
  // the first stages' copies their latency overlaps theirs, where joined to
  // the last stage it lands after the last products (chip_mel_variants.py,
  // fb_last: 1.05x the time at the prompt)
  const int mcols = (n_here + 7) / 8 * 8;   // this group's mels, rounded up to 8
  auto load_fbanks = [&](int f0) {
    for (int idx = tid; idx < BF * mcols; idx += THREADS) {
      const int f = idx / mcols, m = idx % mcols;
      const bool ok = f0 + f < p.n_freqs && m < n_here;
      cp_async4(fb_s + f * MEL_LD + m,
                ok ? p.fbanks + (long long)(f0 + f) * p.n_mels + mel0 + m : p.fbanks, ok);
    }
  };
  // stage s of the k-loop, one cp.async group (with the filterbank rows at s = 0)
  auto issue = [&](int s, int f0) {
    if (s < n_stages) load_stage(ring + (s % NSTAGE) * G::STAGE, (s_begin + s) * BK, f0);
    if (s == 0) load_fbanks(f0);
    cp_commit();
  };

  const int tile_end = min(p.tiles, (blockIdx.y + 1) * p.tiles_per_split);
  for (int tile = blockIdx.y * p.tiles_per_split; tile < tile_end; ++tile) {
    const int f0 = tile * BF;
#pragma unroll
    for (int s = 0; s < NSTAGE - 1; ++s) issue(s, f0);
    float re[MT][NT][4], im[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) re[i][j][e] = im[i][j][e] = 0.f;

    for (int st = 0; st < n_stages; ++st) {
      cp_wait<NSTAGE - 2>();
      team_sync();   // stage st landed for the whole k-group; stage st - 1 is free
      issue(st + NSTAGE - 1, f0);

      const int k0 = (s_begin + st) * BK;
      const float* fr_s = ring + (st % NSTAGE) * G::STAGE;
      const float* cos_s = fr_s + BM * G::LDA;
      const float* sin_s = cos_s + BK * G::LDB;
#pragma unroll
      for (int ks = 0; ks < BK / 8; ++ks) {
        if (k0 + ks * 8 >= p.n_fft) break;
        uint32_t ah[MT][4], al[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i)
          a_frag<G::LDA>(fr_s + (wm * MT + i) * 16 * G::LDA + ks * 8, g, t, ah[i], al[i]);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int col = (wn * NT + j) * 8;
          if (f0 + col >= p.n_freqs) break;
          uint32_t ch[2], cl[2], sh[2], sl[2];
          b_frag<G::LDB>(cos_s + ks * 8 * G::LDB + col, g, t, ch, cl);
          b_frag<G::LDB>(sin_s + ks * 8 * G::LDB + col, g, t, sh, sl);
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            mma3(re[i][j], ah[i], al[i], ch, cl);
            mma3(im[i][j], ah[i], al[i], sh, sl);
          }
        }
      }
    }
    cp_wait<0>();
    __syncthreads();   // every k-group is done with its ring, and the filterbank rows landed

    if constexpr (KG > 1) {   // k-groups 1.. hand their partials to group 0
      if (kg > 0) {
        float* dst = part_s + (kg - 1) * MT * NT * 8 * TEAM + ttid;
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              dst[(((i * NT + j) * 4 + e) * 2) * TEAM] = re[i][j][e];
              dst[(((i * NT + j) * 4 + e) * 2 + 1) * TEAM] = im[i][j][e];
            }
      }
      __syncthreads();
    }
    if (kg == 0) {
      // magnitudes (zero for bins past n_freqs: their bases were zero)
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = re[i][j][e], y = im[i][j][e];
#pragma unroll
            for (int q = 1; q < KG; ++q) {   // in group order: the same sum every run
              const float* src = part_s + (q - 1) * MT * NT * 8 * TEAM + ttid;
              x += src[(((i * NT + j) * 4 + e) * 2) * TEAM];
              y += src[(((i * NT + j) * 4 + e) * 2 + 1) * TEAM];
            }
            const int r = (wm * MT + i) * 16 + g + 8 * (e >> 1);
            const int c = (wn * NT + j) * 8 + 2 * t + (e & 1);
            mag_s[r * G::LDM + c] = spectrum(x, y, p.power_mode, p.half_power);
          }
    }
    __syncthreads();

    float acc[MT][NTM][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NTM; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = mel_acc[((i * NTM + j) * 4 + e) * THREADS + tid];
#pragma unroll
    for (int ks = 0; ks < BF / 8; ++ks) {
      if (f0 + ks * 8 >= p.n_freqs) break;
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        a_frag<G::LDM>(mag_s + (wm * MT + i) * 16 * G::LDM + ks * 8, g, t, ah[i], al[i]);
#pragma unroll
      for (int j = 0; j < NTM; ++j) {
        const int col = (mwn * NTM + j) * 8;
        if (col >= n_here) break;
        uint32_t bh[2], bl[2];
        b_frag<MEL_LD>(fb_s + ks * 8 * MEL_LD + col, g, t, bh, bl);
#pragma unroll
        for (int i = 0; i < MT; ++i) mma3(acc[i][j], ah[i], al[i], bh, bl);
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NTM; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mel_acc[((i * NTM + j) * 4 + e) * THREADS + tid] = acc[i][j][e];
    __syncthreads();   // the next tile's rings and filterbank rows overwrite these
  }

  const bool split_call = gridDim.y > 1;
  float* dst = split_call ? p.partial + (long long)blockIdx.y * p.rows * p.n_mels : p.out;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NTM; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row0 + (wm * MT + i) * 16 + g + 8 * (e >> 1);
        const int m = (mwn * NTM + j) * 8 + 2 * t + (e & 1);
        if (r >= p.rows || m >= n_here) continue;
        const float v = mel_acc[((i * NTM + j) * 4 + e) * THREADS + tid];
        dst[(long long)r * p.n_mels + mel0 + m] = split_call ? v : logf(fmaxf(v, 1e-5f));
      }
}

// the split path's second pass: sum the splits in order, then the log
__global__ void __launch_bounds__(256) mel_log_kernel(const float* partial, float* out,
                                                      long long total, int nsplit) {
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < nsplit; ++k) s += partial[k * total + idx];
    out[idx] = logf(fmaxf(s, 1e-5f));
  }
}

template <class G>
int launch(MelParams& p, int nsplit, cudaStream_t s) {
  p.tiles = (p.n_freqs + G::BF - 1) / G::BF;
  if (nsplit > p.tiles || (nsplit > 1 && !p.partial)) return (int)cudaErrorInvalidValue;
  p.tiles_per_split = (p.tiles + nsplit - 1) / nsplit;
  nsplit = (p.tiles + p.tiles_per_split - 1) / p.tiles_per_split;  // no empty split
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        mel_fwd_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((unsigned)((p.rows + G::BM - 1) / G::BM), (unsigned)nsplit,
                  (unsigned)((p.n_mels + MAXM - 1) / MAXM));
  mel_fwd_kernel<G><<<grid, G::THREADS, G::bytes, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return (int)err;
  const long long total = (long long)p.rows * p.n_mels;
  long long blocks = (total + 255) / 256;
  if (blocks > 132 * 8) blocks = 132 * 8;
  mel_log_kernel<<<(unsigned)blocks, 256, 0, s>>>(p.partial, p.out, total, nsplit);
  return (int)cudaGetLastError();
}

}  // namespace

// nsplit: the blocks that share a row block's frequency tiles (at most the
// chosen geometry's tile count); partial: an (nsplit, rows, n_mels) f32
// scratch buffer when nsplit > 1.
extern "C" int e2_mel_fwd(const void* frames, long long batch_stride, long long frame_stride,
                          int frames_per_batch, int rows, int n_fft, const void* cos_b,
                          const void* sin_b, int n_freqs, const void* fbanks, int n_mels,
                          void* out, void* partial, int nsplit, float power, void* stream) {
  if (n_mels < 1 || n_fft < 1 || n_freqs < 1 || rows < 0 || frames_per_batch < 1 || nsplit < 1)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  MelParams p;
  p.frames = static_cast<const float*>(frames);
  p.batch_stride = batch_stride;
  p.frame_stride = frame_stride;
  p.frames_per_batch = frames_per_batch;
  p.rows = rows;
  p.n_fft = n_fft;
  p.cos_b = static_cast<const float*>(cos_b);
  p.sin_b = static_cast<const float*>(sin_b);
  p.n_freqs = n_freqs;
  p.fbanks = static_cast<const float*>(fbanks);
  p.n_mels = n_mels;
  p.out = static_cast<float*>(out);
  p.partial = static_cast<float*>(partial);
  p.vec = reinterpret_cast<uintptr_t>(frames) % 16 == 0 && batch_stride % 4 == 0 &&
          frame_stride % 4 == 0 && n_fft % 4 == 0;
  p.power_mode = power == 1.f ? 1 : (power == 2.f ? 2 : 0);
  p.half_power = 0.5f * power;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows >= LARGE_ROWS) return launch<Large>(p, nsplit, s);
  return launch<Small>(p, nsplit, s);
}
