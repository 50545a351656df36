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
// materialised.
//
// What bounds it: operations. Per frame the two DFT products are 4 n_fft
// n_freqs = 2.1 MFLOP against 4 hop = 1 KB of new wave: the f32 FMA rate
// (67 TFLOP/s, no tensor cores: TF32's 10-bit mantissa is too coarse once the
// log amplifies relative error in quiet bins) bounds it. Design: a block owns
// 64 frame rows and a range of 64-bin frequency tiles. For a tile it streams
// 16-sample slices of its frames and of the cos / sin bases through shared
// memory (two buffers: the next slice's global loads are in flight while the
// current one is multiplied); each thread accumulates a 4 x 4 (row, bin)
// tile of re and of im with f32 FMA, reading its operands as float4. The
// magnitudes go to shared memory and are multiplied into the block's
// (64, n_mels) mel accumulator (4 x 8 per thread, registers) against the
// tile's filterbank rows, so the (rows, n_freqs) spectrum never leaves the
// SM. The last tile's bins beyond n_freqs, the samples of the last slice
// beyond n_fft (any n_fft: 1000 is 62 slices and a tail of 8) and the rows
// beyond the last frame are zero. More than 128 mels run as mel groups of
// 128 (the grid's third dimension), each block computing the DFT of its rows
// for its group: 160 mels cost two DFT passes where one would do, the price
// of a register accumulator that stays at 4 x 8 per thread. Those two cases
// are a second instantiation (GENERAL), so that the common geometry compiles
// without their masks and groups.
//
// Few rows (a 3-s prompt is 282 frames: 5 row blocks) would leave most of
// the 132 SMs idle, so the wrapper then splits the frequency tiles over
// `nsplit` blocks per row block: each writes its partial mel sums to a
// scratch (nsplit, rows, n_mels) buffer and a second pass sums the splits
// in a fixed order and takes the log (the same result every run). With
// enough rows (nsplit = 1) the first pass writes the log-mel itself.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int BR = 64;         // frame rows per block
constexpr int BF = 64;         // frequency bins per tile
constexpr int BK = 16;         // samples per staged slice
constexpr int THREADS = 256;   // 16 x 16; thread (tx, ty): rows 4ty.., bins 4tx..
constexpr int MAXM = 128;      // mels per group (8 mel columns per thread)
constexpr int LDR = BR + 4;    // padded row stride of the staged frames / magnitudes
constexpr int STAGE = BK * LDR + 2 * BK * BF;    // one frames + cos + sin slice
constexpr int LOADS = BR * BK / THREADS;         // 4 (= BK * BF / THREADS)

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
  int tiles_per_split;
  float half_power;
  int power_mode;                        // 1: sqrt, 2: square, 0: pow(., half_power)
};

__device__ __forceinline__ float spectrum(float re, float im, int mode, float half_power) {
  const float sq = re * re + im * im;
  if (mode == 2) return sq;
  if (mode == 1) return sqrtf(fmaxf(sq, 0.f));
  return powf(fmaxf(sq, 0.f), half_power);
}

// GENERAL: more than 128 mels (mel groups over the grid's third dimension)
// or an n_fft that is not a multiple of 16 (a masked last slice); the common
// geometry (n_fft a multiple of 16, at most 128 mels) compiles without either
template <bool GENERAL>
__global__ void __launch_bounds__(THREADS, 2) mel_fwd_kernel(MelParams p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  // phase B (mel): magnitudes [BF][LDR], filterbank rows [BF][mel_ld]; phase
  // A (DFT) uses the same memory as two slices of frames [BK][LDR] + cos /
  // sin [BK][BF]
  float* mag_s = smem;
  float* fb_s = smem + BF * LDR;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int row0 = blockIdx.x * BR;
  // this block's mel group: columns [mel0, mel0 + n_here); mel_ld is n_here
  // rounded up to 16
  const int mel0 = GENERAL ? blockIdx.z * MAXM : 0;
  const int n_here = GENERAL ? min(MAXM, p.n_mels - mel0) : p.n_mels;
  const int mel_ld = (n_here + 15) / 16 * 16;

  // the frame rows this thread stages: 16 threads cover one row's slice
  const float* stage_ptr[LOADS];
#pragma unroll
  for (int l = 0; l < LOADS; ++l) {
    const int idx = tid + l * THREADS;
    const int r = row0 + idx / BK;
    stage_ptr[l] = nullptr;
    if (r < p.rows) {
      const int b = r / p.frames_per_batch, t = r - b * p.frames_per_batch;
      stage_ptr[l] = p.frames + b * p.batch_stride + t * p.frame_stride + (idx % BK);
    }
  }

  float acc[4][MAXM / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < MAXM / 16; ++j) acc[i][j] = 0.f;

  const int tile0 = blockIdx.y * p.tiles_per_split;
  const int f_end = min(p.n_freqs, (tile0 + p.tiles_per_split) * BF);
  const int nk = (p.n_fft + BK - 1) / BK;
  for (int f0 = tile0 * BF; f0 < f_end; f0 += BF) {
    float fv[LOADS], cv[LOADS], sv[LOADS];
    // samples k0 .. k0 + 15 of the frames and bases; only the last slice of
    // an n_fft that is not a multiple of 16 (TAIL) masks the samples past it
    auto load = [&](int k0, auto tail) {
      constexpr bool TAIL = decltype(tail)::value;
#pragma unroll
      for (int l = 0; l < LOADS; ++l) {
        fv[l] = stage_ptr[l] && (!TAIL || k0 + tid % BK < p.n_fft) ? stage_ptr[l][k0] : 0.f;
        const int idx = tid + l * THREADS;
        const int f = f0 + idx % BF;
        const long long off = (long long)(k0 + idx / BF) * p.n_freqs + f;
        const bool ok = f < p.n_freqs && (!TAIL || k0 + idx / BF < p.n_fft);
        cv[l] = ok ? p.cos_b[off] : 0.f;
        sv[l] = ok ? p.sin_b[off] : 0.f;
      }
    };
    auto load_slice = [&](int k0) {
      if (!GENERAL || k0 + BK <= p.n_fft) load(k0, std::false_type{});
      else load(k0, std::true_type{});
    };
    auto store = [&](float* stage) {
      float* fr_s = stage;
      float* cos_s = stage + BK * LDR;
      float* sin_s = cos_s + BK * BF;
#pragma unroll
      for (int l = 0; l < LOADS; ++l) {
        const int idx = tid + l * THREADS;
        fr_s[(idx % BK) * LDR + idx / BK] = fv[l];
        cos_s[idx] = cv[l];
        sin_s[idx] = sv[l];
      }
    };

    float re[4][4], im[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) re[i][j] = im[i][j] = 0.f;

    load_slice(0);
    store(smem);
    __syncthreads();
    for (int c = 0; c < nk; ++c) {
      if (c + 1 < nk) load_slice((c + 1) * BK);
      const float* stage = smem + (c & 1) * STAGE;
      const float* fr_s = stage;
      const float* cos_s = stage + BK * LDR;
      const float* sin_s = cos_s + BK * BF;
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(fr_s + kk * LDR + 4 * ty);
        const float4 cc = *reinterpret_cast<const float4*>(cos_s + kk * BF + 4 * tx);
        const float4 ss = *reinterpret_cast<const float4*>(sin_s + kk * BF + 4 * tx);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float cvv[4] = {cc.x, cc.y, cc.z, cc.w};
        const float svv[4] = {ss.x, ss.y, ss.z, ss.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            re[i][j] = fmaf(av[i], cvv[j], re[i][j]);
            im[i][j] = fmaf(av[i], svv[j], im[i][j]);
          }
      }
      if (c + 1 < nk) store(smem + ((c + 1) & 1) * STAGE);
      __syncthreads();
    }

    // magnitudes (zero for the padded bins: their bases were zero)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mag_s[(4 * tx + j) * LDR + 4 * ty + i] =
            spectrum(re[i][j], im[i][j], p.power_mode, p.half_power);
    for (int idx = tid; idx < BF * mel_ld; idx += THREADS) {
      const int f = f0 + idx / mel_ld, m = idx % mel_ld;
      fb_s[idx] = (f < p.n_freqs && m < n_here) ? p.fbanks[(long long)f * p.n_mels + mel0 + m]
                                                 : 0.f;
    }
    __syncthreads();
    const int mcols = mel_ld / 16;
    for (int f = 0; f < BF; ++f) {
      const float4 mg4 = *reinterpret_cast<const float4*>(mag_s + f * LDR + 4 * ty);
      const float mg[4] = {mg4.x, mg4.y, mg4.z, mg4.w};
#pragma unroll
      for (int j = 0; j < MAXM / 16; ++j) {
        if (j < mcols) {
          const float w = fb_s[f * mel_ld + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(mg[i], w, acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

  const bool split = gridDim.y > 1;
  float* dst = split ? p.partial + (long long)blockIdx.y * p.rows * p.n_mels : p.out;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + 4 * ty + i;
    if (r >= p.rows) continue;
#pragma unroll
    for (int j = 0; j < MAXM / 16; ++j) {
      const int m = tx + 16 * j;
      if (m < n_here)
        dst[(long long)r * p.n_mels + mel0 + m] =
            split ? acc[i][j] : logf(fmaxf(acc[i][j], 1e-5f));
    }
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

}  // namespace

extern "C" int e2_mel_fwd(const void* frames, long long batch_stride, long long frame_stride,
                          int frames_per_batch, int rows, int n_fft, const void* cos_b,
                          const void* sin_b, int n_freqs, const void* fbanks, int n_mels,
                          void* out, void* partial, int nsplit, float power, void* stream) {
  const int tiles = (n_freqs + BF - 1) / BF;
  if (n_mels < 1 || n_fft < 1 || rows < 0 ||
      frames_per_batch < 1 || nsplit < 1 || nsplit > tiles || (nsplit > 1 && !partial))
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
  p.tiles_per_split = (tiles + nsplit - 1) / nsplit;
  nsplit = (tiles + p.tiles_per_split - 1) / p.tiles_per_split;  // no empty split
  p.power_mode = power == 1.f ? 1 : (power == 2.f ? 2 : 0);
  p.half_power = 0.5f * power;

  const size_t phase_a = (size_t)2 * STAGE * sizeof(float);
  const int mel_ld = ((n_mels < MAXM ? n_mels : MAXM) + 15) / 16 * 16;  // widest group
  const size_t phase_b = (size_t)(BF * LDR + BF * mel_ld) * sizeof(float);
  const size_t bytes = phase_a > phase_b ? phase_a : phase_b;
  const bool general = n_mels > MAXM || n_fft % BK != 0;
  auto kernel = general ? mel_fwd_kernel<true> : mel_fwd_kernel<false>;
  if (bytes > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)((rows + BR - 1) / BR), (unsigned)nsplit,
                  (unsigned)((n_mels + MAXM - 1) / MAXM));
  kernel<<<grid, THREADS, bytes, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return (int)err;
  const long long total = (long long)rows * n_mels;
  long long blocks = (total + 255) / 256;
  if (blocks > 132 * 8) blocks = 132 * 8;
  mel_log_kernel<<<(unsigned)blocks, 256, 0, s>>>(p.partial, p.out, total, nsplit);
  return (int)cudaGetLastError();
}
