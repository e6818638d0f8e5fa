// Fused Whisper front end: reflect-padded framing -> Hann-windowed real DFT
// -> power -> mel filterbank -> log10, in one pass.
//
// Replaces the TPU kernel enhance_cb_whisper_tpu/ops/mel_pallas.py:_mel_kernel.
// What it computes is that kernel's function, not its block layout:
//
//   out[b, m, t] = log10(max(sum_k fb[k, m] * |sum_n x_b[t*160 + n - 200] * w[n] e^{-2 pi i k n / 400}|^2, 1e-10))
//
// for t < n_samples / 160 (the final STFT frame is never computed: Whisper
// drops it), x reflect-padded by 200 at both ends.  The per-audio max, the
// clamp at max - 8 and (x + 4) / 4 stay outside, in torch ops.
//
// Bound: plain FP32 FMA throughput — ~0.96 GFLOP per 30 s of audio
// (3000 frames x 400 taps x 201 bins x 2 (cos, sin) x 2 flops), no TF32 and
// no bf16 (the JAX kernel runs at Precision.HIGHEST).  Design:
//   * one block = FT consecutive frames of one audio; the 2,800 samples they
//     read are staged once in shared memory (reflect padding resolved while
//     staging), so each sample is read from device memory ~once per tile;
//   * one thread per DFT bin; it streams its column of the windowed cos/sin
//     tables ([400, 224], 358 KB each — too big for shared memory) through
//     L1/L2 and keeps FT complex accumulators in registers; the frame
//     samples are float4 broadcasts from shared memory;
//   * power goes to shared memory only: the [frames, 201] power spectrogram
//     never reaches device memory, which is the point of the fusion;
//   * the filterbank matmul and log10 run on the staged power and write the
//     [n_mels, T] layout the encoder reads.
// First version: no tensor cores, no TMA — right before fast.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNFft = 400;
constexpr int kHop = 160;
constexpr int kPad = kNFft / 2;
constexpr int kBins = kNFft / 2 + 1;           // 201
constexpr int kThreads = 224;                  // 7 warps >= 201 bins
constexpr int kTableCols = kThreads;           // table row stride (zero past 201)
constexpr int kFramesPerTile = 16;
constexpr int kSpan = (kFramesPerTile - 1) * kHop + kNFft;  // 2800 samples
constexpr int kPowerStride = kBins + 2;        // 203: odd, conflict-free rows

__global__ void __launch_bounds__(kThreads)
log_mel_kernel(const float* __restrict__ audio, float* __restrict__ out,
               const float* __restrict__ cos_t, const float* __restrict__ sin_t,
               const float* __restrict__ fb, int n_samples, int n_frames,
               int n_mels) {
  __shared__ __align__(16) float xs[kSpan];
  __shared__ float power[kFramesPerTile * kPowerStride];

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kFramesPerTile;
  const float* a = audio + static_cast<int64_t>(b) * n_samples;

  // stage the tile's samples; padded index p maps to original p - 200,
  // reflected at both ends (numpy/jnp "reflect": the edge is not repeated).
  // Frames past n_frames (the ragged last tile) read zeros and are not stored.
  for (int i = threadIdx.x; i < kSpan; i += kThreads) {
    int j = t0 * kHop + i - kPad;
    if (j < 0) j = -j;
    if (j >= n_samples) j = 2 * (n_samples - 1) - j;
    xs[i] = (j >= 0 && j < n_samples) ? a[j] : 0.0f;
  }
  __syncthreads();

  // windowed real DFT, one bin per thread, FT frames at once
  const int k = threadIdx.x;
  float re[kFramesPerTile];
  float im[kFramesPerTile];
#pragma unroll
  for (int f = 0; f < kFramesPerTile; ++f) {
    re[f] = 0.0f;
    im[f] = 0.0f;
  }
  for (int n = 0; n < kNFft; n += 4) {
    float c[4], s[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      c[q] = __ldg(cos_t + (n + q) * kTableCols + k);
      s[q] = __ldg(sin_t + (n + q) * kTableCols + k);
    }
#pragma unroll
    for (int f = 0; f < kFramesPerTile; ++f) {
      const float4 x = *reinterpret_cast<const float4*>(xs + f * kHop + n);
      re[f] = fmaf(x.x, c[0], re[f]);
      im[f] = fmaf(x.x, s[0], im[f]);
      re[f] = fmaf(x.y, c[1], re[f]);
      im[f] = fmaf(x.y, s[1], im[f]);
      re[f] = fmaf(x.z, c[2], re[f]);
      im[f] = fmaf(x.z, s[2], im[f]);
      re[f] = fmaf(x.w, c[3], re[f]);
      im[f] = fmaf(x.w, s[3], im[f]);
    }
  }
  if (k < kBins) {
#pragma unroll
    for (int f = 0; f < kFramesPerTile; ++f) {
      power[f * kPowerStride + k] = re[f] * re[f] + im[f] * im[f];
    }
  }
  __syncthreads();

  // mel filterbank + log10; consecutive threads take consecutive frames so
  // the [n_mels, T] stores coalesce
  for (int idx = threadIdx.x; idx < kFramesPerTile * n_mels; idx += kThreads) {
    const int f = idx % kFramesPerTile;
    const int m = idx / kFramesPerTile;
    const int t = t0 + f;
    const float* p = power + f * kPowerStride;
    float acc = 0.0f;
    for (int kk = 0; kk < kBins; ++kk) {
      acc = fmaf(p[kk], __ldg(fb + kk * n_mels + m), acc);
    }
    if (t < n_frames) {
      out[(static_cast<int64_t>(b) * n_mels + m) * n_frames + t] =
          log10f(fmaxf(acc, 1e-10f));
    }
  }
}

}  // namespace

// audio [batch, n_samples] f32 (n_samples % 160 == 0, n_samples > 200);
// cos_t/sin_t [400, 224] f32 windowed DFT tables (zero past column 201);
// fb [201, n_mels] f32; out [batch, n_mels, n_samples / 160] f32.
// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int ecw_log10_mel(const float* audio, float* out, const float* cos_t,
                             const float* sin_t, const float* fb, int batch,
                             int n_samples, int n_mels, void* stream) {
  const int n_frames = n_samples / kHop;
  const dim3 grid((n_frames + kFramesPerTile - 1) / kFramesPerTile, batch);
  log_mel_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      audio, out, cos_t, sin_t, fb, n_samples, n_frames, n_mels);
  return static_cast<int>(cudaGetLastError());
}

// Table geometry the Python wrapper must match.
extern "C" int ecw_log10_mel_table_cols() { return kTableCols; }
