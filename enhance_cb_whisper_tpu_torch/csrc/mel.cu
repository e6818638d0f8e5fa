// Fused Whisper front end: reflect-padded framing -> Hann-windowed real DFT
// -> power -> mel filterbank -> log10, in one pass.
//
// Replaces the TPU kernel enhance_cb_whisper_tpu/ops/mel_pallas.py:_mel_kernel
// (launched by log_mel_spectrogram_pallas).  What it computes is that
// kernel's function, not its block layout:
//
//   out[b, m, t] = log10(max(sum_k fb[k, m] * |sum_n x_b[t*160 + n - 200] * w[n] e^{-2 pi i k n / 400}|^2, 1e-10))
//
// for t < n_samples / 160 (the final STFT frame is never computed: Whisper
// drops it), x reflect-padded by 200 at both ends.  The per-audio max, the
// clamp at max - 8 and (x + 4) / 4 stay outside, in torch ops.
//
// Bound.  The function reads 4 B of audio per sample and writes 4 B per
// (mel, frame) output: 2.9 MB per 30 s utterance, 0.86 us at 3.35 TB/s.  Its
// least arithmetic (a real FFT per frame) is ~31 MFLOP, 0.47 us at the FP32
// peak, so it is bytes-bound.  This kernel is not: at batch 8 it is bound by
// issuing its FP32 instructions (~24 k per frame, two thirds of them in
// stage 2's 20-point DFTs), and at batch 1 by one launch's latency, which is
// larger than either bound.  Everything is plain FP32: the JAX kernel runs at
// Precision.HIGHEST, so no TF32 and no tensor cores.  A 3xTF32 split would
// keep the precision, but the factored transform's ~30 MFLOP per utterance
// already costs less than one launch.
//
// Design.
//   * One block = kFrames consecutive frames of one audio.  The samples they
//     read are staged once in shared memory, reflect padding resolved while
//     staging.  The twiddle, window and filterbank tables (4.8 KB + ~2.6 KB)
//     are staged there too; nothing is read from device memory in the
//     transform or the filterbank.
//   * The 400-point DFT is factored 400 = 20 x 20 (Cooley-Tukey).  With
//     n = 20 n1 + n2 and k = k1 + 20 k2,
//       X[k] = sum_n2 W20^(n2 k2) * W400^(n2 k1) * Y[n2, k1],
//       Y[n2, k1] = sum_n1 x_w[20 n1 + n2] * W20^(n1 k1),
//     W_N = e^{-2 pi i / N}, x_w the frame times the Hann window (applied as
//     the samples are read).  Stage 1: one thread per (frame, n2) computes a
//     real 20-point DFT; its output is conjugate-symmetric, so it keeps bins
//     k1 = 0..10.  Stage 2: one thread per (frame, k1) applies the twiddle
//     W400^(n2 k1) and a 20-point complex DFT over n2, for the k2 with
//     k = k1 + 20 k2 <= 200.  Both 20-point DFTs are direct: ~24 k FP32
//     instructions per frame against the 400 x 201 direct DFT's ~160 k.
//     Every twiddle is the shared 400-entry cos/sin table at (a b) mod 400.
//     The W20 ones sit in registers, and the multiples of pi/2 among them are
//     adds.  Each stage streams its inputs from shared memory and keeps its
//     22 outputs in registers (48 registers a thread, no spills).
//   * Stage buffers share one shared-memory region: samples, then the
//     stage-1 output, then the power spectrum.  Each stage reads all its
//     inputs, passes a barrier, then writes its outputs over them.
//   * The power spectrum never leaves the SM.  The filterbank is sparse:
//     each mel sums its contiguous run of nonzero taps (<= 14 at 80 mels,
//     391 taps in all, against 16,080 dense) in ascending bin order, which
//     gives the dense sum bit for bit.  Consecutive threads take consecutive
//     frames, so the [n_mels, T] stores coalesce.
//   * The grid: 8 frames per block, 160 threads (5 warps), ~22 KB of shared
//     memory.  [1, 480000] is 375 blocks, so every one of the 132 SMs holds
//     two or three of them at once (with 16 frames, 188 blocks: two on 56
//     SMs and one on the other 76).  On an H100, 8 frames ran faster than 4
//     or 16 at batch 1 and at batch 8.
//   * Two real frames are not packed into one complex transform.  That would
//     halve the work, but the two spectra would then be separated by a
//     subtraction, so a near-silent frame next to a loud one would take an
//     error of the loud frame's size.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNFft = 400;
constexpr int kHop = 160;
constexpr int kPad = kNFft / 2;
constexpr int kRadix = 20;                       // 400 = 20 x 20
constexpr int kHalf = kRadix / 2 + 1;            // 11 distinct bins of a real 20-point DFT
constexpr int kFrames = 8;                       // frames per block: see the design note
constexpr int kThreads = kFrames * kRadix;       // one per (frame, n2), then per (frame, k1)
constexpr int kSpan = (kFrames - 1) * kHop + kNFft;
// per-frame strides of the stage buffers, padded so that the 20 threads of
// one frame and their neighbours in the warp fall in distinct banks
constexpr int kYStride = 235;                    // >= 20 * 11, = 11 mod 32
constexpr int kPowerStride = 212;                // >= 201, = 20 mod 32
constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int kWork = cmax(kSpan, cmax(2 * kFrames * kYStride, kFrames * kPowerStride));

// Asynchronous copies to shared memory (cp.async): every staging load of a
// block is in flight at once, where a load-then-store loop waits for one
// round trip to L2 per step.  cp_async4 zero-fills when `valid` is false.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// acc += v * W20^j for a real v, W20^j = cos(2 pi j / 20) - i sin(2 pi j / 20),
// with c[j] = cos and s[j] = sin for j <= 10.  j is a constant once the
// caller's loops unroll, so the branches fold; multiples of pi/2 are adds.
__device__ __forceinline__ void mac_w20(float& re, float& im, float v, int j,
                                        const float* c, const float* s) {
  if (j == 0) {
    re += v;
  } else if (j == 10) {
    re -= v;
  } else if (j == 5) {
    im -= v;
  } else if (j == 15) {
    im += v;
  } else {
    re = fmaf(v, c[j < 10 ? j : 20 - j], re);
    im = fmaf(v, j < 10 ? -s[j] : s[20 - j], im);
  }
}

// acc += (zr + i zi) * W20^j, as mac_w20
__device__ __forceinline__ void cmac_w20(float& re, float& im, float zr, float zi, int j,
                                         const float* c, const float* s) {
  if (j == 0) {
    re += zr;
    im += zi;
  } else if (j == 10) {
    re -= zr;
    im -= zi;
  } else if (j == 5) {  // * -i
    re += zi;
    im -= zr;
  } else if (j == 15) {  // * +i
    re -= zi;
    im += zr;
  } else {
    const float cw = c[j < 10 ? j : 20 - j];
    const float sw = j < 10 ? s[j] : -s[20 - j];
    re = fmaf(zr, cw, fmaf(zi, sw, re));
    im = fmaf(zi, cw, fmaf(-zr, sw, im));
  }
}

__global__ void __launch_bounds__(kThreads)
log_mel_kernel(const float* __restrict__ audio, float* __restrict__ out,
               const float* __restrict__ tables, const float* __restrict__ fb_w,
               const int* __restrict__ fb_meta, int n_samples, int n_frames,
               int n_mels, int n_taps) {
  // cos(2 pi j / 400), sin(2 pi j / 400), Hann window w[j], j < 400
  __shared__ __align__(16) float tab_s[3 * kNFft];
  // samples, then stage-1 output (re, im), then power: see the design note
  __shared__ __align__(16) float work[kWork];
  // sparse filterbank: packed taps, then per mel its first bin, then the
  // n_mels + 1 offsets of each mel's taps in the packed array
  extern __shared__ float fb_s[];
  int* meta_s = reinterpret_cast<int*>(fb_s + n_taps);
  const float* cos_s = tab_s;
  const float* sin_s = tab_s + kNFft;
  const float* win_s = tab_s + 2 * kNFft;

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kFrames;
  const float* a = audio + static_cast<int64_t>(b) * n_samples;

  for (int i = threadIdx.x; i < 3 * kNFft / 4; i += kThreads) cp_async16(tab_s + 4 * i, tables + 4 * i);
  for (int i = threadIdx.x; i < n_taps; i += kThreads) cp_async4(fb_s + i, fb_w + i, true);
  for (int i = threadIdx.x; i < 2 * n_mels + 1; i += kThreads) cp_async4(meta_s + i, fb_meta + i, true);
  // stage the tile's samples; padded index p maps to original p - 200,
  // reflected at both ends (numpy/jnp "reflect": the edge is not repeated).
  // Frames past n_frames (the ragged last tile) read zeros or reflected
  // samples and are not stored.
  for (int i = threadIdx.x; i < kSpan; i += kThreads) {
    int j = t0 * kHop + i - kPad;
    if (j < 0) j = -j;
    if (j >= n_samples) j = 2 * (n_samples - 1) - j;
    const bool in = j >= 0 && j < n_samples;
    cp_async4(work + i, in ? a + j : a, in);
  }
  cp_async_wait_all();
  __syncthreads();

  const int f = threadIdx.x / kRadix;  // frame in the tile
  const int r = threadIdx.x % kRadix;  // n2 in stage 1, k1 in stage 2
  float c[kHalf], s[kHalf];            // W20 twiddles
#pragma unroll
  for (int j = 0; j < kHalf; ++j) {
    c[j] = cos_s[kRadix * j];
    s[j] = sin_s[kRadix * j];
  }

  // stage 1: real 20-point DFT of x_w[20 n1 + n2] over n1, bins k1 = 0..10;
  // the samples stream through, the bins stay in registers
  float yr[kHalf], yi[kHalf];
#pragma unroll
  for (int k1 = 0; k1 < kHalf; ++k1) yr[k1] = yi[k1] = 0.0f;
#pragma unroll
  for (int n1 = 0; n1 < kRadix; ++n1) {
    const float v = work[f * kHop + kRadix * n1 + r] * win_s[kRadix * n1 + r];
#pragma unroll
    for (int k1 = 0; k1 < kHalf; ++k1) mac_w20(yr[k1], yi[k1], v, (n1 * k1) % kRadix, c, s);
  }
  __syncthreads();  // every thread has read its samples; work now takes Y
  float* y_re = work + f * kYStride + r * kHalf;  // all frames' re, then all frames' im
  float* y_im = y_re + kFrames * kYStride;
#pragma unroll
  for (int k1 = 0; k1 < kHalf; ++k1) {
    y_re[k1] = yr[k1];
    y_im[k1] = yi[k1];  // exactly 0 at k1 = 0 and 10
  }
  __syncthreads();

  // stage 2: twiddle, then a 20-point complex DFT over n2 for k1 = r, the
  // outputs X[k1 + 20 k2] in registers (k2 = 10 is kept for k1 = 0 only);
  // Y[n2, k1] for k1 > 10 is conj(Y[n2, 20 - k1]) (real input)
  const int k1 = r;
  const int src = k1 < kHalf ? k1 : kRadix - k1;
  const float conj = k1 < kHalf ? 1.0f : -1.0f;
  float xr[kHalf], xi[kHalf];
#pragma unroll
  for (int k2 = 0; k2 < kHalf; ++k2) xr[k2] = xi[k2] = 0.0f;
#pragma unroll
  for (int n2 = 0; n2 < kRadix; ++n2) {
    float zr = work[f * kYStride + n2 * kHalf + src];
    float zi = conj * work[(kFrames + f) * kYStride + n2 * kHalf + src];
    if (n2 > 0) {  // * W400^(n2 k1) = cos - i sin; n2 k1 <= 361
      const float ct = cos_s[n2 * k1], st = sin_s[n2 * k1];
      const float tr = fmaf(zr, ct, zi * st);
      zi = fmaf(zi, ct, -zr * st);
      zr = tr;
    }
#pragma unroll
    for (int k2 = 0; k2 < kHalf; ++k2) cmac_w20(xr[k2], xi[k2], zr, zi, (n2 * k2) % kRadix, c, s);
  }
  __syncthreads();  // every thread has read Y; work now takes the power spectrum
  float* power = work + f * kPowerStride + k1;
#pragma unroll
  for (int k2 = 0; k2 < kHalf - 1; ++k2) power[kRadix * k2] = fmaf(xr[k2], xr[k2], xi[k2] * xi[k2]);
  if (k1 == 0) power[kRadix * (kHalf - 1)] = fmaf(xr[kHalf - 1], xr[kHalf - 1], xi[kHalf - 1] * xi[kHalf - 1]);
  __syncthreads();

  // mel filterbank + log10; consecutive threads take consecutive frames so
  // the [n_mels, T] stores coalesce
  for (int idx = threadIdx.x; idx < kFrames * n_mels; idx += kThreads) {
    const int ff = idx % kFrames;
    const int m = idx / kFrames;
    const int t = t0 + ff;
    const float* p = work + ff * kPowerStride + meta_s[m];
    const int lo = meta_s[n_mels + m], hi = meta_s[n_mels + m + 1];
    float acc = 0.0f;
    for (int j = lo; j < hi; ++j) acc = fmaf(p[j - lo], fb_s[j], acc);
    if (t < n_frames) {
      out[(static_cast<int64_t>(b) * n_mels + m) * n_frames + t] = log10f(fmaxf(acc, 1e-10f));
    }
  }
}

}  // namespace

// audio [batch, n_samples] f32 (n_samples % 160 == 0, n_samples > 200);
// tables [3, 400] f32: cos(2 pi j / 400), sin(2 pi j / 400), Hann window;
// fb_w [n_taps] f32 and fb_meta [2 n_mels + 1] int32: the sparse filterbank
// (ops/mel_cuda.py:sparse_filterbank); out [batch, n_mels, n_samples / 160] f32.
// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int ecw_log10_mel(const float* audio, float* out, const float* tables,
                             const float* fb_w, const int* fb_meta, int batch,
                             int n_samples, int n_mels, int n_taps, void* stream) {
  const int n_frames = n_samples / kHop;
  const dim3 grid((n_frames + kFrames - 1) / kFrames, batch);
  const size_t smem = sizeof(float) * n_taps + sizeof(int) * (2 * n_mels + 1);
  log_mel_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      audio, out, tables, fb_w, fb_meta, n_samples, n_frames, n_mels, n_taps);
  return static_cast<int>(cudaGetLastError());
}
