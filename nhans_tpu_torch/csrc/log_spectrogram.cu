// Fused waveform -> log-magnitude spectrogram for Hopper (sm_90a).
//
// Replaces the TPU kernel nhans_tpu/ops/stft_pallas.py::pallas_log_spectrogram
// (pallas_call at stft_pallas.py:121).  For each 400-sample frame (hop 160,
// periodic Hann window, no pad_end) it computes the 201-bin real DFT and
// writes log(sqrt(re^2 + im^2) + 1e-5); with re/im outputs given it also
// writes the raw re and im.
//
// What bounds it: per frame the function reads 160 new samples (640 B,
// the hop) and writes 2.4 KB (with re/im), and with an FFT it needs about
// 10,000 operations (2.5 N log2 N for a real 400-point FFT, the window, the
// log-magnitude), about 3 per byte, so its least time on an H100 is set by
// the 3.35 TB/s of device memory.  This kernel does not get near that: it
// takes the direct DFT, 2 * 400 * 402 = 321,600 float32 operations per
// frame, 32 times the FFT's work and about 105 per byte, so the float32
// CUDA-core rate (67 TFLOP/s) holds it to about 5x the byte bound at best.
// An FFT or tensor-core design is queued in ROADMAP.md.  The reference
// takes its DFT at Precision.HIGHEST, so the products are true
// float32 FMAs: no TF32, no tensor cores.
//
// Design: one block computes a tile of 64 frames x 32 bins of one row.
//   * The waveform span of its frames, (64 - 1) * 160 + 400 samples, is
//     staged once in shared memory (41.9 KB) and read by all its threads;
//     a frame is 400 contiguous samples of it.
//   * The windowed DFT basis is not kept whole (400 x 402 float32 is 643 KB,
//     more than a block's 227 KB of shared memory).  Since the angle of
//     basis entry (n, k) is 2*pi*((n*k) mod 400)/400, each 16-row slice of
//     the basis for the block's 32 bins is rebuilt in shared memory from a
//     400-entry cos table and the 400-entry window (3.2 KB, read through
//     the read-only cache).  -sin(2*pi*m/400) = cos(2*pi*(m+100)/400), so
//     the one table serves both.  Entry = float(w) * float(cos) rounded
//     once in float32, against float32(w * cos) taken in float64 by the
//     plain version's _dft_bases_np: they differ by at most about 1 ulp.
//   * 128 threads each hold 8 frames x 2 bins of (re, im) in registers,
//     so each step of the product reads 8 samples and 4 basis values from
//     shared memory for 32 FMAs.
//   * The ragged last frame tile and the bins past 200 are masked at the
//     store; samples past the row's end read as zero.  F = 0 never
//     launches (the wrapper returns empty outputs).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFrameLength = 400;
constexpr int kFrameStep = 160;
constexpr int kBins = kFrameLength / 2 + 1;            // 201
constexpr float kLogEps = 1e-5f;

constexpr int kTileFrames = 64;                        // frames per block
constexpr int kTileBins = 32;                          // bins per block
constexpr int kThreadFrames = 8;                       // frames per thread
constexpr int kThreadBins = 2;                         // bins per thread
constexpr int kFrameThreads = kTileFrames / kThreadFrames;   // 8
constexpr int kBinThreads = kTileBins / kThreadBins;         // 16
constexpr int kThreads = kFrameThreads * kBinThreads;        // 128
constexpr int kChunk = 16;                             // basis rows per step
constexpr int kSpan = (kTileFrames - 1) * kFrameStep + kFrameLength;  // 10480

static_assert(kFrameLength % kChunk == 0, "basis chunks must tile the frame");

// tables: [0, 400) cos(2*pi*m/400), [400, 800) periodic Hann window.
__global__ void __launch_bounds__(kThreads)
log_spectrogram_kernel(const float* __restrict__ x, float* __restrict__ lm,
                       float* __restrict__ re_out, float* __restrict__ im_out,
                       const float* __restrict__ tables, int L, int F) {
  __shared__ float span[kSpan];
  __shared__ float basis[kChunk][2 * kTileBins];  // [n][cos bins | sin bins]

  const int tid = threadIdx.x;
  const int f0 = blockIdx.x * kTileFrames;
  const int k0 = blockIdx.y * kTileBins;
  const int row = blockIdx.z;
  const float* xr = x + static_cast<int64_t>(row) * L;

  const int64_t s0 = static_cast<int64_t>(f0) * kFrameStep;
  for (int i = tid; i < kSpan; i += kThreads) {
    const int64_t s = s0 + i;
    span[i] = s < L ? xr[s] : 0.0f;
  }

  const int tb = tid % kBinThreads;   // bins k0 + tb + 16 * j
  const int tf = tid / kBinThreads;   // frames f0 + tf + 8 * i
  float acc_re[kThreadFrames][kThreadBins];
  float acc_im[kThreadFrames][kThreadBins];
#pragma unroll
  for (int i = 0; i < kThreadFrames; ++i) {
#pragma unroll
    for (int j = 0; j < kThreadBins; ++j) {
      acc_re[i][j] = 0.0f;
      acc_im[i][j] = 0.0f;
    }
  }

  for (int n0 = 0; n0 < kFrameLength; n0 += kChunk) {
    __syncthreads();  // the span is staged / the previous slice is consumed
    for (int e = tid; e < kChunk * kTileBins; e += kThreads) {
      const int r = e / kTileBins;
      const int c = e % kTileBins;
      const int n = n0 + r;
      const int m = (n * (k0 + c)) % kFrameLength;
      const float w = __ldg(tables + kFrameLength + n);
      basis[r][c] = w * __ldg(tables + m);
      basis[r][kTileBins + c] =
          w * __ldg(tables + (m + kFrameLength / 4) % kFrameLength);
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < kChunk; ++r) {
      float a[kThreadFrames];
#pragma unroll
      for (int i = 0; i < kThreadFrames; ++i)
        a[i] = span[(tf + kFrameThreads * i) * kFrameStep + n0 + r];
      float bc[kThreadBins], bs[kThreadBins];
#pragma unroll
      for (int j = 0; j < kThreadBins; ++j) {
        bc[j] = basis[r][tb + kBinThreads * j];
        bs[j] = basis[r][kTileBins + tb + kBinThreads * j];
      }
#pragma unroll
      for (int i = 0; i < kThreadFrames; ++i) {
#pragma unroll
        for (int j = 0; j < kThreadBins; ++j) {
          acc_re[i][j] = fmaf(a[i], bc[j], acc_re[i][j]);
          acc_im[i][j] = fmaf(a[i], bs[j], acc_im[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kThreadFrames; ++i) {
    const int f = f0 + tf + kFrameThreads * i;
    if (f >= F) continue;
    const int64_t base = (static_cast<int64_t>(row) * F + f) * kBins;
#pragma unroll
    for (int j = 0; j < kThreadBins; ++j) {
      const int k = k0 + tb + kBinThreads * j;
      if (k >= kBins) continue;
      const float r = acc_re[i][j];
      const float q = acc_im[i][j];
      lm[base + k] = logf(sqrtf(r * r + q * q) + kLogEps);
      if (re_out != nullptr) {
        re_out[base + k] = r;
        im_out[base + k] = q;
      }
    }
  }
}

}  // namespace

// x [B, L], lm/re/im [B, F, 201] float32, contiguous, on the device.
// re and im are both null for the log-only variant.  Returns the
// cudaError_t of the launch (0 = cudaSuccess).
extern "C" int nhans_log_spectrogram(const float* x, float* lm, float* re,
                                     float* im, const float* tables, int B,
                                     int L, int F, void* stream) {
  if (B <= 0 || F <= 0) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((F + kTileFrames - 1) / kTileFrames,
            (kBins + kTileBins - 1) / kTileBins, B);
  log_spectrogram_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      x, lm, re, im, tables, L, F);
  return static_cast<int>(cudaGetLastError());
}
