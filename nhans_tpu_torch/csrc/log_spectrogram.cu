// Fused waveform -> log-magnitude spectrogram for Hopper (sm_90a), by a
// float32 FFT in shared memory.
//
// Replaces the TPU kernel nhans_tpu/ops/stft_pallas.py::pallas_log_spectrogram
// (pallas_call at stft_pallas.py:121).  For each 400-sample frame (hop 160,
// periodic Hann window, no pad_end) it computes the 201-bin real DFT and
// writes log(sqrt(re^2 + im^2) + 1e-5); with re/im outputs given it also
// writes the raw re and im.
//
// What bounds it: bytes.  Per frame the function reads 160 new samples
// (640 B, the hop) and writes 201 floats per output: 3,052 B with re/im,
// 1,444 B log-only.  The H100's float32 line lies at 67e12 / 3.35e12 = 20
// operations per byte, about 61,000 operations per frame with re/im and
// 29,000 log-only.  This kernel does about 11,300 (FMA counted as 2, sqrt
// and log as 1 each):
//   window 400; two radix-5 stages 2 x 40 x 48 = 3,840; their twiddles
//   40 x 4 x 6 = 960; the radix-8 stage 25 x 56 = 1,400 and its twiddles
//   25 x 7 x 6 = 1,050; the real split 101 x 18 = 1,818; the
//   log-magnitude 201 x 5 = 1,005; and, in float64, the two real bins
//   400 x 2 = 800 (step 6).
// So it stays bound by bytes in both variants.  The FFT is true float32
// FMAs on the CUDA cores: no TF32, no tensor cores, no fast math (the
// reference takes its DFT at Precision.HIGHEST).
//
// Design: one block of 160 threads computes 4 consecutive frames of one
// row, all 201 bins; the grid is 1-D over B * ceil(F / 4) blocks, so a
// 10 s row (F = 998) alone launches 250 blocks for the 132 SMs.
//   1. Staging: the tile's waveform span, 3 * 160 + 400 = 880 samples, is
//      read from device memory once, by 16-byte loads where it lies whole
//      in the row and starts 16-byte aligned, else sample by sample (a row
//      starts at row * L, which is not aligned when L % 4 != 0) with zero
//      past the row's end.  The window and the cos table come into shared
//      memory beside it by 16-byte loads.
//   2. Pack: the 400 windowed real samples of a frame are the 200 complex
//      values z[m] = xw[2m] + i xw[2m+1], read by the first stage directly
//      from the span (samples and window as float2).
//   3. A 200-point complex FFT, 200 = 5 * 5 * 8, in three Stockham stages
//      (radix 5 with Ns = 1, radix 5 with Ns = 5, radix 8 with Ns = 25)
//      that ping-pong between two shared buffers, so no digit-reversal pass
//      is needed.  A stage of radix R reads v[r] = z[j + r * 200 / R],
//      multiplies v[r] by exp(-2 pi i (j % Ns) r / (Ns R)), takes the
//      R-point DFT and writes it to (j / Ns) * Ns * R + j % Ns + r * Ns.
//      The radix-5 stages take the 40 butterflies of each frame, one per
//      thread; the radix-8 stage 25 per frame.  Radix 5 comes first: the
//      first stage writes with stride 5, which no two threads of a warp
//      share a bank at.
//   4. Real split, with W = exp(-2 pi i / 400) and Z[200] = Z[0]:
//        X[k] = (Z[k] + conj Z[200-k]) / 2 - i W^k (Z[k] - conj Z[200-k]) / 2,
//      one thread per pair (k, 200 - k), k = 0..100, which share both Z
//      values and W^k.
//   5. Store: the 4 frames of a tile are one contiguous run of 4 * 201
//      floats in each output.  Each run is staged in shared memory, shifted
//      by the misalignment of its start in device memory, and written by
//      16-byte stores, neighbouring threads on neighbouring addresses; the
//      ragged ends and frames past F are masked.  The log-only variant
//      writes only the log-magnitude.
//   6. The two real bins, 0 and 200, are the sum and the alternating sum
//      of the windowed frame.  Their values are real and, unlike a complex
//      bin's, fall within 1e-5 of zero often enough to matter: in 10^5 frames
//      of noise some |X[0]| or |X[200]| is a few 1e-5, where
//      log(|X| + 1e-5) turns the float32 FFT's absolute error, about
//      1e-7 x max|X|, into an error of 1e-2.  So they are summed in
//      float64, samples times the window held in float64: each thread of
//      stage 1 sums the 10 samples it reads, the sums wait in the span's
//      place, and the warp that stage 3 leaves idle adds them up.  The
//      split takes the two bins from there, rounded once to float32, with
//      an imaginary part of exactly 0.
//   Every twiddle, and W^k, is a power of exp(-2 pi i / 400): cos and sin
//   come from the 400-entry cos table built in float64 and rounded once
//   (-sin(2 pi m / 400) = cos(2 pi (m + 100) / 400)), which the block
//   keeps as 500 entries so that m + 100 needs no wrap.  The radix-5 and
//   radix-8 butterflies' own constants are literals.  F = 0 never launches
//   (the wrapper returns empty outputs).  At most 40 registers a thread
//   (the launch bounds) and 19,984 bytes of shared memory a block let 10
//   blocks, 50 warps, share an SM.
//
// Against the direct-DFT kernel this replaces: it does about 1/30 of the
// operations (11,300 against 321,600 per frame); it reads each sample of
// the span once per tile, not once per 32-bin tile (7 times); it computes
// exactly the 201 bins, not 224; it has no basis to rebuild, no bank
// conflict on the samples, and 5 __syncthreads per block, not 50; and a
// 10 s row fills the card with 250 blocks, not 112.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFrameLength = 400;
constexpr int kFrameStep = 160;
constexpr int kBins = kFrameLength / 2 + 1;            // 201
constexpr int kN = kFrameLength / 2;                   // complex FFT length
constexpr int kPairs = kN / 2 + 1;                     // (k, 200 - k), k <= 100
constexpr int kCos = kFrameLength + kFrameLength / 4;  // 500
constexpr float kLogEps = 1e-5f;

constexpr int kTileFrames = 4;                         // frames per block
constexpr int kFrameThreads = kN / 5;                  // 40 radix-5 butterflies
constexpr int kThreads = kTileFrames * kFrameThreads;  // 160
constexpr int kSpan = (kTileFrames - 1) * kFrameStep + kFrameLength;  // 880
constexpr int kZ = kTileFrames * kN;                   // one FFT buffer, re or im
constexpr int kRun = kTileFrames * kBins + 4;          // 808: one output + shift
// span and the second FFT buffer, later the three staged output runs
constexpr int kWork = kSpan + 2 * kZ > 3 * kRun ? kSpan + 2 * kZ : 3 * kRun;

static_assert(kN == 5 * 5 * 8, "the stages below factor 200 as 5 * 5 * 8");

constexpr float kC1 = 0.309016994374947424f;   // cos(2 pi / 5)
constexpr float kC2 = -0.809016994374947424f;  // cos(4 pi / 5)
constexpr float kS1 = 0.951056516295153572f;   // sin(2 pi / 5)
constexpr float kS2 = 0.587785252292473129f;   // sin(4 pi / 5)
constexpr float kH = 0.707106781186547524f;    // sqrt(1 / 2)

struct cpx {
  float re, im;
};

__device__ __forceinline__ cpx add(cpx a, cpx b) { return {a.re + b.re, a.im + b.im}; }
__device__ __forceinline__ cpx sub(cpx a, cpx b) { return {a.re - b.re, a.im - b.im}; }
__device__ __forceinline__ cpx mul(cpx a, cpx w) {
  return {a.re * w.re - a.im * w.im, a.re * w.im + a.im * w.re};
}
__device__ __forceinline__ cpx mul_mi(cpx a) { return {a.im, -a.re}; }  // -i a

// exp(-2 pi i m / 400) from the shared cos table, m in [0, 400)
__device__ __forceinline__ cpx twiddle(const float* cosw, int m) {
  return {cosw[m], cosw[m + kFrameLength / 4]};
}

// In-place forward DFTs, X[k] = sum_n a[n] exp(-2 pi i n k / R).
__device__ __forceinline__ void dft5(cpx* a) {
  const cpx t1 = add(a[1], a[4]), t2 = add(a[2], a[3]);
  const cpx t3 = sub(a[1], a[4]), t4 = sub(a[2], a[3]);
  const cpx b1 = {a[0].re + kC1 * t1.re + kC2 * t2.re,
                  a[0].im + kC1 * t1.im + kC2 * t2.im};
  const cpx b2 = {a[0].re + kC2 * t1.re + kC1 * t2.re,
                  a[0].im + kC2 * t1.im + kC1 * t2.im};
  const cpx d1 = mul_mi({kS1 * t3.re + kS2 * t4.re, kS1 * t3.im + kS2 * t4.im});
  const cpx d2 = mul_mi({kS2 * t3.re - kS1 * t4.re, kS2 * t3.im - kS1 * t4.im});
  a[0] = add(a[0], add(t1, t2));
  a[1] = add(b1, d1);
  a[4] = sub(b1, d1);
  a[2] = add(b2, d2);
  a[3] = sub(b2, d2);
}

__device__ __forceinline__ void dft4(cpx* b) {
  const cpx p0 = add(b[0], b[2]), p1 = sub(b[0], b[2]);
  const cpx p2 = add(b[1], b[3]), p3 = mul_mi(sub(b[1], b[3]));
  b[0] = add(p0, p2);
  b[1] = add(p1, p3);
  b[2] = sub(p0, p2);
  b[3] = sub(p1, p3);
}

__device__ __forceinline__ void dft8(cpx* a) {
  cpx u[4], v[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    u[r] = add(a[r], a[r + 4]);
    v[r] = sub(a[r], a[r + 4]);
  }
  v[1] = {kH * (v[1].re + v[1].im), kH * (v[1].im - v[1].re)};   // (1 - i) / sqrt 2
  v[2] = mul_mi(v[2]);                                          // -i
  v[3] = {kH * (v[3].im - v[3].re), -kH * (v[3].re + v[3].im)};  // (-1 - i) / sqrt 2
  dft4(u);
  dft4(v);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    a[2 * r] = u[r];
    a[2 * r + 1] = v[r];
  }
}

__device__ __forceinline__ float log_mag(float r, float q) {
  return logf(sqrtf(r * r + q * q) + kLogEps);
}

// tables: [0, 400) cos(2*pi*m/400), [400, 800) periodic Hann window, then
// the window in float64 (400 doubles in the place of 800 floats); 16-byte
// aligned.  Block b computes frames 4 * (b % tiles) + [0, 4) of
// row b / tiles.
__global__ void __launch_bounds__(kThreads, 10)
log_spectrogram_fft(const float* __restrict__ x, float* __restrict__ lm,
                    float* __restrict__ re_out, float* __restrict__ im_out,
                    const float* __restrict__ tables, int L, int F, int tiles) {
  __shared__ __align__(16) float cosw[kCos];
  __shared__ __align__(16) float win[kFrameLength];
  __shared__ __align__(16) float work[kWork + 2 * kZ];
  __shared__ double edge[kTileFrames][2];  // X[0], X[200] of each frame
  float* span = work;
  float* zr1 = work + kSpan;
  float* zi1 = zr1 + kZ;
  float* zr0 = work + kWork;
  float* zi0 = zr0 + kZ;

  const int tid = threadIdx.x;
  const int row = blockIdx.x / tiles;
  const int f0 = (blockIdx.x - row * tiles) * kTileFrames;
  const bool reim = re_out != nullptr;

  // The tables: cos[0, 400), cos[0, 100) again at [400, 500), the window.
  const float4* t4 = reinterpret_cast<const float4*>(tables);
  for (int i = tid; i < (kCos + kFrameLength) / 4; i += kThreads) {
    const int src = i < kFrameLength / 4 ? i
                    : i < kCos / 4       ? i - kFrameLength / 4
                                         : i - (kCos - kFrameLength) / 4;
    float* dst = i < kCos / 4 ? cosw + 4 * i : win + 4 * i - kCos;
    *reinterpret_cast<float4*>(dst) = __ldg(t4 + src);
  }
  // The span, by 16-byte loads where the whole span lies in the row and
  // starts 16-byte aligned, else sample by sample with zero past the end.
  const float* xs = x + static_cast<int64_t>(row) * L +
                    static_cast<int64_t>(f0) * kFrameStep;
  const int left = L - f0 * kFrameStep;
  if (left >= kSpan && (reinterpret_cast<uintptr_t>(xs) & 15) == 0) {
    for (int i = tid; i < kSpan / 4; i += kThreads)
      reinterpret_cast<float4*>(span)[i] =
          __ldg(reinterpret_cast<const float4*>(xs) + i);
  } else {
    for (int i = tid; i < kSpan; i += kThreads)
      span[i] = i < left ? __ldg(xs + i) : 0.0f;
  }
  __syncthreads();

  cpx v[8];
  const int q = tid / kFrameThreads;  // frame of the tile
  const int j = tid % kFrameThreads;  // butterfly of a radix-5 stage

  // Stage 1: radix 5, Ns = 1, on the packed windowed frame.  Beside it,
  // each thread sums its 5 even and 5 odd samples times the float64
  // window, for the real bins 0 and 200.
  double sum_even = 0.0, sum_odd = 0.0;
  {
    const float2* s2 = reinterpret_cast<const float2*>(span + q * kFrameStep);
    const float2* w2 = reinterpret_cast<const float2*>(win);
    const double2* w64 =
        reinterpret_cast<const double2*>(tables + 2 * kFrameLength);
#pragma unroll
    for (int r = 0; r < 5; ++r) {
      const float2 s = s2[j + r * (kN / 5)];
      const float2 w = w2[j + r * (kN / 5)];
      const double2 wd = __ldg(w64 + j + r * (kN / 5));
      v[r] = {s.x * w.x, s.y * w.y};
      sum_even = fma(static_cast<double>(s.x), wd.x, sum_even);
      sum_odd = fma(static_cast<double>(s.y), wd.y, sum_odd);
    }
    dft5(v);
    float* ore = zr0 + q * kN;
    float* oim = zi0 + q * kN;
#pragma unroll
    for (int r = 0; r < 5; ++r) {
      ore[5 * j + r] = v[r].re;
      oim[5 * j + r] = v[r].im;
    }
  }
  __syncthreads();

  // The span is read: its place holds the 160 threads' float64 sums.
  reinterpret_cast<double2*>(span)[tid] = make_double2(sum_even, sum_odd);

  // Stage 2: radix 5, Ns = 5; twiddle exp(-2 pi i (j % 5) r / 25).
  {
    const float* ire = zr0 + q * kN;
    const float* iim = zi0 + q * kN;
#pragma unroll
    for (int r = 0; r < 5; ++r)
      v[r] = {ire[j + r * (kN / 5)], iim[j + r * (kN / 5)]};
#pragma unroll
    for (int r = 1; r < 5; ++r)
      v[r] = mul(v[r], twiddle(cosw, 16 * (j % 5) * r));
    dft5(v);
    float* ore = zr1 + q * kN;
    float* oim = zi1 + q * kN;
    const int d = (j / 5) * 25 + j % 5;
#pragma unroll
    for (int r = 0; r < 5; ++r) {
      ore[d + 5 * r] = v[r].re;
      oim[d + 5 * r] = v[r].im;
    }
  }
  __syncthreads();

  // Stage 3: radix 8, Ns = 25, 25 butterflies per frame; twiddle
  // exp(-2 pi i j r / 200).  Meanwhile the last warp, idle in this stage,
  // adds up the float64 sums: 8 lanes per frame, 5 of its 40 threads'
  // sums each, then across the 8 lanes.
  if (tid < kTileFrames * (kN / 8)) {
    const int q3 = tid / (kN / 8);
    const int j3 = tid % (kN / 8);
    const float* ire = zr1 + q3 * kN;
    const float* iim = zi1 + q3 * kN;
#pragma unroll
    for (int r = 0; r < 8; ++r)
      v[r] = {ire[j3 + r * (kN / 8)], iim[j3 + r * (kN / 8)]};
#pragma unroll
    for (int r = 1; r < 8; ++r)
      v[r] = mul(v[r], twiddle(cosw, 2 * j3 * r));
    dft8(v);
    float* ore = zr0 + q3 * kN;
    float* oim = zi0 + q3 * kN;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      ore[j3 + r * (kN / 8)] = v[r].re;
      oim[j3 + r * (kN / 8)] = v[r].im;
    }
  } else if (tid >= kThreads - 32) {
    const int lane = tid - (kThreads - 32);
    const double2* part =
        reinterpret_cast<const double2*>(span) + (lane >> 3) * kFrameThreads;
    double se = 0.0, so = 0.0;
#pragma unroll
    for (int i = lane & 7; i < kFrameThreads; i += 8) {
      se += part[i].x;
      so += part[i].y;
    }
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) {
      se += __shfl_xor_sync(0xffffffffu, se, o);
      so += __shfl_xor_sync(0xffffffffu, so, o);
    }
    if ((lane & 7) == 0) {
      edge[lane >> 3][0] = se + so;  // X[0]
      edge[lane >> 3][1] = se - so;  // X[200]
    }
  }
  __syncthreads();

  // Real split: X[k] = E - i P and X[200 - k] = conj E - i conj P, with
  // E = (Z[k] + conj Z[200-k]) / 2 and P = W^k (Z[k] - conj Z[200-k]) / 2.
  // The tile's frames are one contiguous run of 4 * 201 floats in each
  // output; each run is staged in the span's place, shifted by the
  // misalignment (in floats) of its start in device memory.
  const int64_t g0 = (static_cast<int64_t>(row) * F + f0) * kBins;
  float* outs[3] = {lm + g0, reim ? re_out + g0 : lm, reim ? im_out + g0 : lm};
  int shift[3];
#pragma unroll
  for (int o = 0; o < 3; ++o)
    shift[o] = static_cast<int>((reinterpret_cast<uintptr_t>(outs[o]) >> 2) & 3);
  {
    const float* Zr = zr0 + q * kN;
    const float* Zi = zi0 + q * kN;
    float* sl = work + shift[0] + q * kBins;
    float* sr = work + kRun + shift[1] + q * kBins;
    float* si = work + 2 * kRun + shift[2] + q * kBins;
#pragma unroll
    for (int k = j; k < kPairs; k += kFrameThreads) {
      const int kc = k == 0 ? 0 : kN - k;
      const cpx a = {Zr[k], Zi[k]};
      const cpx bc = {Zr[kc], -Zi[kc]};
      const cpx e = {0.5f * (a.re + bc.re), 0.5f * (a.im + bc.im)};
      const cpx o = {0.5f * (a.re - bc.re), 0.5f * (a.im - bc.im)};
      const cpx p = mul(o, twiddle(cosw, k));
      // X[k] and X[200 - k]; the real bins 0 and 200 from float64
      cpx xk = {e.re + p.im, e.im - p.re}, xc = {e.re - p.im, -e.im - p.re};
      if (k == 0) {
        xk = {static_cast<float>(edge[q][0]), 0.0f};
        xc = {static_cast<float>(edge[q][1]), 0.0f};
      }
      sl[k] = log_mag(xk.re, xk.im);
      if (reim) {
        sr[k] = xk.re;
        si[k] = xk.im;
      }
      if (k != kN / 2) {
        sl[kN - k] = log_mag(xc.re, xc.im);
        if (reim) {
          sr[kN - k] = xc.re;
          si[kN - k] = xc.im;
        }
      }
    }
  }
  __syncthreads();

  // Store each run of nf * 201 floats (frames past F are dropped): 16-byte
  // stores, neighbouring threads on neighbouring addresses, and single
  // floats at the two ragged ends.
  const int n = (F - f0 < kTileFrames ? F - f0 : kTileFrames) * kBins;
  for (int o = 0; o < (reim ? 3 : 1); ++o) {
    const float* src = work + o * kRun;
    float* dst = outs[o] - shift[o];  // 16-byte aligned
    const int lo = shift[o], hi = shift[o] + n;
    for (int t = tid; 4 * t < hi; t += kThreads) {
      if (4 * t >= lo && 4 * t + 4 <= hi) {
        reinterpret_cast<float4*>(dst)[t] =
            reinterpret_cast<const float4*>(src)[t];
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (4 * t + c >= lo && 4 * t + c < hi) dst[4 * t + c] = src[4 * t + c];
      }
    }
  }
}

}  // namespace

// x [B, L], lm/re/im [B, F, 201] float32, contiguous, on the device;
// tables as above.  re and im are both null for the log-only variant.
// Returns the cudaError_t of the launch (0 = cudaSuccess).
extern "C" int nhans_log_spectrogram(const float* x, float* lm, float* re,
                                     float* im, const float* tables, int B,
                                     int L, int F, void* stream) {
  if (B <= 0 || F <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(tables) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int tiles = (F + kTileFrames - 1) / kTileFrames;
  const int64_t blocks = static_cast<int64_t>(B) * tiles;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  log_spectrogram_fft<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      x, lm, re, im, tables, L, F, tiles);
  return static_cast<int>(cudaGetLastError());
}
