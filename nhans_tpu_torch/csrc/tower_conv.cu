// The towers' kh x kw convolutions in float32, for Hopper (sm_90a):
// y = conv2d(pad(x, SAME pads), w, b, stride), NCHW, as a direct sum.
//
// A CondResBlock in inference (nhans_tpu_torch/nn/model.py) runs two of
// these per block, sixteen per tower forward: k x k with k in {3, 4},
// stride 1 or 2, 1 to 512 input and 64 to 512 output channels.  In
// training (ops/tower_conv.py::TrainConv) the same kernel runs the
// forward of both towers' 24 convolutions, the context tower's 8 x 4 ones
// (stride (3, 2) or 1, 1 to 128 channels) and 4 x 4 ones (256 and 512
// channels) among them, and the input gradient of the stride-1 ones as a
// convolution of the output gradient with the weights rotated by 180
// degrees.  It replaces no TPU kernel: the JAX package leaves its
// convolutions to XLA.  It replaces cuDNN's float32 choices at these
// shapes (FFT convolutions for the stride-1 4 x 4 layers, sm80 implicit
// GEMMs and dgrad kernels for the rest), the SAME pad copy before each
// convolution and the bias add after it.
//
// Arithmetic: float32 multiply-adds on the CUDA cores, no TF32, no FFT or
// Winograd transform.  Every output sums all Cin * kh * kw products of
// its window in two levels: the products of each run of kFold steps of
// the K loop (64 to 128 of them, in the order input channel, kernel row,
// kernel column) into a partial sum, and the partial sums in order into
// the accumulator; the bias is added last.  The result differs from
// another float32 convolution only by the order of the sum, and lies
// nearer the exact one than a single running sum over K (which is what
// cuDNN's implicit GEMMs take) or cuDNN's float32 FFTs.
//
// What bounds it: operations.  A window of the tower is 10.16 GFLOP of
// these convolutions against about 70 MB of activations in and out, so
// all but the first layer (one input channel, bound by its output bytes)
// lie far above the H100's 20 float32 operations per byte.  The peak is
// 67 TFLOP/s of fused multiply-adds: 128 a clock on each of 132 SMs.
//
// Design: an implicit GEMM.  M = output positions (n, ho, wo) with wo
// fastest, N = output channels, K = Cin * kh * kw.  A block of 256
// threads computes a BM x BN tile, one block to an SM (the two levels of
// sums take about 220 registers a thread); each thread holds an 8 x 8
// tile of accumulators (two 4-wide runs of positions by two 4-wide runs of
// channels), and each row of K costs it four 16-byte shared-memory loads
// for 64 FFMAs.  The tile follows (k, Cin, Cout): 64 x 256 for the 3 x 3
// layers (the widest, so that each gathered input word feeds 256
// channels), 128 x 128 for k x k layers of more than 64 output channels,
// 256 x 64 for those of 64, and a light 256 x 64 tile for a layer with
// one input channel, which is bound by the bytes it stores.
//   * Input: a thread owns one position of the tile and, at each step of
//     the K loop, the kh * kw taps of one or two input channels (2 or 4
//     channels a step, 32 or 36 rows of K; for 8 x 4, 1 or 2 channels, 32
//     or 64 rows): it copies them with 4-byte
//     cp.async from the NCHW input into the tile's im2col layout in
//     shared memory ([K][BM], positions fastest, so a warp's copies read
//     consecutive positions of one input row and write consecutive
//     words).  A tap in the SAME padding (or past the edge of the image)
//     is a zero-fill copy that reads nothing, so no padded copy of the
//     input exists.  The taps' validity is computed once per thread, as a
//     bit mask; the k^2 reads of an input word by the taps hit L1.
//   * Weights: the caller transposes w to [K][Cout], so that a step's
//     BK x BN tile arrives by 16-byte cp.async and is read as float4 runs
//     of channels.
//   * A ring of kStages tiles in shared memory: the copies of step s + 3
//     are in flight while step s is computed (three tiles where four do
//     not fit: 8 x 4 at 128 x 128, 64 rows of K a step).
//   * The tile goes out through shared memory: each thread writes its
//     accumulators plus the bias (conv2's; conv1 has none) as float4 runs
//     of positions, then each warp stores whole channel rows of the tile,
//     consecutive positions by consecutive lanes.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 4;  // the ring of tiles in shared memory
constexpr int kFold = 2;    // steps whose products are summed apart
constexpr int kMaxSmem = 232448;  // a block's shared memory on sm_90

struct Params {
  const float* x;     // [N, Cin, H, W]
  const float* wt;    // [Cin * kh * kw, ldw], columns past Cout zero
  const float* bias;  // [Cout] or null
  float* y;           // [N, Cout, Ho, Wo]
  int64_t M;          // N * Ho * Wo
  int Cin, H, W, Cout, ldw, Ho, Wo, sh, sw, pt, pl;
};

__device__ __forceinline__ unsigned smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 4 bytes from global memory, or 4 zero bytes where !valid, in which case
// src is not read at all (it may point outside the tensor)
__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      uint32_t valid) {
  asm volatile(
      "{\n .reg .pred skip;\n setp.eq.u32 skip, %2, 0;\n"
      " cp.async.ca.shared.global [%0], [%1], 4, skip;\n}\n" ::"r"(smem(dst)),
      "l"(src), "r"(valid));
}

// 16 bytes from global memory, or 16 zero bytes where !valid
__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       bool valid) {
  asm volatile(
      "{\n .reg .pred skip;\n setp.eq.u32 skip, %2, 0;\n"
      " cp.async.cg.shared.global [%0], [%1], 16, skip;\n}\n" ::"r"(
          smem(dst)),
      "l"(src), "r"(static_cast<uint32_t>(valid)));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// kLight: a layer of one input channel (K = kh * kw), bound by its output
// bytes: one channel a step, the products summed straight into the
// accumulators (K is 16 or 32), a two-slot ring, and few enough registers
// for two blocks on an SM, so that one block's stores overlap another's
// work.
template <int KH, int KW, int BN, bool kLight>
struct Tile {
  static constexpr int kTaps = KH * KW;
  static constexpr int BM = kThreads * 64 / BN;     // 8 x 8 per thread
  static constexpr int kGroups = kThreads / BM;     // threads per position
  // input channels a step: 32 to 36 rows of K (light: kh * kw rows; 8 x 4:
  // one channel a thread)
  static constexpr int kChannels = kLight || kTaps >= 32 ? kGroups
                                   : kTaps >= 16          ? 2
                                                          : 4;
  static constexpr int kOwn = kChannels / kGroups;  // channels a thread copies
  static constexpr int BK = kChannels * kTaps;
  static constexpr int kWarpsM = BM / 32;           // warp tile 32 x 64
  static constexpr int kStageFloats = BK * (BM + BN);
  static constexpr int kRing =
      kLight ? 2
      : kStages * kStageFloats * 4 <= kMaxSmem ? kStages
                                               : kMaxSmem / (kStageFloats * 4);
  static constexpr int kOutStride = BM + 4;         // the staged output tile
  static constexpr int kSmemBytes =
      (kRing * kStageFloats > BN * kOutStride ? kRing * kStageFloats
                                              : BN * kOutStride) * 4;
  static constexpr int kBlocksPerSM = kLight ? 2 : 1;
};

template <int KH, int KW, int BN, bool kLight>
__global__ void __launch_bounds__(kThreads,
                                  (Tile<KH, KW, BN, kLight>::kBlocksPerSM))
    tower_conv(const Params p) {
  using T = Tile<KH, KW, BN, kLight>;
  constexpr int BM = T::BM, BK = T::BK, kTaps = T::kTaps, kRing = T::kRing;
  static_assert(T::kOwn * T::kGroups == T::kChannels, "channels a step");
  extern __shared__ __align__(16) float shared[];
  float* const a_ring = shared;                          // [kRing][BK][BM]
  float* const b_ring = shared + kRing * BK * BM;        // [kRing][BK][BN]
  const int tid = threadIdx.x;
  const int n_tiles = (p.Cout + BN - 1) / BN;
  const int n0 = static_cast<int>(blockIdx.x % n_tiles) * BN;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x / n_tiles) * BM;
  const int P = p.Ho * p.Wo;
  const int64_t HW = static_cast<int64_t>(p.H) * p.W;
  const int K = p.Cin * kTaps;

  // -- this thread's copies of the input: one position, kOwn channels ----
  const int am = tid % BM, ag = tid / BM;
  uint32_t taps = 0;     // bit r * KW + s: tap (r, s) lies in the image
  int64_t at = 0;        // element (n, ag, hi0, wi0), at the first step
  {
    const int64_t m = m0 + am;
    if (m < p.M) {
      const int64_t img = m / P;
      const int q = static_cast<int>(m - img * P);
      const int ho = q / p.Wo, wo = q - ho * p.Wo;
      const int hi = ho * p.sh - p.pt, wi = wo * p.sw - p.pl;
#pragma unroll
      for (int r = 0; r < KH; ++r)
#pragma unroll
        for (int s = 0; s < KW; ++s)
          if (hi + r >= 0 && hi + r < p.H && wi + s >= 0 && wi + s < p.W)
            taps |= 1u << (r * KW + s);
      at = (img * p.Cin + ag) * HW + static_cast<int64_t>(hi) * p.W + wi;
    }
  }

  // this thread's copies of the weights: rows and columns of the tile
  constexpr int kChunks = BK * BN / 4;
  constexpr int kCopies = (kChunks + kThreads - 1) / kThreads;
  const bool col_ok = n0 + (tid % (BN / 4)) * 4 < p.ldw;
  const float* const wsrc =
      p.wt + static_cast<int64_t>(tid / (BN / 4)) * p.ldw + n0 +
      (tid % (BN / 4)) * 4;

  auto load = [&](int step, int slot) {
    // the input: channel c = step * kChannels + ag + kGroups * o fills rows
    // (ag + kGroups * o) * kTaps + tap of the step's tile
#pragma unroll
    for (int o = 0; o < T::kOwn; ++o) {
      const int c = step * T::kChannels + ag + T::kGroups * o;
      const uint32_t live = c < p.Cin ? taps : 0u;
      const float* const src =
          p.x + at +
          static_cast<int64_t>(step * T::kChannels + T::kGroups * o) * HW;
      float* const a = a_ring + slot * BK * BM +
                       (ag + T::kGroups * o) * kTaps * BM + am;
#pragma unroll
      for (int r = 0; r < KH; ++r)
#pragma unroll
        for (int s = 0; s < KW; ++s)
          copy4(a + (r * KW + s) * BM, src + r * p.W + s,
                live & (1u << (r * KW + s)));
    }
    // the weights: BK rows of BN channels, 16 bytes a copy
    const int k0 = step * BK;
    float* const b = b_ring + slot * BK * BN + tid * 4;
    const float* const w = wsrc + static_cast<int64_t>(k0) * p.ldw;
#pragma unroll
    for (int u = 0; u < kCopies; ++u) {
      constexpr int kRows = kThreads / (BN / 4);  // rows a round of copies
      const int row = u * kRows + tid / (BN / 4);
      if (kChunks % kThreads == 0 || u * kThreads + tid < kChunks)
        copy16(b + u * kThreads * 4,
               w + static_cast<int64_t>(u * kRows) * p.ldw,
               col_ok && k0 + row < K);
    }
  };

  // -- the K loop: every kFold steps' products summed apart, then added --
  const int warp = tid >> 5, lane = tid & 31;
  const int tm = (warp % T::kWarpsM) * 32 + (lane & 3) * 4;   // + {0, 16}
  const int tn = (warp / T::kWarpsM) * 64 + (lane >> 2) * 4;  // + {0, 32}
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  const int steps = (p.Cin + T::kChannels - 1) / T::kChannels;
#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) {
    if (s < steps) load(s, s);
    commit();
  }
  // one step of the K loop: the products of its BK rows into sum
  auto run_step = [&](int step, float (&sum)[8][8], bool fresh) {
    wait_copies<kRing - 2>();
    __syncthreads();  // the tile of `step` is in; the slot refilled below
                      // was last read at step - 1 by every warp
    const int next = step + kRing - 1;
    if (next < steps) load(next, next % kRing);
    commit();
    const float* a = a_ring + (step % kRing) * BK * BM;
    const float* b = b_ring + (step % kRing) * BK * BN;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(a + k * BM + tm);
      const float4 a1 = *reinterpret_cast<const float4*>(a + k * BM + tm + 16);
      const float4 b0 = *reinterpret_cast<const float4*>(b + k * BN + tn);
      const float4 b1 = *reinterpret_cast<const float4*>(b + k * BN + tn + 32);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          sum[i][j] = (fresh && k == 0) ? av[i] * bv[j]
                                        : fmaf(av[i], bv[j], sum[i][j]);
    }
  };
  if constexpr (kLight) {
    for (int step = 0; step < steps; ++step) run_step(step, acc, false);
  } else {
    for (int step0 = 0; step0 < steps; step0 += kFold) {
      float part[8][8];
      run_step(step0, part, true);
#pragma unroll
      for (int f = 1; f < kFold; ++f)
        if (step0 + f < steps) run_step(step0 + f, part, false);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += part[i][j];
    }
  }

  // -- store: the tile, with the bias, through shared memory --------------
  wait_copies<0>();
  __syncthreads();  // every warp is done with the ring
  float* const out_tile = shared;                        // [BN][kOutStride]
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = tn + (j & 3) + (j >> 2) * 32;
    const float bias =
        (p.bias != nullptr && n0 + c < p.Cout) ? __ldg(p.bias + n0 + c) : 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(out_tile + c * T::kOutStride + tm + 16 * h) =
          make_float4(acc[4 * h][j] + bias, acc[4 * h + 1][j] + bias,
                      acc[4 * h + 2][j] + bias, acc[4 * h + 3][j] + bias);
  }
  __syncthreads();
  // a warp writes whole channel rows of the tile: consecutive positions
  int64_t at_out[BM / 32];  // (n, 0, ho, wo) of position lane + 32 q
#pragma unroll
  for (int q = 0; q < BM / 32; ++q) {
    const int64_t m = m0 + lane + 32 * q;
    const int64_t img = m / P;
    at_out[q] = m < p.M ? img * p.Cout * P + (m - img * P) : -1;
  }
  for (int c = warp; c < BN && n0 + c < p.Cout; c += kThreads / 32) {
    float* const y = p.y + static_cast<int64_t>(n0 + c) * P;
#pragma unroll
    for (int q = 0; q < BM / 32; ++q)
      if (at_out[q] >= 0)
        y[at_out[q]] = out_tile[c * T::kOutStride + lane + 32 * q];
  }
}

template <int KH, int KW, int BN, bool kLight>
int launch(const Params& p, cudaStream_t stream) {
  using T = Tile<KH, KW, BN, kLight>;
  // set on every launch: the attribute belongs to the current device
  const cudaError_t set = cudaFuncSetAttribute(
      tower_conv<KH, KW, BN, kLight>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int64_t blocks = ((p.M + T::BM - 1) / T::BM) *
                         ((p.Cout + BN - 1) / BN);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  tower_conv<KH, KW, BN, kLight><<<static_cast<unsigned>(blocks), kThreads,
                                   T::kSmemBytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y [N, Cout, Ho, Wo] = conv2d(x [N, Cin, H, W] padded by pt rows above
// and pl columns left (and with zeros below and right as far as Ho, Wo
// reach), w, bias, stride (sh, sw)); wt is w [Cout, Cin, kh, kw] as
// [Cin * kh * kw, ldw], ldw a multiple of 4 not under Cout, the columns
// past Cout zero, 16-byte aligned.  (kh, kw) is (3, 3), (4, 4) or (8, 4);
// bias null for none; all float32, contiguous, on the device.  Returns the
// cudaError_t of the launch (0 = cudaSuccess).
extern "C" int nhans_tower_conv(const float* x, const float* wt,
                                const float* bias, float* y, int N, int Cin,
                                int H, int W, int Cout, int ldw, int Ho,
                                int Wo, int kh, int kw, int sh, int sw,
                                int pt, int pl, void* stream) {
  if (N <= 0 || Cin <= 0 || H <= 0 || W <= 0 || Cout <= 0 || ldw < Cout ||
      ldw % 4 || Ho <= 0 || Wo <= 0 || sh <= 0 || sw <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{x,    wt,  bias, y,  static_cast<int64_t>(N) * Ho * Wo,
                 Cin,  H,   W,    Cout, ldw, Ho, Wo, sh, sw, pt, pl};
  auto s = static_cast<cudaStream_t>(stream);
  // the tile from (kh, kw, Cin, Cout): one input channel to at most 64,
  // the light 256 x 64 tile; to 64 channels, 256 x 64, and to more, 128 x
  // 128; 3 x 3, 64 x 256 (columns past Cout are computed and not stored)
  if (kh == 4 && kw == 4)
    return Cin == 1 && Cout <= 64 ? launch<4, 4, 64, true>(p, s)
           : Cout <= 64           ? launch<4, 4, 64, false>(p, s)
                                  : launch<4, 4, 128, false>(p, s);
  if (kh == 8 && kw == 4)
    return Cin == 1 && Cout <= 64 ? launch<8, 4, 64, true>(p, s)
           : Cout <= 64           ? launch<8, 4, 64, false>(p, s)
                                  : launch<8, 4, 128, false>(p, s);
  if (kh == 3 && kw == 3) return launch<3, 3, 256, false>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
