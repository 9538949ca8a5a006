// The weight and bias gradients of the towers' kh x kw convolutions in
// float32, for Hopper (sm_90a):
//   dw[co, ci, r, s] = sum over (n, ho, wo) of dy[n, co, ho, wo] *
//                      x[n, ci, ho * sh + r - pt, wo * sw + s - pl]
//   db[co]           = sum over (n, ho, wo) of dy[n, co, ho, wo]
// with x read as zeros outside the image, so that no padded copy exists.
//
// The training step (ops/tower_conv.py::TrainConv) runs it in the backward
// pass of both towers' 24 k x k convolutions: 3 x 3, 4 x 4 and 8 x 4
// kernels, stride 1, 2 or (3, 2), 1 to 512 input and 64 to 512 output
// channels, over 64 windows (the main tower) or 128 context crops.  It
// replaces no TPU kernel: the JAX package leaves its convolutions to XLA.
// It replaces cuDNN's float32 weight-gradient kernels (sm80 implicit GEMMs
// and FFT convolutions) and the padded copy they read.
//
// What bounds it: operations.  The sum over (n, ho, wo) is long (8,320 to
// 866,176 positions) and each product feeds one of Cout x Cin x kh x kw
// outputs, so every layer but the two with one input channel does
// hundreds of operations per byte it reads; the peak is 67 TFLOP/s of
// float32 fused multiply-adds.
//
// Design: a GEMM C[co][j] = sum over k of A[co][k] B[j][k], j = (ci, r, s)
// and k = (n, ho, wo): A is dy, B the im2col of x, the block tile and the
// thread tiles as in tower_conv.cu's forward.
//   * A block of 256 threads computes a BM x BN tile (128 x 128, or 64 x
//     256 for 64 output channels) over one slice of k, BK = 32 positions a
//     step; each thread holds 8 x 8 accumulators (two 4-wide runs of rows
//     by two 4-wide runs of columns), and each position costs it four
//     16-byte shared-memory loads for 64 FFMAs.  The tiles sit in shared
//     memory k-major, [BK][BM + 4] and [BK][BN + 4].
//   * Copies: 4-byte cp.async.  Both operands are k-major in device memory
//     (consecutive wo), so a warp's lanes take 8 consecutive positions of 4
//     rows: whole 32-byte sectors read, and the 4 words of padding put the
//     writes on 32 different banks.  A tap of B in the padding is a
//     zero-fill copy that reads nothing.  Each thread tracks its 4
//     positions of a step and moves them on by 32 without a division; the
//     (ci, r, s) of its columns are computed once.
//   * A ring of 4 stages: the copies of step s + 3 are in flight while
//     step s is computed.
//   * Sums in four levels: each step's 32 products, the steps of a chunk
//     (about sqrt(steps / 32) of them, so that the two levels' rounding
//     balance), the chunks in order into the accumulator, and the slices:
//     their tiles go to a workspace [S][Cout][J], and a second kernel adds
//     the S slices in order.  No atomics: the result is the same bit for
//     bit from run to run.  S is chosen by the caller from the shapes
//     alone, so that the blocks fill whole waves of 132 SMs and the
//     workspace stays under 64 MB; with S = 1 the tile goes straight to
//     dw.
//   * The bias gradient: the blocks of the first column tile also sum
//     their A tile's rows: each step's 32 values pairwise, the steps of a
//     chunk in order, the chunks with compensation (Kahan), the slices in
//     order.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int BK = 32;           // positions a step
constexpr int kStages = 4;

struct Params {
  const float* x;    // [N, Cin, H, W]
  const float* dy;   // [N, Cout, Ho, Wo]
  float* dw;         // [S][Cout][J]: the slices' sums, or dw where S == 1
  float* db;         // [S][Cout] or null for no bias
  int K;             // N * Ho * Wo
  int per_slice;     // positions a slice, a multiple of BK
  int fold;          // steps a chunk of the sum
  int Cin, H, W, Cout, J, Ho, Wo, sh, sw, pt, pl;
};

__device__ __forceinline__ unsigned smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 4 bytes from global memory, or 4 zero bytes where !valid, in which case
// src is not read at all (it may point outside the tensor)
__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      bool valid) {
  asm volatile(
      "{\n .reg .pred skip;\n setp.eq.u32 skip, %2, 0;\n"
      " cp.async.ca.shared.global [%0], [%1], 4, skip;\n}\n" ::"r"(smem(dst)),
      "l"(src), "r"(static_cast<uint32_t>(valid)));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

template <int BM, int BN>
struct Tile {
  static_assert(BM * BN == kThreads * 64, "8 x 8 accumulators a thread");
  static constexpr int kWarpsM = BM / 32;           // warp tile 32 x 64
  static constexpr int kLdA = BM + 4, kLdB = BN + 4;
  static constexpr int kRowsA = BM / 32;            // A rows a thread copies
  static constexpr int kColsB = BN / 32;            // B columns a thread copies
  static constexpr int kStageFloats = BK * (kLdA + kLdB);
  static constexpr int kOut = BN + 4;               // the staged output tile
  static constexpr int kSmemBytes =
      (kStages * kStageFloats > BM * kOut ? kStages * kStageFloats
                                          : BM * kOut) * 4;
};

template <int KH, int KW, int BM, int BN>
__global__ void __launch_bounds__(kThreads, 1) conv_wgrad(const Params p) {
  using T = Tile<BM, BN>;
  constexpr int kLdA = T::kLdA, kLdB = T::kLdB, kGroups = BK / 8;
  extern __shared__ __align__(16) float shared[];
  float* const a_ring = shared;                         // [kStages][BK][kLdA]
  float* const b_ring = shared + kStages * BK * kLdA;   // [kStages][BK][kLdB]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int j_tiles = (p.J + BN - 1) / BN;
  const int j0 = (blockIdx.x % j_tiles) * BN;
  const int co0 = (blockIdx.x / j_tiles) * BM;
  const int slice = blockIdx.y;
  const int k_begin = slice * p.per_slice;
  const int k_end = min(p.K, k_begin + p.per_slice);
  const int steps = (k_end - k_begin + BK - 1) / BK;
  const int P = p.Ho * p.Wo, HW = p.H * p.W;

  // -- this thread's copies: positions kk + 8 g of each step (g < 4), rows
  // rr + 4 warp + 32 u of A and columns of B; lanes of a warp cover 8
  // consecutive positions of 4 rows, so that the reads are whole 32-byte
  // sectors and the writes to [k][row + 4] fall on 32 banks
  const int kk = lane & 7, rr = lane >> 3;
  bool row_ok[T::kRowsA];
#pragma unroll
  for (int u = 0; u < T::kRowsA; ++u)
    row_ok[u] = co0 + rr + 4 * warp + 32 * u < p.Cout;
  // B's columns j = (ci, r, s): the tap's offset from the window's corner
  // and its row and column bits (all bits past J: never inside)
  int col_off[T::kColsB];
  uint32_t col_bits[T::kColsB];
#pragma unroll
  for (int u = 0; u < T::kColsB; ++u) {
    const int j = j0 + rr + 4 * warp + 32 * u;
    const int ci = j / (KH * KW), tap = j - ci * (KH * KW);
    const int r = tap / KW, s = tap - r * KW;
    col_off[u] = ci * HW + r * p.W + s;
    col_bits[u] = j < p.J ? (1u << r) | (1u << (8 + s)) : ~0u;
  }
  // the positions k = (n, ho, wo): the loads come in order of step, so
  // each moves on by BK, without a division
  int k[kGroups], n[kGroups], ho[kGroups], wo[kGroups];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    k[g] = k_begin + kk + 8 * g;
    n[g] = k[g] / P;
    ho[g] = (k[g] - n[g] * P) / p.Wo;
    wo[g] = k[g] - n[g] * P - ho[g] * p.Wo;
  }
  const int a_row = (co0 + rr + 4 * warp) * P;

  // offsets are 32-bit: the caller keeps x and dy under 2^30 elements
  auto load = [&](int slot) {
    float* const a = a_ring + slot * BK * kLdA + rr + 4 * warp;
    float* const b = b_ring + slot * BK * kLdB + rr + 4 * warp;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const bool k_ok = k[g] < k_end;
      const int hi = ho[g] * p.sh - p.pt, wi = wo[g] * p.sw - p.pl;
      // the kernel rows r0 <= r < r1 and columns s0 <= s < s1 inside
      const int r0 = min(KH, max(0, -hi)), r1 = max(r0, min(KH, p.H - hi));
      const int s0 = min(KW, max(0, -wi)), s1 = max(s0, min(KW, p.W - wi));
      const uint32_t live =
          k_ok ? ((1u << r1) - (1u << r0)) | (((1u << s1) - (1u << s0)) << 8)
               : 0u;
      const int a_at = n[g] * p.Cout * P + a_row + ho[g] * p.Wo + wo[g];
      const int b_at = n[g] * p.Cin * HW + hi * p.W + wi;
      const int row = kk + 8 * g;
#pragma unroll
      for (int u = 0; u < T::kRowsA; ++u)
        copy4(a + row * kLdA + 32 * u, p.dy + (a_at + 32 * u * P),
              k_ok && row_ok[u]);
#pragma unroll
      for (int u = 0; u < T::kColsB; ++u)
        copy4(b + row * kLdB + 32 * u, p.x + (b_at + col_off[u]),
              (col_bits[u] & live) == col_bits[u]);
      k[g] += BK;
      for (wo[g] += BK; wo[g] >= p.Wo;) {
        wo[g] -= p.Wo;
        if (++ho[g] == p.Ho) ho[g] = 0, ++n[g];
      }
    }
  };

  // this thread's accumulators: rows co = tm + {0..3, 16..19} and columns
  // j = tn + {0..3, 32..35} of the tile
  const int tm = (warp % T::kWarpsM) * 32 + (lane & 3) * 4;
  const int tn = (warp / T::kWarpsM) * 64 + (lane >> 2) * 4;
  const bool bias_rows = p.db != nullptr && j0 == 0 && tid < BM;
  float acc[8][8], db_acc = 0.0f, db_lost = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s);
    commit();
  }
  // one step: its 32 products into part (the first of a chunk starts it
  // afresh), and the bias rows' sum of its A tile into db_part
  auto run_step = [&](int step, float (&part)[8][8], float& db_part,
                      bool fresh) {
    wait_copies<kStages - 2>();
    __syncthreads();  // the tile of `step` is in; the slot refilled below
                      // was last read at step - 1 by every warp
    const int next = step + kStages - 1;
    if (next < steps) load(next % kStages);
    commit();
    const float* const a = a_ring + (step % kStages) * BK * kLdA;
    const float* const b = b_ring + (step % kStages) * BK * kLdB;
#pragma unroll
    for (int q = 0; q < BK; ++q) {
      const float4 a0 = *reinterpret_cast<const float4*>(a + q * kLdA + tm);
      const float4 a1 =
          *reinterpret_cast<const float4*>(a + q * kLdA + tm + 16);
      const float4 b0 = *reinterpret_cast<const float4*>(b + q * kLdB + tn);
      const float4 b1 =
          *reinterpret_cast<const float4*>(b + q * kLdB + tn + 32);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          part[i][j] = (fresh && q == 0) ? av[i] * bv[j]
                                         : fmaf(av[i], bv[j], part[i][j]);
    }
    if (bias_rows) {  // the step's 32 values of the row, pairwise
      static_assert(BK == 32, "a step's bias sum takes 8 runs of 4");
      float s[BK / 4];
#pragma unroll
      for (int q = 0; q < BK / 4; ++q)
        s[q] = (a[4 * q * kLdA + tid] + a[(4 * q + 1) * kLdA + tid]) +
               (a[(4 * q + 2) * kLdA + tid] + a[(4 * q + 3) * kLdA + tid]);
      const float sum = ((s[0] + s[1]) + (s[2] + s[3])) +
                        ((s[4] + s[5]) + (s[6] + s[7]));
      db_part = fresh ? sum : db_part + sum;
    }
  };
  // three levels: a step's products, the steps of a chunk of p.fold, the
  // chunks in order
  for (int step0 = 0; step0 < steps; step0 += p.fold) {
    float part[8][8], db_part = 0.0f;
    run_step(step0, part, db_part, true);
    for (int f = 1; f < p.fold && step0 + f < steps; ++f)
      run_step(step0 + f, part, db_part, false);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] += part[i][j];
    // the chunks' bias sums compensated (Kahan): the rounding each add
    // loses is carried into the next
    const float y = db_part - db_lost, t = db_acc + y;
    db_lost = (t - db_acc) - y;
    db_acc = t;
  }

  // -- store: the tile through shared memory, whole rows by each warp -----
  wait_copies<0>();
  __syncthreads();  // every warp is done with the ring
  float* const out_tile = shared;  // [BM][kOut]
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* const row = out_tile + (tm + (i & 3) + 16 * (i >> 2)) * T::kOut;
    *reinterpret_cast<float4*>(row + tn) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(row + tn + 32) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  __syncthreads();
  float* const dw = p.dw + static_cast<int64_t>(slice) * p.Cout * p.J;
  for (int row = warp; row < BM && co0 + row < p.Cout; row += kThreads / 32)
    for (int c = lane; c < BN && j0 + c < p.J; c += 32)
      dw[static_cast<int64_t>(co0 + row) * p.J + j0 + c] =
          out_tile[row * T::kOut + c];
  if (bias_rows && co0 + tid < p.Cout)
    p.db[static_cast<int64_t>(slice) * p.Cout + co0 + tid] = db_acc;
}

// out[i] = sum over s in order of part[s][i], for the n values of dw and
// then the Cout of db (if any) that follow them in the workspace's order
__global__ void conv_wgrad_reduce(const float* dw_part, const float* db_part,
                                  float* dw, float* db, int S, int64_t n,
                                  int Cout) {
  const int64_t total = n + (db != nullptr ? Cout : 0);
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const bool w = i < n;
    const float* src = w ? dw_part + i : db_part + (i - n);
    const int64_t stride = w ? n : Cout;
    float sum = src[0];
    for (int s = 1; s < S; ++s) sum += src[s * stride];
    (w ? dw[i] : db[i - n]) = sum;
  }
}

template <int KH, int KW, int BM, int BN>
int launch(const Params& p, int S, cudaStream_t stream) {
  using T = Tile<BM, BN>;
  // set on every launch: the attribute belongs to the current device
  const cudaError_t set = cudaFuncSetAttribute(
      conv_wgrad<KH, KW, BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::kSmemBytes);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int64_t tiles = static_cast<int64_t>((p.Cout + BM - 1) / BM) *
                        ((p.J + BN - 1) / BN);
  if (tiles > 0x7fffffff || S > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  conv_wgrad<KH, KW, BM, BN>
      <<<dim3(static_cast<unsigned>(tiles), S), kThreads, T::kSmemBytes,
         stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int KH, int KW>
int launch_tile(const Params& p, int S, cudaStream_t stream) {
  return p.Cout <= 64 ? launch<KH, KW, 64, 256>(p, S, stream)
                      : launch<KH, KW, 128, 128>(p, S, stream);
}

}  // namespace

// dw [Cout, Cin, kh, kw] and db [Cout] (null for none) of
// y = conv2d(x padded by pt rows above and pl columns left, w, stride
// (sh, sw)) from x [N, Cin, H, W] and dy [N, Cout, Ho, Wo].  The sum over
// the K = N * Ho * Wo positions is cut into S slices of per_slice
// positions (a multiple of 32; S = ceil(K / per_slice)); for S > 1,
// ws holds S * Cout * (Cin * kh * kw + 1) floats, which the slices fill
// before the second launch adds them.  (kh, kw) is (3, 3), (4, 4) or (8,
// 4); all float32, contiguous, on the device; K and the elements of x and
// dy below 2^30 (the kernel's 32-bit offsets run a step past the end).  Returns the cudaError_t of the launches (0 =
// cudaSuccess).
extern "C" int nhans_conv_wgrad(const float* x, const float* dy, float* dw,
                                float* db, float* ws, int N, int Cin, int H,
                                int W, int Cout, int Ho, int Wo, int kh,
                                int kw, int sh, int sw, int pt, int pl,
                                int S, int per_slice, void* stream) {
  const int64_t K = static_cast<int64_t>(N) * Ho * Wo;
  if (N <= 0 || Cin <= 0 || H <= 0 || W <= 0 || Cout <= 0 || Ho <= 0 ||
      Wo <= 0 || sh <= 0 || sw <= 0 || S <= 0 || per_slice <= 0 ||
      per_slice % BK || K >= (int64_t{1} << 30) ||
      (static_cast<int64_t>(S) - 1) * per_slice >= K ||
      static_cast<int64_t>(S) * per_slice < K || (S > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int J = Cin * kh * kw;
  const int64_t n = static_cast<int64_t>(Cout) * J;
  float* const dw_part = S > 1 ? ws : dw;
  float* const db_part =
      db == nullptr ? nullptr : S > 1 ? ws + static_cast<int64_t>(S) * n : db;
  // chunks of about sqrt(steps / 32) steps: the rounding of the chunks'
  // sums and of their sum in order balance
  const int fold = static_cast<int>(sqrt(per_slice / BK / 32.0) + 0.5);
  const Params p{x,    dy, dw_part, db_part, static_cast<int>(K), per_slice,
                 fold > 1 ? fold : 1,   Cin, H,   W,  Cout, J,  Ho, Wo, sh,
                 sw,   pt, pl};
  auto s = static_cast<cudaStream_t>(stream);
  int err;
  if (kh == 3 && kw == 3)
    err = launch_tile<3, 3>(p, S, s);
  else if (kh == 4 && kw == 4)
    err = launch_tile<4, 4>(p, S, s);
  else if (kh == 8 && kw == 4)
    err = launch_tile<8, 4>(p, S, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (err != 0 || S == 1) return err;
  const int64_t total = n + (db != nullptr ? Cout : 0);
  const int64_t blocks = (total + 255) / 256;
  conv_wgrad_reduce<<<static_cast<unsigned>(blocks < 1056 ? blocks : 1056),
                      256, 0, s>>>(dw_part, db_part, dw, db, S, n, Cout);
  return static_cast<int>(cudaGetLastError());
}
