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
// What bounds it.  A GEMM C[co][j] = sum over k of A[co][k] B[j][k], j =
// (ci, r, s) and k = (n, ho, wo): A is dy, B the im2col of x.  With more
// than 32 columns j a layer does hundreds of operations per byte it reads
// (the peak is 67 TFLOP/s of float32 fused multiply-adds), but each thread
// of a tile feeds its 64 FFMAs a position from four 16-byte shared-memory
// loads, as tower_conv.cu's forward does, and that alone holds the sum to
// about 70 % of the peak on an H100.  What the copies into shared memory
// cost comes on top, instruction for instruction: both operands are
// contiguous along k in device memory while the tiles want k-major rows,
// so every value arrives by its own 4-byte copy.  A layer of one input
// channel has 16 or 32 columns: it reads 64 values of dy for each 16 or 32
// x 64 products, and is bound by reading dy.
//
// Design.
//   * conv_wgrad (more than 32 columns): a block of 256 threads computes a
//     BM x BN tile (128 x 128, or 64 x 256 for a kernel 4 wide and 64
//     output channels) over one slice of k, BK = 32 positions a step; each
//     thread holds 8 x 8 accumulators (two 4-wide runs of rows by two
//     4-wide runs of columns) on tiles held k-major, [BK][BM + 4] and
//     [BK][BN + 4].
//   * Copies: 4-byte cp.async with the byte count as the predicate (0: a
//     zero written, nothing read), one position of each step a thread,
//     found by two multiplications (Div) rather than a loop.  A warp's
//     lanes take 8 consecutive positions of 4 rows of dy, or of the 4
//     columns s of one channel and kernel row of x, so that each write
//     falls on its own bank and B's reads lie in one run of x; for a
//     kernel 4 wide a thread's columns of one kernel row step by a channel,
//     so that a copy costs an add and a select.
//   * A ring of 4 stages: the copies of step s + 3 are in flight while
//     step s is computed.
//   * conv_wgrad_narrow (at most 32 columns: one input channel): a block
//     takes 64 output channels by all 16 or 32 columns and 128 positions a
//     step; its 256 threads form groups of 16 or 32, each thread an 8 x 8
//     tile over its group's share of the step's positions, and the groups'
//     tiles are added at the end in a fixed tree.
//   * Sums in four levels: each step's products (32 a thread, or 8 or 16 in
//     the narrow kernel), the steps of a chunk (about sqrt(steps /
//     products a step) of them, so that the two levels' rounding balance),
//     the chunks in order into the accumulator (then the narrow kernel's
//     groups in a tree), and the slices: their tiles go to a workspace
//     [S][Cout][J], and conv_wgrad_reduce adds the S slices in order.  No
//     atomics: the result is the same bit for bit from run to run.  S is
//     chosen by the caller from the shapes alone, so that the blocks fill
//     whole waves of 132 SMs and the workspace stays under 64 MB; with S =
//     1 the tile goes straight to dw.
//   * The bias gradient: the blocks of the first column tile also sum
//     their A tile's rows: each run of 32 values pairwise, the steps of a
//     chunk in order, the chunks with compensation (Kahan), the slices in
//     order.
// Measured slower on the card and not kept (PERF.md): staging each step's
// runs of x in shared memory by 16-byte copies and forming the taps from
// there; dy copied by 16-byte chunks into rows read along k; the threads'
// lanes on 32 positions of one row; 8 x 16 sums a thread, with the
// chunks' sums in shared or device memory; B's loads for a kernel 4 wide
// taking only the new columns along an output row (a branch a position).

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int BK = 32;           // positions a step (conv_wgrad)
constexpr int NBK = 128;         // positions a step (conv_wgrad_narrow)
constexpr int kStages = 4;       // the ring of tiles in shared memory

// floor(n / d) for 0 <= n < 2^31 by a multiplication: m = ceil(2^shift /
// d) with shift = 31 + ceil(log2 d), exact since n (m - 2^shift / d) /
// 2^shift < 2^-ceil(log2 d) <= 1 / d
struct Div {
  uint64_t m;
  int shift;
  __device__ __forceinline__ int operator()(int n) const {
    return static_cast<int>((static_cast<uint64_t>(n) * m) >> shift);
  }
};

Div make_div(int d) {
  int bits = 0;
  while ((1 << bits) < d) ++bits;
  const int shift = 31 + bits;
  return {((uint64_t{1} << shift) + d - 1) / d, shift};
}

struct Params {
  const float* x;    // [N, Cin, H, W]
  const float* dy;   // [N, Cout, Ho, Wo]
  float* dw;         // [S][Cout][J]: the slices' sums, or dw where S == 1
  float* db;         // [S][Cout] or null for no bias
  int K;             // N * Ho * Wo
  int per_slice;     // positions a slice, a multiple of the step
  int fold;          // steps a chunk of the sum
  int Cin, H, W, Cout, J, Ho, Wo, sh, sw, pt, pl;
  Div wo, ho;        // by Wo and by Ho
};

__device__ __forceinline__ unsigned smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 4 bytes from global memory where bytes is 4, or 4 zero bytes where it is
// 0, in which case src is not read at all (it may point outside the tensor)
__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem(dst)),
               "l"(src), "r"(bytes));
}

// v, which the compiler may not assume: what is computed from it stays in
// the loop that uses it, instead of being hoisted into registers that the
// sums need
__device__ __forceinline__ int opaque(int v) {
  asm volatile("" : "+r"(v));
  return v;
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

template <int KH, int KW, int BM, int BN>
struct Tile {
  static_assert(BM * BN == kThreads * 64, "8 x 8 accumulators a thread");
  static constexpr int kTaps = KH * KW;
  static constexpr int kWarpsM = BM / 32;           // warp tile 32 x 64
  static constexpr int kLdA = BM + 4, kLdB = BN + 4;
  static constexpr int kRowsA = BM / 8;             // A rows a thread copies
  static constexpr int kColsB = BN / 8;             // B columns a thread copies
  // a kernel 4 wide: a thread's columns of one kernel row step by a
  // channel; else the thread describes each of its columns
  static constexpr int kRowsX = KH / 2;             // (KW == 4) its kernel rows
  static constexpr int kCols = KW == 4 ? 1 : kColsB;
  static constexpr int kStageFloats = BK * (kLdA + kLdB);
  static constexpr int kSmemBytes =
      (kStages * kStageFloats > BM * kLdB ? kStages * kStageFloats
                                          : BM * kLdB) * 4;
};

template <int KH, int KW, int BM, int BN>
__global__ void __launch_bounds__(kThreads, 1) conv_wgrad(const Params p) {
  using T = Tile<KH, KW, BM, BN>;
  constexpr int kLdA = T::kLdA, kLdB = T::kLdB, kTaps = T::kTaps;
  extern __shared__ __align__(16) float shared[];
  float* const a_ring = shared;                          // [kStages][BK][kLdA]
  float* const b_ring = shared + kStages * BK * kLdA;    // [kStages][BK][kLdB]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int j_tiles = (p.J + BN - 1) / BN;
  const int j0 = (blockIdx.x % j_tiles) * BN;
  const int co0 = (blockIdx.x / j_tiles) * BM;
  const int slice = blockIdx.y;
  const int k_begin = slice * p.per_slice;
  const int k_end = min(p.K, k_begin + p.per_slice);
  const int steps = (k_end - k_begin + BK - 1) / BK;
  const int P = p.Ho * p.Wo, HW = p.H * p.W;

  // -- this thread's copies: one position q of each step; A rows e + 4 h +
  // 8 u, B columns 4 (h + 2 u) + e.  A warp's lanes take 8 consecutive
  // positions of 4 rows (A) or of the 4 columns s = 0..3 of one channel
  // and kernel row (B, a kernel 4 wide): each write falls on its own bank,
  // and B's 32 reads lie in one run of x (11 values at column stride 1).
  const int q = (lane & 7) + 8 * (warp & 3);
  const int e = lane >> 3, h = warp >> 2;
  const bool all_rows = co0 + BM <= p.Cout;
  uint32_t rows_ok = 0;
#pragma unroll
  for (int u = 0; u < T::kRowsA; ++u)
    rows_ok |= static_cast<uint32_t>(co0 + e + 4 * h + 8 * u < p.Cout) << u;
  // a kernel not 4 wide: column j = (ci, r, s) as x's offset from (n, 0,
  // hi, wi) of the position, ci * HW + r * W + s, above its tap r * KW + s;
  // a column past J reads the last one (its sums are not stored)
  uint32_t col[T::kCols];
  if constexpr (KW != 4) {
#pragma unroll
    for (int u = 0; u < T::kCols; ++u) {
      const int j = min(p.J - 1, j0 + 4 * (h + 2 * u) + e);
      const int ci = j / kTaps, tap = j - ci * kTaps;
      const int r = tap / KW, s = tap - r * KW;
      col[u] = static_cast<uint32_t>(ci * HW + r * p.W + s) << 6 | tap;
    }
  }

  // offsets are 32-bit: the caller keeps x and dy under 2^30 elements
  auto load = [&](int step, int slot) {
    const int k = k_begin + step * BK + q;
    const int bytes = k < k_end ? 4 : 0;
    const int R = p.wo(k), n = p.ho(R);
    const int hi = (R - n * p.Ho) * p.sh - p.pt,
              wi = (k - R * p.Wo) * p.sw - p.pl;
    {  // A: dy at this position
      const float* const src =
          p.dy + ((n * p.Cout + co0 + e + 4 * h) * P + (k - n * P));
      float* const dst = a_ring + slot * BK * kLdA + q * kLdA + e + 4 * h;
      if (all_rows) {
#pragma unroll
        for (int u = 0; u < T::kRowsA; ++u)
          copy4(dst + 8 * u, src + 8 * u * P, bytes);
      } else {
#pragma unroll
        for (int u = 0; u < T::kRowsA; ++u)
          copy4(dst + 8 * u, src + 8 * u * P, rows_ok >> u & 1 ? bytes : 0);
      }
    }
    // B: x's taps at this position, zero outside the image
    const float* const x = p.x + (n * p.Cin * HW + hi * p.W + wi);
    float* const dst = b_ring + slot * BK * kLdB + q * kLdB + e + 4 * h;
    if constexpr (KW == 4) {
      // column 4 G + e, G = h + 2 u, is the tap (r, e) of channel ci with
      // r = G % KH = h + 2 m and ci = j0 / kTaps + G / KH: for each of the
      // thread's kernel rows m, its columns step by one channel
      const int in_col =
          static_cast<unsigned>(wi + e) < static_cast<unsigned>(p.W) ? bytes
                                                                       : 0;
      const float* const x0 = x + (j0 / kTaps) * HW + h * p.W + e;
#pragma unroll
      for (int m = 0; m < T::kRowsX; ++m) {
        const int in = static_cast<unsigned>(hi + h + 2 * m) <
                               static_cast<unsigned>(p.H)
                           ? in_col
                           : 0;
        const float* src = x0 + 2 * m * p.W;
        const int stride = opaque(HW);
#pragma unroll
        for (int c = 0; c < T::kColsB / T::kRowsX; ++c, src += stride) {
          const int u = c * T::kRowsX + m;
          copy4(dst + 8 * u, src, j0 + 4 * (h + 2 * u) + e < p.J ? in : 0);
        }
      }
    } else {
      // bit r * KW + s: tap (r, s) inside the image
      const int r0 = min(KH, max(0, -hi)), r1 = max(r0, min(KH, p.H - hi));
      const int s0 = min(KW, max(0, -wi)), s1 = max(s0, min(KW, p.W - wi));
      const uint32_t cols = (1u << s1) - (1u << s0);
      uint32_t inside = 0;
#pragma unroll
      for (int r = 0; r < KH; ++r)
        inside |= r >= r0 && r < r1 ? cols << (r * KW) : 0u;
      if (!bytes) inside = 0;
#pragma unroll
      for (int u = 0; u < T::kColsB; ++u)
        copy4(dst + 8 * u, x + (col[u] >> 6),
              (inside >> (col[u] & 63) & 1) * 4);
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
    if (s < steps) load(s, s);
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
    if (next < steps) load(next, next % kStages);
    commit();
    const float* const a = a_ring + (step % kStages) * BK * kLdA;
    const float* const b = b_ring + (step % kStages) * BK * kLdB;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(a + k * kLdA + tm);
      const float4 a1 =
          *reinterpret_cast<const float4*>(a + k * kLdA + tm + 16);
      const float4 b0 = *reinterpret_cast<const float4*>(b + k * kLdB + tn);
      const float4 b1 =
          *reinterpret_cast<const float4*>(b + k * kLdB + tn + 32);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          part[i][j] = (fresh && k == 0) ? av[i] * bv[j]
                                         : fmaf(av[i], bv[j], part[i][j]);
    }
    if (bias_rows) {  // the step's 32 values of the row, pairwise
      static_assert(BK == 32, "a step's bias sum takes 8 runs of 4");
      float s[BK / 4];
#pragma unroll
      for (int k = 0; k < BK / 4; ++k)
        s[k] = (a[4 * k * kLdA + tid] + a[(4 * k + 1) * kLdA + tid]) +
               (a[(4 * k + 2) * kLdA + tid] + a[(4 * k + 3) * kLdA + tid]);
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
  float* const out_tile = shared;  // [BM][kLdB]
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* const row = out_tile + (tm + (i & 3) + 16 * (i >> 2)) * kLdB;
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
          out_tile[row * kLdB + c];
  if (bias_rows && co0 + tid < p.Cout)
    p.db[static_cast<int64_t>(slice) * p.Cout + co0 + tid] = db_acc;
}

// -- at most 32 columns: 64 output channels by all columns a block ----------
template <int KH, int KW, int BN>
struct Narrow {
  static_assert(BN == 16 || BN == 32, "16 or 32 columns");
  static constexpr int BM = 64, kTaps = KH * KW;
  static constexpr int kLdA = BM + 4, kLdB = BN + 4;
  static constexpr int kGroupThreads = (BM / 8) * (BN / 8);
  static constexpr int kGroups = kThreads / kGroupThreads;  // 16 or 8
  static constexpr int kPer = NBK / kGroups;                // a group's positions a step
  static constexpr int kAFloats = NBK * kLdA, kBFloats = NBK * kLdB;
  static constexpr int kSmemBytes =
      (kStages * (kAFloats + kBFloats) > kGroups * BM * BN
           ? kStages * (kAFloats + kBFloats)
           : kGroups * BM * BN) * 4;
};

template <int KH, int KW, int BN>
__global__ void __launch_bounds__(kThreads, 1)
    conv_wgrad_narrow(const Params p) {
  using T = Narrow<KH, KW, BN>;
  constexpr int BM = T::BM, kLdA = T::kLdA, kLdB = T::kLdB;
  extern __shared__ __align__(16) float shared[];
  float* const a_ring = shared;                            // [kStages][NBK][kLdA]
  float* const b_ring = shared + kStages * T::kAFloats;    // [kStages][NBK][kLdB]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int co0 = blockIdx.x * BM;
  const int slice = blockIdx.y;
  const int k_begin = slice * p.per_slice;
  const int k_end = min(p.K, k_begin + p.per_slice);
  const int steps = (k_end - k_begin + NBK - 1) / NBK;
  const int P = p.Ho * p.Wo, HW = p.H * p.W;

  // -- copies: positions kk and kk + 64 of each step, rows and columns
  // rr + 4 u; a warp's lanes cover 8 consecutive positions of 4 rows
  const int kk = (lane & 7) + 8 * warp, rr = lane >> 3;
  uint32_t rows_ok = 0;
#pragma unroll
  for (int u = 0; u < BM / 4; ++u)
    rows_ok |= static_cast<uint32_t>(co0 + rr + 4 * u < p.Cout) << u;
  // B's columns j = (ci, r, s): the tap's offset from the window's corner
  // and its row and column bits (all bits past J: never inside)
  int col_off[BN / 4];
  uint32_t col_bits[BN / 4];
#pragma unroll
  for (int u = 0; u < BN / 4; ++u) {
    const int j = rr + 4 * u;
    const int ci = j / T::kTaps, tap = j - ci * T::kTaps;
    const int r = tap / KW, s = tap - r * KW;
    col_off[u] = ci * HW + r * p.W + s;
    col_bits[u] = j < p.J ? (1u << r) | (1u << (8 + s)) : ~0u;
  }
  auto load = [&](int step, int slot) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = kk + 64 * h, k = k_begin + step * NBK + q;
      const bool k_ok = k < k_end;
      const int R = p.wo(k), n = p.ho(R);
      const int ho = R - n * p.Ho, wo = k - R * p.Wo;
      const int hi = ho * p.sh - p.pt, wi = wo * p.sw - p.pl;
      // the kernel rows r0 <= r < r1 and columns s0 <= s < s1 inside
      const int r0 = min(KH, max(0, -hi)), r1 = max(r0, min(KH, p.H - hi));
      const int s0 = min(KW, max(0, -wi)), s1 = max(s0, min(KW, p.W - wi));
      const uint32_t live =
          k_ok ? ((1u << r1) - (1u << r0)) | (((1u << s1) - (1u << s0)) << 8)
               : 0u;
      const int a_at = (n * p.Cout + co0 + rr) * P + (k - n * P);
      const int b_at = n * p.Cin * HW + hi * p.W + wi;
      float* const a = a_ring + slot * T::kAFloats + q * kLdA + rr;
      float* const b = b_ring + slot * T::kBFloats + q * kLdB + rr;
#pragma unroll
      for (int u = 0; u < BM / 4; ++u)
        copy4(a + 4 * u, p.dy + (a_at + 4 * u * P),
              k_ok && (rows_ok >> u & 1) ? 4 : 0);
#pragma unroll
      for (int u = 0; u < BN / 4; ++u)
        copy4(b + 4 * u, p.x + (b_at + col_off[u]),
              (col_bits[u] & live) == col_bits[u] ? 4 : 0);
    }
  };

  // this thread's group takes positions grp + kGroups i of each step; its
  // accumulators are rows tm + {0..3, 32..35} by columns tn + {0..7}
  const int grp = tid / T::kGroupThreads, t = tid % T::kGroupThreads;
  const int tm = (t % 8) * 4, tn = (t / 8) * 8;
  const bool bias_rows = p.db != nullptr && tid < BM;
  float acc[8][8], db_acc = 0.0f, db_lost = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s, s);
    commit();
  }
  auto run_step = [&](int step, float (&part)[8][8], float& db_part,
                      bool fresh) {
    wait_copies<kStages - 2>();
    __syncthreads();
    const int next = step + kStages - 1;
    if (next < steps) load(next, next % kStages);
    commit();
    const float* const a = a_ring + (step % kStages) * T::kAFloats;
    const float* const b = b_ring + (step % kStages) * T::kBFloats;
#pragma unroll
    for (int i = 0; i < T::kPer; ++i) {
      const int k = grp + T::kGroups * i;
      const float4 a0 = *reinterpret_cast<const float4*>(a + k * kLdA + tm);
      const float4 a1 =
          *reinterpret_cast<const float4*>(a + k * kLdA + tm + 32);
      const float4 b0 = *reinterpret_cast<const float4*>(b + k * kLdB + tn);
      const float4 b1 =
          *reinterpret_cast<const float4*>(b + k * kLdB + tn + 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c)
          part[r][c] = (fresh && i == 0) ? av[r] * bv[c]
                                         : fmaf(av[r], bv[c], part[r][c]);
    }
    if (bias_rows) {  // the step's 128 values of the row: runs of 32 pairwise
      float run[NBK / 32];
#pragma unroll
      for (int h = 0; h < NBK / 32; ++h) {
        float s[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float* const v = a + (32 * h + 4 * k) * kLdA + tid;
          s[k] = (v[0] + v[kLdA]) + (v[2 * kLdA] + v[3 * kLdA]);
        }
        run[h] = ((s[0] + s[1]) + (s[2] + s[3])) + ((s[4] + s[5]) + (s[6] + s[7]));
      }
      const float sum = (run[0] + run[1]) + (run[2] + run[3]);
      db_part = fresh ? sum : db_part + sum;
    }
  };
  for (int step0 = 0; step0 < steps; step0 += p.fold) {
    float part[8][8], db_part = 0.0f;
    run_step(step0, part, db_part, true);
    for (int f = 1; f < p.fold && step0 + f < steps; ++f)
      run_step(step0 + f, part, db_part, false);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] += part[i][j];
    const float y = db_part - db_lost, s = db_acc + y;
    db_lost = (s - db_acc) - y;
    db_acc = s;
  }

  // -- the groups' tiles added in a fixed tree, then stored ---------------
  wait_copies<0>();
  __syncthreads();
  float* const tiles = shared;  // [kGroups][BM][BN]
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* const row = tiles + (grp * BM + tm + (i & 3) + 32 * (i >> 2)) * BN + tn;
    *reinterpret_cast<float4*>(row) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(row + 4) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  __syncthreads();
  float* const dw = p.dw + static_cast<int64_t>(slice) * p.Cout * p.J;
  for (int o = tid; o < BM * BN; o += kThreads) {
    const int row = o / BN, c = o % BN;
    float v[T::kGroups];
#pragma unroll
    for (int h = 0; h < T::kGroups; ++h) v[h] = tiles[h * BM * BN + o];
#pragma unroll
    for (int w = 1; w < T::kGroups; w *= 2)
#pragma unroll
      for (int h = 0; h < T::kGroups; h += 2 * w) v[h] += v[h + w];
    if (co0 + row < p.Cout && c < p.J)
      dw[static_cast<int64_t>(co0 + row) * p.J + c] = v[0];
  }
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
  using T = Tile<KH, KW, BM, BN>;
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

template <int KH, int KW, int BN>
int launch_narrow(const Params& p, int S, cudaStream_t stream) {
  using T = Narrow<KH, KW, BN>;
  const cudaError_t set = cudaFuncSetAttribute(
      conv_wgrad_narrow<KH, KW, BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (S > 65535) return static_cast<int>(cudaErrorInvalidValue);
  conv_wgrad_narrow<KH, KW, BN>
      <<<dim3((p.Cout + T::BM - 1) / T::BM, S), kThreads, T::kSmemBytes,
         stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// the tile from the columns and output channels: at most 32 columns, the
// narrow kernel; a kernel 4 wide and at most 64 output channels, 64 x 256;
// else 128 x 128
template <int KH, int KW>
int launch_tile(const Params& p, int S, cudaStream_t stream) {
  if (p.J <= 16) return launch_narrow<KH, KW, 16>(p, S, stream);
  if (p.J <= 32) return launch_narrow<KH, KW, 32>(p, S, stream);
  if (KW == 4 && p.Cout <= 64) return launch<KH, KW, 64, 256>(p, S, stream);
  return launch<KH, KW, 128, 128>(p, S, stream);
}

}  // namespace

// dw [Cout, Cin, kh, kw] and db [Cout] (null for none) of
// y = conv2d(x padded by pt rows above and pl columns left, w, stride
// (sh, sw)) from x [N, Cin, H, W] and dy [N, Cout, Ho, Wo].  The sum over
// the K = N * Ho * Wo positions is cut into S slices of per_slice
// positions (a multiple of the kernel's step: 128 where Cin * kh * kw <=
// 32, else 32; S = ceil(K / per_slice)); for S > 1, ws holds S * Cout *
// (Cin * kh * kw + 1) floats, which the slices fill before the second
// launch adds them.  (kh, kw) is (3, 3), (4, 4) or (8, 4); all float32,
// contiguous, on the device; K and the elements of x and dy below 2^30
// (the kernel's 32-bit offsets run a step past the end), an image of x
// below 2^26.  Returns the cudaError_t of the launches (0 = cudaSuccess).
extern "C" int nhans_conv_wgrad(const float* x, const float* dy, float* dw,
                                float* db, float* ws, int N, int Cin, int H,
                                int W, int Cout, int Ho, int Wo, int kh,
                                int kw, int sh, int sw, int pt, int pl,
                                int S, int per_slice, void* stream) {
  const int64_t K = static_cast<int64_t>(N) * Ho * Wo;
  const int J = Cin * kh * kw;
  const int step = J <= 32 ? NBK : BK;
  if (N <= 0 || Cin <= 0 || H <= 0 || W <= 0 || Cout <= 0 || Ho <= 0 ||
      Wo <= 0 || sh <= 0 || sw <= 0 || S <= 0 || per_slice <= 0 ||
      per_slice % step || K >= (int64_t{1} << 30) ||
      static_cast<int64_t>(N) * Cin * H * W >= (int64_t{1} << 30) ||
      static_cast<int64_t>(Cin) * H * W >= (int64_t{1} << 26) ||
      (static_cast<int64_t>(S) - 1) * per_slice >= K ||
      static_cast<int64_t>(S) * per_slice < K || (S > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n = static_cast<int64_t>(Cout) * J;
  float* const dw_part = S > 1 ? ws : dw;
  float* const db_part =
      db == nullptr ? nullptr : S > 1 ? ws + static_cast<int64_t>(S) * n : db;
  // chunks of about sqrt(steps / products a step) steps: the rounding of
  // the chunks' sums and of their sum in order balance
  const int per_step = J <= 32 ? (J <= 16 ? 8 : 16) : BK;
  const int fold =
      static_cast<int>(sqrt(static_cast<double>(per_slice) / step / per_step) + 0.5);
  Params p{};
  p.x = x;
  p.dy = dy;
  p.dw = dw_part;
  p.db = db_part;
  p.K = static_cast<int>(K);
  p.per_slice = per_slice;
  p.fold = fold > 1 ? fold : 1;
  p.Cin = Cin;
  p.H = H;
  p.W = W;
  p.Cout = Cout;
  p.J = J;
  p.Ho = Ho;
  p.Wo = Wo;
  p.sh = sh;
  p.sw = sw;
  p.pt = pt;
  p.pl = pl;
  p.wo = make_div(Wo);
  p.ho = make_div(Ho);
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
