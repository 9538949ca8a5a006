// Training's epilogue after each of the towers' k x k convolutions, forward
// and backward, for Hopper (sm_90a):
//
//   v   = y + a[n,c] + b[n,c] + t[h,c] + f[w,c] [+ r]     (the conditioning)
//   out = relu((v - mean[c]) * inv[c] + beta[c]),  times 0 where w >= valid_w
//
// with mean and var the batch's biased moments of v over (n, h, w),
// var = E[v^2] - mean^2, and inv = rsqrt(var + eps) * gamma, as
// nn/blocks.py::BatchNorm takes them in training; the population
// statistics move as BatchNorm.forward moves them, pop = pop * decay +
// (1 - decay) * batch, unless the caller passes none.  The main tower's
// CondResBlock (nn/model.py) runs it after each of its 16 convolutions with
// the conditioning tables (Inject: a, b [N, C], t [H, C], f [W, C]) and,
// after the second, the residual; the context tower's ContextBlock after
// each of its 8 without the tables.  It replaces no TPU kernel: the JAX
// package leaves these passes to XLA.  It replaces PyTorch's unfused
// operations: four broadcast adds, the residual add, the moments, the
// affine map, the ReLU and the autograd backward of each, about 45 passes
// over the activation for one epilogue's forward and backward.
//
// The backward, with dz = dout where (v - mean) * inv + beta > 0 and
// w < valid_w, else 0, is BatchNorm's:
//   dbeta = sum dz,  dgamma = rstd * sum dz (v - mean),
//   dv = A dz + B - K (v - mean),  A = gamma rstd,  B = -A dbeta / M,
//   K = A rstd^2 sum dz (v - mean) / M,
// M the count per channel.  dy and dr are dv.  Each table's gradient is the
// sum of dv over its group, which is linear in the group's sums of dz and v:
//   sum over g of dv = A sum dz + B |g| - K (sum v - |g| mean),
// for g a plane (n, c) (da and db), a row (c, h) over n and w (dt) and a
// column (c, w) over n and h (df); so they come out of the same reading of
// dout and v that the channel's sums take.
//
// What bounds it: bytes.  The forward reads y (and r), writes v (kept for
// the backward, as BatchNorm keeps its input), reads v and writes out; the
// backward reads dout and v twice and writes dv: 9 float32 transfers (10
// with r) an element, against a handful of operations.
//
// Sums: in float64, in a fixed order, with no atomics, so that two runs on
// the same inputs agree bit for bit.  A block takes one channel and a slice
// of the images, each thread its fixed elements, and writes the slice's
// sums; a second kernel adds the slices in order, as conv_wgrad.cu adds its
// slices.  The number of slices is the caller's, from the shapes alone.
//
// Design: the sums' kernels walk a slice's planes as one run of elements,
// 256 threads side by side and each thread's (n, h, w) moved on without a
// division, so that a small plane leaves no thread idle; every thread
// issues 4 loads before it uses them.  The elementwise kernels give a warp
// a plane, as tower_epilogue.cu does.  The backward's row and column sums
// take a few planes' dz and v into shared memory at a time (as many as
// leave a thread for each column and each part of a row): a thread sums a
// column down its rows, or a part of a row about as long as a column, and
// the parts, the planes and each plane's total (a warp's) are then added
// in order.
//
// Rounding: the conditioning adds in the modules' order, and the affine map
// is written with the _rn intrinsics so that the compiler contracts nothing
// into an FMA, and so the backward recomputes the forward's pre-activation
// bit for bit to find the ReLU's mask.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 4;  // loads a thread issues before it uses them

// BatchNorm's affine map, rounded as PyTorch's separate operations round
__device__ __forceinline__ float affine(float v, float m, float iv,
                                        float be) {
  return __fadd_rn(__fmul_rn(__fsub_rn(v, m), iv), be);
}

// dz of one element: dout where the forward's pre-activation is above 0
// and the column is inside
__device__ __forceinline__ float relu_grad(float d, float v, float m,
                                           float iv, float be, bool inside) {
  return affine(v, m, iv, be) > 0.0f && inside ? d : 0.0f;
}

__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  return x;
}

// the block's sums of x and y, in a fixed order, in thread 0
__device__ __forceinline__ void block_sum2(double& x, double& y) {
  __shared__ double part[2][kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  x = warp_sum(x);
  y = warp_sum(y);
  if (lane == 0) part[0][warp] = x, part[1][warp] = y;
  __syncthreads();
  if (threadIdx.x == 0) {
    x = part[0][0];
    y = part[1][0];
    for (int i = 1; i < kWarps; ++i) x += part[0][i], y += part[1][i];
  }
}

// A thread's element (n, h, w) in a run of one channel's planes, moved on
// by kThreads elements at a time without a division
struct Cursor {
  int n, h, w, dn, dh, dw;
  __device__ Cursor(int n0, int first, int H, int W) {
    const int HW = H * W, e = first % HW, rest = kThreads % HW;
    n = n0 + first / HW;
    h = e / W;
    w = e - h * W;
    dn = kThreads / HW;
    dh = rest / W;
    dw = rest - dh * W;
  }
  __device__ __forceinline__ void advance(int H, int W) {
    n += dn;
    h += dh;
    w += dw;
    if (w >= W) w -= W, ++h;
    if (h >= H) h -= H, ++n;
  }
};

// -- forward ----------------------------------------------------------------

// v for block (c, slice) and the slice's sums of v and v^2:
// part[slice][c][0..1]
template <bool kTables, bool kResidual>
__global__ void __launch_bounds__(kThreads)
    train_epilogue_stats(const float* __restrict__ y,
                         const float* __restrict__ r,
                         const float* __restrict__ a,
                         const float* __restrict__ b,
                         const float* __restrict__ t,
                         const float* __restrict__ f, float* __restrict__ v,
                         double* __restrict__ part, int N, int C, int H,
                         int W, int per) {
  // t[., c], f[., c], then a and b of the slice's images
  extern __shared__ float tab[];
  const int c = blockIdx.x, slice = blockIdx.y, tid = threadIdx.x;
  const int HW = H * W, n0 = slice * per, n1 = min(N, n0 + per);
  float* const ta = tab + H + W;
  float* const tb = ta + per;
  if (kTables) {
    for (int i = tid; i < H; i += kThreads) tab[i] = t[int64_t{i} * C + c];
    for (int i = tid; i < W; i += kThreads)
      tab[H + i] = f[int64_t{i} * C + c];
    for (int i = tid; i < n1 - n0; i += kThreads)
      ta[i] = a[int64_t{n0 + i} * C + c], tb[i] = b[int64_t{n0 + i} * C + c];
    __syncthreads();
  }
  Cursor at(n0, tid, H, W);
  double s1 = 0.0, s2 = 0.0;
  while (at.n < n1) {
    float x[kBatch], res[kBatch];
    int64_t off[kBatch];
    int nn[kBatch], hh[kBatch], ww[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      nn[u] = at.n, hh[u] = at.h, ww[u] = at.w;
      if (at.n < n1) {
        off[u] = (int64_t{at.n} * C + c) * HW + at.h * W + at.w;
        x[u] = y[off[u]];
        if (kResidual) res[u] = r[off[u]];
      }
      at.advance(H, W);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (nn[u] >= n1) break;
      float xv = x[u];
      if (kTables)
        xv = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(xv, ta[nn[u] - n0]),
                                           tb[nn[u] - n0]),
                                 tab[hh[u]]),
                       tab[H + ww[u]]);
      if (kResidual) xv = __fadd_rn(xv, res[u]);
      v[off[u]] = xv;
      const double xd = xv;
      s1 += xd;
      s2 = fma(xd, xd, s2);
    }
  }
  block_sum2(s1, s2);
  if (tid == 0) {
    part[(int64_t{slice} * C + c) * 2] = s1;
    part[(int64_t{slice} * C + c) * 2 + 1] = s2;
  }
}

// the moments from the slices' sums, in order; mom = [mean | inv | rstd]
// (mean and inv are float32 values); the population statistics moved as
// BatchNorm.forward moves them, where pop_mean is not null
__global__ void train_epilogue_moments(const double* __restrict__ part,
                                       int S, int C, double count,
                                       const float* __restrict__ gamma,
                                       double eps, float* pop_mean,
                                       float* pop_var, float decay,
                                       float keep, double* __restrict__ mom) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  double s1 = 0.0, s2 = 0.0;
  for (int s = 0; s < S; ++s)
    s1 += part[(int64_t{s} * C + c) * 2],
        s2 += part[(int64_t{s} * C + c) * 2 + 1];
  const double mean = s1 / count, var = s2 / count - mean * mean;
  const double rstd = 1.0 / sqrt(var + eps);
  const float mean_f = static_cast<float>(mean);
  mom[c] = mean_f;
  mom[C + c] = static_cast<float>(rstd * gamma[c]);
  mom[2 * C + c] = rstd;
  if (pop_mean != nullptr) {
    pop_mean[c] = __fadd_rn(__fmul_rn(pop_mean[c], decay),
                            __fmul_rn(keep, mean_f));
    pop_var[c] = __fadd_rn(__fmul_rn(pop_var[c], decay),
                           __fmul_rn(keep, static_cast<float>(var)));
  }
}

// out = relu(affine(v)), times 0 at columns >= valid_w: a warp a plane
template <bool kMask>
__global__ void __launch_bounds__(kThreads)
    train_epilogue_apply(const float* __restrict__ v,
                         const double* __restrict__ mom,
                         const float* __restrict__ beta,
                         float* __restrict__ out, int64_t planes, int C,
                         int HW, int W, int valid_w) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = int64_t{gridDim.x} * kWarps;
  for (int64_t p = int64_t{blockIdx.x} * kWarps + (threadIdx.x >> 5);
       p < planes; p += warps) {
    const int c = static_cast<int>(p % C);
    const float m = static_cast<float>(mom[c]);
    const float iv = static_cast<float>(mom[C + c]), be = beta[c];
    const float* vp = v + p * HW;
    float* op = out + p * HW;
    for (int e0 = lane; e0 < HW; e0 += 32 * kBatch) {
      float x[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (e0 + 32 * u < HW) x[u] = vp[e0 + 32 * u];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + 32 * u;
        if (e >= HW) break;
        float z = affine(x[u], m, iv, be);
        z = isnan(z) ? z : fmaxf(z, 0.0f);
        if (kMask && e % W >= valid_w) z = __fmul_rn(z, 0.0f);
        op[e] = z;
      }
    }
  }
}

// -- backward ---------------------------------------------------------------

// block (c, slice): the slice's sums of dz and dz (v - mean) into
// ch[slice][c][0..1]
__global__ void __launch_bounds__(kThreads)
    train_epilogue_grad_sums(const float* __restrict__ dout,
                             const float* __restrict__ v,
                             const double* __restrict__ mom,
                             const float* __restrict__ beta,
                             double* __restrict__ ch, int N, int C, int H,
                             int W, int valid_w, int per) {
  const int c = blockIdx.x, slice = blockIdx.y, tid = threadIdx.x;
  const int HW = H * W, n0 = slice * per, n1 = min(N, n0 + per);
  const float m = static_cast<float>(mom[c]);
  const float iv = static_cast<float>(mom[C + c]), be = beta[c];
  const double md = mom[c];
  Cursor at(n0, tid, H, W);
  double s_dz = 0.0, s_dzx = 0.0;
  while (at.n < n1) {
    float d[kBatch], x[kBatch];
    bool in[kBatch], inside[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      in[u] = at.n < n1;
      inside[u] = at.w < valid_w;
      if (in[u]) {
        const int64_t off = (int64_t{at.n} * C + c) * HW + at.h * W + at.w;
        d[u] = dout[off];
        x[u] = v[off];
      }
      at.advance(H, W);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (!in[u]) break;
      const float dz = relu_grad(d[u], x[u], m, iv, be, inside[u]);
      s_dz += dz;
      s_dzx = fma(static_cast<double>(dz), static_cast<double>(x[u]) - md,
                  s_dzx);
    }
  }
  block_sum2(s_dz, s_dzx);
  if (tid == 0) {
    ch[(int64_t{slice} * C + c) * 2] = s_dz;
    ch[(int64_t{slice} * C + c) * 2 + 1] = s_dzx;
  }
}

// How the table sums take a slice: P planes at a time, each row in G parts
struct Plan {
  int P, G;
  size_t bytes;  // dynamic shared memory
};

Plan grad_plan(int H, int W, int per) {
  constexpr size_t kMostBytes = 76 * 1024;  // three blocks an SM
  Plan p;
  p.G = (W + H - 1) / H;
  p.P = kThreads / (H + W);
  p.P = p.P < 1 ? 1 : p.P > per ? per : p.P;
  for (;; --p.P) {
    p.bytes = sizeof(double) * 2 * (W + H + p.P * W + p.P * H * p.G) +
              sizeof(float) * 2 * p.P * H * W;
    if (p.P == 1 || p.bytes <= kMostBytes) return p;
  }
}

// block (c, slice): as train_epilogue_grad_sums, and each plane's sums of
// dz and v into planes[n][c][0..1], the slice's row sums into
// rows[slice][c][0..1][h] and its column sums into cols[slice][c][0..1][w]
__global__ void __launch_bounds__(kThreads)
    train_epilogue_grad_table_sums(const float* __restrict__ dout,
                                   const float* __restrict__ v,
                                   const double* __restrict__ mom,
                                   const float* __restrict__ beta,
                                   double* __restrict__ ch,
                                   double* __restrict__ planes,
                                   double* __restrict__ rows,
                                   double* __restrict__ cols, int N, int C,
                                   int H, int W, int valid_w, int per, int P,
                                   int G) {
  // the running column sums [2][W] and row sums [2][H] of dz and v; the
  // step's column sums [P][2][W] and row parts [P][2][H][G]; then the
  // step's dz and v [P * H * W] each
  extern __shared__ double smem[];
  double* const cacc = smem;
  double* const racc = cacc + 2 * W;
  double* const pcol = racc + 2 * H;
  double* const part = pcol + 2 * P * W;
  float* const sdz = reinterpret_cast<float*>(part + 2 * P * H * G);
  float* const sv = sdz + P * H * W;
  const int c = blockIdx.x, slice = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int HW = H * W, n0 = slice * per, n1 = min(N, n0 + per);
  const int L = (W + G - 1) / G;  // columns a part of a row
  const float m = static_cast<float>(mom[c]);
  const float iv = static_cast<float>(mom[C + c]), be = beta[c];
  const double md = mom[c];
  for (int i = tid; i < 2 * (W + H); i += kThreads) cacc[i] = 0.0;
  double s_dz = 0.0, s_dzx = 0.0;
  for (int ns = n0; ns < n1; ns += P) {
    const int np = min(P, n1 - ns), ne = ns + np;
    // this step's planes into shared memory, at k = (n - ns) HW + h W + w
    Cursor at(ns, tid, H, W);
    while (at.n < ne) {
      float d[kBatch], x[kBatch];
      int k[kBatch];
      bool inside[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        k[u] = at.n < ne ? (at.n - ns) * HW + at.h * W + at.w : -1;
        inside[u] = at.w < valid_w;
        if (k[u] >= 0) {
          const int64_t off = (int64_t{at.n} * C + c) * HW + at.h * W + at.w;
          d[u] = dout[off];
          x[u] = v[off];
        }
        at.advance(H, W);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (k[u] < 0) break;
        const float dz = relu_grad(d[u], x[u], m, iv, be, inside[u]);
        s_dz += dz;
        s_dzx = fma(static_cast<double>(dz), static_cast<double>(x[u]) - md,
                    s_dzx);
        sdz[k[u]] = dz;
        sv[k[u]] = x[u];
      }
    }
    __syncthreads();  // the step's planes are in
    // a column down its rows, or a part of a row L columns long
    const int ncol = np * W, tasks = ncol + np * H * G;
    for (int j = tid; j < tasks; j += kThreads) {
      double sd = 0.0, sx = 0.0;
      if (j < ncol) {
        const int p = j / W, w = j - p * W;
        const float* zd = sdz + p * HW + w;
        const float* zx = sv + p * HW + w;
        for (int h = 0; h < H; ++h) sd += zd[h * W], sx += zx[h * W];
        pcol[p * 2 * W + w] = sd;
        pcol[(p * 2 + 1) * W + w] = sx;
      } else {
        const int i = j - ncol, p = i / (H * G), q = i - p * H * G;
        const int h = q / G, g = q - h * G;
        const int w0 = g * L, w1 = min(W, w0 + L);
        const float* zd = sdz + p * HW + h * W;
        const float* zx = sv + p * HW + h * W;
        for (int w = w0; w < w1; ++w) sd += zd[w], sx += zx[w];
        part[(p * 2 * H + h) * G + g] = sd;
        part[((p * 2 + 1) * H + h) * G + g] = sx;
      }
    }
    __syncthreads();  // the step's sums are in; its planes may be replaced
    // the running sums, plane after plane, each by the thread that owns it
    for (int j = tid; j < W + H; j += kThreads) {
      if (j < W) {
        for (int p = 0; p < np; ++p)
          cacc[j] += pcol[p * 2 * W + j],
              cacc[W + j] += pcol[(p * 2 + 1) * W + j];
      } else {
        const int h = j - W;
        for (int p = 0; p < np; ++p) {
          double sd = 0.0, sx = 0.0;
          for (int g = 0; g < G; ++g)
            sd += part[(p * 2 * H + h) * G + g],
                sx += part[((p * 2 + 1) * H + h) * G + g];
          racc[h] += sd;
          racc[H + h] += sx;
        }
      }
    }
    // each plane's total, by a warp over its column sums
    for (int p = warp; p < np; p += kWarps) {
      double sd = 0.0, sx = 0.0;
      for (int w = lane; w < W; w += 32)
        sd += pcol[p * 2 * W + w], sx += pcol[(p * 2 + 1) * W + w];
      sd = warp_sum(sd);
      sx = warp_sum(sx);
      if (lane == 0) {
        planes[(int64_t{ns + p} * C + c) * 2] = sd;
        planes[(int64_t{ns + p} * C + c) * 2 + 1] = sx;
      }
    }
    // the next step writes pcol and part only after its first barrier
  }
  block_sum2(s_dz, s_dzx);  // its barrier orders the last running sums
  const int64_t sc = int64_t{slice} * C + c;
  if (tid == 0) ch[sc * 2] = s_dz, ch[sc * 2 + 1] = s_dzx;
  for (int i = tid; i < 2 * H; i += kThreads) rows[sc * 2 * H + i] = racc[i];
  for (int i = tid; i < 2 * W; i += kThreads) cols[sc * 2 * W + i] = cacc[i];
}

// block c: the channel's sums from the slices, in order; coef = [A | B | K],
// dgamma and dbeta; with the tables, da [N, C], dt [H, C] and df [W, C]
__global__ void __launch_bounds__(kThreads)
    train_epilogue_grad_coef(const double* __restrict__ ch,
                             const double* __restrict__ planes,
                             const double* __restrict__ rows,
                             const double* __restrict__ cols,
                             const double* __restrict__ mom,
                             const float* __restrict__ gamma,
                             double* __restrict__ coef,
                             float* __restrict__ dgamma,
                             float* __restrict__ dbeta, float* __restrict__ da,
                             float* __restrict__ dt, float* __restrict__ df,
                             int S, int N, int C, int H, int W) {
  __shared__ double k[3];
  const int c = blockIdx.x, tid = threadIdx.x;
  if (tid == 0) {
    double sdz = 0.0, sdzx = 0.0;
    for (int s = 0; s < S; ++s)
      sdz += ch[(int64_t{s} * C + c) * 2],
          sdzx += ch[(int64_t{s} * C + c) * 2 + 1];
    const double count = static_cast<double>(N) * H * W;
    const double rstd = mom[2 * C + c];
    const double A = static_cast<double>(gamma[c]) * rstd;
    k[0] = A;
    k[1] = -A * sdz / count;
    k[2] = A * rstd * rstd * sdzx / count;
    coef[c] = k[0];
    coef[C + c] = k[1];
    coef[2 * C + c] = k[2];
    dgamma[c] = static_cast<float>(rstd * sdzx);
    dbeta[c] = static_cast<float>(sdz);
  }
  __syncthreads();
  if (da == nullptr) return;
  const double A = k[0], B = k[1], K = k[2], m = mom[c];
  // sum over a group of g elements of dv, from its sums of dz and v
  auto group = [&](double sd, double sv, double g) {
    return static_cast<float>(A * sd + B * g - K * (sv - g * m));
  };
  const double hw = static_cast<double>(H) * W;
  for (int n = tid; n < N; n += kThreads) {
    const int64_t i = (int64_t{n} * C + c) * 2;
    da[int64_t{n} * C + c] = group(planes[i], planes[i + 1], hw);
  }
  for (int j = tid; j < H + W; j += kThreads) {
    const bool row = j < H;
    const int i = row ? j : j - H, len = row ? H : W;
    const double* src = row ? rows : cols;
    double sd = 0.0, sv = 0.0;
    for (int s = 0; s < S; ++s) {
      const int64_t at = (int64_t{s} * C + c) * 2 * len + i;
      sd += src[at];
      sv += src[at + len];
    }
    const double g = static_cast<double>(N) * (row ? W : H);
    (row ? dt : df)[int64_t{i} * C + c] = group(sd, sv, g);
  }
}

// dv = A dz + (B - K (v - mean)): a warp a plane
template <bool kMask>
__global__ void __launch_bounds__(kThreads)
    train_epilogue_grad_apply(const float* __restrict__ dout,
                              const float* __restrict__ v,
                              const double* __restrict__ mom,
                              const float* __restrict__ beta,
                              const double* __restrict__ coef,
                              float* __restrict__ dv, int64_t planes, int C,
                              int HW, int W, int valid_w) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = int64_t{gridDim.x} * kWarps;
  for (int64_t p = int64_t{blockIdx.x} * kWarps + (threadIdx.x >> 5);
       p < planes; p += warps) {
    const int c = static_cast<int>(p % C);
    const float m = static_cast<float>(mom[c]);
    const float iv = static_cast<float>(mom[C + c]), be = beta[c];
    const float A = static_cast<float>(coef[c]);
    const float B = static_cast<float>(coef[C + c]);
    const float K = static_cast<float>(coef[2 * C + c]);
    const float* dp = dout + p * HW;
    const float* vp = v + p * HW;
    float* op = dv + p * HW;
    for (int e0 = lane; e0 < HW; e0 += 32 * kBatch) {
      float d[kBatch], x[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (e0 + 32 * u < HW) d[u] = dp[e0 + 32 * u], x[u] = vp[e0 + 32 * u];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + 32 * u;
        if (e >= HW) break;
        const float dz =
            relu_grad(d[u], x[u], m, iv, be, !kMask || e % W < valid_w);
        op[e] = __fadd_rn(__fmul_rn(A, dz),
                          __fsub_rn(B, __fmul_rn(K, __fsub_rn(x[u], m))));
      }
    }
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      count = 132;
  }
  return count;
}

// blocks of warps a plane: every warp resident at once
unsigned plane_blocks(int64_t planes) {
  const int64_t want = (planes + kWarps - 1) / kWarps;
  const int64_t cap = int64_t{sm_count()} * (2048 / kThreads);
  return static_cast<unsigned>(want < cap ? want : cap);
}

template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes) {
  // set on every launch: the attribute belongs to the current device
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

bool bad_shape(int N, int C, int H, int W, int S, int per) {
  return N <= 0 || C <= 0 || H <= 0 || W <= 0 || S <= 0 || S > 65535 ||
         per <= 0 || int64_t{S} * per < N || int64_t{S - 1} * per >= N ||
         int64_t{H} * W * N >= (int64_t{1} << 31);
}

}  // namespace

// The forward.  y, r (null: no residual), v and out [N, C, H, W]; a, b
// [N, C], t [H, C] and f [W, C] (all null: no tables); gamma, beta [C];
// pop_mean, pop_var [C] (null: left as they are); mom [3][C] doubles
// (mean, inv, rstd, for the backward); ws S * C * 2 doubles.  The images
// are cut into S slices of per (S = ceil(N / per)).  All contiguous on the
// device; N * H * W under 2^31.  Returns the cudaError_t of the launches
// (0 = cudaSuccess).
extern "C" int nhans_train_epilogue_forward(
    const float* y, const float* r, const float* a, const float* b,
    const float* t, const float* f, const float* gamma, const float* beta,
    float* pop_mean, float* pop_var, float* v, float* out, double* mom,
    double* ws, int N, int C, int H, int W, int valid_w, int S, int per,
    double eps, float decay, float keep, void* stream) {
  if (bad_shape(N, C, H, W, S, per) ||
      (pop_mean == nullptr) != (pop_var == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const bool tables = a != nullptr;
  const size_t tab_bytes = tables ? sizeof(float) * (H + W + 2 * per) : 0;
  const dim3 grid(C, S);
  int err = 0;
  if (tables && r != nullptr) {
    err = allow_smem(train_epilogue_stats<true, true>, tab_bytes);
    if (!err)
      train_epilogue_stats<true, true><<<grid, kThreads, tab_bytes, st>>>(
          y, r, a, b, t, f, v, ws, N, C, H, W, per);
  } else if (tables) {
    err = allow_smem(train_epilogue_stats<true, false>, tab_bytes);
    if (!err)
      train_epilogue_stats<true, false><<<grid, kThreads, tab_bytes, st>>>(
          y, r, a, b, t, f, v, ws, N, C, H, W, per);
  } else if (r != nullptr) {
    train_epilogue_stats<false, true><<<grid, kThreads, 0, st>>>(
        y, r, a, b, t, f, v, ws, N, C, H, W, per);
  } else {
    train_epilogue_stats<false, false><<<grid, kThreads, 0, st>>>(
        y, r, a, b, t, f, v, ws, N, C, H, W, per);
  }
  if (err) return err;
  train_epilogue_moments<<<(C + 127) / 128, 128, 0, st>>>(
      ws, S, C, static_cast<double>(N) * H * W, gamma, eps, pop_mean,
      pop_var, decay, keep, mom);
  const int64_t planes = int64_t{N} * C;
  if (valid_w < W)
    train_epilogue_apply<true><<<plane_blocks(planes), kThreads, 0, st>>>(
        v, mom, beta, out, planes, C, H * W, W, valid_w);
  else
    train_epilogue_apply<false><<<plane_blocks(planes), kThreads, 0, st>>>(
        v, mom, beta, out, planes, C, H * W, W, valid_w);
  return static_cast<int>(cudaGetLastError());
}

// The backward's shared memory with the tables for an H x W plane, at the
// least (one plane at a time), for the caller's check of its shapes.
extern "C" long long nhans_train_epilogue_smem(int H, int W) {
  return static_cast<long long>(grad_plan(H, W, 1).bytes);
}

// The backward.  dout, v and dv [N, C, H, W]; mom as the forward left it;
// gamma, beta, dgamma, dbeta [C]; da [N, C], dt [H, C], df [W, C] (all null:
// no tables); ws S * C * 2 + 3 * C doubles, and with the tables N * C * 2 +
// S * C * 2 * (H + W) more.  Slices as the forward's.  Returns the
// cudaError_t of the launches (0 = cudaSuccess).
extern "C" int nhans_train_epilogue_backward(
    const float* dout, const float* v, const double* mom, const float* gamma,
    const float* beta, float* dv, float* dgamma, float* dbeta, float* da,
    float* dt, float* df, double* ws, int N, int C, int H, int W,
    int valid_w, int S, int per, void* stream) {
  if (bad_shape(N, C, H, W, S, per))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const bool tables = da != nullptr;
  double* const ch = ws;
  double* const coef = ch + int64_t{S} * C * 2;
  double* const planes = tables ? coef + 3 * int64_t{C} : nullptr;
  double* const rows = tables ? planes + int64_t{N} * C * 2 : nullptr;
  double* const cols = tables ? rows + int64_t{S} * C * 2 * H : nullptr;
  const dim3 grid(C, S);
  if (tables) {
    const Plan plan = grad_plan(H, W, per);
    const int err = allow_smem(train_epilogue_grad_table_sums, plan.bytes);
    if (err) return err;
    train_epilogue_grad_table_sums<<<grid, kThreads, plan.bytes, st>>>(
        dout, v, mom, beta, ch, planes, rows, cols, N, C, H, W, valid_w, per,
        plan.P, plan.G);
  } else {
    train_epilogue_grad_sums<<<grid, kThreads, 0, st>>>(
        dout, v, mom, beta, ch, N, C, H, W, valid_w, per);
  }
  train_epilogue_grad_coef<<<C, kThreads, 0, st>>>(
      ch, planes, rows, cols, mom, gamma, coef, dgamma, dbeta, da, dt, df, S,
      N, C, H, W);
  const int64_t count = int64_t{N} * C;
  if (valid_w < W)
    train_epilogue_grad_apply<true><<<plane_blocks(count), kThreads, 0, st>>>(
        dout, v, mom, beta, coef, dv, count, C, H * W, W, valid_w);
  else
    train_epilogue_grad_apply<false><<<plane_blocks(count), kThreads, 0, st>>>(
        dout, v, mom, beta, coef, dv, count, C, H * W, W, valid_w);
  return static_cast<int>(cudaGetLastError());
}
