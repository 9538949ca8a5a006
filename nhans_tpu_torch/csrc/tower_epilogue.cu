// The main tower's conditioning, BatchNorm, residual and ReLU after a
// convolution, in one pass over its output, for Hopper (sm_90a).
//
// A CondResBlock in inference (nhans_tpu_torch/nn/model.py) follows each
// of its two convolutions with the same per-element arithmetic: the
// conditioning x + a + b + t + f (Inject), the residual add after the
// second one, the BatchNorm's affine map in float32, a ReLU, and in the
// lane-padded geometry the mask past the true width.  Done as separate
// PyTorch operations that is about 16 passes over the activation per
// convolution, each a full read and write; here it is one read of y (and
// of the residual) and one write:
//
//   out = relu(((((y + a[n,c]) + b[n,c]) + t[c,h]) + f[c,w] [+ r]
//               - mean[c]) * inv[c] + beta[c]),  times 0 where w >= valid_w
//
// y, r and out are NCHW [N, C, H, W] in the compute dtype (float32 or
// bfloat16); a and b are [N, C], t [C, H] and f [C, W] in that dtype; mean,
// inv (= rsqrt(var + eps) * gamma, computed by the caller as BatchNorm
// computes it) and beta are [C] float32.
//
// Rounding: the result equals the PyTorch operations bit for bit.  Each
// add, the subtraction and the multiply are the IEEE operations of
// PyTorch's elementwise kernels, written with the _rn intrinsics so that
// the compiler contracts nothing into an FMA; in bfloat16 every add is
// taken in float32 and rounded to bfloat16, as PyTorch's bfloat16 add
// does, and the BatchNorm runs in float32 and is rounded once, as
// BatchNorm.forward does.  The ReLU keeps a NaN, as torch.relu does, and
// the dead columns past valid_w are the result times 0, as the modules'
// mask multiplies: 0 for a finite value, NaN for a NaN or an infinity.
//
// What bounds it: bytes.  About 12 operations per element against 8 to
// 12 bytes moved (float32), far under the H100's 20 operations per byte.
//
// Design: one warp per (n, c) plane of H * W elements, so that a, b,
// mean, inv and beta are loaded once per plane into registers; the
// planes are dealt to the warps of a grid sized to fill the card.  Lanes
// take consecutive elements of the plane (coalesced loads and stores,
// whatever the plane's alignment), 4 elements a lane per step, whose
// loads are all issued before any is used.  Each lane carries its
// element's (h, w) and advances it by 32 with at most a few compares, so
// no element takes an integer division; t[c, h] and f[c, w] are read
// through the read-only cache, where a warp's reads of f are contiguous
// and those of t fall on one or two addresses.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;

template <typename T>
__device__ __forceinline__ float load(const T* p);
template <>
__device__ __forceinline__ float load<float>(const float* p) {
  return __ldg(p);
}
template <>
__device__ __forceinline__ float load<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// x rounded to the compute dtype, as the dtype's tensor would hold it
template <typename T>
__device__ __forceinline__ float held(float x);
template <>
__device__ __forceinline__ float held<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float held<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T>
__device__ __forceinline__ void store(T* p, float x);
template <>
__device__ __forceinline__ void store<float>(float* p, float x) {
  *p = x;
}
template <>
__device__ __forceinline__ void store<__nv_bfloat16>(__nv_bfloat16* p,
                                                     float x) {
  *p = __float2bfloat16_rn(x);
}

// (h, w) of the element 32 further on in a row-major [H, W] plane
__device__ __forceinline__ void advance(int& h, int& w, int W) {
  w += 32;
  while (w >= W) {
    w -= W;
    ++h;
  }
}

template <typename T, bool kResidual>
__global__ void __launch_bounds__(kThreads)
    tower_epilogue(const T* __restrict__ y, const T* __restrict__ r,
                   T* __restrict__ out, const T* __restrict__ a,
                   const T* __restrict__ b, const T* __restrict__ t,
                   const T* __restrict__ f, const float* __restrict__ mean,
                   const float* __restrict__ inv,
                   const float* __restrict__ beta, int64_t planes, int C,
                   int H, int W, int valid_w) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  const int HW = H * W;
  const int h0 = lane / W, w0 = lane - h0 * W;
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * kWarps +
                   (threadIdx.x >> 5);
       p < planes; p += warps) {
    const int c = static_cast<int>(p % C);
    const float pa = load(a + p), pb = load(b + p);
    const float m = __ldg(mean + c), iv = __ldg(inv + c),
                be = __ldg(beta + c);
    const T* tc = t + static_cast<int64_t>(c) * H;
    const T* fc = f + static_cast<int64_t>(c) * W;
    const int64_t base = p * HW;
    const T* yp = y + base;
    const T* rp = kResidual ? r + base : nullptr;
    T* op = out + base;
    int h = h0, w = w0;
    for (int e0 = lane; e0 < HW; e0 += 32 * kUnroll) {
      float v[kUnroll], res[kUnroll], tv[kUnroll], fv[kUnroll];
      int ws[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int e = e0 + 32 * u;
        ws[u] = w;
        if (e < HW) {
          v[u] = load(yp + e);
          if (kResidual) res[u] = load(rp + e);
          tv[u] = load(tc + h);
          fv[u] = load(fc + w);
        }
        advance(h, w, W);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int e = e0 + 32 * u;
        if (e >= HW) break;
        float x = held<T>(__fadd_rn(v[u], pa));
        x = held<T>(__fadd_rn(x, pb));
        x = held<T>(__fadd_rn(x, tv[u]));
        x = held<T>(__fadd_rn(x, fv[u]));
        if (kResidual) x = held<T>(__fadd_rn(x, res[u]));
        x = held<T>(__fadd_rn(__fmul_rn(__fsub_rn(x, m), iv), be));
        x = isnan(x) ? x : fmaxf(x, 0.0f);
        store(op + e, ws[u] < valid_w ? x : __fmul_rn(x, 0.0f));
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

template <typename T>
int launch(const void* y, const void* r, void* out, const void* a,
           const void* b, const void* t, const void* f, const float* mean,
           const float* inv, const float* beta, int64_t planes, int C,
           int H, int W, int valid_w, cudaStream_t stream) {
  // every warp resident at once: 8 blocks of 256 threads fill an SM
  const int64_t want = (planes + kWarps - 1) / kWarps;
  const int64_t cap = static_cast<int64_t>(sm_count()) * (2048 / kThreads);
  const unsigned blocks = static_cast<unsigned>(want < cap ? want : cap);
  auto ty = static_cast<const T*>(y);
  auto tr = static_cast<const T*>(r);
  auto to = static_cast<T*>(out);
  auto ta = static_cast<const T*>(a);
  auto tb = static_cast<const T*>(b);
  auto tt = static_cast<const T*>(t);
  auto tf = static_cast<const T*>(f);
  if (r != nullptr)
    tower_epilogue<T, true><<<blocks, kThreads, 0, stream>>>(
        ty, tr, to, ta, tb, tt, tf, mean, inv, beta, planes, C, H, W,
        valid_w);
  else
    tower_epilogue<T, false><<<blocks, kThreads, 0, stream>>>(
        ty, tr, to, ta, tb, tt, tf, mean, inv, beta, planes, C, H, W,
        valid_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype 0: float32, 1: bfloat16.  y, r (null: no residual) and out
// [N, C, H, W]; a, b [N, C]; t [C, H]; f [C, W]; mean, inv, beta [C]
// float32; all contiguous on the device.  Columns w >= valid_w are
// written as the result times 0 (valid_w = W: none).  Returns the cudaError_t of the
// launch (0 = cudaSuccess).
extern "C" int nhans_tower_epilogue(int dtype, const void* y, const void* r,
                                    void* out, const void* a, const void* b,
                                    const void* t, const void* f,
                                    const float* mean, const float* inv,
                                    const float* beta, int N, int C, int H,
                                    int W, int valid_w, void* stream) {
  if (N <= 0 || C <= 0 || H <= 0 || W <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t planes = static_cast<int64_t>(N) * C;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(y, r, out, a, b, t, f, mean, inv, beta, planes, C,
                         H, W, valid_w, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(y, r, out, a, b, t, f, mean, inv, beta,
                                 planes, C, H, W, valid_w, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
