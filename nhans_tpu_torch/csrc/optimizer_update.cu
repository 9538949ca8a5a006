// The optimizer's update of every parameter tensor in one pass, for Hopper
// (sm_90a): sgd or Adam, written in place, with each gradient's squared
// sum on the side.
//
// It replaces no Pallas kernel: the JAX package leaves optax's update to
// XLA, which fuses it.  Done as PyTorch operations per tensor
// (train/optim.py's rules, then an add_ and the squares of the global
// norm), a step issues about 17 kernels a tensor for Adam and 5 for sgd,
// 6,700 and 2,000 at the separator's 393 tensors, most of them on tensors
// of fewer than 4,096 values, and the card waits on the host that issues
// them.  Here one launch updates every tensor and a second sums the
// squares:
//
//   sgd:  p += step * g
//   adam: m = (1 - b1) g + b1 m;  v = ((1 - b2) g) g + b2 v;
//         p += step * ((m * inv_c1) / (sqrt(v * inv_c2) + eps))
//
// with the gradient g read once and p, m and v written in place.  A null
// gradient reads as 0.
//
// Rounding: the results equal the PyTorch operations' bit for bit.  Each
// multiply, add, division and square root is the IEEE float32 operation
// of PyTorch's CUDA kernels, written with the _rn intrinsics so that the
// compiler contracts nothing into an FMA.  A tensor divided by a Python
// number is, in ATen's CUDA kernel (BinaryDivTrueKernel.cu), the tensor
// times the float32 reciprocal of the number: inv_c1 and inv_c2 are those
// reciprocals, taken on the host as ATen takes them.
//
// What bounds it: bytes.  Adam reads g, p, m and v and writes p, m and v,
// 28 bytes a value, against about 12 operations: at the separator's
// 28,980,937 values 811 MB, 0.24 ms at 3.35 TB/s (sgd: 12 bytes a value,
// 348 MB, 0.10 ms).
//
// Design: the tensors are cut into chunks of `chunk` values (a multiple of
// 4), one block a chunk, enough blocks to fill the 132 SMs several times
// over; no chunk spans two tensors.  The table of tensors travels in the
// launch's parameter space (CUDA 12.1 and later take 32 KB there), so
// nothing is copied to the device before the launch; a block finds its
// tensor by a binary search of the table's first chunks.  Where the base
// of every pointer of a tensor is 16-byte aligned, a thread moves 4
// values with each load and store; the rest of a chunk, and every value of
// a tensor that is not aligned, goes one value at a time.  Each block
// writes its chunk's sum of g * g to a slot of its own, in the slot of its
// tensor's group (0: replicated, 1: split over the model axis), and
// optimizer_update_norm adds the slots in a fixed order: no atomics, so
// the norm has one order from run to run.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxTensors = 512;
constexpr int kThreads = 256;
constexpr int kNormThreads = 512;

// The tensors of one launch.  The host writes it byte for byte (the
// wrapper's TABLE_LAYOUT); optimizer_update_table_bytes reports its size.
struct TensorTable {
  float* param[kMaxTensors];
  const float* grad[kMaxTensors];  // null: no gradient, read as 0
  float* mu[kMaxTensors];          // Adam's slots; unused by sgd
  float* nu[kMaxTensors];
  int64_t numel[kMaxTensors];
  int32_t first[kMaxTensors + 1];  // each tensor's first chunk; first[count]:
                                   // the launch's chunks
  int32_t group[kMaxTensors];      // 0 or 1: the slot of its squared sum
  int32_t count;
};

// The rule's numbers, float32 as the PyTorch operations take them.
struct Rule {
  float step;    // -lr
  float a1, b1;  // 1 - b1, b1
  float a2, b2;  // 1 - b2, b2
  float inv_c1, inv_c2;
  float eps;
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <bool kAdam>
__device__ __forceinline__ void update(const Rule& r, float g, float& p,
                                       float& m, float& v) {
  if (kAdam) {
    m = __fadd_rn(__fmul_rn(r.a1, g), __fmul_rn(r.b1, m));
    v = __fadd_rn(__fmul_rn(__fmul_rn(r.a2, g), g), __fmul_rn(r.b2, v));
    const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v, r.inv_c2)), r.eps);
    p = __fadd_rn(p, __fmul_rn(r.step, __fdiv_rn(__fmul_rn(m, r.inv_c1),
                                                 den)));
  } else {
    p = __fadd_rn(p, __fmul_rn(r.step, g));
  }
}

template <bool kAdam>
__global__ void __launch_bounds__(kThreads)
    optimizer_update(const __grid_constant__ TensorTable t, const Rule r,
                     int64_t chunk, float* __restrict__ partials) {
  const int b = blockIdx.x;
  int lo = 0, hi = t.count;  // first[lo] <= b < first[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (t.first[mid] <= b)
      lo = mid;
    else
      hi = mid;
  }
  const int64_t begin = static_cast<int64_t>(b - t.first[lo]) * chunk;
  const int64_t end =
      begin + chunk < t.numel[lo] ? begin + chunk : t.numel[lo];
  float* __restrict__ p = t.param[lo];
  const float* __restrict__ g = t.grad[lo];
  float* __restrict__ m = t.mu[lo];
  float* __restrict__ v = t.nu[lo];
  float sq = 0.0f;
  int64_t tail = begin;
  if (aligned16(p) && aligned16(g) &&
      (!kAdam || (aligned16(m) && aligned16(v)))) {
    const int64_t quads = (end - begin) >> 2;
    for (int64_t j = threadIdx.x; j < quads; j += kThreads) {
      const int64_t at = begin + 4 * j;
      const float4 gq = g != nullptr
                            ? __ldg(reinterpret_cast<const float4*>(g + at))
                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      float4 pq = *reinterpret_cast<const float4*>(p + at);
      float4 mq, vq;
      if (kAdam) {
        mq = *reinterpret_cast<const float4*>(m + at);
        vq = *reinterpret_cast<const float4*>(v + at);
      }
      update<kAdam>(r, gq.x, pq.x, mq.x, vq.x);
      update<kAdam>(r, gq.y, pq.y, mq.y, vq.y);
      update<kAdam>(r, gq.z, pq.z, mq.z, vq.z);
      update<kAdam>(r, gq.w, pq.w, mq.w, vq.w);
      sq = fmaf(gq.x, gq.x, sq);
      sq = fmaf(gq.y, gq.y, sq);
      sq = fmaf(gq.z, gq.z, sq);
      sq = fmaf(gq.w, gq.w, sq);
      *reinterpret_cast<float4*>(p + at) = pq;
      if (kAdam) {
        *reinterpret_cast<float4*>(m + at) = mq;
        *reinterpret_cast<float4*>(v + at) = vq;
      }
    }
    tail = begin + 4 * quads;
  }
  for (int64_t at = tail + threadIdx.x; at < end; at += kThreads) {
    const float gv = g != nullptr ? __ldg(g + at) : 0.0f;
    float mv = 0.0f, vv = 0.0f;
    if (kAdam) {
      mv = m[at];
      vv = v[at];
    }
    update<kAdam>(r, gv, p[at], mv, vv);
    if (kAdam) {
      m[at] = mv;
      v[at] = vv;
    }
    sq = fmaf(gv, gv, sq);
  }
  // the block's sum, in the same order every run
  __shared__ float warp_sums[kThreads / 32];
  for (int d = 16; d > 0; d >>= 1) sq += __shfl_down_sync(0xffffffffu, sq, d);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = sq;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int w = 0; w < kThreads / 32; ++w) s += warp_sums[w];
    const int slot = t.group[lo];
    partials[2 * b + slot] = s;
    partials[2 * b + 1 - slot] = 0.0f;
  }
}

// out[k] = the sum over chunks c of partials[2 c + k], in float64, in one
// fixed order
__global__ void __launch_bounds__(kNormThreads)
    optimizer_update_norm(const float* __restrict__ partials, int chunks,
                          float* __restrict__ out) {
  __shared__ double sums[2][kNormThreads];
  double s0 = 0.0, s1 = 0.0;
  for (int c = threadIdx.x; c < chunks; c += kNormThreads) {
    s0 += partials[2 * c];
    s1 += partials[2 * c + 1];
  }
  sums[0][threadIdx.x] = s0;
  sums[1][threadIdx.x] = s1;
  __syncthreads();
  for (int w = kNormThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) {
      sums[0][threadIdx.x] += sums[0][threadIdx.x + w];
      sums[1][threadIdx.x] += sums[1][threadIdx.x + w];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    out[0] = static_cast<float>(sums[0][0]);
    out[1] = static_cast<float>(sums[1][0]);
  }
}

}  // namespace

extern "C" int64_t nhans_optimizer_table_bytes() {
  return static_cast<int64_t>(sizeof(TensorTable));
}

extern "C" int nhans_optimizer_max_tensors() { return kMaxTensors; }

// adam 0: sgd, 1: Adam.  table: a TensorTable on the host, its tensors
// float32 and contiguous on the device; rule: the 8 floats of Rule;
// chunk: values a block updates, a positive multiple of 4; partials: 2 x
// the table's chunks floats on the device.  Returns the cudaError_t of the
// launch (0 = cudaSuccess).
extern "C" int nhans_optimizer_update(int adam, const void* table,
                                      const float* rule, int64_t chunk,
                                      float* partials, void* stream) {
  const TensorTable& t = *static_cast<const TensorTable*>(table);
  if (t.count <= 0 || t.count > kMaxTensors || chunk <= 0 || chunk % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = t.first[t.count];
  if (blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Rule r{rule[0], rule[1], rule[2], rule[3],
               rule[4], rule[5], rule[6], rule[7]};
  auto s = static_cast<cudaStream_t>(stream);
  if (adam)
    optimizer_update<true><<<blocks, kThreads, 0, s>>>(t, r, chunk, partials);
  else
    optimizer_update<false><<<blocks, kThreads, 0, s>>>(t, r, chunk,
                                                        partials);
  return static_cast<int>(cudaGetLastError());
}

// out[0], out[1]: the two groups' sums of the first `chunks` pairs of
// partials.
extern "C" int nhans_optimizer_update_norm(const float* partials, int chunks,
                                           float* out, void* stream) {
  if (chunks < 0) return static_cast<int>(cudaErrorInvalidValue);
  optimizer_update_norm<<<1, kNormThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(partials,
                                                               chunks, out);
  return static_cast<int>(cudaGetLastError());
}
