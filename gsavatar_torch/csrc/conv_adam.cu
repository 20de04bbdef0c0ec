// K5: the converter's optimizer step, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves optax's chain
// (gsavatar/scene.py:converter_optimizer: clip_by_global_norm,
// add_decayed_weights, scale_by_adam, the scheduled step) to XLA, which
// fuses it. The port's plain version (gsavatar_torch/scene.py:
// ConverterOptimizer.step_plain) runs about twenty small operations per
// leaf, some 2,600 launches a step on the default converter, and its host
// time was most of the training step's update. Here the whole chain is two
// launches over the leaves where they lie (multi-tensor: no flat copy).
//
// Function: over T gradient tensors g_t (the first N belong to parameters
// p_t with Adam moments mu_t and nu_t, the rest are the frozen subject
// constants', which enter only the clip's norm):
//   launch 1 (only with clip > 0): partial[b] = sum of g * g over block b's
//     chunk of CHUNK elements of one tensor;
//   launch 2: g_norm = sqrt(sum of the partials, in block order); then per
//     element of the N parameters, in the plain version's order and
//     rounding,
//       u   = g_norm < clip ? g : g / g_norm * clip   (u = g without a clip)
//       u   = u + wd[group] * p                        (where wd != 0)
//       mu  = (1 - B1) * u + B1 * mu
//       nu  = (1 - B2) * (u * u) + B2 * nu
//       p  += step[group] * ((mu / bc1) / (sqrt(nu / bc2) + eps))
//     with p, mu and nu written in place. Block 0 also stores g_norm after
//     the partials.
// Every operation is a _rn intrinsic, so nvcc contracts nothing into an
// FMA: given the same g_norm the result is the plain version's bit for bit.
// The norm has no float atomics: each block sums its chunk in a fixed
// order and every block of launch 2 adds the partials in the same fixed
// order, so every launch gives the same bits.
//
// Inputs: the gradient pointers change every step and travel by value in
// the kernel's argument struct (at most kMaxTensors, within the 4 KB of
// kernel arguments that every CUDA 12 release allows). What changes only
// with the state (the sizes, the pointers of p, mu and nu, the group ids
// and the block list) is one int64 table in device memory that the
// wrapper (gsavatar_torch/ops/conv_adam.py) builds once and keeps:
//   [0, T)             numel of each tensor
//   [T, T + N)         p pointers      [T + N, T + 2N)   mu pointers
//   [T + 2N, T + 3N)   nu pointers     [T + 3N, T + 4N)  group ids
//   then n_norm norm blocks and n_update update blocks, each
//   (tensor << 32) | chunk; launch 1 runs one block per norm block, launch
//   2 one per update block.
//
// What bounds it on this card: the bytes. The default converter (129
// leaves, 2.24M floats; 9 constants, 4.84M) reads 28 MB for the norm and
// reads 4 and writes 3 floats per parameter for the update, about 91 MB
// over 3.35 TB/s: 27 us. Chunks of 8,192 elements give 989 norm and
// 391 update blocks, a few resident on each of the 132 SMs; each thread
// walks its chunk with stride 256 (coalesced), unrolled so that several
// loads are in flight.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kChunk = 8192;      // elements per block
constexpr int kMaxTensors = 480;        // 8 bytes each, under 4 KB in all
constexpr int kGroups = 6;

struct Args {
  const float* g[kMaxTensors];
  const long long* table;
  float* partials;                      // n_norm partials, then g_norm
  int n_tensors, n_params, n_norm;
  float clip, a1, b1, a2, b2, bc1, bc2, eps;
  float step[kGroups];
  float wd[kGroups];
};

// The block's sum of v in a fixed order (a shuffle tree in each warp,
// then the warps in order); every thread gets it.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float s_warp[kWarps];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total = __fadd_rn(total, s_warp[w]);
  return total;
}

__device__ __forceinline__ void chunk_of(const Args& a, long long entry,
                                         int* t, long long* start,
                                         long long* end) {
  *t = static_cast<int>(entry >> 32);
  *start = (entry & 0xffffffffLL) * kChunk;
  const long long n = a.table[*t];
  *end = n < *start + kChunk ? n : *start + kChunk;
}

__global__ void __launch_bounds__(kThreads)
conv_adam_norm(const __grid_constant__ Args a) {
  const long long* blocks = a.table + a.n_tensors + 4LL * a.n_params;
  int t;
  long long start, end;
  chunk_of(a, blocks[blockIdx.x], &t, &start, &end);
  const float* __restrict__ g = a.g[t];
  float acc = 0.f;
#pragma unroll 8
  for (long long j = start + threadIdx.x; j < end; j += kThreads) {
    const float x = __ldg(g + j);
    acc = __fadd_rn(acc, __fmul_rn(x, x));
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) a.partials[blockIdx.x] = acc;
}

__global__ void __launch_bounds__(kThreads)
conv_adam_update(const __grid_constant__ Args a) {
  float g_norm = 0.f;
  bool keep = true;
  if (a.clip > 0.f) {
    float acc = 0.f;
    for (int i = threadIdx.x; i < a.n_norm; i += kThreads)
      acc = __fadd_rn(acc, a.partials[i]);
    g_norm = __fsqrt_rn(block_sum(acc));
    keep = g_norm < a.clip;
    if (blockIdx.x == 0 && threadIdx.x == 0) a.partials[a.n_norm] = g_norm;
  }
  const long long* blocks =
      a.table + a.n_tensors + 4LL * a.n_params + a.n_norm;
  int t;
  long long start, end;
  chunk_of(a, blocks[blockIdx.x], &t, &start, &end);
  const long long* ptrs = a.table + a.n_tensors;
  const float* __restrict__ g = a.g[t];
  float* __restrict__ p = reinterpret_cast<float*>(ptrs[t]);
  float* __restrict__ mu = reinterpret_cast<float*>(ptrs[a.n_params + t]);
  float* __restrict__ nu =
      reinterpret_cast<float*>(ptrs[2LL * a.n_params + t]);
  const int group = static_cast<int>(ptrs[3LL * a.n_params + t]);
  const float step = a.step[group], wd = a.wd[group];
#pragma unroll 4
  for (long long j = start + threadIdx.x; j < end; j += kThreads) {
    const float gj = __ldg(g + j);
    float pj = p[j];
    float u = keep ? gj : __fmul_rn(__fdiv_rn(gj, g_norm), a.clip);
    if (wd != 0.f) u = __fadd_rn(u, __fmul_rn(wd, pj));
    const float m = __fadd_rn(__fmul_rn(a.a1, u), __fmul_rn(a.b1, mu[j]));
    const float v = __fadd_rn(__fmul_rn(a.a2, __fmul_rn(u, u)),
                              __fmul_rn(a.b2, nu[j]));
    const float upd = __fdiv_rn(
        __fdiv_rn(m, a.bc1),
        __fadd_rn(__fsqrt_rn(__fdiv_rn(v, a.bc2)), a.eps));
    mu[j] = m;
    nu[j] = v;
    p[j] = __fadd_rn(pj, __fmul_rn(step, upd));
  }
}

}  // namespace

// Plain C entry point for ctypes. grads: n_tensors device pointers (a host
// array); table: the device table above; partials: n_norm + 1 device f32;
// scalars: a host array of clip, 1 - B1, B1, 1 - B2, B2, bc1, bc2, eps,
// the six groups' step sizes and their weight decays (20 floats). Queues
// launch 1 (when clip > 0 and n_norm > 0) and launch 2 (when n_update > 0)
// on `stream`; returns the first cudaGetLastError() that is not 0, else 0.
extern "C" int gs_conv_adam(const long long* grads, int n_tensors,
                            int n_params, const void* table, void* partials,
                            int n_norm, int n_update, const float* scalars,
                            void* stream) {
  if (n_tensors < 0 || n_tensors > kMaxTensors || n_params < 0 ||
      n_params > n_tensors || n_norm < 0 || n_update < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  for (int i = 0; i < n_tensors; ++i)
    a.g[i] = reinterpret_cast<const float*>(grads[i]);
  a.table = static_cast<const long long*>(table);
  a.partials = static_cast<float*>(partials);
  a.n_tensors = n_tensors;
  a.n_params = n_params;
  a.n_norm = n_norm;
  a.clip = scalars[0];
  a.a1 = scalars[1];
  a.b1 = scalars[2];
  a.a2 = scalars[3];
  a.b2 = scalars[4];
  a.bc1 = scalars[5];
  a.bc2 = scalars[6];
  a.eps = scalars[7];
  for (int k = 0; k < kGroups; ++k) {
    a.step[k] = scalars[8 + k];
    a.wd[k] = scalars[8 + kGroups + k];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.clip > 0.f && n_norm > 0) {
    conv_adam_norm<<<n_norm, kThreads, 0, s>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_update > 0) {
    conv_adam_update<<<n_update, kThreads, 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  return 0;
}
