// K3: the sorted segment sum, for Hopper (sm_90a).
//
// Replaces gsavatar/ops/segsum_pallas.py:_kernel (the Pallas TPU kernel
// behind segment_sum_sorted_blocked_t). Same function: values (M, C) f32,
// row-major, and seg_ids (M,) int32 sorted ascending; out (S, C) f32 holds
// the sum of the rows of each segment. Ids >= S are dropped, and their
// values are never read: the spans below end before them, so garbage (NaN)
// in those rows cannot reach a sum.
//
// Design: one block per 512 output segments. The wrapper finds the block's
// span of rows [starts[b], starts[b+1]) with one torch.searchsorted over the
// NB + 1 block bounds (as segsum_pallas.py does), since with sorted ids a
// block's rows are contiguous. Each thread sums a contiguous piece of the
// span: it carries a running sum over consecutive equal ids in registers
// and, at a change of id, adds it into the block's (512, C) accumulator in
// shared memory with a shared-memory atomicAdd. At the end the block writes
// its 512 rows, so every output row is written (empty segments as zero).
// The sums are f32; the atomics add in an order that changes from run to
// run, so results differ between runs in the last bits.
//
// What bounds it on this card: the bytes, M (4 + 4C) read and S 4C written,
// over 3.35 TB/s; the adds are one per value. Reading contiguous pieces per
// thread makes a warp's loads strided, which costs bandwidth; a warp-wide
// segmented reduction over coalesced loads is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kSegBlock = 512;  // output segments per block
constexpr int kThreads = 256;

template <int C>
__global__ void __launch_bounds__(kThreads)
segsum_kernel(const float* __restrict__ values, const int* __restrict__ ids,
              const int* __restrict__ starts, float* __restrict__ out,
              int num_segments) {
  __shared__ float s_acc[kSegBlock * C];
  const int seg0 = blockIdx.x * kSegBlock;
  for (int i = threadIdx.x; i < kSegBlock * C; i += kThreads) s_acc[i] = 0.0f;
  __syncthreads();

  const int s0 = starts[blockIdx.x];
  const int s1 = starts[blockIdx.x + 1];
  const int per = (s1 - s0 + kThreads - 1) / kThreads;
  const int lo = s0 + threadIdx.x * per;
  const int hi = min(s1, lo + per);
  float run[C] = {};
  int cur = -1;
  for (int i = lo; i < hi; ++i) {
    const int id = ids[i];
    if (id != cur) {
      if (cur >= 0 && cur < num_segments) {
#pragma unroll
        for (int c = 0; c < C; ++c)
          atomicAdd(&s_acc[(cur - seg0) * C + c], run[c]);
      }
      cur = id;
#pragma unroll
      for (int c = 0; c < C; ++c) run[c] = 0.0f;
    }
    const float* v = values + (size_t)i * C;
#pragma unroll
    for (int c = 0; c < C; ++c) run[c] += v[c];
  }
  if (cur >= 0 && cur < num_segments) {
#pragma unroll
    for (int c = 0; c < C; ++c)
      atomicAdd(&s_acc[(cur - seg0) * C + c], run[c]);
  }
  __syncthreads();

  const int rows = min(kSegBlock, num_segments - seg0);
  float* o = out + (size_t)seg0 * C;
  for (int i = threadIdx.x; i < rows * C; i += kThreads) o[i] = s_acc[i];
}

template <int C>
void launch(const float* values, const int* ids, const int* starts,
            float* out, int num_segments, int n_blocks, cudaStream_t stream) {
  segsum_kernel<C><<<n_blocks, kThreads, 0, stream>>>(values, ids, starts,
                                                       out, num_segments);
}

}  // namespace

// Plain C entry point for ctypes: values (M, n_cols) f32, ids (M,) int32
// sorted, starts (n_blocks + 1,) int32 span bounds, out (num_segments,
// n_cols) f32 with n_blocks = ceil(num_segments / 512). Built for the column
// counts of the training step only: 2 (hash table), 3 and 6 (AIAP gathers)
// and 9 (pair gradients). Launches on `stream` and returns cudaGetLastError()
// (0 = launched; cudaErrorInvalidValue for any other column count).
extern "C" int gs_segsum(const void* values, const void* ids,
                         const void* starts, void* out, int n_cols,
                         int num_segments, void* stream) {
  const int n_blocks = (num_segments + kSegBlock - 1) / kSegBlock;
  if (n_blocks == 0) return static_cast<int>(cudaGetLastError());
  const float* v = static_cast<const float*>(values);
  const int* i = static_cast<const int*>(ids);
  const int* s = static_cast<const int*>(starts);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n_cols) {
    case 2: launch<2>(v, i, s, o, num_segments, n_blocks, st); break;
    case 3: launch<3>(v, i, s, o, num_segments, n_blocks, st); break;
    case 6: launch<6>(v, i, s, o, num_segments, n_blocks, st); break;
    case 9: launch<9>(v, i, s, o, num_segments, n_blocks, st); break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
