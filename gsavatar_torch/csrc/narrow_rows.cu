// K4: the narrow-row probe, for Hopper (sm_90a).
//
// Replaces tools/profile_narrow_dma.py:_kernel (the Pallas TPU kernel behind
// `run`), which asked whether the TPU's DMA engine streams (64, 12) row
// chunks of a (P, 12) f32 array. Here it measures how fast the card streams
// rows of that width: 48 bytes, the layout of the port's pair rows
// (ops/rasterizer/pairs.py: PAIR_COLS = 12), which K1, K2 and K3 read.
//
// Function: x (P, 12) f32, row-major, 16-byte aligned, P a multiple of 1024;
// out (P / 1024, 12) f32 with out[b, c] = sum over r < 1024 of
// x[1024 b + r, c]. That is the TPU kernel's live output; its (8, 128)
// padding existed only for the TPU's tiles.
//
// Design: one block of 256 threads per 1024-row block (48 KB, contiguous).
// Thread t reads rows t, t + 256, t + 512 and t + 768, each as three float4
// loads, all twelve issued before any add, so that each thread keeps twelve
// 16-byte loads in flight. A warp's loads of one row cover 1536 contiguous
// bytes. Each thread then holds 12 column sums; a warp-shuffle tree sums
// them over the warp, and the 8 warps' sums meet in shared memory, where 12
// threads add them and write the block's row. The TPU kernel's double-
// buffered DMA is not copied: the loads in flight take its place.
// cp.async or TMA staging is later work.
//
// What bounds it on this card: the bytes, P * 48 read and P / 1024 * 48
// written over 3.35 TB/s (0.0301 ms at P = 2^21); the adds, 12 per row, are
// two orders of magnitude below.

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 12;
constexpr int kRows = 1024;     // rows per output row
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = kRows / kThreads;

__global__ void __launch_bounds__(kThreads)
narrow_rows_kernel(const float4* __restrict__ x, float* __restrict__ out) {
  __shared__ float s_part[kWarps][kCols];
  // three float4 per row: the block's rows start at 3 * 1024 * blockIdx.x
  const float4* base = x + (size_t)blockIdx.x * kRows * 3;
  float4 v[kRowsPerThread][3];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const float4* row = base + (size_t)(threadIdx.x + i * kThreads) * 3;
#pragma unroll
    for (int q = 0; q < 3; ++q) v[i][q] = __ldg(row + q);
  }
  float acc[kCols];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    acc[4 * q + 0] = v[0][q].x;
    acc[4 * q + 1] = v[0][q].y;
    acc[4 * q + 2] = v[0][q].z;
    acc[4 * q + 3] = v[0][q].w;
  }
#pragma unroll
  for (int i = 1; i < kRowsPerThread; ++i) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      acc[4 * q + 0] += v[i][q].x;
      acc[4 * q + 1] += v[i][q].y;
      acc[4 * q + 2] += v[i][q].z;
      acc[4 * q + 3] += v[i][q].w;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      acc[c] += __shfl_down_sync(0xffffffffu, acc[c], off);
  }
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) s_part[warp][c] = acc[c];
  }
  __syncthreads();
  if (threadIdx.x < kCols) {
    float s = s_part[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += s_part[w][threadIdx.x];
    out[(size_t)blockIdx.x * kCols + threadIdx.x] = s;
  }
}

}  // namespace

// Plain C entry point for ctypes: x (n_rows, 12) f32, 16-byte aligned, with
// n_rows a positive multiple of 1024; out (n_rows / 1024, 12) f32. Launches
// on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int gs_narrow_rows(const void* x, void* out, long long n_rows,
                              void* stream) {
  if (n_rows <= 0 || n_rows % kRows != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_blocks = n_rows / kRows;
  if (n_blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  narrow_rows_kernel<<<static_cast<unsigned>(n_blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
