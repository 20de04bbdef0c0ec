// K1: the fused per-tile compositor, forward, for Hopper (sm_90a).
//
// Replaces gsavatar/ops/rasterizer/pallas_composite.py:_fwd_kernel (the
// Pallas TPU kernel behind composite_pairs_fwd). Same function: for each
// 16x16 tile t, walk its depth-sorted pairs [tile_start[t], tile_start[t+1])
// of pair_data (P, 12) f32 rows [m2dx, m2dy, a, b, c, r, g, b, opac, 0, 0, 0]
// and, for every pixel of the tile,
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy,  alpha = min(0.99, opac e^power)
// skipping the pair when power > 0 or alpha < 1/255; front to back
// T *= (1 - alpha), where the pair that would take T below 1e-4 is excluded
// and the pixel stops. Output (num_tiles, 8, 256) f32 in the JAX kernel's
// layout: rows 0-2 the colour without background, row 3 1 - final_T,
// row 4 final_T, rows 5-7 zero.
//
// Design: one CTA per tile, one thread per pixel. Pair rows are staged in
// batches of 256 through shared memory, one row (three 16-byte loads) per
// thread, and every thread then walks the batch. The tile stops at the next
// batch once every pixel has stopped (a block-wide __syncthreads_count
// vote). A plain product T *= (1 - alpha) replaces the TPU kernel's
// log-space cumsum and MXU colour product; the two agree to rounding.
// Power, alpha and T are rounded by composite_common.cuh, which K2 shares.
//
// What bounds it on this card: the bytes are small (each pair row is read
// once per tile, 48 B, plus 8 KB of output per tile), so the bound is the
// f32 work, about 25 operations per (pair, pixel) evaluated before the
// pixel stops, over the 67 TFLOP/s of the non-tensor f32 units. A tile's
// pairs are walked in order by one CTA, so the tiles at the body's centre,
// which hold the most pairs, set the kernel's time; spreading a tile's
// walk over more warps is later work.

#include <cuda_runtime.h>

#include "composite_common.cuh"

namespace {

using namespace gs;

constexpr int kBatch = kPix;          // pair rows staged per round

__global__ void __launch_bounds__(kPix)
composite_fwd_kernel(const float* __restrict__ pair_data,
                     const int* __restrict__ tile_start,
                     float* __restrict__ out, int grid_x) {
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int start = tile_start[t];
  const int end = tile_start[t + 1];
  const float px = static_cast<float>((t % grid_x) * kTile + (tid % kTile));
  const float py = static_cast<float>((t / grid_x) * kTile + (tid / kTile));

  __shared__ float4 s_geo[kBatch];  // m2dx, m2dy, a, b
  __shared__ float4 s_col[kBatch];  // c, r, g, b
  __shared__ float s_opac[kBatch];

  float T = 1.0f;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  int done = 0;

  for (int base = start; base < end; base += kBatch) {
    // the vote is also the barrier that frees the previous batch
    if (__syncthreads_count(done) == kPix) break;
    const int row = base + tid;
    if (row < end) {
      const float4* src =
          reinterpret_cast<const float4*>(pair_data + (size_t)row * kCols);
      s_geo[tid] = src[0];
      s_col[tid] = src[1];
      s_opac[tid] = src[2].x;
    }
    __syncthreads();
    const int n = min(kBatch, end - base);
    for (int j = 0; j < n && !done; ++j) {
      const float4 c = s_col[j];
      Splat s;
      if (!splat_at(s_geo[j], c.x, s_opac[j], px, py, s)) continue;
      const float test_T = transmit(T, s.alpha);
      if (test_T < kTStop) {
        done = 1;
        break;
      }
      const float w = s.alpha * T;
      acc_r += c.y * w;
      acc_g += c.z * w;
      acc_b += c.w * w;
      T = test_T;
    }
  }

  float* o = out + (size_t)t * kOutRows * kPix + tid;
  o[0 * kPix] = acc_r;
  o[1 * kPix] = acc_g;
  o[2 * kPix] = acc_b;
  o[3 * kPix] = 1.0f - T;
  o[4 * kPix] = T;
  o[5 * kPix] = 0.0f;
  o[6 * kPix] = 0.0f;
  o[7 * kPix] = 0.0f;
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int gs_composite_fwd(const void* pair_data, const void* tile_start,
                                void* out, int num_tiles, int grid_x,
                                void* stream) {
  if (num_tiles > 0) {
    composite_fwd_kernel<<<num_tiles, kPix, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(pair_data),
        static_cast<const int*>(tile_start), static_cast<float*>(out),
        grid_x);
  }
  return static_cast<int>(cudaGetLastError());
}
