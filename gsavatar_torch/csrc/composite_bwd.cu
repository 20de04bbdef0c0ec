// K2: the fused per-tile compositor, backward, for Hopper (sm_90a).
//
// Replaces gsavatar/ops/rasterizer/pallas_composite.py:_bwd_kernel (the
// Pallas TPU kernel behind composite_pairs_bwd, the VJP of
// make_composite_pairs). Same function: for every pair row of a tile's range
// [tile_start[t], tile_start[t+1]), the gradients of
// (m2dx, m2dy, a, b, c, r, g, b, opac), each summed over the tile's 256
// pixels, written to grad (P, 12) f32 in pair_data's column layout (columns
// 9-11 stay zero). Inputs besides the pair arrays: ct, the cotangent of the
// forward output (num_tiles, 8, 256) (rows 0-2 colour, 3 alpha, 4 final_T),
// and fwd, the forward output itself. Per pixel and included pair k, with
// T_k the transmittance before it and w_k = alpha_k T_k:
//   dL/dc_k     = w_k ct_rgb
//   S_k         = acc_out - sum_{j<=k} w_j c_j      (the suffix, from K1's output)
//   dL/dalpha_k = sum_c ct_c (T_k c_k,c - S_k,c / max(1 - alpha_k, 1e-6))
//                 - (ct_finalT - ct_alpha) final_T / max(1 - alpha_k, 1e-6)
// and through alpha = min(0.99, opac e^power) (no gradient where the 0.99
// clamp holds) to opac, power and from power to (m2d, a, b, c); the conic-b
// gradient is sum d_power (-dx dy). Excluded and skipped pairs get zero.
//
// Design: one CTA per tile and one thread per pixel, walking the pairs
// front to back as K1 does. Each thread recomputes power, alpha and T with
// K1's rounding (composite_common.cuh), so the two include the same pairs,
// and keeps its T and its three colour prefixes in registers. Pair rows are
// staged in batches of 128 through shared memory. For every row each warp
// sums its 32 pixels' nine terms with shuffles (skipped when no pixel of the
// warp includes the pair) into a per-warp slot in shared memory; at the end
// of the batch the CTA adds the 8 warps' slots and writes the rows.
//
// Early exit: the wrapper allocates grad with torch.zeros, so the kernel
// stops at the same block-wide vote as K1 once every pixel has stopped: the
// rows it does not write are the zeros every later pair would get.
//
// What bounds it on this card: like K1, the f32 work per (pair, pixel)
// walked before the pixel stops (about 60 operations per included pair,
// plus the warp sums), over the 67 TFLOP/s of the non-tensor f32 units; the
// bytes (nine columns of each pair row read and of its gradient row written,
// and 9 KB of cotangent and forward output per tile) take less. As in K1 the
// fullest tiles, walked by one CTA each, set the time.

#include <cuda_runtime.h>

#include "composite_common.cuh"

namespace {

using namespace gs;

constexpr int kBatch = 128;           // pair rows staged per round
constexpr int kWarps = kPix / 32;
constexpr int kGrads = 9;             // live gradient columns of a row

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kPix)
composite_bwd_kernel(const float* __restrict__ pair_data,
                     const int* __restrict__ tile_start,
                     const float* __restrict__ ct,
                     const float* __restrict__ fwd,
                     float* __restrict__ grad, int grid_x) {
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int start = tile_start[t];
  const int end = tile_start[t + 1];
  const float px = static_cast<float>((t % grid_x) * kTile + (tid % kTile));
  const float py = static_cast<float>((t / grid_x) * kTile + (tid / kTile));

  __shared__ float4 s_geo[kBatch];  // m2dx, m2dy, a, b
  __shared__ float4 s_col[kBatch];  // c, r, g, b
  __shared__ float s_opac[kBatch];
  __shared__ float s_part[kWarps][kBatch][kGrads];

  const float* c_in = ct + (size_t)t * kOutRows * kPix + tid;
  const float* f_in = fwd + (size_t)t * kOutRows * kPix + tid;
  const float ct_r = c_in[0 * kPix];
  const float ct_g = c_in[1 * kPix];
  const float ct_b = c_in[2 * kPix];
  // dL/dT_end through the alpha image (1 - T_end) and the final_T output
  const float dT_end = c_in[4 * kPix] - c_in[3 * kPix];
  const float acc_r = f_in[0 * kPix];
  const float acc_g = f_in[1 * kPix];
  const float acc_b = f_in[2 * kPix];
  const float final_T = f_in[4 * kPix];

  float T = 1.0f;
  float pre_r = 0.0f, pre_g = 0.0f, pre_b = 0.0f;
  int done = 0;

  for (int base = start; base < end; base += kBatch) {
    // the vote is also the barrier that frees the previous batch's rows
    // and warp sums
    if (__syncthreads_count(done) == kPix) break;
    const int row = base + tid;
    if (tid < kBatch && row < end) {
      const float4* src =
          reinterpret_cast<const float4*>(pair_data + (size_t)row * kCols);
      s_geo[tid] = src[0];
      s_col[tid] = src[1];
      s_opac[tid] = src[2].x;
    }
    __syncthreads();
    const int n = min(kBatch, end - base);
    for (int j = 0; j < n; ++j) {
      float g[kGrads];
#pragma unroll
      for (int k = 0; k < kGrads; ++k) g[k] = 0.0f;
      int included = 0;
      if (!done) {
        const float4 geo = s_geo[j];
        const float4 col = s_col[j];
        const float opac = s_opac[j];
        Splat s;
        if (splat_at(geo, col.x, opac, px, py, s)) {
          const float test_T = transmit(T, s.alpha);
          if (test_T < kTStop) {
            done = 1;
          } else {
            included = 1;
            const float w = s.alpha * T;
            pre_r += w * col.y;
            pre_g += w * col.z;
            pre_b += w * col.w;
            const float one_m = fmaxf(1.0f - s.alpha, 1e-6f);
            const float d_alpha =
                ct_r * (T * col.y - (acc_r - pre_r) / one_m)
                + ct_g * (T * col.z - (acc_g - pre_g) / one_m)
                + ct_b * (T * col.w - (acc_b - pre_b) / one_m)
                + dT_end * (-final_T / one_m);
            g[5] = w * ct_r;
            g[6] = w * ct_g;
            g[7] = w * ct_b;
            if (s.alpha < kMaxAlpha) {
              const float d_power = d_alpha * s.alpha;
              g[0] = d_power * (-(geo.z * s.dx) - geo.w * s.dy);
              g[1] = d_power * (-(col.x * s.dy) - geo.w * s.dx);
              g[2] = d_power * (-0.5f * s.dx * s.dx);
              g[3] = d_power * (-s.dx * s.dy);
              g[4] = d_power * (-0.5f * s.dy * s.dy);
              g[8] = d_alpha * s.alpha / opac;
            }
            T = test_T;
          }
        }
      }
      if (__any_sync(0xffffffffu, included)) {
#pragma unroll
        for (int k = 0; k < kGrads; ++k) g[k] = warp_sum(g[k]);
      }
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < kGrads; ++k) s_part[warp][j][k] = g[k];
      }
    }
    __syncthreads();
    for (int i = tid; i < n * kGrads; i += kPix) {
      const int j = i / kGrads;
      const int k = i - j * kGrads;
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += s_part[w][j][k];
      grad[(size_t)(base + j) * kCols + k] = sum;
    }
  }
}

}  // namespace

// Plain C entry point for ctypes. `grad` must be zero-filled (the kernel
// leaves the rows after a tile's early exit untouched). Launches on `stream`
// and returns cudaGetLastError() (0 = launched).
extern "C" int gs_composite_bwd(const void* pair_data, const void* tile_start,
                                const void* ct, const void* fwd, void* grad,
                                int num_tiles, int grid_x, void* stream) {
  if (num_tiles > 0) {
    composite_bwd_kernel<<<num_tiles, kPix, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(pair_data),
        static_cast<const int*>(tile_start), static_cast<const float*>(ct),
        static_cast<const float*>(fwd), static_cast<float*>(grad), grid_x);
  }
  return static_cast<int>(cudaGetLastError());
}
