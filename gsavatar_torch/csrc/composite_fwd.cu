// K1: the fused per-tile compositor, forward, for Hopper (sm_90a).
//
// Replaces gsavatar/ops/rasterizer/pallas_composite.py:_fwd_kernel (the
// Pallas TPU kernel behind composite_pairs_fwd). Same function: for each
// 16x16 tile t of the call's range, the global tile tile_base + t (the
// range is one rank's slice of the tile grid when the compositor is split
// over the mesh's model axis; 0 and the whole grid otherwise), walk its
// depth-sorted pairs [tile_start[t], tile_start[t+1])
// of pair_data (P, 12) f32 rows [m2dx, m2dy, a, b, c, r, g, b, opac, 0, 0, 0]
// and, for every pixel of the tile,
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy,  alpha = min(0.99, opac e^power)
// skipping the pair when power > 0 or alpha < 1/255; front to back
// T *= (1 - alpha), where the pair that would take T below 1e-4 is excluded
// and the pixel stops. Output (num_tiles, 8, 256) f32 in the JAX kernel's
// layout: rows 0-2 the colour without background, row 3 1 - final_T,
// row 4 final_T, rows 5-7 zero.
//
// What bounds it on this card: the bytes are small (each pair row is read
// once per tile, 48 B, plus 8 KB of output per tile), so the bound is the
// f32 work, about 25 operations per (pair, pixel) walked before the pixel
// stops, over the 67 TFLOP/s of the non-tensor f32 units. What bounds it in
// practice is the longest sequential walk: the tiles at the body's centre
// hold nearly a hundred times the mean number of pairs, and a pixel's T is
// a chain through every one of them.
//
// Design: the work unit is (tile, 32-pixel group), two rows of the tile,
// one CTA of eight warps each, eight CTAs per tile, so that a heavy tile's
// groups run on eight SMs at once. Within a CTA the pixel's chain is taken
// apart from the evaluation that does not depend on T:
// - seven evaluating warps stage 224 pair rows a step (each warp its own 32
//   rows, one row per lane, prefetched into registers a step ahead) and
//   evaluate them at the group's 32 pixels with splat_at, writing alpha
//   (0 where the pair is skipped; an evaluated alpha is at least 1/255) to
//   shared memory. splat_at branches on power > 0, so one warp evaluates
//   its pairs one after another; seven warps keep the chain fed;
// - the chain warp, lane i on pixel i of the group, walks the previous
//   step's alphas in depth order, eight at a time: the transmittance after
//   each of the eight is transmit's product of the one before (a skipped
//   pair's alpha of 0 multiplies by exactly 1), with no test on that path.
//   T only falls, so the pixel stops at the first of the eight products
//   below 1e-4: that pair and every later one are excluded, and T is the
//   last product at or above 1e-4. The colour adds alpha T_before of each
//   included pair.
// The two halves run one step apart on double buffers; one __syncthreads
// per step hands a batch over, and is also the vote that stops the CTA
// once every pixel of the group has stopped. Products computed past a
// pixel's stop are discarded. Power, alpha and T are rounded by
// composite_common.cuh, which K2 shares, and every pixel applies transmit
// to its included pairs in depth order, so the included pairs and T are
// those of the plain version and K2, bit for bit. The chain lanes write
// their pixels' 8 output values: 128-byte stores per row and group.

#include <cuda_runtime.h>

#include "composite_common.cuh"

namespace {

using namespace gs;

constexpr int kGroup = 32;                   // pixels of a unit, chain lanes
constexpr int kGroups = kPix / kGroup;       // units per tile
constexpr int kEvalWarps = 7;
constexpr int kThreads = kGroup * (1 + kEvalWarps);
constexpr int kBatch = kGroup * kEvalWarps;  // pairs handed over per step
constexpr int kAhead = 8;                    // alphas the chain takes at once
// shared memory, two buffers of: pair rows (m2dx, m2dy, a, b | c, r, g, b),
// opacities and the (kBatch, 32) alphas
constexpr int kSmem = 2 * kBatch * (2 * 16 + 4 + 4 * kGroup);

__global__ void __launch_bounds__(kThreads)
composite_fwd_kernel(const float* __restrict__ pair_data,
                     const int* __restrict__ tile_start,
                     float* __restrict__ out, int grid_x, int tile_base) {
  extern __shared__ float4 smem[];
  float4* s_geo = smem;                                  // [2][kBatch]
  float4* s_col = smem + 2 * kBatch;                     // [2][kBatch]
  float* s_opac = reinterpret_cast<float*>(smem + 4 * kBatch);
  float* s_alpha = s_opac + 2 * kBatch;                  // [2][kBatch][32]

  const int t = blockIdx.x / kGroups;
  const int group = blockIdx.x % kGroups;
  const int warp = threadIdx.x / kGroup;
  const int lane = threadIdx.x % kGroup;
  const int start = tile_start[t];
  const int end = tile_start[t + 1];
  const int pix = group * kGroup + lane;
  const int tg = tile_base + t;     // the global tile: its pixels
  const float px = static_cast<float>((tg % grid_x) * kTile + pix % kTile);
  const float py = static_cast<float>((tg / grid_x) * kTile + pix / kTile);

  const int n_steps = (end - start + kBatch - 1) / kBatch;
  // an evaluating warp's slots in a batch, and its lane's prefetched row
  const int first = (warp - 1) * kGroup;
  const int slot = first + lane;
  float4 geo = make_float4(0.0f, 0.0f, 0.0f, 0.0f), col = geo;
  float opac = 0.0f;
  if (warp > 0 && start + slot < end) {
    const float4* src = reinterpret_cast<const float4*>(
        pair_data + (size_t)(start + slot) * kCols);
    geo = src[0];
    col = src[1];
    opac = src[2].x;
  }

  float T = 1.0f;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  int done = 0;

  for (int step = 0; step <= n_steps; ++step) {
    if (warp > 0) {
      if (step < n_steps) {
        const int buf = (step & 1) * kBatch;
        const int base = start + step * kBatch;
        const int n = min(kBatch, end - base);
        if (slot < n) {
          s_geo[buf + slot] = geo;
          s_col[buf + slot] = col;
          s_opac[buf + slot] = opac;
        }
        const int row = base + kBatch + slot;
        if (row < end) {
          const float4* src =
              reinterpret_cast<const float4*>(pair_data + (size_t)row * kCols);
          geo = src[0];
          col = src[1];
          opac = src[2].x;
        }
        __syncwarp();
        const int last = min(first + kGroup, n);
#pragma unroll 4
        for (int j = first; j < last; ++j) {
          Splat s;
          const bool hit = splat_at(s_geo[buf + j], s_col[buf + j].x,
                                    s_opac[buf + j], px, py, s);
          s_alpha[(buf + j) * kGroup + lane] = hit ? s.alpha : 0.0f;
        }
      }
    } else if (step > 0) {
      const int buf = ((step - 1) & 1) * kBatch;
      const int n = min(kBatch, end - (start + (step - 1) * kBatch));
      for (int j = 0; j < n; j += kAhead) {
        if (__all_sync(0xffffffffu, done)) break;
        float a[kAhead];
        float4 c[kAhead];
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          a[u] = j + u < n ? s_alpha[(buf + j + u) * kGroup + lane] : 0.0f;
          c[u] = s_col[buf + j + u];
        }
        // tt[u]: T before pair j + u, had every pair so far been included
        float tt[kAhead + 1];
        tt[0] = T;
#pragma unroll
        for (int u = 0; u < kAhead; ++u) tt[u + 1] = transmit(tt[u], a[u]);
        float T_next = T;
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          const bool keep = !(tt[u + 1] < kTStop);
          if (!done && keep && a[u] > 0.0f) {
            const float w = a[u] * tt[u];
            acc_r += c[u].y * w;
            acc_g += c[u].z * w;
            acc_b += c[u].w * w;
          }
          T_next = keep ? tt[u + 1] : T_next;
        }
        T = done ? T : T_next;
        done = done || tt[kAhead] < kTStop;
      }
    }
    // hands the batch over and frees the other buffer; stops the CTA once
    // every pixel of the group has stopped
    if (__syncthreads_count(warp == 0 && done) == kGroup) break;
  }

  if (warp == 0) {
    float* o = out + (size_t)t * kOutRows * kPix + pix;
    o[0 * kPix] = acc_r;
    o[1 * kPix] = acc_g;
    o[2 * kPix] = acc_b;
    o[3 * kPix] = 1.0f - T;
    o[4 * kPix] = T;
    o[5 * kPix] = 0.0f;
    o[6 * kPix] = 0.0f;
    o[7 * kPix] = 0.0f;
  }
}

}  // namespace

// Plain C entry point for ctypes: the num_tiles tiles from global tile
// tile_base, tile_start their num_tiles + 1 pair offsets. Launches on
// `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int gs_composite_fwd(const void* pair_data, const void* tile_start,
                                void* out, int num_tiles, int grid_x,
                                int tile_base, void* stream) {
  // above the 48 KB a block gets by default: set once per process
  static const cudaError_t attr = cudaFuncSetAttribute(
      composite_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (num_tiles > 0) {
    composite_fwd_kernel<<<num_tiles * kGroups, kThreads, kSmem,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(pair_data),
        static_cast<const int*>(tile_start), static_cast<float*>(out),
        grid_x, tile_base);
  }
  return static_cast<int>(cudaGetLastError());
}
