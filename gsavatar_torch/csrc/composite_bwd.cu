// K2: the fused per-tile compositor, backward, for Hopper (sm_90a).
//
// Replaces gsavatar/ops/rasterizer/pallas_composite.py:_bwd_kernel (the
// Pallas TPU kernel behind composite_pairs_bwd, the VJP of
// make_composite_pairs). Same function: for every pair row of a tile's range
// [tile_start[t], tile_start[t+1]), t a tile of the call's range (global
// tile tile_base + t, as in K1), the gradients of
// (m2dx, m2dy, a, b, c, r, g, b, opac), each summed over the tile's 256
// pixels, written to grad (P, 12) f32 in pair_data's column layout (columns
// 9-11 zero; every row outside [tile_start[0], tile_start[num_tiles]) zero).
// Inputs besides the pair arrays: ct, the cotangent of the
// forward output (num_tiles, 8, 256) (rows 0-2 colour, 3 alpha, 4 final_T),
// and fwd, the forward output itself. Per pixel and included pair k, with
// T_k the transmittance before it, w_k = alpha_k T_k, ct.c the cotangent's
// colour rows dotted with the pair's colour and
//   Q_k = sum_{j<=k} w_j (ct.c_j)                (one scalar per pixel)
//   K   = ct.acc_out + dT_end final_T,  dT_end = ct_finalT - ct_alpha,
// the gradients are
//   dL/dc_k     = w_k ct_rgb
//   dL/dalpha_k = T_k (ct.c_k) - (K - Q_k) / max(1 - alpha_k, 1e-6)
// (the three colour prefixes of the suffix term enter only through Q_k), and
// through alpha = min(0.99, opac e^power) (no gradient where the 0.99 clamp
// holds) to opac, power and from power to (m2d, a, b, c); the conic-b
// gradient is sum d_power (-dx dy). Excluded and skipped pairs get zero.
//
// What bounds it on this card: the f32 work per (pair, pixel) walked
// before the pixel stops (about 80 operations per included pair, counted by
// chip_smoke.py: 0.0085 ms on a bench-shape training step's input at
// 67 TFLOP/s); the bytes take less (0.0057 ms). The work per tile is
// uneven: the fullest tile of that input holds about 3,500 pairs against a
// mean of about 100, and a pixel's T and Q are chains through all of them.
// The one-CTA-per-tile design this replaces walked each whole tile with
// every per-pair step (alpha, T, four divisions, nine five-level shuffle
// sums) on that walk: 1.2169 ms (NVIDIA H100 80GB HBM3, 700 W).
//
// Design: the work unit is (tile, 32-pixel group), one CTA, eight per tile
// (as K1), so a heavy tile's walk runs on eight SMs. Within a CTA three
// stages run one step apart on rotating shared-memory buffers, a step being
// kBatch pair rows:
// - evaluate (kLanesOf warps, step s): each warp stages 32 pair rows
//   (prefetched into registers a step ahead) and evaluates them at the
//   group's 32 pixels with splat_at, writing alpha (0 where the pair is
//   skipped) to shared memory;
// - chain (one warp, lane = pixel, step s - 1): walks those alphas in depth
//   order eight at a time with transmit's product and K1's stop rule, and
//   records per (pair, pixel) T_k (0 where the pixel does not include the
//   pair) and Q_k. T and Q are the only sequential state;
// - gradient (kLanesOf warps, lane = pair, step s - 2): each lane walks the
//   group's 32 pixels in order, reading alpha, T_k and Q_k (rows padded to
//   33 words, so the 32 lanes hit 32 banks) and the pixel's cotangent from
//   shared memory, and sums its pair's terms in registers: no shuffles.
//   The power gradient is kept as sums of d_power times 1, dx, dy, dx^2,
//   dx dy, dy^2, and multiplied by the conic at the end.
// One __syncthreads per step hands the buffers on and is the vote that ends
// the walk once every pixel of the group has stopped. Power, alpha and T go
// through composite_common.cuh, as in K1, so K2 includes exactly K1's pairs.
//
// The eight units' sums of a pair row are combined without atomics: each
// unit writes its partial row (zeros past its stop) to a scratch plane of
// its own, partial[group][row][9], and a second kernel, launched as a
// programmatic dependent launch, adds the eight planes in group order and
// writes every row of grad. Every add happens in an order fixed by the
// input, so two launches give the same bits.

#include <cuda_runtime.h>

#include "composite_common.cuh"

namespace {

using namespace gs;

constexpr int kGroup = 32;                    // pixels of a unit, chain lanes
constexpr int kGroups = kPix / kGroup;        // units per tile
constexpr int kLanesOf = 3;                   // evaluating and gradient warps
constexpr int kBatch = kGroup * kLanesOf;     // pair rows of a step
constexpr int kWarps = 1 + 2 * kLanesOf;      // chain, evaluate, gradient
constexpr int kThreads = kGroup * kWarps;
constexpr int kChainWarp = 0;
constexpr int kGradWarp0 = 1 + kLanesOf;
constexpr int kAhead = 8;                     // alphas the chain takes at once
constexpr int kPad = kGroup + 1;              // words per (pair, 32 pixels)
constexpr int kGrads = 9;                     // live gradient columns
constexpr int kCombineThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
// shared memory: three buffers of pair rows (geo, col: float4; opac) and of
// alphas (kBatch x kPad), two of (T_k, Q_k) (kBatch x kPad float2), and the
// group's per-pixel (ct_r, ct_g, ct_b, K)
constexpr int kSmem = 3 * kBatch * (2 * 16 + 4 + 4 * kPad)
                      + 2 * kBatch * 8 * kPad + kGroup * 16;

__global__ void __launch_bounds__(kThreads, 2)
composite_bwd_kernel(const float* __restrict__ pair_data,
                     const int* __restrict__ tile_start,
                     const float* __restrict__ ct,
                     const float* __restrict__ fwd,
                     float* __restrict__ partial, int num_pairs, int grid_x,
                     int tile_base, long long* __restrict__ clocks) {
  extern __shared__ float4 smem[];
  float4* s_geo = smem;                                    // [3][kBatch]
  float4* s_col = s_geo + 3 * kBatch;                      // [3][kBatch]
  float4* s_pix = s_col + 3 * kBatch;                      // [kGroup]
  // [2][kBatch][kPad]
  float2* s_tq = reinterpret_cast<float2*>(s_pix + kGroup);
  float* s_alpha = reinterpret_cast<float*>(s_tq + 2 * kBatch * kPad);
  float* s_opac = s_alpha + 3 * kBatch * kPad;             // [3][kBatch]

  const long long t_begin = clocks ? clock64() : 0;
  long long busy = 0;
  const int t = blockIdx.x / kGroups;
  const int group = blockIdx.x % kGroups;
  const int warp = threadIdx.x / kGroup;
  const int lane = threadIdx.x % kGroup;
  const int start = tile_start[t];
  const int end = tile_start[t + 1];
  if (end <= start) return;
  // the group's pixel rows: pixel p at (x0 + p % 16, y0 + p / 16) of the
  // global tile tile_base + t
  const int tg = tile_base + t;
  const int x0 = (tg % grid_x) * kTile;
  const int y0 = (tg / grid_x) * kTile + group * (kGroup / kTile);
  float* out = partial + ((size_t)group * num_pairs) * kGrads;

  // evaluating warps: their 32 slots of a batch, the lane's prefetched row
  const int first = (warp - 1) * kGroup;
  const int slot = first + lane;
  const bool evaluates = warp >= 1 && warp < kGradWarp0;
  float4 geo = make_float4(0.0f, 0.0f, 0.0f, 0.0f), col = geo;
  float opac = 0.0f;
  if (evaluates && start + slot < end) {
    const float4* src = reinterpret_cast<const float4*>(
        pair_data + (size_t)(start + slot) * kCols);
    geo = src[0];
    col = src[1];
    opac = src[2].x;
  }

  // the chain's pixel: its cotangent and the constant part of dL/dalpha
  float T = 1.0f, Q = 0.0f;
  int done = 0;
  float ct_r = 0.0f, ct_g = 0.0f, ct_b = 0.0f;
  if (warp == kChainWarp) {
    const size_t o = (size_t)t * kOutRows * kPix + group * kGroup + lane;
    ct_r = ct[o + 0 * kPix];
    ct_g = ct[o + 1 * kPix];
    ct_b = ct[o + 2 * kPix];
    const float dT_end = ct[o + 4 * kPix] - ct[o + 3 * kPix];
    const float K = ct_r * fwd[o + 0 * kPix] + ct_g * fwd[o + 1 * kPix]
                    + ct_b * fwd[o + 2 * kPix] + dT_end * fwd[o + 4 * kPix];
    s_pix[lane] = make_float4(ct_r, ct_g, ct_b, K);
  }

  const int n_steps = (end - start + kBatch - 1) / kBatch;
  int n_live = n_steps;   // batches the chain walks: fewer once all stop
  for (int s = 0; s < n_live + 2; ++s) {
    const long long t0 = clocks ? clock64() : 0;
    if (evaluates) {
      if (s < n_live) {
        const int buf = (s % 3) * kBatch;
        const int base = start + s * kBatch;
        const int n = min(kBatch, end - base);
        if (slot < n) {
          s_geo[buf + slot] = geo;
          s_col[buf + slot] = col;
          s_opac[buf + slot] = opac;
        }
        const int row = base + kBatch + slot;
        if (row < end) {
          const float4* src = reinterpret_cast<const float4*>(
              pair_data + (size_t)row * kCols);
          geo = src[0];
          col = src[1];
          opac = src[2].x;
        }
        __syncwarp();
        const float px = static_cast<float>(x0 + lane % kTile);
        const float py = static_cast<float>(y0 + lane / kTile);
        const int last = min(first + kGroup, n);
#pragma unroll 4
        for (int j = first; j < last; ++j) {
          Splat sp;
          const bool hit = splat_at(s_geo[buf + j], s_col[buf + j].x,
                                    s_opac[buf + j], px, py, sp);
          s_alpha[(buf + j) * kPad + lane] = hit ? sp.alpha : 0.0f;
        }
      }
    } else if (warp == kChainWarp) {
      if (s >= 1 && s - 1 < n_live) {
        const int b = s - 1;
        const int buf = (b % 3) * kBatch;
        const int tq = (b & 1) * kBatch;
        const int n = min(kBatch, end - (start + b * kBatch));
        for (int j = 0; j < n; j += kAhead) {
          float a[kAhead];
          float4 c[kAhead];
#pragma unroll
          for (int u = 0; u < kAhead; ++u) {
            a[u] = j + u < n ? s_alpha[(buf + j + u) * kPad + lane] : 0.0f;
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
            // T only falls: the first product under 1e-4 excludes its pair
            // and stops the pixel, and every later product is under too
            const bool keep = !(tt[u + 1] < kTStop);
            const bool incl = !done && keep && a[u] > 0.0f;
            const float ctc = ct_r * c[u].y + ct_g * c[u].z + ct_b * c[u].w;
            Q = fmaf(incl ? a[u] * tt[u] : 0.0f, ctc, Q);
            s_tq[(tq + j + u) * kPad + lane] =
                make_float2(incl ? tt[u] : 0.0f, Q);
            T_next = keep ? tt[u + 1] : T_next;
          }
          T = done ? T : T_next;
          done = done || tt[kAhead] < kTStop;
        }
      }
    } else if (s >= 2 && s - 2 < n_live) {
      // gradient: lane = pair slot of batch s - 2
      const int b = s - 2;
      const int buf = (b % 3) * kBatch;
      const int tq = (b & 1) * kBatch;
      const int gslot = (warp - kGradWarp0) * kGroup + lane;
      const int row = start + b * kBatch + gslot;
      const float4 g_geo = s_geo[buf + gslot];
      const float4 g_col = s_col[buf + gslot];
      const float* al = s_alpha + (buf + gslot) * kPad;
      const float2* rec = s_tq + (tq + gslot) * kPad;
      // sums over the pixels of d_power times 1, dx, dy, dx^2, dx dy, dy^2,
      // and of w ct_rgb
      float sp = 0.0f, sx = 0.0f, sy = 0.0f, sxx = 0.0f, sxy = 0.0f;
      float syy = 0.0f, sr = 0.0f, sg = 0.0f, sb = 0.0f;
#pragma unroll 4
      for (int p = 0; p < kGroup; ++p) {
        const float2 v = rec[p];      // (T_k or 0, Q_k)
        const bool in = row < end && v.x > 0.0f;
        if (!__any_sync(kFull, in)) continue;
        const float a = al[p];
        const float4 pc = s_pix[p];   // (ct_r, ct_g, ct_b, K)
        const float w = in ? a * v.x : 0.0f;
        sr = fmaf(w, pc.x, sr);
        sg = fmaf(w, pc.y, sg);
        sb = fmaf(w, pc.z, sb);
        const float ctc = pc.x * g_col.y + pc.y * g_col.z + pc.z * g_col.w;
        const float one_m = fmaxf(1.0f - a, 1e-6f);
        // an approximate quotient (2 ulp): well inside the tolerance
        const float d_alpha = v.x * ctc - __fdividef(pc.w - v.y, one_m);
        const float dp = in && a < kMaxAlpha ? d_alpha * a : 0.0f;
        const float dx = g_geo.x - static_cast<float>(x0 + p % kTile);
        const float dy = g_geo.y - static_cast<float>(y0 + p / kTile);
        const float px_ = dp * dx, py_ = dp * dy;
        sp += dp;
        sx += px_;
        sy += py_;
        sxx = fmaf(px_, dx, sxx);
        sxy = fmaf(px_, dy, sxy);
        syy = fmaf(py_, dy, syy);
      }
      if (row < end) {
        const float g_opac = s_opac[buf + gslot];
        float* o = out + (size_t)row * kGrads;
        o[0] = -(g_geo.z * sx) - g_geo.w * sy;
        o[1] = -(g_col.x * sy) - g_geo.w * sx;
        o[2] = -0.5f * sxx;
        o[3] = -sxy;
        o[4] = -0.5f * syy;
        o[5] = sr;
        o[6] = sg;
        o[7] = sb;
        o[8] = sp != 0.0f ? sp / g_opac : 0.0f;
      }
    }
    if (clocks) busy += clock64() - t0;
    // hands the buffers on; ends the walk once every pixel has stopped (the
    // chain walked batch s - 1 last: two more steps' gradients, then out)
    if (__syncthreads_count(warp == kChainWarp && done) == kGroup &&
        n_live > s)
      n_live = s;
  }

  // the rows after the last walked batch: no pixel of the group includes them
  const int r0 = start + n_live * kBatch;
  for (int i = threadIdx.x; i < (end - r0) * kGrads; i += kThreads)
    out[(size_t)r0 * kGrads + i] = 0.0f;
  if (clocks && lane == 0) {
    long long* c = clocks + ((size_t)blockIdx.x * kWarps + warp) * 2;
    c[0] = busy;
    c[1] = clock64() - t_begin;
  }
}

// grad[r] = the eight groups' partial rows added in group order for the
// rows of the call's tiles, [tile_start[0], tile_start[num_tiles]); zero
// elsewhere and in columns 9-11. `partial` is read only inside that span,
// where the first kernel wrote every row
__global__ void __launch_bounds__(kCombineThreads)
composite_bwd_combine(const float* __restrict__ partial,
                      const int* __restrict__ tile_start, int num_tiles,
                      int num_pairs, float* __restrict__ grad) {
  // launched while composite_bwd_kernel still runs (programmatic dependent
  // launch); wait here until its partial rows are written
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const long long i = (long long)blockIdx.x * kCombineThreads + threadIdx.x;
  if (i >= (long long)num_pairs * kCols) return;
  const int r = static_cast<int>(i / kCols);
  const int c = static_cast<int>(i % kCols);
  float v = 0.0f;
  if (c < kGrads && r >= tile_start[0] && r < tile_start[num_tiles]) {
    const float* p = partial + (size_t)r * kGrads + c;
    const size_t plane = (size_t)num_pairs * kGrads;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) v += p[g * plane];
  }
  grad[i] = v;
}

}  // namespace

// Plain C entry point for ctypes: the num_tiles tiles from global tile
// tile_base, tile_start their num_tiles + 1 pair offsets. `partial` is
// scratch of 8 * num_pairs * 9 f32 (the span's rows written before they are
// read); every row of `grad` (num_pairs, 12) is written, zero outside the
// span. `clocks`, when not null, receives per (tile, group) unit and
// warp the cycles the warp spent in its stage and the cycles the unit ran
// ((num_tiles * 8, 7, 2) int64). Launches both kernels on `stream`, each
// checked with cudaGetLastError (0 = launched).
extern "C" int gs_composite_bwd(const void* pair_data, const void* tile_start,
                                const void* ct, const void* fwd,
                                void* partial, void* grad, int num_pairs,
                                int num_tiles, int grid_x, int tile_base,
                                void* clocks, void* stream) {
  // above the 48 KB a block gets by default: set once per process
  static const cudaError_t attr = cudaFuncSetAttribute(
      composite_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_tiles > 0 && num_pairs > 0) {
    composite_bwd_kernel<<<num_tiles * kGroups, kThreads, kSmem, st>>>(
        static_cast<const float*>(pair_data),
        static_cast<const int*>(tile_start), static_cast<const float*>(ct),
        static_cast<const float*>(fwd), static_cast<float*>(partial),
        num_pairs, grid_x, tile_base, static_cast<long long*>(clocks));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (num_pairs == 0) return static_cast<int>(cudaGetLastError());
  const long long n = (long long)num_pairs * kCols;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(
      (n + kCombineThreads - 1) / kCombineThreads));
  cfg.blockDim = dim3(kCombineThreads);
  cfg.stream = st;
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &pdl;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, composite_bwd_combine, static_cast<const float*>(partial),
      static_cast<const int*>(tile_start), num_tiles, num_pairs,
      static_cast<float*>(grad));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
