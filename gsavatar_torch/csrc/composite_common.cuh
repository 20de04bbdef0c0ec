// What the compositor's forward (K1, composite_fwd.cu) and backward (K2,
// composite_bwd.cu) share: the tile and pair-row layout, and the rounding of
// power, alpha and transmittance. Both kernels must decide alike which pairs
// a pixel includes and where it stops (the pair that would take T below
// 1e-4 is excluded and ends the pixel), so both go through these functions:
// a one-ulp difference in T can move a whole splat across the cut-off.
#pragma once

#include <cuda_runtime.h>

namespace gs {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;   // pixels of a tile, threads of a CTA
constexpr int kCols = 12;             // floats per pair row
constexpr int kOutRows = 8;           // rows of a tile's compositor output
constexpr float kMaxAlpha = 0.99f;
constexpr float kMinAlpha = 1.0f / 255.0f;
constexpr float kTStop = 1e-4f;

// One pair at one pixel: the offset from the pixel centre, the Gaussian's
// exponent and its alpha.
struct Splat {
  float dx, dy, power, alpha;
};

// Evaluates pair row [m2dx, m2dy, a, b | c, ...] at pixel (px, py):
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy,  alpha = min(0.99, opac e^power).
// Every product and sum is rounded on its own (__fmul_rn and friends are
// never fused into an FMA), in the order of the plain PyTorch version's
// tensor expression, so that the kernels and the plain version agree bit
// for bit. Returns false when the pair is skipped at this pixel (power > 0
// or alpha < 1/255).
__device__ __forceinline__ bool splat_at(float4 geo, float con_c, float opac,
                                         float px, float py, Splat& s) {
  s.dx = geo.x - px;
  s.dy = geo.y - py;
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(geo.z, s.dx), s.dx),
                               __fmul_rn(__fmul_rn(con_c, s.dy), s.dy));
  s.power = __fsub_rn(__fmul_rn(-0.5f, quad),
                      __fmul_rn(__fmul_rn(geo.w, s.dx), s.dy));
  if (s.power > 0.0f) return false;
  s.alpha = fminf(kMaxAlpha, __fmul_rn(opac, expf(s.power)));
  return !(s.alpha < kMinAlpha);
}

// The transmittance after an included pair. Below kTStop the pair is
// excluded instead and the pixel stops.
__device__ __forceinline__ float transmit(float T, float alpha) {
  return __fmul_rn(T, __fsub_rn(1.0f, alpha));
}

}  // namespace gs
