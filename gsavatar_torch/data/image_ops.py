"""Undistortion and resizing of 8-bit frames, with OpenCV's arithmetic.

The data loaders of the JAX package undistort and resize each frame with
`cv2.undistort` and `cv2.resize`. The port has no OpenCV; these functions
compute the same integers with PyTorch on the frame's device:

- `build_undistort_map` + `remap_linear` = `cv2.undistort`: OpenCV's
  `initUndistortRectifyMap` in float64 (R = I, the
  new camera matrix = K, inverted by the 3x3 adjugate as `Matx::inv`
  does, and built in the row stripes that `cv::undistort` uses), the map
  rounded to 1/32 pixel, then `remap`'s fixed-point bilinear: 15-bit
  weights from the 32x32 table, `(acc + 2^14) >> 15`, constant-0 borders.
- `resize_linear`: an exact 2x downscale takes OpenCV's area path, the
  mean of each 2x2 block as `(a + b + c + d + 2) >> 2`; any other size
  takes the fixed-point bilinear path (11-bit coefficients, the vertical
  pass as OpenCV's SIMD code rounds it). On float32 it computes what
  `cv2.resize` computes there through Intel IPP, which OpenCV's builds call
  by default for float linear resizes: the source coordinate
  `(d + 0.5) * src / dst - 0.5` in float64, its fraction t as float32,
  replicated edges, and `fma(b - a, t, a)` in float32 along x, then along
  y (exact: float64 products, rounded to odd, then to float32); on three
  channels, IPP's replicated-edge columns that fall in a last run of 5 or
  more (of each side's, taken 16 at a time) round the vertical step of
  channels 0 and 1 unfused.
- `resize_nearest`: `floor(x * src / dst)` in float64.
- `resize_lanczos4`: the 8x8 Lanczos kernel with 11-bit coefficients.

Images are uint8 tensors, (H, W) or (H, W, C); `resize_linear` also
takes float32."""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

INTER_BITS = 5                 # the remap table: 1/32 pixel
INTER_TAB = 1 << INTER_BITS
REMAP_BITS = 15                # remap's fixed-point weights
RESIZE_BITS = 11               # resize's fixed-point coefficients


def _inv3(a: np.ndarray) -> np.ndarray:
    """cv::Matx33d::inv: the adjugate times 1/determinant, in OpenCV's
    order of operations."""
    d = (a[0, 0] * (a[1, 1] * a[2, 2] - a[2, 1] * a[1, 2])
         - a[0, 1] * (a[1, 0] * a[2, 2] - a[2, 0] * a[1, 2])
         + a[0, 2] * (a[1, 0] * a[2, 1] - a[2, 0] * a[1, 1]))
    d = 1.0 / d
    b = np.empty((3, 3))
    b[0, 0] = (a[1, 1] * a[2, 2] - a[1, 2] * a[2, 1]) * d
    b[0, 1] = (a[0, 2] * a[2, 1] - a[0, 1] * a[2, 2]) * d
    b[0, 2] = (a[0, 1] * a[1, 2] - a[0, 2] * a[1, 1]) * d
    b[1, 0] = (a[1, 2] * a[2, 0] - a[1, 0] * a[2, 2]) * d
    b[1, 1] = (a[0, 0] * a[2, 2] - a[0, 2] * a[2, 0]) * d
    b[1, 2] = (a[0, 2] * a[1, 0] - a[0, 0] * a[1, 2]) * d
    b[2, 0] = (a[1, 0] * a[2, 1] - a[1, 1] * a[2, 0]) * d
    b[2, 1] = (a[0, 1] * a[2, 0] - a[0, 0] * a[2, 1]) * d
    b[2, 2] = (a[0, 0] * a[1, 1] - a[0, 1] * a[1, 0]) * d
    return b


def undistort_map(K, D, h: int, w: int, device) -> torch.Tensor:
    """`build_undistort_map`, kept: every frame of a view shares K, D and
    its size, so each view's map is built once (the most recent 32 are
    kept; the map of a 1024^2 frame takes 16 MiB)."""
    return _kept_map(np.asarray(K, np.float64).reshape(3, 3).tobytes(),
                     np.asarray(D, np.float64).ravel().tobytes(),
                     int(h), int(w), str(torch.device(device)))


@functools.lru_cache(maxsize=32)
def _kept_map(K_bytes: bytes, D_bytes: bytes, h: int, w: int,
              device: str) -> torch.Tensor:
    return build_undistort_map(np.frombuffer(K_bytes).reshape(3, 3),
                               np.frombuffer(D_bytes), h, w, device)


def build_undistort_map(K, D, h: int, w: int, device) -> torch.Tensor:
    """(h, w, 2) int64: for each output pixel, its source position in
    1/32 pixels, x then y (`cvRound(u * 32)`)."""
    K = np.asarray(K, np.float64).reshape(3, 3)
    d = np.zeros(14)
    dv = np.asarray(D, np.float64).ravel()
    d[:dv.size] = dv
    k1, k2, p1, p2, k3, k4, k5, k6, s1, s2, s3, s4 = d[:12]
    if d[12] or d[13]:
        raise NotImplementedError("tilted-sensor distortion (tauX, tauY)")
    fx, fy, u0, v0 = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    # cv::undistort builds the map in stripes of rows, each with the new
    # camera matrix's principal point moved up by the stripe's first row
    stripe = min(max(1, (1 << 12) // max(w, 1)), h)
    starts = np.arange(h) // stripe * stripe
    rows = np.arange(h) - starts
    ir = np.empty((h, 9))
    for s in np.unique(starts):
        Ar = K.copy()
        Ar[1, 2] = v0 - s
        ir[starts == s] = _inv3(Ar).ravel()
    f64 = dict(dtype=torch.float64, device=device)
    ir = torch.as_tensor(ir, **f64)
    i = torch.as_tensor(rows, **f64)[:, None]
    j = torch.arange(w, **f64)[None, :]
    _x = i * ir[:, 1:2] + ir[:, 2:3] + j * ir[:, 0:1]
    _y = i * ir[:, 4:5] + ir[:, 5:6] + j * ir[:, 3:4]
    _w = i * ir[:, 7:8] + ir[:, 8:9] + j * ir[:, 6:7]
    ww = 1.0 / _w
    x = _x * ww
    y = _y * ww
    x2, y2 = x * x, y * y
    r2 = x2 + y2
    _2xy = 2 * x * y
    kr = (1 + ((k3 * r2 + k2) * r2 + k1) * r2) \
        / (1 + ((k6 * r2 + k5) * r2 + k4) * r2)
    u = fx * (x * kr + p1 * _2xy + p2 * (r2 + 2 * x2) + s1 * r2
              + s2 * r2 * r2) + u0
    v = fy * (y * kr + p1 * (r2 + 2 * y2) + p2 * _2xy + s3 * r2
              + s4 * r2 * r2) + v0
    return torch.stack([torch.round(u * INTER_TAB),
                        torch.round(v * INTER_TAB)], -1).to(torch.int64)


def remap_linear(img: torch.Tensor, fixed_map: torch.Tensor) -> torch.Tensor:
    """OpenCV's `remap(INTER_LINEAR, BORDER_CONSTANT 0)` of a uint8 image
    on a 1/32-pixel map: source pixels outside the image count as 0."""
    squeeze = img.dim() == 2
    src = img[..., None] if squeeze else img
    H, W = src.shape[:2]
    sx = fixed_map[..., 0] >> INTER_BITS
    sy = fixed_map[..., 1] >> INTER_BITS
    fx = fixed_map[..., 0] & (INTER_TAB - 1)
    fy = fixed_map[..., 1] & (INTER_TAB - 1)
    scale = (1 << REMAP_BITS) // (INTER_TAB * INTER_TAB)
    src32 = src.to(torch.int32)
    acc = torch.zeros(fixed_map.shape[:2] + (src.shape[2],),
                      dtype=torch.int32, device=img.device)
    for dy, wy in ((0, INTER_TAB - fy), (1, fy)):
        for dx, wx in ((0, INTER_TAB - fx), (1, fx)):
            xx, yy = sx + dx, sy + dy
            inside = (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
            px = src32[yy.clamp(0, H - 1), xx.clamp(0, W - 1)]
            wgt = (wy * wx * scale * inside).to(torch.int32)
            acc += px * wgt[..., None]
    out = ((acc + (1 << (REMAP_BITS - 1))) >> REMAP_BITS).clamp(0, 255)
    out = out.to(torch.uint8)
    return out[..., 0] if squeeze else out


def _linear_taps(src: int, dst: int):
    """OpenCV's bilinear source index and 11-bit coefficients per output
    coordinate (resize's `INTER_LINEAR` set-up)."""
    scale = 1.0 / (dst / src)
    fx = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    sx = np.floor(fx).astype(np.int64)
    fx = fx - sx.astype(np.float32)
    low = sx < 0
    fx[low], sx[low] = 0.0, 0
    high = sx >= src - 1
    fx[high], sx[high] = 0.0, src - 1
    one = 1 << RESIZE_BITS
    a1 = np.rint(fx * np.float32(one)).astype(np.int64)
    a0 = np.rint((np.float32(1) - fx) * np.float32(one)).astype(np.int64)
    return sx, np.minimum(sx + 1, src - 1), a0, a1


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
           ) -> torch.Tensor:
    """fma(a, b, c) of float32 tensors, rounded once: the float64 product
    is exact, the float64 sum is rounded to odd (its exact error from
    TwoSum decides), which makes the final rounding to float32 correct."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    away = torch.where(err > 0, float('inf'), float('-inf')).to(s)
    s = torch.where((err != 0) & even, torch.nextafter(s, away), s)
    return s.float()


def _ipp_linear_taps(src: int, dst: int):
    f = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    s = np.floor(f)
    t = (f - s).astype(np.float32)
    s = s.astype(np.int64)
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), t


def _ipp_border_tail(src: int, dst: int) -> np.ndarray:
    """The output columns whose source column is clamped (left of 0 or
    right of src - 1) and that fall in the last run, of 5 or more, when
    each side's clamped columns are taken 16 at a time."""
    f = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    out = []
    for side in (np.nonzero(f < 0)[0], np.nonzero(f >= src - 1)[0]):
        tail = side[16 * (len(side) // 16):]
        if len(tail) >= 5:
            out.extend(tail.tolist())
    return np.asarray(out, np.int64)


def _resize_linear_float(img: torch.Tensor, hw) -> torch.Tensor:
    h, w = hw
    H, W = img.shape[:2]
    if img.dim() == 3 and img.shape[2] == 1:
        img = img[..., 0]                 # cv2 drops a single channel
    dev = img.device
    x0, x1, tx = (torch.as_tensor(a, device=dev)
                  for a in _ipp_linear_taps(W, w))
    y0, y1, ty = (torch.as_tensor(a, device=dev)
                  for a in _ipp_linear_taps(H, h))
    extra = (1,) * (img.dim() - 2)
    a, b = img[:, x0], img[:, x1]
    rows = _fma32(b - a, tx.view((1, w) + extra).expand_as(a), a)
    a, b = rows[y0], rows[y1]
    out = _fma32(b - a, ty.view((h, 1) + extra).expand_as(a), a)
    if img.dim() == 3 and img.shape[2] == 3:
        # IPP's three-channel border: where the source column is clamped
        # (replicated edge), each side's columns go in runs of 16; a last
        # run of 5 or more rounds the vertical step of channels 0 and 1
        # as a product and a sum, not as one fma
        cols = _ipp_border_tail(W, w)
        if len(cols):
            c = torch.as_tensor(cols, device=dev)
            a, b = a[:, c, :2], b[:, c, :2]
            out[:, c, :2] = (b - a) * ty.view(h, 1, 1) + a
    return out


def resize_linear(img: torch.Tensor, hw) -> torch.Tensor:
    """`cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)` of a uint8
    or float32 image; a float32 (H, W, 1) gives (h, w), as cv2 does."""
    if img.dtype == torch.float32:
        return _resize_linear_float(img, hw)
    if img.dtype != torch.uint8:
        raise TypeError(f"resize_linear takes uint8 or float32, not "
                        f"{img.dtype}")
    h, w = hw
    H, W = img.shape[:2]
    if H == 2 * h and W == 2 * w:
        # OpenCV's area path for an exact 2x downscale
        x = img.to(torch.int32)
        s = x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2]
        return ((s + 2) >> 2).to(torch.uint8)
    dev = img.device
    t = lambda a: torch.as_tensor(a, device=dev)
    x0, x1, ax0, ax1 = (t(a) for a in _linear_taps(W, w))
    y0, y1, by0, by1 = (t(a) for a in _linear_taps(H, h))
    x = img.to(torch.int32)
    shape = (1, -1) + (1,) * (img.dim() - 2)
    rows = x[:, x0] * ax0.view(shape).int() + x[:, x1] * ax1.view(shape).int()
    # the vertical pass as OpenCV's VResizeLinearVec_32s8u computes it:
    # each row >> 4, a 16-bit high multiply by its coefficient, then a
    # rounding shift by 2
    col = (-1,) + (1,) * (img.dim() - 1)
    r0 = (rows[y0] >> 4) * by0.view(col).int() >> 16
    r1 = (rows[y1] >> 4) * by1.view(col).int() >> 16
    return ((r0 + r1 + 2) >> 2).clamp(0, 255).to(torch.uint8)


def resize_nearest(img: torch.Tensor, hw) -> torch.Tensor:
    """`cv2.resize(img, (w, h), interpolation=cv2.INTER_NEAREST)`."""
    h, w = hw
    H, W = img.shape[:2]
    sx = np.minimum(np.floor(np.arange(w) * (1.0 / (w / W))), W - 1)
    sy = np.minimum(np.floor(np.arange(h) * (1.0 / (h / H))), H - 1)
    sx = torch.as_tensor(sx.astype(np.int64), device=img.device)
    sy = torch.as_tensor(sy.astype(np.int64), device=img.device)
    return img[sy][:, sx]


def _lanczos4_coeffs(x: float) -> np.ndarray:
    """OpenCV's interpolateLanczos4 (float32 results, float sum)."""
    s45 = 0.70710678118654752440084436210485
    cs = [(1, 0), (-s45, -s45), (0, 1), (s45, -s45), (-1, 0), (s45, s45),
          (0, -1), (-s45, s45)]
    x3 = np.float32(np.float32(x) + np.float32(3))
    y0 = -float(x3) * math.pi * 0.25
    s0, c0 = math.sin(y0), math.cos(y0)
    coeffs = np.zeros(8, np.float32)
    total = np.float32(0)
    for i in range(8):
        yi = np.float32(x3 - np.float32(i))
        if abs(float(yi)) >= np.finfo(np.float32).eps:
            y = -float(yi) * math.pi * 0.25
            coeffs[i] = np.float32((cs[i][0] * s0 + cs[i][1] * c0) / (y * y))
        else:
            coeffs[i] = np.float32(1e30)
        total = np.float32(total + coeffs[i])
    return (coeffs * np.float32(1.0 / total)).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _lanczos4_taps(src: int, dst: int):
    scale = 1.0 / (dst / src)
    idx = np.zeros((dst, 8), np.int64)
    coef = np.zeros((dst, 8), np.int64)
    for d in range(dst):
        f = np.float32((d + 0.5) * scale - 0.5)
        s = int(math.floor(f))
        f = np.float32(f - np.float32(s))
        c = _lanczos4_coeffs(f)
        coef[d] = np.rint(c.astype(np.float64) * (1 << RESIZE_BITS))
        idx[d] = np.clip(np.arange(s - 3, s + 5), 0, src - 1)
    return idx, coef


def resize_lanczos4(img: torch.Tensor, hw) -> torch.Tensor:
    """`cv2.resize(img, (w, h), interpolation=cv2.INTER_LANCZOS4)`: an
    8-tap pass along x, then along y, in OpenCV's fixed point."""
    h, w = hw
    H, W = img.shape[:2]
    dev = img.device
    xi, xc = (torch.as_tensor(a, device=dev) for a in _lanczos4_taps(W, w))
    yi, yc = (torch.as_tensor(a, device=dev) for a in _lanczos4_taps(H, h))
    x = img.to(torch.int64)
    extra = (1,) * (img.dim() - 2)
    rows = (x[:, xi] * xc.view((1, w, 8) + extra)).sum(2)
    acc = (rows[yi] * yc.view((h, 8, 1) + extra)).sum(1)
    shift = 2 * RESIZE_BITS
    out = (acc + (1 << (shift - 1))) >> shift
    return out.clamp(0, 255).to(torch.uint8)
