"""K1, the fused per-tile compositor forward: CUDA kernel and plain version.

Counterpart of `gsavatar/ops/rasterizer/pallas_composite.py:
composite_pairs_fwd`. Both functions here take the pair arrays of
`pairs.build_pairs` and return the (num_tiles, 8, 256) tile outputs of the
JAX kernel: rows 0-2 colour without background, row 3 alpha = 1 - final_T,
row 4 final_T, rows 5-7 zero.

`composite_pairs_fwd` launches the hand-written Hopper kernel
(`gsavatar_torch/csrc/composite_fwd.cu`) for CUDA tensors and counts its
launches in `composite_pairs_fwd.launches`. Only for CPU tensors does it
take the plain version, `composite_pairs_fwd_plain`, which the CPU tests
and the on-card comparison use."""
from __future__ import annotations

import ctypes

import torch

from .pairs import PAIR_COLS
from .project import TILE

P_PIX = TILE * TILE
OUT_ROWS = 8
MIN_ALPHA = 1.0 / 255.0
MAX_ALPHA = 0.99
T_STOP = 1e-4


def pixel_coords(num_tiles: int, grid_x: int, device):
    """Pixel-centre coordinates (num_tiles, 256) of every tile."""
    t = torch.arange(num_tiles, device=device)[:, None]
    pix = torch.arange(P_PIX, device=device)[None, :]
    px = (t % grid_x) * TILE + pix % TILE
    py = torch.div(t, grid_x, rounding_mode='floor') * TILE \
        + torch.div(pix, TILE, rounding_mode='floor')
    return px.float(), py.float()


def composite_pairs_fwd_plain(pair_data, tile_start, grid_x: int):
    """Plain PyTorch K1: a loop over tiles, each a (pairs, 256) alpha matrix
    composited with a cumulative product. Same signature and output as the
    kernel; T after each pair is a running product, so a pair is included
    while that product stays >= 1e-4, as in the kernel's sequential walk."""
    num_tiles = tile_start.shape[0] - 1
    out = torch.zeros((num_tiles, OUT_ROWS, P_PIX), dtype=torch.float32,
                      device=pair_data.device)
    out[:, 4] = 1.0
    px, py = pixel_coords(num_tiles, grid_x, pair_data.device)
    bounds = tile_start.tolist()
    for t in range(num_tiles):
        s, e = bounds[t], bounds[t + 1]
        if e <= s:
            continue
        d = pair_data[s:e]
        dx = d[:, 0:1] - px[t][None]
        dy = d[:, 1:2] - py[t][None]
        power = -0.5 * (d[:, 2:3] * dx * dx + d[:, 4:5] * dy * dy) \
            - d[:, 3:4] * dx * dy
        alpha = torch.clamp_max(d[:, 8:9] * torch.exp(power), MAX_ALPHA)
        skip = (power > 0.0) | (alpha < MIN_ALPHA)
        alpha = torch.where(skip, 0.0, alpha)
        T_after = torch.cumprod(1.0 - alpha, dim=0)          # (n, 256)
        T_before = torch.cat([torch.ones_like(T_after[:1]), T_after[:-1]])
        include = (T_after >= T_STOP) & ~skip
        w = torch.where(include, alpha * T_before, 0.0)
        out[t, 0:3] = d[:, 5:8].T @ w
        final_T = torch.where(include, T_after, 1.0).amin(dim=0)
        out[t, 3] = 1.0 - final_T
        out[t, 4] = final_T
    return out


def composite_pairs_fwd(pair_data, tile_start, grid_x: int):
    """pair_data (P, 12) f32, tile_start (num_tiles + 1,) int32 ->
    (num_tiles, 8, 256) f32. CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    if pair_data.device.type == 'cpu':
        return composite_pairs_fwd_plain(pair_data, tile_start, grid_x)
    if pair_data.device.type != 'cuda':
        raise ValueError(f"K1 runs on CUDA or CPU tensors, not "
                         f"{pair_data.device}")
    if tile_start.device != pair_data.device:
        raise ValueError("pair_data and tile_start are on different devices")
    if pair_data.dtype != torch.float32 or pair_data.ndim != 2 \
            or pair_data.shape[1] != PAIR_COLS:
        raise ValueError(f"pair_data must be f32 (P, {PAIR_COLS}), got "
                         f"{pair_data.dtype} {tuple(pair_data.shape)}")
    if tile_start.dtype != torch.int32 or tile_start.ndim != 1:
        raise ValueError("tile_start must be a 1-D int32 tensor")
    if not (pair_data.is_contiguous() and tile_start.is_contiguous()):
        raise ValueError("K1 takes contiguous tensors")
    if pair_data.data_ptr() % 16:
        raise ValueError("pair_data must be 16-byte aligned")
    from gsavatar_torch import kernels
    lib = kernels.load('composite_fwd')
    lib.gs_composite_fwd.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.gs_composite_fwd.restype = ctypes.c_int
    num_tiles = tile_start.shape[0] - 1
    out = torch.empty((num_tiles, OUT_ROWS, P_PIX), dtype=torch.float32,
                      device=pair_data.device)
    stream = torch.cuda.current_stream(pair_data.device).cuda_stream
    err = lib.gs_composite_fwd(pair_data.data_ptr(), tile_start.data_ptr(),
                               out.data_ptr(), num_tiles, grid_x, stream)
    if err != 0:
        raise RuntimeError(f"composite_fwd launch failed: CUDA error {err}")
    composite_pairs_fwd.launches += 1
    return out


composite_pairs_fwd.launches = 0
