# Frozen copy of gsavatar_torch/ops/rasterizer/composite.py for the benchmark's plain reference (run
# on every device with the kernels' plain versions); it imports nothing of
# the program and is not edited when the program changes.
"""K1 and K2, the fused per-tile compositor forward and backward: CUDA
kernels, plain versions and the differentiable compositor.

Counterpart of `gsavatar/ops/rasterizer/pallas_composite.py`
(`composite_pairs_fwd`, `composite_pairs_bwd`, `make_composite_pairs`,
`make_composite_pairs_sharded`). The forward functions take the pair
arrays of `pairs.build_pairs` and return the (num_tiles, 8, 256) tile
outputs of the JAX kernel: rows 0-2 colour without background, row 3
alpha = 1 - final_T, row 4 final_T, rows 5-7 zero. The backward functions
take, besides, the cotangent of that output and the output itself, and
return the (P, 12) gradient of pair_data in its column layout (columns
9-11 zero). Each takes `tile_base`, the first global tile of its range, as
the JAX kernels do (`pallas_composite.py:91-100, 199-215`): `tile_start`
is then the range's `num_tiles + 1` global pair offsets, the pixels are
those of the global tiles, and the backward's rows outside the range's
pairs are zero.

`composite_pairs_fwd` and `composite_pairs_bwd` launch the hand-written
Hopper kernels (`gsavatar_torch/csrc/composite_fwd.cu`, `composite_bwd.cu`)
for CUDA tensors and count their launches in `.launches`. Only for CPU
tensors do they take the plain versions, which the CPU tests and the
on-card comparisons use. `CompositePairs` is the autograd Function of the
training path: K1 forward, K2 backward (the plain versions on the CPU).
`make_composite_pairs_sharded` splits the tile grid over the mesh's
`model` axis: each rank composites its own range and the collectives of
`parallel.mesh.Mesh` put the ranges together."""
from __future__ import annotations

import torch

from .pairs import PAIR_COLS
from .project import TILE

P_PIX = TILE * TILE
OUT_ROWS = 8
MIN_ALPHA = 1.0 / 255.0
MAX_ALPHA = 0.99
T_STOP = 1e-4
# K2's work units per tile (32-pixel groups), the warps of a unit (a chain
# warp, three evaluating, three gradient) and the live gradient columns
BWD_GROUPS = 8
BWD_WARPS = 7
BWD_GRADS = 9


def pixel_coords(num_tiles: int, grid_x: int, device, tile_base: int = 0):
    """Pixel-centre coordinates (num_tiles, 256) of the global tiles
    tile_base .. tile_base + num_tiles - 1."""
    t = tile_base + torch.arange(num_tiles, device=device)[:, None]
    pix = torch.arange(P_PIX, device=device)[None, :]
    px = (t % grid_x) * TILE + pix % TILE
    py = torch.div(t, grid_x, rounding_mode='floor') * TILE \
        + torch.div(pix, TILE, rounding_mode='floor')
    return px.float(), py.float()


def composite_pairs_fwd_plain(pair_data, tile_start, grid_x: int,
                              tile_base: int = 0):
    """Plain PyTorch K1: a loop over tiles, each a (pairs, 256) alpha matrix
    composited with a cumulative product. Same signature and output as the
    kernel; T after each pair is a running product, so a pair is included
    while that product stays >= 1e-4, as in the kernel's sequential walk."""
    num_tiles = tile_start.shape[0] - 1
    out = torch.zeros((num_tiles, OUT_ROWS, P_PIX), dtype=torch.float32,
                      device=pair_data.device)
    out[:, 4] = 1.0
    px, py = pixel_coords(num_tiles, grid_x, pair_data.device, tile_base)
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


def composite_pairs_fwd(pair_data, tile_start, grid_x: int,
                        tile_base: int = 0):
    """The plain version on every device."""
    return composite_pairs_fwd_plain(pair_data, tile_start, grid_x,
                                     tile_base)


def _walk(d, px, py):
    """One tile's pairs d (n, 12) walked front to back over its pixels (px,
    py (256,)) as `composite_pairs_fwd_plain` walks them: dx, dy, alpha, the
    transmittance before each pair and whether the pixel includes it, each
    (n, 256)."""
    dx = d[:, 0:1] - px[None]
    dy = d[:, 1:2] - py[None]
    power = -0.5 * (d[:, 2:3] * dx * dx + d[:, 4:5] * dy * dy) \
        - d[:, 3:4] * dx * dy
    alpha = torch.clamp_max(d[:, 8:9] * torch.exp(power), MAX_ALPHA)
    skip = (power > 0.0) | (alpha < MIN_ALPHA)
    T_after = torch.cumprod(1.0 - torch.where(skip, 0.0, alpha), dim=0)
    T_before = torch.cat([torch.ones_like(T_after[:1]), T_after[:-1]])
    return dx, dy, alpha, T_before, (T_after >= T_STOP) & ~skip


def composite_pairs_bwd_plain(pair_data, tile_start, ct, fwd, grid_x: int,
                              tile_base: int = 0):
    """Plain PyTorch K2: a loop over tiles with `_bwd_kernel`'s formulas on
    each (pairs, 256) matrix. The pairs a pixel includes come from the same
    running product of (1 - alpha) as `composite_pairs_fwd_plain`; the
    suffix sum S_k = acc_out - sum_{j<=k} w_j c_j uses the forward output
    `fwd` (rows 0-2), and dL/dT_end = ct[4] - ct[3]. Returns the (P, 12)
    gradient of pair_data; rows of pairs no pixel includes, and every row
    outside the range's pairs, are zero."""
    grad = torch.zeros_like(pair_data)
    px, py = pixel_coords(tile_start.shape[0] - 1, grid_x, pair_data.device,
                          tile_base)
    bounds = tile_start.tolist()
    for t in range(len(bounds) - 1):
        s, e = bounds[t], bounds[t + 1]
        if e <= s:
            continue
        d = pair_data[s:e]
        con_a, con_b, con_c = d[:, 2:3], d[:, 3:4], d[:, 4:5]
        rgb, opac = d[:, 5:8], d[:, 8:9]
        dx, dy, alpha, T_before, include = _walk(d, px[t], py[t])
        w = torch.where(include, alpha * T_before, 0.0)        # (n, 256)

        ct_rgb, acc_out = ct[t, 0:3], fwd[t, 0:3]              # (3, 256)
        dT_end = ct[t, 4] - ct[t, 3]
        one_m = torch.clamp_min(1.0 - alpha, 1e-6)
        d_alpha = torch.zeros_like(w)
        for c in range(3):
            prefix = torch.cumsum(w * rgb[:, c:c + 1], dim=0)
            suffix = acc_out[c][None] - prefix
            d_alpha = d_alpha + ct_rgb[c][None] * (
                T_before * rgb[:, c:c + 1] - suffix / one_m)
        d_alpha = d_alpha + dT_end[None] * (-fwd[t, 4][None] / one_m)
        d_alpha = torch.where(include, d_alpha, 0.0)
        unclamped = alpha < MAX_ALPHA
        d_opac = torch.where(unclamped, d_alpha * alpha / opac, 0.0)
        d_power = torch.where(unclamped, d_alpha * alpha, 0.0)
        grad[s:e, 0] = (d_power * (-(con_a * dx) - con_b * dy)).sum(1)
        grad[s:e, 1] = (d_power * (-(con_c * dy) - con_b * dx)).sum(1)
        grad[s:e, 2] = (d_power * (-0.5 * dx * dx)).sum(1)
        grad[s:e, 3] = (d_power * (-dx * dy)).sum(1)
        grad[s:e, 4] = (d_power * (-0.5 * dy * dy)).sum(1)
        grad[s:e, 5:8] = w @ ct_rgb.T
        grad[s:e, 8] = d_opac.sum(1)
    return grad


def composite_pairs_bwd_scale(pair_data, tile_start, ct, fwd, grid_x: int,
                              tile_base: int = 0):
    """The size of what each value of `composite_pairs_bwd_plain` sums: its
    formula with every factor and every term in absolute value (the suffix
    S_k as |acc_out| + prefix), summed over the tile's pixels. Taking the
    256-pixel sum in another order, or rounding the prefixes and T
    otherwise, moves a value by some f32 ulps of this, however much the
    value itself cancels: the yardstick for holding K2 to its plain version
    row by row. (P, 12), zero for the rows no pixel includes."""
    scale = torch.zeros_like(pair_data)
    px, py = pixel_coords(tile_start.shape[0] - 1, grid_x, pair_data.device,
                          tile_base)
    bounds = tile_start.tolist()
    for t in range(len(bounds) - 1):
        s, e = bounds[t], bounds[t + 1]
        if e <= s:
            continue
        d = pair_data[s:e]
        dx, dy, alpha, T_before, include = _walk(d, px[t], py[t])
        dx, dy, m = dx.abs(), dy.abs(), d.abs()
        con_a, con_b, con_c = m[:, 2:3], m[:, 3:4], m[:, 4:5]
        rgb, opac = m[:, 5:8], d[:, 8:9]
        w = torch.where(include, alpha * T_before, 0.0)
        ct_rgb, acc_out = ct[t, 0:3].abs(), fwd[t, 0:3].abs()
        one_m = torch.clamp_min(1.0 - alpha, 1e-6)
        d_alpha = (ct[t, 4].abs() + ct[t, 3].abs())[None] \
            * fwd[t, 4].abs()[None] / one_m
        for c in range(3):
            prefix = torch.cumsum(w * rgb[:, c:c + 1], dim=0)
            d_alpha = d_alpha + ct_rgb[c][None] * (
                T_before * rgb[:, c:c + 1] + (acc_out[c][None] + prefix)
                / one_m)
        d_alpha = torch.where(include, d_alpha, 0.0)
        unclamped = alpha < MAX_ALPHA
        d_power = torch.where(unclamped, d_alpha * alpha, 0.0)
        scale[s:e, 0] = (d_power * (con_a * dx + con_b * dy)).sum(1)
        scale[s:e, 1] = (d_power * (con_c * dy + con_b * dx)).sum(1)
        scale[s:e, 2] = (d_power * (0.5 * dx * dx)).sum(1)
        scale[s:e, 3] = (d_power * (dx * dy)).sum(1)
        scale[s:e, 4] = (d_power * (0.5 * dy * dy)).sum(1)
        scale[s:e, 5:8] = w @ ct_rgb.T
        scale[s:e, 8] = torch.where(unclamped, d_alpha * alpha / opac,
                                    0.0).sum(1)
    return scale


def composite_pairs_bwd(pair_data, tile_start, ct, fwd, grid_x: int,
                        tile_base: int = 0):
    """The plain version on every device."""
    return composite_pairs_bwd_plain(pair_data, tile_start, ct, fwd,
                                     grid_x, tile_base)


class CompositePairs(torch.autograd.Function):
    """The differentiable compositor: pair_data (P, 12), tile_start ->
    (num_tiles, 8, 256). Forward K1, backward K2; the gradient reaches
    pair_data only."""

    @staticmethod
    def forward(ctx, pair_data, tile_start, grid_x: int):
        out = composite_pairs_fwd(pair_data, tile_start, grid_x)
        ctx.save_for_backward(pair_data, tile_start, out)
        ctx.grid_x = grid_x
        return out

    @staticmethod
    def backward(ctx, ct):
        pair_data, tile_start, out = ctx.saved_tensors
        grad = composite_pairs_bwd(pair_data, tile_start, ct.contiguous(),
                                   out, ctx.grid_x)
        return grad, None, None
