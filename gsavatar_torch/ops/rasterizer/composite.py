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

import ctypes

import torch

from gsavatar_torch import tracing
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


def _check_pairs(name, pair_data, tile_start):
    """The pair arrays the kernels take: CUDA, f32 (P, 12) 16-byte aligned
    rows, int32 tile ranges, contiguous, on one device."""
    if pair_data.device.type != 'cuda':
        raise ValueError(f"{name} runs on CUDA or CPU tensors, not "
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
        raise ValueError(f"{name} takes contiguous tensors")
    if pair_data.data_ptr() % 16:
        raise ValueError("pair_data must be 16-byte aligned")


def composite_pairs_fwd(pair_data, tile_start, grid_x: int,
                        tile_base: int = 0):
    """pair_data (P, 12) f32, tile_start (num_tiles + 1,) int32 ->
    (num_tiles, 8, 256) f32: the tiles from global tile `tile_base`. CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if pair_data.device.type == 'cpu':
        return composite_pairs_fwd_plain(pair_data, tile_start, grid_x,
                                         tile_base)
    _check_pairs('K1', pair_data, tile_start)
    from gsavatar_torch import kernels
    lib = kernels.load('composite_fwd')
    lib.gs_composite_fwd.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.gs_composite_fwd.restype = ctypes.c_int
    num_tiles = tile_start.shape[0] - 1
    out = torch.empty((num_tiles, OUT_ROWS, P_PIX), dtype=torch.float32,
                      device=pair_data.device)
    stream = torch.cuda.current_stream(pair_data.device).cuda_stream
    err = lib.gs_composite_fwd(pair_data.data_ptr(), tile_start.data_ptr(),
                               out.data_ptr(), num_tiles, grid_x, tile_base,
                               stream)
    if err != 0:
        raise RuntimeError(f"composite_fwd launch failed: CUDA error {err}")
    composite_pairs_fwd.launches += 1
    return out


composite_pairs_fwd.launches = 0


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
                        tile_base: int = 0, stage_cycles=None):
    """pair_data (P, 12) f32, tile_start (num_tiles + 1,) int32, ct and fwd
    (num_tiles, 8, 256) f32 -> (P, 12) f32: the tiles from global tile
    `tile_base`, zero outside their pairs. CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise.

    `stage_cycles`, for measurement only: a zeroed int64 CUDA tensor
    (num_tiles * BWD_GROUPS, BWD_WARPS, 2) that receives, per (tile,
    32-pixel group) unit and warp, the cycles the warp spent in its stage
    and the cycles the unit ran (warp 0 the chain, then the evaluating,
    then the gradient warps; untouched for empty tiles)."""
    if pair_data.device.type == 'cpu':
        return composite_pairs_bwd_plain(pair_data, tile_start, ct, fwd,
                                         grid_x, tile_base)
    _check_pairs('K2', pair_data, tile_start)
    num_tiles = tile_start.shape[0] - 1
    for name, x in (('ct', ct), ('fwd', fwd)):
        if x.device != pair_data.device or x.dtype != torch.float32 \
                or tuple(x.shape) != (num_tiles, OUT_ROWS, P_PIX) \
                or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous f32 "
                             f"({num_tiles}, {OUT_ROWS}, {P_PIX}) on "
                             f"{pair_data.device}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    clocks = 0
    if stage_cycles is not None:
        if stage_cycles.device != pair_data.device \
                or stage_cycles.dtype != torch.int64 \
                or tuple(stage_cycles.shape) != (num_tiles * BWD_GROUPS,
                                                 BWD_WARPS, 2) \
                or not stage_cycles.is_contiguous():
            raise ValueError("stage_cycles must be contiguous int64 "
                             f"({num_tiles * BWD_GROUPS}, {BWD_WARPS}, 2)")
        clocks = stage_cycles.data_ptr()
    from gsavatar_torch import kernels
    lib = kernels.load('composite_bwd')
    lib.gs_composite_bwd.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    lib.gs_composite_bwd.restype = ctypes.c_int
    num_pairs = pair_data.shape[0]
    # each (tile, 32-pixel group) unit's partial sums of its tile's rows,
    # which a second kernel adds in group order into every row of grad
    partial = torch.empty(BWD_GROUPS * num_pairs * BWD_GRADS,
                          dtype=torch.float32, device=pair_data.device)
    grad = torch.empty_like(pair_data)
    stream = torch.cuda.current_stream(pair_data.device).cuda_stream
    err = lib.gs_composite_bwd(
        pair_data.data_ptr(), tile_start.data_ptr(), ct.data_ptr(),
        fwd.data_ptr(), partial.data_ptr(), grad.data_ptr(),
        num_pairs, num_tiles, grid_x, tile_base, clocks, stream)
    if err != 0:
        raise RuntimeError(f"composite_bwd launch failed: CUDA error {err}")
    composite_pairs_bwd.launches += 1
    return grad


composite_pairs_bwd.launches = 0


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
        with tracing.span('backward/composite'):
            grad = composite_pairs_bwd(pair_data, tile_start,
                                       ct.contiguous(), out, ctx.grid_x)
        return grad, None, None


class CompositePairsSharded(torch.autograd.Function):
    """`CompositePairs` with the tile grid split over the mesh's `model`
    axis: model rank m owns the tiles [m T/M, (m + 1) T/M). Forward: K1 on
    the rank's range, written into a zero (T, 8, 256) buffer that is summed
    over the `model` group. Backward: K2 on the rank's range with that
    range's cotangent and forward rows, the (P, 12) pair gradient (zero
    outside the range's pairs) summed over the `model` group, as
    `pallas_composite.py:404-483` psums it. Every element has one rank that
    writes it and zeros from the others, so both sums are exact: the
    result is the whole launch's, bit for bit."""

    @staticmethod
    def forward(ctx, pair_data, tile_start, grid_x: int, mesh):
        num_tiles = tile_start.shape[0] - 1
        per = num_tiles // mesh.shape['model']
        base = mesh.coords['model'] * per
        out = torch.zeros((num_tiles, OUT_ROWS, P_PIX), dtype=torch.float32,
                          device=pair_data.device)
        out[base:base + per] = composite_pairs_fwd(
            pair_data, tile_start[base:base + per + 1], grid_x, base)
        mesh.all_reduce(out, 'model')
        ctx.save_for_backward(pair_data, tile_start, out)
        ctx.grid_x, ctx.mesh, ctx.range = grid_x, mesh, (base, per)
        return out

    @staticmethod
    def backward(ctx, ct):
        pair_data, tile_start, out = ctx.saved_tensors
        base, per = ctx.range
        with tracing.span('backward/composite'):
            grad = composite_pairs_bwd(
                pair_data, tile_start[base:base + per + 1],
                ct[base:base + per].contiguous(), out[base:base + per],
                ctx.grid_x, base)
            ctx.mesh.all_reduce(grad, 'model')
        return grad, None, None, None


def make_composite_pairs_sharded(num_tiles: int, grid_x: int, mesh):
    """The differentiable compositor over the mesh's `model` axis:
    f(pair_data (P, 12), tile_start (num_tiles + 1,)) -> (num_tiles, 8,
    256), the same function as `CompositePairs` (counterpart of
    `pallas_composite.py:404 make_composite_pairs_sharded`). The pair
    arrays stay replicated over `model`: the pairs are tile-sorted, so a
    rank's tiles are one contiguous span of them."""
    if num_tiles % mesh.shape['model']:
        raise ValueError(f"{num_tiles} tiles do not split over "
                         f"{mesh.shape['model']} model ranks")

    def f(pair_data, tile_start):
        if tile_start.shape[0] != num_tiles + 1:
            raise ValueError(f"tile_start has {tile_start.shape[0]} "
                             f"entries, not {num_tiles + 1}")
        return CompositePairsSharded.apply(pair_data, tile_start, grid_x,
                                           mesh)

    return f
