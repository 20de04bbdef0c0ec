"""(tile, Gaussian) pair building for the compositor, forward.

Counterpart of `gsavatar/ops/rasterizer/pairs.py:build_pairs`. Every
Gaussian owns a (max_rect x max_rect) window of candidate tiles; a rect
wider than the window is clamped to a window CENTRED on it, and the tiles
it loses are counted in `rect_dropped`. Each candidate gets the packed key
(tile << 20) | depth, with depth quantized over [0.2, 100] to 20 bits; dead
candidates get a sentinel key that sorts past every tile. One sort orders
and compacts the candidates, `torch.searchsorted` over the sorted tile ids
gives each tile its [start, end) range, and the first `max_pairs` survive
(the rest are counted in `pair_overflow`).

`pair_data` is a contiguous f32 (P, 12) array: 48 B rows
[m2dx, m2dy, con_a, con_b, con_c, r, g, b, opac, 0, 0, 0], three 16-byte
loads each. P is this frame's pair count: the compositor checks its own
bounds, so no rows of padding follow. Reading the pair count is the one
device sync of the render path.

The rows are gathered with `segsum.gather_rows`, so that the pair
gradients reach the Gaussians through a sort and one K3 launch over the
9 live columns, as the JAX package's `_pair_gather` VJP does."""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from gsavatar_torch import tracing
from gsavatar_torch.ops.segsum import gather_rows
from .project import Projection

DEPTH_BITS = 20
DEPTH_LEVELS = (1 << DEPTH_BITS) - 1
PAIR_COLS = 12
LIVE_COLS = 9   # leading columns of a pair row that carry data


class PairArrays(NamedTuple):
    pair_data: torch.Tensor   # (P, PAIR_COLS) f32
    pair_gauss: torch.Tensor  # (P,) int32 source Gaussian of each pair
    tile_start: torch.Tensor  # (num_tiles + 1,) int32 range offsets
    n_pairs: int
    pair_overflow: int        # pairs dropped past max_pairs
    rect_dropped: int         # tiles dropped by the max_rect clamp


def build_pairs(proj: Projection, colors, opacities, grid_x: int, grid_y: int,
                max_pairs: int, znear: float = 0.2, zfar: float = 100.0,
                max_rect: int = 8) -> PairArrays:
    num_tiles = grid_x * grid_y
    if num_tiles >= (1 << (31 - DEPTH_BITS)):
        raise ValueError(f"tile grid {grid_x}x{grid_y} overflows the packed "
                         f"int32 sort key at DEPTH_BITS={DEPTH_BITS}")
    dev = colors.device
    w = proj.rect_max[:, 0] - proj.rect_min[:, 0]
    h = proj.rect_max[:, 1] - proj.rect_min[:, 1]
    vis = proj.tiles_touched > 0
    wc = torch.clamp_max(w, max_rect)
    hc = torch.clamp_max(h, max_rect)
    x0 = proj.rect_min[:, 0] + torch.div(w - wc, 2, rounding_mode='floor')
    y0 = proj.rect_min[:, 1] + torch.div(h - hc, 2, rounding_mode='floor')
    zero = torch.zeros_like(w)
    rect_dropped = torch.where(vis, w * h - wc * hc, zero).sum()
    total = torch.where(vis, wc * hc, zero).sum()

    r = torch.arange(max_rect, dtype=torch.int32, device=dev)[None, :, None]
    c = torch.arange(max_rect, dtype=torch.int32, device=dev)[None, None, :]
    tile = (y0[:, None, None] + r) * grid_x + x0[:, None, None] + c
    valid = vis[:, None, None] & (r < hc[:, None, None]) \
        & (c < wc[:, None, None])
    dq = ((proj.depths - znear) / (zfar - znear) * DEPTH_LEVELS)
    dq = dq.clamp(-1.0, DEPTH_LEVELS + 1.0).to(torch.int32).clamp(
        0, DEPTH_LEVELS)
    sentinel = (num_tiles << DEPTH_BITS) | DEPTH_LEVELS
    key = torch.where(valid, (tile << DEPTH_BITS) | dq[:, None, None],
                      sentinel).reshape(-1)

    # unstable: the order within one (tile, quantized depth) key is free
    sorted_key, order = torch.sort(key, stable=False)
    # one host read, queued behind the sort, for the pair count and both
    # counters
    total, rect_dropped = (int(v) for v in tracing.device_read(
        torch.stack([total, rect_dropped])).tolist())
    n_pairs = min(total, max_pairs)
    sorted_key = sorted_key[:n_pairs]
    pair_gauss = torch.div(order[:n_pairs], max_rect * max_rect,
                           rounding_mode='floor').to(torch.int32)
    tile_start = torch.searchsorted(
        sorted_key >> DEPTH_BITS,
        torch.arange(num_tiles + 1, dtype=torch.int32, device=dev),
        side='left').to(torch.int32)

    gathered = torch.cat([proj.means2d, proj.conics, colors,
                          opacities.reshape(-1, 1)], dim=1)
    pair_data = F.pad(gather_rows(gathered, pair_gauss),
                      (0, PAIR_COLS - LIVE_COLS))
    return PairArrays(pair_data=pair_data,
                      pair_gauss=pair_gauss, tile_start=tile_start,
                      n_pairs=n_pairs,
                      pair_overflow=max(total - max_pairs, 0),
                      rect_dropped=rect_dropped)
