"""The rasterizer on the pairs route: project -> pairs -> K1 -> untile.

Counterpart of `gsavatar/ops/rasterizer/api.py:rasterize` with its pairs
route (`_rasterize_pairs`, `_untile`), with the compositor split over the
mesh's `model` axis inside `parallel.context.sharding_scope` as the JAX
route splits it. One call returns the colour image
and the alpha image, both read off the same compositor output; the
background is blended outside the kernel. There is no backend string: the
device of the tensors decides (K1 and K2 on CUDA, their plain versions on
the CPU). Gradients reach means3d, colors, opacities, cov3d, the
background and `means2d_offset` (see `project.project`)."""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from gsavatar_torch import tracing
from gsavatar_torch.parallel.context import active_mesh

from . import composite as _composite
from . import pairs as _pairs
from . import project as _project
from .project import TILE


@dataclasses.dataclass(frozen=True)
class RasterizeConfig:
    width: int = 512
    height: int = 512
    max_pairs: int = 2 ** 21
    # splats overlapping more than max_rect tiles per axis keep a centred
    # window of max_rect tiles (the dropped tiles count in rect_dropped)
    max_rect: int = 8

    @property
    def grid_x(self) -> int:
        return (self.width + TILE - 1) // TILE

    @property
    def grid_y(self) -> int:
        return (self.height + TILE - 1) // TILE


class RasterizeResult(NamedTuple):
    image: torch.Tensor     # (H, W, 3)
    alpha: torch.Tensor     # (H, W)
    radii: torch.Tensor     # (N,) int32; > 0 == visible
    n_pairs: int
    pair_overflow: int
    rect_dropped: int
    max_rect_side: torch.Tensor  # () int32, largest rect side before clamp


def _untile(x, grid_x: int, grid_y: int, width: int, height: int):
    """(num_tiles, 256, ch) -> (height, width, ch)."""
    ch = x.shape[-1]
    x = x.reshape(grid_y, grid_x, TILE, TILE, ch).permute(0, 2, 1, 3, 4)
    return x.reshape(grid_y * TILE, grid_x * TILE, ch)[:height, :width]


def rasterize(means3d, colors, opacities, cov3d, *, viewmatrix,
              full_projmatrix, tanfovx, tanfovy, background,
              config: RasterizeConfig,
              active: Optional[torch.Tensor] = None,
              means2d_offset: Optional[torch.Tensor] = None
              ) -> RasterizeResult:
    """means3d (N, 3); colors (N, 3) RGB; opacities (N, 1) or (N,); cov3d
    (N, 6) upper-triangular world covariance; matrices in the row-vector
    convention (Camera fields); background (3,); active (N,) arena mask;
    means2d_offset (N, 2) zeros, the hook for screen-space gradients."""
    with tracing.span('rasterize/project'):
        proj = _project.project(
            means3d, cov3d, viewmatrix, full_projmatrix, tanfovx, tanfovy,
            config.width, config.height, active=active,
            means2d_offset=means2d_offset)
        vis = proj.tiles_touched > 0
        side = torch.maximum(proj.rect_max[:, 0] - proj.rect_min[:, 0],
                             proj.rect_max[:, 1] - proj.rect_min[:, 1])
        max_side = torch.where(vis, side, 0).max()
    with tracing.span('rasterize/pairs'):
        pa = _pairs.build_pairs(proj, colors, opacities, config.grid_x,
                                config.grid_y, config.max_pairs,
                                max_rect=config.max_rect)
    with tracing.span('rasterize/composite'):
        # under a mesh with more than one `model` rank each rank
        # composites its tile range (`api.py:147-158` of the JAX package)
        num_tiles = config.grid_x * config.grid_y
        mesh = active_mesh()
        if mesh is not None and mesh.shape['model'] > 1 \
                and num_tiles % mesh.shape['model'] == 0:
            raw = _composite.make_composite_pairs_sharded(
                num_tiles, config.grid_x, mesh)(pa.pair_data, pa.tile_start)
        else:
            raw = _composite.CompositePairs.apply(
                pa.pair_data, pa.tile_start, config.grid_x)   # (T, 8, 256)

    def untile(rows):
        return _untile(raw[:, rows, :].transpose(1, 2), config.grid_x,
                       config.grid_y, config.width, config.height)

    with tracing.span('rasterize/untile'):
        final_T = untile(slice(4, 5))
        image = untile(slice(0, 3)) + final_T * background[None, None, :]
        alpha = untile(slice(3, 4))[..., 0]
    return RasterizeResult(
        image=image, alpha=alpha, radii=proj.radii,
        n_pairs=pa.n_pairs, pair_overflow=pa.pair_overflow,
        rect_dropped=pa.rect_dropped, max_rect_side=max_side)
