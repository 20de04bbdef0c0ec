"""render(): the whole per-frame forward pass.

Counterpart of `gsavatar/renderer.py:render`: the converter moves and
colours the canonical Gaussians (at `train=True` with the step's random
draws), then the rasterizer draws them with precomputed colours and
covariances. One rasterizer pass gives both the colour image and the
opacity image; `means2d_offset` is the screen-space gradient hook. The
stages carry `tracing` spans (`render/converter` here, `converter/*` in
the converter, `non_rigid/*` and `texture/*` inside two of its stages,
`rasterize/*` in the rasterizer) that `python -m
gsavatar_torch.profile_render` prints."""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from gsavatar_torch import tracing
from gsavatar_torch.core.gaussians import Gaussians
from gsavatar_torch.ops.rasterizer import RasterizeConfig, rasterize


class RenderPackage(NamedTuple):
    render: torch.Tensor             # (H, W, 3)
    opacity_render: torch.Tensor     # (H, W)
    viewspace_grad_hook: Any         # (N, 2) means2d_offset, or None
    visibility_filter: torch.Tensor  # (N,) bool
    radii: torch.Tensor              # (N,) int32
    loss_reg: dict
    deformed_gaussians: Any          # Gaussians
    colors: torch.Tensor             # (N, 3)
    pair_overflow: int
    rect_dropped: int
    n_pairs: int
    max_rect_side: torch.Tensor      # () int32


def render(converter, gaussians: Gaussians, camera, iteration: int,
           raster_config: RasterizeConfig, background, *,
           nr_cache=None, train: bool = False, draws=None,
           means2d_offset=None) -> RenderPackage:
    with tracing.span('render/converter'):
        deformed, loss_reg, colors = converter(gaussians, camera, iteration,
                                               nr_cache=nr_cache,
                                               train=train, draws=draws)
    res = rasterize(
        deformed.get_xyz, colors, deformed.get_opacity,
        deformed.get_covariance(),
        viewmatrix=camera.world_view_transform,
        full_projmatrix=camera.full_proj_transform,
        tanfovx=camera.tanfovx, tanfovy=camera.tanfovy,
        background=background, config=raster_config, active=deformed.alive,
        means2d_offset=means2d_offset)
    return RenderPackage(
        render=res.image, opacity_render=res.alpha,
        viewspace_grad_hook=means2d_offset,
        visibility_filter=res.radii > 0, radii=res.radii, loss_reg=loss_reg,
        deformed_gaussians=deformed, colors=colors,
        pair_overflow=res.pair_overflow, rect_dropped=res.rect_dropped,
        n_pairs=res.n_pairs, max_rect_side=res.max_rect_side)
