"""Densification statistics.

Counterpart of `gsavatar/core/densify.py:add_stats_prefix`: accumulate, for
every visible alive Gaussian of a bucketed step, the norm of its
screen-space gradient (the `means2d_offset` hook's), the visible count and
the largest screen radius. Densify, prune and the opacity reset come with
the next slice."""
from __future__ import annotations

import torch

from .gaussians import GaussianAux


def add_stats_prefix(aux: GaussianAux, means2d_grad, radii) -> GaussianAux:
    """`means2d_grad` (b, 2) and `radii` (b,) cover the first b arena rows
    (the alive prefix); the rows after them keep their statistics."""
    b = radii.shape[0]
    vis = (radii > 0) & aux.alive[:b]
    gnorm = torch.linalg.vector_norm(means2d_grad[:, :2], dim=-1)
    max_r = torch.where(vis, torch.maximum(aux.max_radii2d[:b],
                                           radii.to(torch.float32)),
                        aux.max_radii2d[:b])

    def prefix(full, head):
        return torch.cat([head, full[b:]])

    return aux.replace(
        xyz_gradient_accum=prefix(aux.xyz_gradient_accum,
                                  aux.xyz_gradient_accum[:b]
                                  + torch.where(vis, gnorm, 0.0)),
        denom=prefix(aux.denom, aux.denom[:b] + vis.to(torch.float32)),
        max_radii2d=prefix(aux.max_radii2d, max_r))
