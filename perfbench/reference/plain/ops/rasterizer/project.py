# Frozen copy of gsavatar_torch/ops/rasterizer/project.py for the benchmark's plain reference (run
# on every device with the kernels' plain versions); it imports nothing of
# the program and is not edited when the program changes.
"""Gaussian projection: 3D -> screen (EWA splatting preprocessing).

Counterpart of `gsavatar/ops/rasterizer/project.py`: frustum cull at
z <= 0.2, perspective projection through the camera's row-vector matrices,
EWA 2D covariance J W Sigma W^T J^T with +0.3 px dilation and the
1.3 tan(fov) clamp, radius ceil(3 sqrt(lambda_max)), and the 16x16 tile
rect by int truncation. Plain elementwise tensor code.

`means2d_offset` (N, 2) is the hook through which training reads
d(loss)/d(screen position) for the densify statistics: it is added to the
NDC means, so its gradient is the NDC gradient times half the image size,
the units of the reference CUDA kernel's dL_dmean2D."""
from __future__ import annotations

from typing import NamedTuple

import torch

TILE = 16
# pixel coordinates are clamped into +-2^30 before the int cast, which
# keeps the cast defined; the rect is clipped to the grid afterwards
_PIX_LIMIT = float(1 << 30)


class Projection(NamedTuple):
    means2d: torch.Tensor        # (N, 2) pixel coords
    depths: torch.Tensor         # (N,) view-space z
    conics: torch.Tensor         # (N, 3) inverse 2D covariance (a, b, c)
    radii: torch.Tensor          # (N,) int32 pixel radius (0 = culled)
    rect_min: torch.Tensor       # (N, 2) int32 tile rect (x0, y0) inclusive
    rect_max: torch.Tensor       # (N, 2) int32 tile rect (x1, y1) exclusive
    tiles_touched: torch.Tensor  # (N,) int32


def ndc_to_pix(v, size):
    return ((v + 1.0) * size - 1.0) * 0.5


def _tile_index(v, grid: int):
    """int32 truncation of a tile coordinate, clipped to [0, grid]."""
    v = v.clamp(-_PIX_LIMIT, _PIX_LIMIT).to(torch.int32)
    return v.clamp(0, grid)


def project(means3d, cov3d, viewmatrix, full_projmatrix, tanfovx, tanfovy,
            width, height, active=None, means2d_offset=None,
            near: float = 0.2) -> Projection:
    """means3d (N, 3); cov3d (N, 6) upper triangle; matrices in the
    row-vector convention (p_h @ M)."""
    N = means3d.shape[0]
    p_hom4 = torch.cat([means3d, torch.ones((N, 1), dtype=means3d.dtype,
                                            device=means3d.device)], dim=1)

    t = (p_hom4[:, :, None] * viewmatrix[None, :, :3]).sum(1)    # (N, 3)
    tz = t[:, 2]
    in_front = tz > near

    p_hom = (p_hom4[:, :, None] * full_projmatrix[None]).sum(1)  # (N, 4)
    p_w = 1.0 / (p_hom[:, 3] + 1e-7)
    ndc_xy = p_hom[:, :2] * p_w[:, None]
    if means2d_offset is not None:
        ndc_xy = ndc_xy + means2d_offset
    means2d = torch.stack([ndc_to_pix(ndc_xy[:, 0], width),
                           ndc_to_pix(ndc_xy[:, 1], height)], dim=1)

    focal_x = width / (2.0 * tanfovx)
    focal_y = height / (2.0 * tanfovy)
    limx, limy = 1.3 * tanfovx, 1.3 * tanfovy
    tz_safe = torch.where(in_front, tz, torch.ones_like(tz))
    tx = torch.clamp(t[:, 0] / tz_safe, -limx, limx) * tz_safe
    ty = torch.clamp(t[:, 1] / tz_safe, -limy, limy) * tz_safe

    # viewmatrix is W2V^T, so W[k, :] = Wr[:, k]
    Wr = viewmatrix[:3, :3]
    xx, xy, xz, yy, yz, zz = [cov3d[:, i] for i in range(6)]
    inv_z = 1.0 / tz_safe
    inv_z2 = inv_z * inv_z
    j00 = focal_x * inv_z
    j02 = -focal_x * tx * inv_z2
    j11 = focal_y * inv_z
    j12 = -focal_y * ty * inv_z2
    m0 = j00[:, None] * Wr[:, 0][None, :] + j02[:, None] * Wr[:, 2][None, :]
    m1 = j11[:, None] * Wr[:, 1][None, :] + j12[:, None] * Wr[:, 2][None, :]
    Sm0 = torch.stack([xx * m0[:, 0] + xy * m0[:, 1] + xz * m0[:, 2],
                       xy * m0[:, 0] + yy * m0[:, 1] + yz * m0[:, 2],
                       xz * m0[:, 0] + yz * m0[:, 1] + zz * m0[:, 2]], dim=1)
    Sm1 = torch.stack([xx * m1[:, 0] + xy * m1[:, 1] + xz * m1[:, 2],
                       xy * m1[:, 0] + yy * m1[:, 1] + yz * m1[:, 2],
                       xz * m1[:, 0] + yz * m1[:, 1] + zz * m1[:, 2]], dim=1)
    c00 = (m0 * Sm0).sum(1) + 0.3
    c01 = (m0 * Sm1).sum(1)
    c11 = (m1 * Sm1).sum(1) + 0.3

    det = c00 * c11 - c01 * c01
    det_ok = det != 0.0
    inv_det = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    conics = torch.stack([c11 * inv_det, -c01 * inv_det, c00 * inv_det],
                         dim=1)

    mid = 0.5 * (c00 + c11)
    disc = torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    lambda1 = mid + disc
    radius_f = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(lambda1, 0.0)))

    grid_x = (width + TILE - 1) // TILE
    grid_y = (height + TILE - 1) // TILE
    px, py = means2d[:, 0], means2d[:, 1]
    x0 = _tile_index((px - radius_f) / TILE, grid_x)
    y0 = _tile_index((py - radius_f) / TILE, grid_y)
    x1 = _tile_index((px + radius_f + TILE - 1) / TILE, grid_x)
    y1 = _tile_index((py + radius_f + TILE - 1) / TILE, grid_y)
    area = (x1 - x0) * (y1 - y0)

    visible = in_front & det_ok & (area > 0)
    if active is not None:
        visible = visible & active
    radii = torch.where(visible, radius_f, 0.0).to(torch.int32)
    tiles_touched = torch.where(visible, area, 0).to(torch.int32)
    return Projection(
        means2d=means2d, depths=tz, conics=conics, radii=radii,
        rect_min=torch.stack([x0, y0], 1), rect_max=torch.stack([x1, y1], 1),
        tiles_touched=tiles_touched)
