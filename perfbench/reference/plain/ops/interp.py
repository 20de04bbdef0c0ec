# Frozen copy of gsavatar_torch/ops/interp.py for the benchmark's plain reference (run
# on every device with the kernels' plain versions); it imports nothing of
# the program and is not edited when the program changes.
"""Trilinear grid sampling of a volume.

Counterpart of `gsavatar/ops/interp.py:grid_sample_3d`: the semantics of
`F.grid_sample` with `align_corners=False` and border padding, written as
the JAX package writes it (clipped corner indices, eight weighted
gathers), so that out-of-range coordinates and the rounding follow the
JAX function and not the library call. It samples the distilled
skinning-weight voxel (`models/rigid.py:SkinningField`)."""
from __future__ import annotations

import torch


def grid_sample_3d(vol, coords):
    """vol (C, D, H, W); coords (N, 3) in [-1, 1] as (x, y, z), x indexing
    W, y H and z D. Returns (N, C)."""
    C, D, H, W = vol.shape
    x, y, z = coords[:, 0], coords[:, 1], coords[:, 2]

    def corners(v, size):
        f = ((v + 1.0) * size - 1.0) / 2.0
        f0 = torch.floor(f)
        w1 = f - f0
        i0 = f0.to(torch.int64)
        return (i0.clamp(0, size - 1), (i0 + 1).clamp(0, size - 1), w1)

    x0, x1, wx = corners(x, W)
    y0, y1, wy = corners(y, H)
    z0, z1, wz = corners(z, D)
    flat = vol.reshape(C, -1)

    def gather(zi, yi, xi):
        return flat[:, (zi * H + yi) * W + xi].T          # (N, C)

    return (gather(z0, y0, x0) * ((1 - wz) * (1 - wy) * (1 - wx))[:, None]
            + gather(z0, y0, x1) * ((1 - wz) * (1 - wy) * wx)[:, None]
            + gather(z0, y1, x0) * ((1 - wz) * wy * (1 - wx))[:, None]
            + gather(z0, y1, x1) * ((1 - wz) * wy * wx)[:, None]
            + gather(z1, y0, x0) * (wz * (1 - wy) * (1 - wx))[:, None]
            + gather(z1, y0, x1) * (wz * (1 - wy) * wx)[:, None]
            + gather(z1, y1, x0) * (wz * wy * (1 - wx))[:, None]
            + gather(z1, y1, x1) * (wz * wy * wx)[:, None])
