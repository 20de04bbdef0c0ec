"""Multiresolution hash-grid encoding.

Counterpart of `gsavatar/models/hashgrid.py`: L levels x F features, a
2^log2_hashmap_size table per level, geometric resolutions from base to
max, input mapped [-1, 1] -> [0, 1], trilinear interpolation, dense
indexing where a level's grid fits its table and the spatial hash
x ^ (y * 2654435761) ^ (z * 805459861) mod T where it does not.

As in the JAX package, the forward reads a bf16-rounded copy of the table
and returns f32 features (the parameters stay f32), and the table's
gradient is summed in f32 by `segsum.segment_sum_leveled` (one sort per
level and one K3 launch for all levels, `_HashGather`), not by autograd's
scatter-add. Gradients reach the positions through the trilinear weights,
outside the gather. The hash is uint32
arithmetic; torch has no general uint32 multiply, so it runs in int64 with
each product reduced mod 2^32 (`_mul_u32`), and a negative corner wraps as
the uint32 cast does."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from gsavatar_torch import tracing
from gsavatar_torch.ops.segsum import segment_sum_leveled

_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF


def _mul_u32(a, p: int):
    """(a * p) mod 2^32 for int64 `a` in [0, 2^32) and a uint32 constant
    `p`, splitting p in 16-bit halves so that no int64 product overflows."""
    lo = a * (p & 0xFFFF)
    hi = ((a * (p >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


class _HashGather(torch.autograd.Function):
    """table (L, T, F) f32, idx (L, M) int32 per-level ids in [0, T) ->
    (L, M, F) f32 read from the bf16-rounded table; backward the f32
    segment sum of the cotangent rows onto the table."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.table_shape = table.shape
        table16 = table.to(torch.bfloat16)
        return torch.stack([table16[l][idx[l]]
                            for l in range(table.shape[0])]).float()

    @staticmethod
    def backward(ctx, ct):
        idx, = ctx.saved_tensors
        L, T, F = ctx.table_shape
        with tracing.span('backward/segsum'):
            d = segment_sum_leveled(ct, idx, T)
        return d.reshape(L, T, F), None


class HashGrid(nn.Module):
    def __init__(self, n_levels: int = 16, n_features_per_level: int = 2,
                 log2_hashmap_size: int = 16, base_resolution: int = 16,
                 max_resolution: int = 2048, per_level_scale: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_levels = n_levels
        self.n_features_per_level = n_features_per_level
        self.table_size = 1 << log2_hashmap_size
        if max_resolution > 0:
            b = float(np.exp(np.log(max_resolution / base_resolution)
                             / (n_levels - 1)))
        else:
            b = per_level_scale
        self.resolutions = [int(np.floor(base_resolution * b ** l))
                            for l in range(n_levels)]
        table = torch.empty(n_levels, self.table_size, n_features_per_level)
        nn.init.uniform_(table, -1e-4, 1e-4, generator=generator)
        self.table = nn.Parameter(table)
        corners = [[(c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1]
                   for c in range(8)]
        self.register_buffer('corners', torch.tensor(corners),
                             persistent=False)

    @property
    def n_output_dims(self) -> int:
        return self.n_levels * self.n_features_per_level

    def forward(self, x_sym):
        """x_sym (N, 3) in [-1, 1] -> (N, L * F) f32."""
        T = self.table_size
        n = x_sym.shape[0]
        x = (x_sym + 1.0) * 0.5
        off = self.corners                                  # (8, 3) int64
        idx_lvl, w_lvl = [], []
        for res in self.resolutions:
            pos = x * res
            p0 = torch.floor(pos)
            frac = pos - p0
            c = p0.to(torch.int32).to(torch.int64)[:, None, :] + off  # (N,8,3)
            if (res + 1) ** 3 <= T:
                idx = (c[..., 0] * (res + 1) + c[..., 1]) * (res + 1) \
                    + c[..., 2]
                idx = torch.remainder(idx, T)
            else:
                cu = c & _U32
                idx = (_mul_u32(cu[..., 0], _PRIMES[0])
                       ^ _mul_u32(cu[..., 1], _PRIMES[1])
                       ^ _mul_u32(cu[..., 2], _PRIMES[2])) % T
            w = torch.where(off == 1, frac[:, None, :], 1.0 - frac[:, None, :])
            idx_lvl.append(idx.to(torch.int32).reshape(-1))   # (N * 8,)
            w_lvl.append(w[..., 0] * w[..., 1] * w[..., 2])   # (N, 8)
        g = _HashGather.apply(self.table, torch.stack(idx_lvl))  # (L, N*8, F)
        g = g.reshape(len(self.resolutions), n, 8, -1)
        return torch.cat([(g[l] * w[..., None]).sum(dim=1)
                          for l, w in enumerate(w_lvl)], dim=1)
