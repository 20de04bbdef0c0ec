"""Conditional MLPs.

Counterpart of `gsavatar/models/mlp.py`: configurable skip and conditioning
layers, LeakyReLU(0.01), skip concat scaled by 1/sqrt(2). The optional
N(0, 1e-5) last-layer init, which no config of the render path sets, comes
with a later slice. Layers are named `lin{l}` as in the JAX package, so
that a flax tree maps onto the state dict by path (`gsavatar_torch.convert`).
Every initializer draws from an explicit `torch.Generator`."""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn
import torch.nn.functional as F


def torch_dense(fan_in: int, fan_out: int,
                generator: Optional[torch.Generator] = None) -> nn.Linear:
    """nn.Linear with torch's default U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    for both weight and bias, drawn from `generator`."""
    lin = nn.Linear(fan_in, fan_out)
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        nn.init.uniform_(lin.weight, -bound, bound, generator=generator)
        nn.init.uniform_(lin.bias, -bound, bound, generator=generator)
    return lin


class VanillaCondMLP(nn.Module):
    def __init__(self, dim_in: int, dim_cond: int, dim_out: int,
                 n_neurons: int, n_hidden_layers: int,
                 skip_in: Sequence[int] = (), cond_in: Sequence[int] = (),
                 multires: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if multires > 0:
            raise ValueError("positional-encoding inputs (multires > 0) are "
                             "not part of the render path's configuration")
        self.skip_in = tuple(skip_in)
        self.cond_in = tuple(cond_in)
        dims = [dim_in] + [n_neurons] * n_hidden_layers + [dim_out]
        self.n_layers = len(dims) - 1
        x_dim = dims[0]
        for l in range(self.n_layers):
            out_dim = dims[l + 1] - dims[0] if (l + 1) in self.skip_in \
                else dims[l + 1]
            if l in self.cond_in:
                x_dim += dim_cond
            if l in self.skip_in:
                x_dim += dims[0]
            setattr(self, f'lin{l}', torch_dense(x_dim, out_dim, generator))
            x_dim = out_dim

    def forward(self, coords, cond=None):
        x = coords
        for l in range(self.n_layers):
            if l in self.cond_in:
                x = torch.cat([x, cond.expand(x.shape[0], cond.shape[-1])],
                              dim=1)
            if l in self.skip_in:
                x = torch.cat([x, coords], dim=1) / math.sqrt(2)
            x = getattr(self, f'lin{l}')(x)
            if l < self.n_layers - 1:
                x = F.leaky_relu(x, negative_slope=0.01)
        return x


def cond_mlp_from_cfg(dim_in: int, dim_cond: int, dim_out: int, cfg: dict,
                      generator=None) -> VanillaCondMLP:
    return VanillaCondMLP(
        dim_in=dim_in, dim_cond=dim_cond, dim_out=dim_out,
        n_neurons=cfg['n_neurons'], n_hidden_layers=cfg['n_hidden_layers'],
        skip_in=tuple(cfg.get('skip_in', ())),
        cond_in=tuple(cfg.get('cond_in', ())),
        multires=cfg.get('multires', 0), generator=generator)
