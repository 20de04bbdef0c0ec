# Frozen copy of gsavatar_torch/models/mlp.py for the benchmark's plain reference (run
# on every device with the kernels' plain versions); it imports nothing of
# the program and is not edited when the program changes.
"""Conditional MLPs.

Counterpart of `gsavatar/models/mlp.py`: `VanillaCondMLP` (LeakyReLU(0.01),
an optional positional encoding of the input, the optional N(0, 1e-5)
last-layer init) and `HannwCondMLP` (ReLU, the Hann-window annealed
encoding, every bias zero, the conditioning columns of each `cond_in`
layer zero at init), both with configurable skip and conditioning layers
and the skip concat of the encoded input scaled by 1/sqrt(2). Layers are
named `lin{l}` as in the JAX package, so that a flax tree maps onto the
state dict by path (`perfbench.reference.plain.convert`). Every initializer draws
from an explicit `torch.Generator`."""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn
import torch.nn.functional as F

from .embedders import get_embedder, get_hannw_embedder


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


def _layer_dims(dims, dim_cond, skip_in, cond_in):
    """(fan_in, fan_out) of each layer: a `cond_in` layer also takes the
    condition, a `skip_in` layer the encoded input, and the layer before a
    skip gives up that many outputs."""
    out, x_dim = [], dims[0]
    for l in range(len(dims) - 1):
        out_dim = dims[l + 1] - dims[0] if (l + 1) in skip_in \
            else dims[l + 1]
        if l in cond_in:
            x_dim += dim_cond
        if l in skip_in:
            x_dim += dims[0]
        out.append((x_dim, out_dim))
        x_dim = out_dim
    return out


class _CondMLP(nn.Module):
    """The layer walk shared by both MLPs: condition and skip concats, then
    `lin{l}`, then the activation on every layer but the last."""

    def _walk(self, x, cond, act):
        coords = x
        for l in range(self.n_layers):
            if l in self.cond_in:
                x = torch.cat([x, cond.expand(x.shape[0], cond.shape[-1])],
                              dim=1)
            if l in self.skip_in:
                x = torch.cat([x, coords], dim=1) / math.sqrt(2)
            x = getattr(self, f'lin{l}')(x)
            if l < self.n_layers - 1:
                x = act(x)
        return x


class VanillaCondMLP(_CondMLP):
    def __init__(self, dim_in: int, dim_cond: int, dim_out: int,
                 n_neurons: int, n_hidden_layers: int,
                 skip_in: Sequence[int] = (), cond_in: Sequence[int] = (),
                 multires: int = 0, last_layer_init: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.skip_in = tuple(skip_in)
        self.cond_in = tuple(cond_in)
        self.embed, input_ch = get_embedder(multires, dim_in)
        dims = [input_ch] + [n_neurons] * n_hidden_layers + [dim_out]
        layers = _layer_dims(dims, dim_cond, self.skip_in, self.cond_in)
        self.n_layers = len(layers)
        for l, (fan_in, fan_out) in enumerate(layers):
            lin = torch_dense(fan_in, fan_out, generator)
            if last_layer_init and l == self.n_layers - 1:
                with torch.no_grad():
                    nn.init.normal_(lin.weight, 0.0, 1e-5,
                                    generator=generator)
                    lin.bias.zero_()
            setattr(self, f'lin{l}', lin)

    def forward(self, coords, cond=None):
        return self._walk(self.embed(coords), cond,
                          lambda x: F.leaky_relu(x, negative_slope=0.01))


class HannwCondMLP(_CondMLP):
    """ReLU MLP on the Hann-window annealed encoding; `forward` takes the
    iteration (a Python int) that sets the window."""

    def __init__(self, dim_in: int, dim_cond: int, dim_out: int,
                 n_neurons: int, n_hidden_layers: int, kick_in_iter: int,
                 full_band_iter: int, skip_in: Sequence[int] = (),
                 cond_in: Sequence[int] = (), multires: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.skip_in = tuple(skip_in)
        self.cond_in = tuple(cond_in)
        if multires > 0:
            self.embed, input_ch = get_hannw_embedder(
                multires, kick_in_iter, full_band_iter, dim_in)
        else:
            self.embed, input_ch = (lambda x, iteration: x), dim_in
        dims = [input_ch] + [n_neurons] * n_hidden_layers + [dim_out]
        layers = _layer_dims(dims, dim_cond, self.skip_in, self.cond_in)
        self.n_layers = len(layers)
        for l, (fan_in, fan_out) in enumerate(layers):
            lin = torch_dense(fan_in, fan_out, generator)
            with torch.no_grad():
                lin.bias.zero_()
                # the last dim_cond input columns, as the JAX package zeroes
                # its kernel's last rows
                if l in self.cond_in and dim_cond > 0:
                    lin.weight[:, -dim_cond:] = 0.0
            setattr(self, f'lin{l}', lin)

    def forward(self, coords, iteration: int, cond=None):
        return self._walk(self.embed(coords, iteration), cond, F.relu)


def cond_mlp_from_cfg(dim_in: int, dim_cond: int, dim_out: int, cfg: dict,
                      generator=None) -> VanillaCondMLP:
    return VanillaCondMLP(
        dim_in=dim_in, dim_cond=dim_cond, dim_out=dim_out,
        n_neurons=cfg['n_neurons'], n_hidden_layers=cfg['n_hidden_layers'],
        skip_in=tuple(cfg.get('skip_in', ())),
        cond_in=tuple(cfg.get('cond_in', ())),
        multires=cfg.get('multires', 0),
        last_layer_init=cfg.get('last_layer_init', False),
        generator=generator)
