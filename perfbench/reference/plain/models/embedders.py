# Frozen copy of gsavatar_torch/models/embedders.py for the benchmark's plain reference (run
# on every device with the kernels' plain versions); it imports nothing of
# the program and is not edited when the program changes.
"""Positional-encoding embedders.

Counterpart of `gsavatar/models/embedders.py`: the layout
[x?, sin(x f0), cos(x f0), sin(x f1), cos(x f1), ...] with the frequencies
2^0..2^(multires-1) in float32. The Hann-window variant takes the
iteration as a Python int; its weights are a few float32 numbers computed
on the host (numpy, the JAX package's formula), so that no device value is
read back."""
from __future__ import annotations

import numpy as np
import torch


def get_embedder(multires: int, input_dims: int = 3):
    """(embed_fn, out_dim); multires == 0 is the identity."""
    if multires == 0:
        return (lambda x: x), input_dims
    freqs = 2.0 ** np.arange(multires, dtype=np.float32)
    out_dim = input_dims * (1 + 2 * multires)

    def embed(x):
        parts = [x]
        for f in freqs:
            parts.append(torch.sin(x * float(f)))
            parts.append(torch.cos(x * float(f)))
        return torch.cat(parts, dim=-1)

    return embed, out_dim


def hannw_weights(iteration: int, multires: int, kick_in_iter: int,
                  full_band_iter: int) -> np.ndarray:
    """Per-frequency Hann-window weights in [0, 1], (multires,) float32:
    0 until `kick_in_iter`, each frequency ramped in turn up to 1 at
    `full_band_iter`."""
    f32 = np.float32
    if full_band_iter <= 0 or kick_in_iter >= full_band_iter:
        alpha = f32(multires)
    else:
        t = np.maximum(f32(iteration) - f32(kick_in_iter), f32(0.0))
        alpha = f32(multires) * t / f32(full_band_iter - kick_in_iter)
    idx = np.arange(multires, dtype=f32)
    return ((f32(1.0) - np.cos(f32(np.pi) * np.clip(alpha - idx, f32(0.0),
                                                     f32(1.0)))) / f32(2.0)
            ).astype(f32)


def get_hannw_embedder(multires: int, kick_in_iter: int, full_band_iter: int,
                       input_dims: int = 3):
    """The annealed embedder without the identity part: (embed_fn(x,
    iteration), out_dim)."""
    freqs = 2.0 ** np.arange(multires, dtype=np.float32)
    out_dim = input_dims * 2 * multires

    def embed(x, iteration: int):
        w = hannw_weights(iteration, multires, kick_in_iter, full_band_iter)
        parts = []
        for wi, f in zip(w, freqs):
            parts.append(float(wi) * torch.sin(x * float(f)))
            parts.append(float(wi) * torch.cos(x * float(f)))
        return torch.cat(parts, dim=-1)

    return embed, out_dim
