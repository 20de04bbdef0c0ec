# Frozen copy of gsavatar_torch/core/optim.py for the benchmark's plain reference (run
# on every device with the kernels' plain versions); it imports nothing of
# the program and is not edited when the program changes.
"""Arena Adam: per-field Adam over the Gaussian arena.

Counterpart of `gsavatar/core/optim.py`: torch.optim.Adam's update (bias
correction, eps = 1e-15 added after the square root) on the six arena
fields, masked to the alive slots, with one `step` shared by all fields
that advances only when `apply` is true (the Gaussians wait for
`model.gaussian.delay`). A plain tensor function rather than a
`torch.optim` optimizer: the alive mask and the shared step do not fit one.
`zero_moments` is the moment surgery of densify and the opacity reset."""
from __future__ import annotations

import dataclasses

import torch

from .gaussians import GaussianParams

ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-15
FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity")


@dataclasses.dataclass
class ArenaAdamState:
    m: GaussianParams
    v: GaussianParams
    step: int


def init_adam(params: GaussianParams) -> ArenaAdamState:
    return ArenaAdamState(m=params.map(torch.zeros_like),
                          v=params.map(torch.zeros_like), step=0)


def adam_step(params: GaussianParams, grads: GaussianParams,
              state: ArenaAdamState, lrs: dict, alive, apply: bool = True):
    """One Adam step; returns (new params, new state). `lrs` maps each field
    to its learning rate; only alive slots move, and nothing does when
    `apply` is false."""
    step = state.step + int(apply)
    t = torch.tensor(float(max(step, 1)), dtype=torch.float32)
    bc1 = (1.0 - ADAM_B1 ** t).to(params.xyz.device)
    bc2 = (1.0 - ADAM_B2 ** t).to(params.xyz.device)
    new = {}
    for field in FIELDS:
        p, g = getattr(params, field), getattr(grads, field)
        m, v = getattr(state.m, field), getattr(state.v, field)
        mask = alive.reshape((-1,) + (1,) * (p.ndim - 1)).to(p.dtype)
        do = float(apply) * mask
        m_new = m + do * ((1 - ADAM_B1) * (g - m))
        v_new = v + do * ((1 - ADAM_B2) * (g * g - v))
        update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + ADAM_EPS)
        new[field] = (p - do * lrs[field] * update, m_new, v_new)
    pick = lambda i: GaussianParams(**{f: new[f][i] for f in FIELDS})
    return pick(0), ArenaAdamState(m=pick(1), v=pick(2), step=step)


def zero_moments(state: ArenaAdamState, slot_mask, fields=FIELDS
                 ) -> ArenaAdamState:
    """Zero the Adam moments of the slots in `slot_mask` (N,) bool, for the
    given fields (default all six); the step stays."""
    def z(tree):
        return tree.replace(**{
            f: torch.where(slot_mask.reshape((-1,) + (1,) * (
                getattr(tree, f).ndim - 1)), 0.0, getattr(tree, f))
            for f in fields})
    return ArenaAdamState(m=z(state.m), v=z(state.v), step=state.step)
