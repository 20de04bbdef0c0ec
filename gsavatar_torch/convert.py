"""Carry weights from the JAX package's state to the port.

Takes the JAX state as numpy trees (the caller does the `np.asarray` on
the JAX side, so this module imports no JAX) and returns the port's:

* `converter_state(conv_params['params'])`: the GaussianConverter state
  dict. A flax path maps onto a module path by name: `Dense_0` levels drop
  out, `kernel` (in, out) becomes `weight` (out, in), `embedding` becomes
  `weight`, and the pose encoder's `layers_{j}_{k}` becomes `layers.{j}.{k}`.
  The hash `table` (L, 2^16, 2), the latent embeddings and the
  pose-correction tables map by path unchanged.
* `arena(gauss_params, gauss_aux)`: GaussianParams / GaussianAux from the
  JAX package's, their leaves numpy arrays: the parameters, the alive mask,
  the densify statistics and the cached AIAP neighbours.
* `arena_adam(gauss_adam)`: the arena Adam's moments and its shared step.

* `unstack_state(stacked, i)`: subject i of a JAX stacked TrainState
  (`gsavatar/parallel/multi_subject.py`, every leaf with a leading subject
  axis) through the three above.

The converter optimizer's state is not carried: a carried state starts
fresh (count 0, zero moments, `scene.ConverterOptimizer.init`). Carrying a
mid-run optax state waits for checkpoints."""
from __future__ import annotations

import re
from types import SimpleNamespace
from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from gsavatar_torch.core.gaussians import GaussianAux, GaussianParams
from gsavatar_torch.core.optim import ArenaAdamState

_LAYERS = re.compile(r'^layers_(\d+)_(\d+)$')


def _walk(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, prefix + (str(k),))
    else:
        yield prefix, tree


def converter_state(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax `conv_params['params']` (numpy leaves) -> state dict."""
    out = {}
    for path, leaf in _walk(params):
        arr = np.asarray(leaf, np.float32)
        names = []
        for p in path:
            if p == 'Dense_0':
                continue
            m = _LAYERS.match(p)
            names.extend(('layers',) + m.groups() if m else (p,))
        if names[-1] == 'kernel':
            names[-1] = 'weight'
            arr = arr.T
        elif names[-1] == 'embedding':
            names[-1] = 'weight'
        out['.'.join(names)] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


PARAM_FIELDS = ('xyz', 'features_dc', 'features_rest', 'scaling',
                'rotation', 'opacity')
AUX_FIELDS = ('alive', 'max_radii2d', 'xyz_gradient_accum', 'denom', 'nn_ix')


def _params(tree) -> GaussianParams:
    return GaussianParams(**{
        k: torch.from_numpy(np.array(getattr(tree, k), np.float32))
        for k in PARAM_FIELDS})


def arena(gauss_params, gauss_aux):
    """JAX GaussianParams / GaussianAux (numpy leaves) -> the port's."""
    f32 = lambda x: torch.from_numpy(np.array(x, np.float32))
    aux = GaussianAux(
        alive=torch.from_numpy(np.array(gauss_aux.alive, bool)),
        max_radii2d=f32(gauss_aux.max_radii2d),
        xyz_gradient_accum=f32(gauss_aux.xyz_gradient_accum),
        denom=f32(gauss_aux.denom),
        nn_ix=torch.from_numpy(np.array(gauss_aux.nn_ix, np.int32)))
    return _params(gauss_params), aux


def arena_adam(gauss_adam) -> ArenaAdamState:
    """JAX ArenaAdamState (numpy leaves) -> the port's."""
    return ArenaAdamState(m=_params(gauss_adam.m), v=_params(gauss_adam.v),
                          step=int(np.asarray(gauss_adam.step)))


class CarriedState(NamedTuple):
    """What the port takes of one JAX TrainState."""
    converter: Dict[str, torch.Tensor]
    gauss_params: GaussianParams
    gauss_aux: GaussianAux
    gauss_adam: ArenaAdamState


def _lane(tree, names, i):
    return SimpleNamespace(**{n: np.asarray(getattr(tree, n))[i]
                              for n in names})


def unstack_state(stacked, i: int) -> CarriedState:
    """Subject i of a JAX stacked TrainState (numpy leaves, each with a
    leading subject axis): its converter state dict, arena and arena Adam."""
    take = lambda tree: ({k: take(v) for k, v in tree.items()}
                         if isinstance(tree, dict) else np.asarray(tree)[i])
    adam = stacked.gauss_adam
    gauss_params, gauss_aux = arena(
        _lane(stacked.gauss_params, PARAM_FIELDS, i),
        _lane(stacked.gauss_aux, AUX_FIELDS, i))
    return CarriedState(
        converter=converter_state(take(stacked.conv_params['params'])),
        gauss_params=gauss_params, gauss_aux=gauss_aux,
        gauss_adam=arena_adam(SimpleNamespace(
            m=_lane(adam.m, PARAM_FIELDS, i), v=_lane(adam.v, PARAM_FIELDS, i),
            step=np.asarray(adam.step)[i])))
