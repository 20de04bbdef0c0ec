"""One optimizer step over B frames on one device.

Counterpart of the batch semantics of `gsavatar/parallel/shard.py:
make_sharded_train_step` (and of `stack_cameras`, whose batch is here the
list of B cameras: nothing is traced, so nothing is stacked). The step
draws B `TrainDraws` from the state's generator in frame order, renders
each frame at `train=True` through the single-frame loss assembly
(`train.make_loss_fn`), takes the mean of the B losses, makes one backward
pass, steps the converter's optimizer once (the clip over the gradient of
the mean) and the arena Adam once, and adds the densify statistics frame
by frame (`train.make_batch_step_core`). With B = 1 it is
`train.make_step_core` (the same draws and operations) plus the metric
`loss`. The mesh placement (`put_replicated`, `put_batch`, the sharding
hints) is not ported."""
from __future__ import annotations

import torch

from gsavatar_torch.train import make_batch_step_core

# the metrics that reduce over the batch by a max (`shard.py:139-145`): the
# worst frame sizes the arena
MAX_KEYS = ('raster/n_pairs', 'raster/max_rect_side')


def reduce_metric(key: str, values: list):
    """One metric of the B frames, reduced as the JAX step reduces it: the
    overflow counts summed, the pair count and the rect side their max,
    every other value the mean."""
    if key.startswith('overflow/'):
        return sum(values)
    if key in MAX_KEYS:
        return max(values)
    return torch.stack(values).mean()


def make_batch_train_step(scene):
    """step(state, cameras, iteration, weights, xyz_lr, active_sh_degree=0,
    bucket=0, pair_bucket=0, rect_window=0, draws=None) -> (state, metrics):
    one optimizer step over the B frames of `cameras` (`draws` a list of B
    `TrainDraws` to replay, else drawn from the state's generator), with
    the metrics reduced over the frames, `loss` the mean loss and `n_alive`
    the alive count. Updates `state` in place."""
    core = make_batch_step_core(scene)

    def step(state, cameras, iteration: int, weights: dict, xyz_lr: float,
             active_sh_degree: int = 0, bucket: int = 0, pair_bucket: int = 0,
             rect_window: int = 0, draws=None):
        state, loss, frames = core(state, cameras, iteration, weights, xyz_lr,
                                   active_sh_degree, bucket, pair_bucket,
                                   rect_window, draws)
        metrics = {k: reduce_metric(k, [m[k] for m in frames])
                   for k in frames[0]}
        metrics['n_alive'] = state.gauss_aux.alive.sum()
        metrics['loss'] = loss
        return state, metrics

    return step
