"""One optimizer step over B frames: on one device, or over the
('data', 'model') mesh of `parallel/mesh.py`.

Counterpart of `gsavatar/parallel/shard.py`: `stack_cameras` (:28; the
batch is here the list of B cameras: nothing is traced, so nothing is
stacked), `put_replicated` (:44), `put_batch` (:58) and
`make_sharded_train_step` (:73-202). The B-frame step
(`make_batch_train_step`) draws B `TrainDraws` from the state's generator
in frame order, renders each frame at `train=True` through the
single-frame loss assembly (`train.make_loss_fn`), takes the mean of the B
losses, makes one backward pass, steps the converter's optimizer once (the
clip over the gradient of the mean) and the arena Adam once, and adds the
densify statistics frame by frame (`train.make_batch_step_core`). With
B = 1 it is `train.make_step_core` (the same draws and operations) plus
the metric `loss`.

Over a mesh (`make_sharded_train_step`) data rank d renders the frames
[d B/D, (d + 1) B/D) (`put_batch`, `P('data')`) and the `data` groups sum
what one device would have summed over the B frames (`DataExchange`). The
JAX step asks XLA for that sum by sharding the batch; here it is one
`all_reduce` of the gradients and one of the frames' metrics. The ranks of
a `data` row render the same frames and split each frame's compositor
over `model` (`ops/rasterizer/composite.py:make_composite_pairs_sharded`).
JAX's other `model` hint, the arena rows of the geometry stages
(`shard.py:122`), has no counterpart: the geometry is replicated over
`model` (`context.hint`). Every rank steps the same optimizers on the same
sums, so the ranks' states stay equal bit for bit."""
from __future__ import annotations

import torch

from gsavatar_torch.core.optim import FIELDS
from gsavatar_torch.core.gaussians import GaussianParams
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


def state_tensors(state) -> dict:
    """Every tensor of a `TrainState` by name: the arena, its Adam moments,
    the converter's parameters and its optimizer's moments (not the
    generator's state)."""
    out = {}
    for part in ('gauss_params', 'gauss_aux'):
        out.update({f'{part}.{k}': v
                    for k, v in vars(getattr(state, part)).items()})
    for which in ('m', 'v'):
        out.update({f'adam.{which}.{k}': v for k, v in
                    vars(getattr(state.gauss_adam, which)).items()})
    out.update({f'conv.{k}': v for k, v in state.conv_params.items()})
    out.update({f'mu.{k}': v for k, v in state.conv_opt.mu.items()})
    out.update({f'nu.{k}': v for k, v in state.conv_opt.nu.items()})
    return out


@torch.no_grad()
def put_replicated(state, mesh):
    """Global rank 0's state on every rank of `mesh`, in place: each tensor
    of `state_tensors`, the generator's state and the two step counts
    broadcast from rank 0. Returns `state`."""
    if mesh.shape['data'] * mesh.shape['model'] == 1:
        return state
    for x in state_tensors(state).values():
        mesh.broadcast(x, 0)
    gen = mesh.broadcast(state.generator.get_state(), 0)
    state.generator.set_state(gen)
    counts = mesh.broadcast(torch.tensor(
        [state.gauss_adam.step, state.conv_opt.count]), 0).tolist()
    state.gauss_adam.step, state.conv_opt.count = counts
    return state


def put_batch(batch: list, mesh) -> list:
    """This rank's rows of a batch of B frames (or frame ids): the `data`
    row d keeps [d B/D, (d + 1) B/D), contiguous as `P('data')`."""
    D = mesh.shape['data']
    if len(batch) % D:
        raise ValueError(f"a batch of {len(batch)} frames does not split "
                         f"over {D} data ranks")
    n = len(batch) // D
    d = mesh.coords['data']
    return batch[d * n:(d + 1) * n]


class DataExchange:
    """The sums over the mesh's `data` axis between a step's backward pass
    and its update. A rank's gradients are those of its frames' losses
    over B; one flat f32 buffer holds them (the converter's leaves, the
    subject constants', the arena rows') and each frame's `means2d`
    gradient and radii in the frame's slot of zeros, and gets one
    `all_reduce` over the `data` group (never over the world: with
    `model` > 1 that would count each frame M times). The frames' metrics
    go the same way in float64, which holds their f32 values and integer
    counts exactly; the mean loss is then taken over the B frames' losses
    as one device takes it."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.size = mesh.shape['data']
        self.index = mesh.coords['data']

    def __call__(self, metrics: list, radii: list, grads: dict):
        """Local (metrics, radii, grads) of n frames -> (loss, metrics,
        radii, grads) of all B = n D frames."""
        n = len(metrics)
        frames, first = n * self.size, n * self.index
        shared = list(grads['conv'].values()) \
            + list(grads['subject'].values()) \
            + [getattr(grads['gauss'], f) for f in FIELDS]
        bucket = radii[0].shape[0]
        slot = 3 * bucket                 # means2d (bucket, 2), then radii
        sizes = [g.numel() for g in shared]
        width = sum(sizes)
        buf = torch.zeros(width + frames * slot, dtype=torch.float32,
                          device=radii[0].device)
        buf[:width] = torch.cat([g.reshape(-1) for g in shared])
        rows = buf[width:].view(frames, slot)
        for b, (g, r) in enumerate(zip(grads['means2d'], radii)):
            rows[first + b, :2 * bucket] = g.reshape(-1)
            rows[first + b, 2 * bucket:] = r
        self.mesh.all_reduce(buf, 'data')

        views = iter(v.view_as(g) for v, g in
                     zip(buf[:width].split(sizes), shared))
        out = {name: {k: next(views) for k in grads[name]}
               for name in ('conv', 'subject')}
        out['gauss'] = GaussianParams(**{f: next(views) for f in FIELDS})
        out['means2d'] = [rows[b, :2 * bucket].view(bucket, 2)
                          for b in range(frames)]
        radii = [rows[b, 2 * bucket:].to(radii[0].dtype)
                 for b in range(frames)]

        # the f32 tensors first, then the host integers (the counts)
        keys = list(metrics[0])
        tensors = [k for k in keys if isinstance(metrics[0][k], torch.Tensor)]
        counts = [k for k in keys if k not in tensors]
        table = torch.zeros((frames, len(keys)), dtype=torch.float64,
                            device=buf.device)
        for b, m in enumerate(metrics):
            table[first + b] = torch.cat([
                torch.stack([m[k].to(torch.float64) for k in tensors]),
                torch.tensor([float(m[k]) for k in counts],
                             dtype=torch.float64).to(buf.device)])
        self.mesh.all_reduce(table, 'data')
        values = table[:, :len(tensors)].to(torch.float32)
        host = table[:, len(tensors):].tolist()     # one host read
        metrics = []
        for b in range(frames):
            m = dict(zip(tensors, values[b]))
            m.update(zip(counts, map(int, host[b])))
            metrics.append({k: m[k] for k in keys})
        loss = torch.stack([m['loss/total_loss'] for m in metrics]).sum() \
            / frames
        return loss, metrics, radii, out


def make_batch_train_step(scene, exchange=None):
    """step(state, cameras, iteration, weights, xyz_lr, active_sh_degree=0,
    bucket=0, pair_bucket=0, rect_window=0, draws=None) -> (state, metrics):
    one optimizer step over the frames of `cameras` (`draws` a list of a
    `TrainDraws` per frame to replay, else drawn from the state's
    generator), with the metrics reduced over the frames, `loss` the mean
    loss and `n_alive` the alive count. Updates `state` in place.
    `exchange`, a `DataExchange`, makes `cameras` this rank's rows of a
    batch over the mesh's `data` axis (`make_sharded_train_step`)."""
    core = make_batch_step_core(scene, exchange)

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


def make_sharded_train_step(scene, mesh):
    """`make_batch_train_step` over `mesh`: step(state, cameras, ...) with
    `cameras` this rank's rows of the batch (`put_batch`) and `draws`, when
    given, the whole batch's. Every rank draws all B `TrainDraws` in frame
    order and keeps its rows, so the generators stay in step; the gradients
    and the frames' metrics are summed over the `data` group; every rank
    steps the optimizers and adds the densify statistics of all B frames in
    frame order, so every rank holds the same state. Call it, and the
    step, inside `context.sharding_scope(mesh)`, where the rasterizer
    splits the compositor over `model`."""
    return make_batch_train_step(
        scene, DataExchange(mesh) if mesh.shape['data'] > 1 else None)
