"""The port's test helper that every `test_torch_*` module imports, and
the ranks of its multi-process tests (tests/test_torch_mesh.py,
tests/test_torch_distributed.py), started with
`torch.multiprocessing.spawn` by `spawn`. A rank imports no JAX: the JAX
side of a comparison runs in the test process, which hands the ranks their
inputs and reads their results as files under `out`.

Importing it puts the process's torch CPU work on one thread, and sets
the thread-count variables of OpenMP, MKL and OpenBLAS to 1 in the
environment, which the processes it starts (ranks, subprocesses) inherit:
the test workers share the machine's cores, and torch's pool in each,
sized to every core and oversubscribed by the others, runs the tests'
small tensors tens of times slower than one thread does."""
from __future__ import annotations

import os
import sys
import time

import torch
import torch.multiprocessing as mp

os.environ.update(OMP_NUM_THREADS='1', MKL_NUM_THREADS='1',
                  OPENBLAS_NUM_THREADS='1')
torch.set_num_threads(1)

# the shape of the step parity tests: tests/test_train_e2e.py's avatar
# (64x64, 768 Gaussians in 1024 slots) with a small skinning pool
STEP_TINY = ["dataset.img_hw=[64,64]", "dataset.n_verts=512",
             "dataset.n_points=768", "dataset.n_target_gaussians=512",
             "dataset.train_frames=[0,2,1]", "dataset.train_views=['0']",
             "model.gaussian.capacity=1024", "rasterizer.max_pairs=65536",
             "opt.skinning_pool_size=2048", "opt.n_reg_pts=128"]
# 3 iterations with a densify at 2 (inside the densify window from 1)
DRIVER = ["model.gaussian.delay=0", "opt.densify_from_iter=1",
          "opt.densification_interval=2", "opt.densify_until_iter=100",
          "opt.opacity_reset_interval=100", "opt.iterations=3",
          "test_interval=0", "seed=0"]


def spawn(job: str, world: int, out, args=(), timeout: float = 300.0,
          env: bool = False):
    """Run `job(rank, world, out, *args)` of this module on `world` ranks of
    a gloo process group on a free localhost port; fail after `timeout`
    seconds. With `env` the ranks get only torchrun's environment
    variables and join from them; else `rank_main` joins with explicit
    arguments."""
    from gsavatar_torch.parallel.mesh import free_port
    ctx = mp.spawn(rank_main, args=(world, free_port(), env, job, str(out),
                                    tuple(args)),
                   nprocs=world, join=False)
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{job} on {world} ranks did not finish in "
                               f"{timeout} s")


def rank_main(rank, world, port, env, job, out, args):
    import torch.distributed as dist
    from gsavatar_torch.parallel.mesh import initialize_distributed
    if env:
        os.environ.update(MASTER_ADDR='127.0.0.1', MASTER_PORT=str(port),
                          RANK=str(rank), WORLD_SIZE=str(world))
        assert initialize_distributed()
    else:
        assert initialize_distributed(f'tcp://127.0.0.1:{port}', world, rank)
    try:
        globals()[job](rank, world, out, *args)
        assert 'jax' not in sys.modules
    finally:
        dist.destroy_process_group()


def collectives(rank, world, out):
    """The group the environment made: its backend and size, the mesh over
    it, an all_reduce over each axis, the broadcasts, and the ValueError of
    a config on fewer ranks than the group's."""
    import torch.distributed as dist
    from gsavatar_torch.parallel.mesh import (initialize_distributed,
                                              make_mesh, require_world)
    assert initialize_distributed()          # idempotent
    mesh = make_mesh()
    x = torch.tensor([float(rank + 1)])
    try:
        require_world(1, 'parallel.data x parallel.model')
        mismatch = None
    except ValueError as e:
        mismatch = str(e)
    got = {'backend': dist.get_backend(), 'world': dist.get_world_size(),
           'shape': mesh.shape, 'coords': mesh.coords,
           'data_sum': float(mesh.all_reduce(x.clone(), 'data')),
           'model_sum': float(mesh.all_reduce(x.clone(), 'model')),
           'from_last': float(mesh.broadcast(x.clone(), world - 1)),
           'bytes': mesh.broadcast_bytes(
               b'rank %d' % rank if rank == 1 else None, 1),
           'mismatch': mismatch}
    torch.save(got, os.path.join(out, f'rank{rank}.pt'))


def sharded_composite(rank, world, out, inputs):
    """K1 and K2 (their plain versions) over a 1 x world mesh through
    `make_composite_pairs_sharded`: the forward output and the VJP of the
    given cotangent."""
    from gsavatar_torch.ops.rasterizer.composite import \
        make_composite_pairs_sharded
    from gsavatar_torch.parallel.mesh import make_mesh
    x = torch.load(inputs)
    mesh = make_mesh(world, data=1, model=world)
    pair_data = x['pair_data'].clone().requires_grad_()
    f = make_composite_pairs_sharded(x['num_tiles'], x['grid_x'], mesh)
    y = f(pair_data, x['tile_start'])
    (g,) = torch.autograd.grad(y, pair_data, x['ct'])
    torch.save({'out': y.detach(), 'grad': g},
               os.path.join(out, f'rank{rank}.pt'))


def train_run(rank, world, out, overrides):
    """`train.training` on the CPU with `overrides`; rank r's experiment
    directory is `out/exp{r}`. Saves the state's tensors (by
    `shard.state_tensors`, plus the generator's state), the logged rows
    and the per-step reduced metrics."""
    from gsavatar_torch import train
    from gsavatar_torch.config import load_config
    from gsavatar_torch.parallel import shard
    steps = []
    make = shard.make_sharded_train_step

    def recording(scene, mesh):
        step = make(scene, mesh)

        def recorded(*a, **k):
            state, metrics = step(*a, **k)
            steps.append(train.host_metrics(metrics))
            return state, metrics
        return recorded

    shard.make_sharded_train_step = recording
    cfg = load_config(STEP_TINY + DRIVER + list(overrides)
                      + [f"exp_dir={os.path.join(out, f'exp{rank}')}"])
    _, state, logger = train.training(cfg, log_every=1, progress=False,
                                      device='cpu')
    torch.save({'state': state_dict(state), 'steps': steps,
                'history': logger.history if logger else None},
               os.path.join(out, f'rank{rank}.pt'))


def sharded_steps(rank, world, out, inputs):
    """Steps of `shard.make_sharded_train_step` over a world x 1 mesh from
    a given state: `inputs` holds the state's tensors and step counts, the
    converter's weights, the frames' ground truth, and per step the
    iteration, loss weights, position learning rate and every frame's
    draws. Saves the state's tensors after each step and the metrics."""
    from gsavatar_torch.config import load_config
    from gsavatar_torch.parallel import shard
    from gsavatar_torch.parallel.context import sharding_scope
    from gsavatar_torch.parallel.mesh import make_mesh
    from gsavatar_torch.scene import Scene
    from gsavatar_torch.train import TrainDraws, host_metrics
    x = torch.load(inputs)
    scene = Scene(load_config(STEP_TINY), seed=0, device='cpu')
    state = scene.init_state()
    scene.converter.load_state_dict(x['converter'])
    live = shard.state_tensors(state)
    with torch.no_grad():
        for k, v in x['state'].items():
            live[k].copy_(v)
    state.gauss_adam.step, state.conv_opt.count = x['counts']
    cams = [scene.train_dataset[i].replace(image=img, mask=mask)
            for i, (img, mask) in enumerate(x['frames'])]
    mesh = make_mesh(world, data=world, model=1)
    states, metrics = [], []
    with sharding_scope(mesh):
        step = shard.make_sharded_train_step(scene, mesh)
        for it, weights, xyz_lr, draws in x['steps']:
            state, m = step(state, shard.put_batch(cams, mesh), it, weights,
                            xyz_lr, bucket=x['bucket'],
                            draws=[TrainDraws(**d) for d in draws])
            metrics.append(host_metrics(m))
            states.append(state_dict(state))
    torch.save({'states': states, 'metrics': metrics},
               os.path.join(out, f'rank{rank}.pt'))


def subjects_run(rank, world, out, overrides):
    """The multi-subject driver on the CPU; saves this rank's subjects'
    states by global index, and rank 0's logged rows."""
    from gsavatar_torch import train
    from gsavatar_torch.config import load_config
    cfg = load_config(STEP_TINY + DRIVER + list(overrides)
                      + [f"exp_dir={os.path.join(out, f'exp{rank}')}"])
    ms, states, logger = train.training(cfg, log_every=1, progress=False,
                                        device='cpu')
    torch.save({'states': {i: state_dict(s) for i, s in
                           zip(ms.subjects, states)},
                'history': logger.history if logger else None},
               os.path.join(out, f'rank{rank}.pt'))


def state_dict(state) -> dict:
    """Every tensor of a TrainState, the generator's state and the two
    step counts, detached."""
    from gsavatar_torch.parallel.shard import state_tensors
    out = {k: v.detach().clone() for k, v in state_tensors(state).items()}
    out['generator'] = state.generator.get_state()
    out['adam.step'] = torch.tensor(state.gauss_adam.step)
    out['conv_opt.count'] = torch.tensor(state.conv_opt.count)
    return out
