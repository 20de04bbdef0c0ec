"""The ('data', 'model') mesh of gsavatar_torch in one process, on the CPU:
its layout against `gsavatar/parallel/mesh.py`, K1 and K2 over one
rank's tile range against the JAX kernels in interpret mode, the ranges
put together against the whole grid, the 1 x 1 mesh route against the
B-frame route it is built on, and the configurations that raise. The
multi-process routes are in tests/test_torch_distributed.py.

Tolerances, and why:
* the layout (`factorize`, each rank's coordinates): no difference;
* K1 and K2 on a range against the Pallas kernels with the same
  `tile_base`: tests/test_torch_raster.py's, K1 3e-5 absolute (a running
  product of (1 - alpha) against the kernel's exp of a cumulative log1p
  sum) and K2 1e-4 of the largest |value| of the same column in the same
  tile (that difference through 1 / (1 - alpha), and the 256-pixel sums
  in another order); the rows outside the range zero in both;
* the ranges put together against the whole grid, and the 1 x 1 mesh route
  against the B-frame route: bit for bit (the same operations on the same
  rows)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_dist_workers import DRIVER
from torch_parity import (GRID, PAIR_CHUNK, STEP_TINY, TILES, close,
                          grid_pairs, padded_pairs, tile_column_scale)

from gsavatar_torch import train as ttrain
from gsavatar_torch.config import load_config as t_load_config
from gsavatar_torch.ops.rasterizer.composite import (
    composite_pairs_bwd, composite_pairs_fwd)
from gsavatar_torch.parallel import context as tcontext
from gsavatar_torch.parallel import mesh as tmesh
from gsavatar_torch.parallel import shard as tshard

from gsavatar.ops.rasterizer.pallas_composite import (
    composite_pairs_bwd as j_composite_pairs_bwd,
    composite_pairs_fwd as j_composite_pairs_fwd)
from gsavatar.parallel import mesh as jmesh


def test_factorize_matches_jax():
    for n in range(1, 17):
        assert tmesh.factorize(n) == jmesh.factorize(n), n


@pytest.mark.parametrize('n, data, model', [
    (1, 1, 1), (2, 2, 1), (2, 1, 2), (4, 2, 2), (4, 4, 1), (6, 2, 3),
    (6, 3, 2), (8, 2, 4), (8, 4, 2), (8, 1, 8), (8, None, None)])
def test_mesh_layout_matches_jax(n, data, model):
    """Each rank's (data, model) coordinates are those of JAX's device of
    the same index in `make_mesh`'s (data, model) array."""
    jm = jmesh.make_mesh(n, data=data, model=model)
    D, M = jm.shape['data'], jm.shape['model']
    if data is None:
        assert (D, M) == tmesh.factorize(n)
    for d in range(D):
        for m in range(M):
            rank = int(jm.devices[d, m].id)
            assert tmesh.mesh_coords(rank, D, M) == {'data': d, 'model': m}


def test_one_process_mesh(monkeypatch):
    """Without a process group: `initialize_distributed` returns False, the
    mesh is 1 x 1 with identity collectives, a larger mesh raises, and
    `sharding_scope` sets and restores the active mesh; `hint` returns its
    input."""
    for key in ('MASTER_ADDR', 'MASTER_PORT', 'RANK', 'WORLD_SIZE'):
        monkeypatch.delenv(key, raising=False)
    assert tmesh.initialize_distributed() is False
    assert tmesh.world_size() == 1
    mesh = tmesh.make_mesh()
    assert mesh.shape == {'data': 1, 'model': 1}
    assert mesh.rank == 0 and mesh.coords == {'data': 0, 'model': 0}
    x = torch.arange(3.0)
    assert mesh.all_reduce(x, 'data') is x
    assert torch.equal(x, torch.arange(3.0))
    assert mesh.broadcast(x) is x
    with pytest.raises(ValueError, match="a mesh of 2 ranks in a process "
                                         "group of 1"):
        tmesh.make_mesh(2)
    with pytest.raises(ValueError, match=r"data x model = 2 x 2 is not 2"):
        tmesh.make_mesh(2, data=2, model=2)
    assert tcontext.active_mesh() is None
    with tcontext.sharding_scope(mesh) as m:
        assert m is mesh and tcontext.active_mesh() is mesh
        assert tcontext.hint(x, 'model') is x
    assert tcontext.active_mesh() is None


def _ranges(M):
    """(first tile, tiles) of each of the M model ranks."""
    per = TILES // M
    return [(m * per, per) for m in range(M)]


@pytest.mark.parametrize('M', [2, 4])
def test_plain_k1_range_matches_pallas_interpret(M):
    pair_data, tile_start, _ = grid_pairs()
    pd = padded_pairs(pair_data)
    for base, per in _ranges(M):
        ts = tile_start[base:base + per + 1]
        got = composite_pairs_fwd(pair_data, ts, GRID, base)
        want = np.asarray(j_composite_pairs_fwd(
            pd, jnp.asarray(ts.numpy()), num_tiles=per, grid_x=GRID,
            chunk=PAIR_CHUNK, interpret=True,
            tile_base=jnp.asarray([base], jnp.int32)))
        assert got.shape == (per, 8, 256)
        close(got, want, 0, 3e-5, f'range at {base}')


@pytest.mark.parametrize('M', [2, 4])
def test_plain_k2_range_matches_pallas_interpret(M):
    """The range's forward rows and cotangent through the plain K2 and
    `composite_pairs_bwd(..., tile_base=...)`; JAX's rows outside the
    range masked as its sharded compositor masks them."""
    pair_data, tile_start, ct = grid_pairs()
    pd = padded_pairs(pair_data)
    P = pair_data.shape[0]
    for base, per in _ranges(M):
        ts = tile_start[base:base + per + 1]
        fwd = composite_pairs_fwd(pair_data, ts, GRID, base)
        ct_r = ct[base:base + per].contiguous()
        got = composite_pairs_bwd(pair_data, ts, ct_r, fwd, GRID, base)
        want = np.asarray(j_composite_pairs_bwd(
            pd, jnp.asarray(ts.numpy()), jnp.asarray(ct_r.numpy()),
            jnp.asarray(fwd.numpy()), num_tiles=per, grid_x=GRID,
            chunk=PAIR_CHUNK, interpret=True,
            tile_base=jnp.asarray([base], jnp.int32)))[:P, :12]
        lo, hi = int(ts[0]), int(ts[-1])
        inside = np.zeros(P, bool)
        inside[lo:hi] = True
        want = np.where(inside[:, None], want, 0.0)
        assert not got[~torch.from_numpy(inside)].any()
        scale = tile_column_scale(want, tile_start.numpy())
        np.testing.assert_array_less(np.abs(got.numpy() - want),
                                     1e-4 * scale + 1e-30)
        assert np.abs(want).max() > 0.0


@pytest.mark.parametrize('M', [2, 4])
def test_ranges_put_together_are_the_whole_grid(M):
    """The M ranges' forward outputs stacked, and their pair gradients
    added, equal one call over the whole grid bit for bit."""
    pair_data, tile_start, ct = grid_pairs()
    whole = composite_pairs_fwd(pair_data, tile_start, GRID)
    grad = composite_pairs_bwd(pair_data, tile_start, ct, whole, GRID)
    outs, total = [], torch.zeros_like(grad)
    for base, per in _ranges(M):
        ts = tile_start[base:base + per + 1]
        outs.append(composite_pairs_fwd(pair_data, ts, GRID, base))
        total += composite_pairs_bwd(pair_data, ts,
                                     ct[base:base + per].contiguous(),
                                     whole[base:base + per], GRID, base)
    assert torch.equal(torch.cat(outs), whole)
    assert torch.equal(total, grad)
    assert torch.equal(composite_pairs_fwd(pair_data, tile_start, GRID, 0),
                       whole)


def _run(tmp_path, tag, extra):
    cfg = t_load_config(STEP_TINY + DRIVER + list(extra)
                        + [f"exp_dir={tmp_path / tag}"])
    _, state, logger = ttrain.training(cfg, log_every=1, progress=False,
                                       device='cpu')
    return state, logger


def test_one_by_one_mesh_route_is_the_batch_route(tmp_path, monkeypatch):
    """`{data: 1, model: 1}` at B = 2 for 3 iterations (densify at 2)
    through the mesh route (`make_sharded_train_step`, `put_replicated`,
    `put_batch`, the sharding scope) against the same run with the step of
    `make_batch_train_step` alone: the logged rows and every state tensor
    bit for bit."""
    extra = ["parallel.data=1", "parallel.model=1",
             "parallel.frames_per_step=2"]
    state0, log0 = _run(tmp_path, 'mesh', extra)
    monkeypatch.setattr(tshard, 'make_sharded_train_step',
                        lambda scene, mesh: tshard.make_batch_train_step(
                            scene))
    state1, log1 = _run(tmp_path, 'batch', extra)
    strip = lambda lg: [{k: v for k, v in r.items()
                         if k not in ('time', 'iter_time')}
                        for r in lg.history]
    assert strip(log0) == strip(log1)
    assert any('densify/n_alive' in r for r in log0.history)
    a, b = tshard.state_tensors(state0), tshard.state_tensors(state1)
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    assert torch.equal(state0.generator.get_state(),
                       state1.generator.get_state())


@pytest.mark.parametrize('parallel, message', [
    (["parallel.data=2", "parallel.model=2"],
     r"parallel\.data x parallel\.model = 4 exceeds the 1 visible devices"),
    (["parallel.data=2", "parallel.model=1", "parallel.frames_per_step=3"],
     r"parallel\.frames_per_step \(3\) must be a multiple of "
     r"parallel\.data \(2\)"),
    (["parallel.subjects=[{'seed': 0}, {'seed': 1}, {'seed': 2}]",
      "parallel.data=2"],
     r"subjects \(3\) must be divisible by parallel\.data \(2\)"),
    (["parallel.subjects=[{'seed': 0}, {'seed': 1}]", "parallel.data=1",
      "parallel.model=2"],
     r"shards subjects over 'data'; use model=1"),
    (["parallel.subjects=[{'seed': 0}, {'seed': 1}]", "parallel.data=2"],
     r"parallel\.data = 2 exceeds the 1 visible devices"),
])
def test_mesh_configurations_raise(tmp_path, monkeypatch, parallel, message):
    """The JAX driver's ValueErrors, and the world size's, with no process
    group."""
    for key in ('MASTER_ADDR', 'MASTER_PORT', 'RANK', 'WORLD_SIZE'):
        monkeypatch.delenv(key, raising=False)
    cfg = t_load_config(STEP_TINY + DRIVER + parallel
                        + [f"exp_dir={tmp_path}"])
    with pytest.raises(ValueError, match=message):
        ttrain.training(cfg, progress=False, device='cpu')


def test_main_needs_a_gpu_per_rank(tmp_path, monkeypatch):
    """`main` started plainly with D x M > 1 starts one rank per GPU: more
    ranks than GPUs (here one) raise before any starts."""
    monkeypatch.delenv('RANK', raising=False)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    with pytest.raises(ValueError, match=r"trains on 2 ranks, which exceeds "
                                         r"the 1 visible GPUs"):
        ttrain.main(STEP_TINY + DRIVER + [
            "parallel.data=2", "parallel.model=1", f"exp_dir={tmp_path}"])
