"""The ('data', 'model') mesh of gsavatar_torch over gloo ranks on the CPU.

Each test starts its ranks with `torch.multiprocessing.spawn` on a free
localhost port (tests/torch_dist_workers.py, which imports no JAX; each
spawn has its own timeout) and reads their results as files. The JAX side
of a comparison runs in this process.

* `initialize_distributed` from torchrun's environment variables alone on
  four ranks (the port's counterpart of tests/test_distributed.py:139):
  the group, the 2 x 2 mesh `make_mesh` factors, a sum over each axis and
  a broadcast;
* the sharded compositor on a 1 x 2 mesh, forward and VJP, against JAX's
  `make_composite_pairs_sharded` on a (1, 2) mesh (interpret mode) at
  tests/test_torch_raster.py's tolerances (K1 3e-5 absolute, K2 1e-4 of
  the largest |value| of the same column in the same tile), and against
  the port's whole-grid compositor bit for bit (each element has one
  writer, so the sums over the ranks are exact);
* `training` with `{data: 2, model: 1}`, `{data: 1, model: 2}` (B = 2) and
  `{data: 2, model: 2}` (B = 4) for 3 iterations with a densify at 2,
  against the one-process B-frame route (which tests/
  test_torch_frames_per_step.py holds to JAX's sharded step). Every rank's
  state equals rank 0's bit for bit, and only rank 0 writes. The loss terms
  and the reduced metrics agree to 1e-6 relative (the counts exactly), and
  every state tensor to 1e-5 of its largest |value| on the mean of its
  elements' differences; integer and boolean tensors exactly. The data
  sum adds the ranks' gradients, where autograd adds the frames' in its
  own order, so the arena's Adam steps may differ where a gradient is
  rounding noise: at the isotropic initial Gaussians the rotation's
  gradient is zero but for rounding, and Adam steps by its learning rate
  in the direction of its sign. A few percent of the rotation elements
  then differ by up to 1.5 learning rates, and the largest elementwise
  difference is 1.5e-3 of the largest rotation (the model axis alone
  changes no sum: that route is bit-equal);
* four subjects on two data ranks against the one-process multi-subject
  route: each subject's state, the logged rows and the checkpoints bit for
  bit."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as workers
from torch_parity import (GRID, PAIR_CHUNK, TILES, close, grid_pairs,
                          padded_pairs, tile_column_scale)

from gsavatar_torch.ops.rasterizer.composite import (
    composite_pairs_bwd, composite_pairs_fwd)

from gsavatar.ops.rasterizer.pallas_composite import \
    make_composite_pairs_sharded as j_sharded
from gsavatar.parallel import mesh as jmesh


def _results(out, world):
    return [torch.load(os.path.join(out, f'rank{r}.pt'))
            for r in range(world)]


def test_initialize_from_environment(tmp_path):
    workers.spawn('collectives', 4, tmp_path, env=True)
    for rank, got in enumerate(_results(tmp_path, 4)):
        d, m = divmod(rank, 2)
        assert got['backend'] == 'gloo' and got['world'] == 4
        assert got['shape'] == {'data': 2, 'model': 2}
        assert got['coords'] == {'data': d, 'model': m}
        # ranks m and 2 + m sum over data, 2d and 2d + 1 over model
        assert got['data_sum'] == (m + 1) + (2 + m + 1)
        assert got['model_sum'] == (2 * d + 1) + (2 * d + 2)
        assert got['from_last'] == 4.0 and got['bytes'] == b'rank 1'
        assert got['mismatch'] == ("parallel.data x parallel.model = 1 does "
                                   "not match the 4 ranks of the process "
                                   "group")


def test_sharded_composite_matches_jax(tmp_path):
    pair_data, tile_start, ct = grid_pairs()
    P = pair_data.shape[0]
    inputs = tmp_path / 'inputs.pt'
    torch.save({'pair_data': pair_data, 'tile_start': tile_start, 'ct': ct,
                'num_tiles': TILES, 'grid_x': GRID}, inputs)
    workers.spawn('sharded_composite', 2, tmp_path, args=(str(inputs),))

    f = j_sharded(TILES, GRID, jmesh.make_mesh(2, data=1, model=2),
                  chunk=PAIR_CHUNK, interpret=True)
    ts = jnp.asarray(tile_start.numpy())
    want, vjp = jax.vjp(lambda p: f(p, ts), padded_pairs(pair_data))
    want = np.asarray(want)
    want_g = np.asarray(vjp(jnp.asarray(ct.numpy()))[0])[:P, :12]

    whole = composite_pairs_fwd(pair_data, tile_start, GRID)
    whole_g = composite_pairs_bwd(pair_data, tile_start, ct, whole, GRID)
    for got in _results(tmp_path, 2):
        close(got['out'], want, 0, 3e-5, 'forward')
        scale = tile_column_scale(want_g, tile_start.numpy())
        np.testing.assert_array_less(
            np.abs(got['grad'].numpy() - want_g), 1e-4 * scale + 1e-30)
        assert torch.equal(got['out'], whole)
        assert torch.equal(got['grad'], whole_g)


def _one_process(tmp_path, frames):
    out = tmp_path / 'one'
    out.mkdir()
    workers.train_run(0, 1, str(out), [
        "parallel.data=1", "parallel.model=1",
        f"parallel.frames_per_step={frames}"])
    return torch.load(out / 'rank0.pt')


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


@pytest.mark.parametrize('data, model, frames',
                         [(2, 1, 2), (1, 2, 2), (2, 2, 4)])
def test_training_on_ranks_matches_one_process(tmp_path, data, model,
                                                frames):
    world = data * model
    workers.spawn('train_run', world, tmp_path, args=([
        f"parallel.data={data}", f"parallel.model={model}",
        f"parallel.frames_per_step={frames}"],))
    ranks = _results(tmp_path, world)
    want = _one_process(tmp_path, frames)

    first = ranks[0]['state']
    for r in ranks[1:]:
        assert set(r['state']) == set(first)
        for k, v in r['state'].items():
            assert torch.equal(v, first[k]), k
    assert [r['history'] is None for r in ranks] == [False] + [True] * (
        world - 1)
    assert sorted(os.listdir(tmp_path / 'exp0')) == ['ckpt3.pt',
                                                     'metrics.jsonl']
    for r in range(1, world):
        assert not (tmp_path / f'exp{r}').exists()

    # the reduced metrics of each step: the counts exactly, the rest 1e-6
    assert len(ranks[0]['steps']) == len(want['steps']) == 3
    for got_m, want_m in zip(ranks[0]['steps'], want['steps']):
        assert set(got_m) == set(want_m)
        for k, v in want_m.items():
            if k.startswith(('overflow/', 'raster/')) or k == 'n_alive':
                assert got_m[k] == v, k
            else:
                assert _rel(got_m[k], v) < 1e-6, (k, got_m[k], v)
    rows = lambda h: [{k: v for k, v in r.items()
                       if k not in ('time', 'iter_time')} for r in h]
    got_rows, want_rows = rows(ranks[0]['history']), rows(want['history'])
    assert [r['step'] for r in got_rows] == [r['step'] for r in want_rows]
    densify = [r for r in got_rows if 'densify/n_alive' in r]
    assert densify == [r for r in want_rows if 'densify/n_alive' in r]
    assert [r['step'] for r in densify] == [2]

    state, want_state = first, want['state']
    assert set(state) == set(want_state)
    for k, v in want_state.items():
        got = state[k]
        assert got.dtype == v.dtype, k
        if not v.dtype.is_floating_point:
            assert torch.equal(got, v), k
            continue
        scale = float(v.abs().max())
        err = float((got.double() - v.double()).abs().mean())
        assert err <= 1e-5 * scale, (k, err, scale)


def test_subjects_on_two_data_ranks(tmp_path):
    """Four subjects, two on each data rank, for 3 iterations (densify at
    2): each subject's final state, rank 0's logged rows and the four
    checkpoints (two written from rank 1's bytes) bit for bit against the
    one-process multi-subject run."""
    subjects = ["parallel.subjects=[{'seed': 0}, {'seed': 1}, {'seed': 2}, "
                "{'seed': 3}]"]
    workers.spawn('subjects_run', 2, tmp_path,
                  args=(subjects + ["parallel.data=2"],))
    ranks = _results(tmp_path, 2)
    one = tmp_path / 'one'
    one.mkdir()
    workers.subjects_run(0, 1, str(one), subjects)
    want = torch.load(one / 'rank0.pt')

    assert sorted(ranks[0]['states']) == [0, 1]
    assert sorted(ranks[1]['states']) == [2, 3]
    for r in ranks:
        for i, state in r['states'].items():
            for k, v in want['states'][i].items():
                assert torch.equal(state[k], v), (i, k)
    rows = lambda h: [{k: v for k, v in r.items()
                       if k not in ('time', 'iter_time')} for r in h]
    assert rows(ranks[0]['history']) == rows(want['history'])
    assert ranks[1]['history'] is None
    assert not (tmp_path / 'exp1').exists()
    for i in range(4):
        got = torch.load(tmp_path / 'exp0' / f'subject{i}' / 'ckpt3.pt')
        ref = torch.load(one / 'exp0' / f'subject{i}' / 'ckpt3.pt')
        for part in ('gauss_params', 'gauss_aux'):
            for k, v in ref[part].items():
                assert torch.equal(got[part][k], v), (i, part, k)
        for k, v in ref['converter'].items():
            assert torch.equal(got['converter'][k], v), (i, k)
        assert torch.equal(got['generator'], ref['generator'])
