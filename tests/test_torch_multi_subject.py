"""Multi-subject training (`parallel.subjects`) of gsavatar_torch against
gsavatar's, on the CPU.

One multi-subject step of two tiny synthetic subjects (tests/
test_torch_train.py's shape; the subjects differ by `dataset.seed`, so in
canonical body, AABB, skinning pool, poses and ground truth): the JAX side
is `gsavatar/parallel/multi_subject.py:make_multi_subject_step` on its
stacked initial state, the single-subject step vmapped over the subject
axis, with the pairs route in interpret mode (K1, K2) at iteration 6000
(every delay gate open); the port's is `parallel/multi_subject.py:
make_multi_subject_step` on the S states `convert.unstack_state` takes from
the stacked one, with the JAX ground truth and each lane's own draws
(`torch_parity.jax_draws` on the lane's key). The driver tests are
port-only: a 2-subject run against the two single-subject runs, and the
configurations that raise.

Tolerances, and why:
* the subject constants, delta 0: the dataset's SMPL arrays, the
  skinning pool's weights and the converter's SMPL tables are copied from
  data; the AABB (exact already in tests/test_torch_math.py) and the
  pool's points, which it normalizes, are computed in f32 by the same
  separately rounded operations in both packages;
* per subject, the loss terms 1e-4 relative, the gradient leaves (both
  packages' Adam first moments) bench.py's gate and cosine > 0.999, the
  densify statistics' counts and radii exactly and their norms as a
  gradient leaf: tests/test_torch_train.py's tolerances;
* the multi-subject run against the single runs: bit for bit (the same
  frames, draws and operations on each subject's own state)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import (STEP_TINY, carry_state, close, grad_gate,
                          jax_conv_mu, jax_draws, to_np)

from gsavatar_torch import convert
from gsavatar_torch import train as ttrain
from gsavatar_torch.config import load_config as t_load_config
from gsavatar_torch.core.optim import FIELDS
from gsavatar_torch.parallel import multi_subject as tms_mod

from gsavatar.config import load_config as j_load_config
from gsavatar.parallel import multi_subject as jms_mod
from gsavatar.parallel.shard import stack_cameras
from gsavatar.train import loss_weights as j_loss_weights

ITERATION = 6000
SUBJECTS = [{'seed': 0}, {'seed': 1}]
FRAMES = (0, 1)   # each subject's camera in the step
# tests/test_multi_subject.py:18-41: a densify (iteration 4) and an opacity
# reset (iteration 5) inside 6 iterations
DRIVER = ["model.gaussian.delay=1", "opt.densify_from_iter=2",
          "opt.densification_interval=4", "opt.densify_until_iter=100",
          "opt.opacity_reset_interval=5", "opt.iterations=6",
          "test_interval=0", "seed=0"]
SUBJECTS_OV = f"parallel.subjects={SUBJECTS}"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _lane(tree, i):
    return jax.tree.map(lambda x: np.asarray(x)[i], tree)


@pytest.fixture(scope='module')
def ms():
    """Both packages' two subjects, and one multi-subject step of each from
    the same states, cameras and draws."""
    jcfg = j_load_config(overrides=["dataset=synthetic"] + STEP_TINY + [
        "rasterizer.backend=pallas_interpret", "rasterizer.chunk=32"])
    jcfg['parallel']['subjects'] = SUBJECTS
    jms = jms_mod.MultiSubjectScene(jcfg, seed=0)
    jstate = jms.init_states()
    before = _np(jstate)
    tms = tms_mod.MultiSubjectScene(
        t_load_config(STEP_TINY + [SUBJECTS_OV]), seed=0, device='cpu')
    tstates = tms.init_states()
    for i, (scene, state) in enumerate(zip(tms.scenes, tstates)):
        carry_state(scene, state, convert.unstack_state(before, i))

    jcams = [s.train_dataset[f] for s, f in zip(jms.scenes, FRAMES)]
    tcams = [s.train_dataset[f].replace(
        image=torch.from_numpy(np.asarray(jc.image)),
        mask=torch.from_numpy(np.asarray(jc.mask)))
        for s, f, jc in zip(tms.scenes, FRAMES, jcams)]
    n_alive = before.gauss_aux.alive.sum(axis=1)
    bucket = jms.bucket_for(int(n_alive.max()))
    buckets = [s.bucket_for(int(n)) for s, n in zip(tms.scenes, n_alive)]
    assert buckets == [bucket] * len(SUBJECTS)
    draws, rng_next = [], []
    for i, scene in enumerate(tms.scenes):
        r, (d,) = jax_draws(
            jstate.rng[i], tuple(jcams[i].rots.shape), scene.n_reg_pts,
            int(scene.skinning_pool_pts.shape[0]), scene.converter.pose_noise,
            scene.converter.view_noise)
        draws.append(d)
        rng_next.append(np.asarray(r))
    wj = dict(j_loss_weights(jcfg, ITERATION), _in_densify_window=1.0)
    wt = dict(ttrain.loss_weights(tms.cfg, ITERATION), _in_densify_window=1.0)
    xyz_lr = float(jms.scenes[0].xyz_lr_fn(ITERATION))
    assert xyz_lr == float(tms.scenes[1].xyz_lr_fn(ITERATION))

    j_step, _ = jms_mod.make_multi_subject_step(jms, None)
    jstate, jm = j_step(jstate, stack_cameras(jcams), jnp.int32(ITERATION),
                        wj, xyz_lr, active_sh_degree=0, bucket=bucket)
    assert np.array_equal(np.asarray(jstate.rng), np.stack(rng_next))
    tstates, tm = tms_mod.make_multi_subject_step(tms)(
        tstates, tcams, ITERATION, wt, active_sh_degree=0, buckets=buckets,
        draws=draws)
    jm = _np(jm)
    return {'jms': jms, 'tms': tms, 'before': before, 'j': _np(jstate),
            't': tstates,
            'jm': [{k: float(v[i]) for k, v in jm.items()}
                   for i in range(len(SUBJECTS))],
            'tm': [ttrain.host_metrics(m) for m in tm]}


def _subject_names(tree):
    """The leaves of a 'subject' collection under the port's buffer names."""
    key = lambda k: str(getattr(k, 'key', getattr(k, 'name', k)))
    return {'.'.join(key(k) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_subject_constants_match(ms):
    """Each port Scene's AABB, SMPL tables, skinning pool and converter
    constants against JAX's `ms.scenes[i]` and the stacked 'subject'
    collection's lane i."""
    pools = []
    for i, (js, ts) in enumerate(zip(ms['jms'].scenes, ms['tms'].scenes)):
        jmd, tmd = js.train_dataset.metadata, ts.train_dataset.metadata
        for f in ('coord_min', 'coord_max'):
            close(getattr(tmd['aabb'], f), getattr(jmd['aabb'], f), 0, 0, f)
        for k in ('smpl_verts', 'faces', 'skinning_weights', 'Jtr',
                  'bone_transforms_02v'):
            close(tmd[k], jmd[k], 0, 0, k)
        close(ts.skinning_pool_w, js.skinning_pool_w, 0, 0, 'pool w')
        close(ts.skinning_pool_pts, js.skinning_pool_pts, 0, 0, 'pool')
        pools.append(to_np(ts.skinning_pool_pts))
        want = _subject_names(_lane(ms['before'].conv_params['subject'], i))
        got = ts.converter.subject_constants()
        assert set(got) == set(want) and got
        for k, v in want.items():
            close(got[k], v, 0, 0, k)
    assert not np.array_equal(pools[0], pools[1])


def test_subject_losses_match(ms):
    for i, (jm, tm) in enumerate(zip(ms['jm'], ms['tm'])):
        for k, v in jm.items():
            if k.startswith(('loss/', 'psnr')):
                close(tm[k], v, 1e-4, 1e-9, f'subject {i} {k}')
            else:
                assert tm[k] == v, (i, k)
        assert tm['raster/n_pairs'] > 0 and tm['loss/perceptual_loss'] > 0
    # the subjects differ
    a, b = ms['tm']
    assert a['loss/total_loss'] != b['loss/total_loss']
    assert a['raster/n_pairs'] != b['raster/n_pairs']


def test_subject_gradients_match(ms):
    for i, ts in enumerate(ms['t']):
        ja = _lane(ms['j'], i)
        alive = ms['before'].gauss_aux.alive[i]
        for f in FIELDS:
            grad_gate(getattr(ts.gauss_adam.m, f)[alive],
                      getattr(ja.gauss_adam.m, f)[alive], f'{i} {f}')
        mu = jax_conv_mu(ja.conv_opt)
        assert set(mu) == set(ts.conv_opt.mu)
        for k, v in ts.conv_opt.mu.items():
            grad_gate(v, mu[k], f'{i} {k}')


def test_subject_densify_statistics_match(ms):
    for i, ts in enumerate(ms['t']):
        ja = _lane(ms['j'].gauss_aux, i)
        ta = ts.gauss_aux
        np.testing.assert_array_equal(ta.denom.numpy(), ja.denom)
        np.testing.assert_array_equal(ta.max_radii2d.numpy(),
                                      ja.max_radii2d)
        assert float(ta.denom.sum()) > 0
        grad_gate(ta.xyz_gradient_accum, ja.xyz_gradient_accum,
                  f'{i} xyz_gradient_accum')


def _arena(state):
    out = {}
    for part in ('gauss_params', 'gauss_aux'):
        out.update({f'{part}.{k}': v
                    for k, v in vars(getattr(state, part)).items()})
    for which in ('m', 'v'):
        out.update({f'adam.{which}.{k}': v for k, v in
                    vars(getattr(state.gauss_adam, which)).items()})
    out.update({f'conv.{k}': v.detach() for k, v in state.conv_params.items()})
    return out


def _same(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_subjects_equal_their_single_runs(tmp_path):
    """A 2-subject run of 6 iterations (densify at 4, reset at 5) against
    the single runs with `dataset.seed=i seed=i`: the logged losses,
    `densify/n_alive` and final arenas bit for bit, each subject's final
    checkpoint loading back bit for bit, and each mean row the mean of
    its subject rows."""
    cfg = t_load_config(STEP_TINY + DRIVER + [
        SUBJECTS_OV, f"exp_dir={tmp_path / 'ms'}"])
    ms, states, logger = ttrain.training(cfg, log_every=1, progress=False,
                                         device='cpu')
    assert isinstance(ms, tms_mod.MultiSubjectScene)
    rows = [r for r in logger.history if 'loss/total_loss' in r]
    assert [r['step'] for r in rows] == list(range(1, 7))
    densify = [r['densify/n_alive'] for r in logger.history
               if 'densify/n_alive' in r]
    assert len(densify) == 1
    losses = []
    for i in range(len(SUBJECTS)):
        single = t_load_config(STEP_TINY + DRIVER + [
            f"dataset.seed={i}", f"seed={i}", f"exp_dir={tmp_path / str(i)}"])
        _, state, slog = ttrain.training(single, log_every=1, progress=False,
                                         device='cpu')
        want = [r['loss/total_loss'] for r in slog.history
                if 'loss/total_loss' in r]
        assert [r[f'subject{i}/loss/total_loss'] for r in rows] == want
        losses.append(want)
        assert densify[0][i] == next(r['densify/n_alive'] for r in
                                     slog.history if 'densify/n_alive' in r)
        _same(_arena(states[i]), _arena(state))
        path = tmp_path / 'ms' / f'subject{i}' / 'ckpt6.pt'
        loaded, it = ms.scenes[i].load_checkpoint(str(path))
        assert it == 6
        _same(_arena(loaded), _arena(states[i]))
        assert torch.equal(loaded.generator.get_state(),
                           states[i].generator.get_state())
    assert losses[0] != losses[1]
    for r in rows:
        for k in ('loss/total_loss', 'psnr', 'n_alive', 'raster/n_pairs'):
            assert r[k] == float(np.mean([r[f'subject{i}/{k}']
                                          for i in range(len(SUBJECTS))]))


@pytest.mark.parametrize('parallel, message', [
    (["parallel.model=2"], r"shards subjects over 'data'; use model=1"),
    (["parallel.subjects=[{'seed': 0}, {'seed': 1}, {'seed': 2}]",
      "parallel.data=2"],
     r"subjects \(3\) must be divisible by parallel\.data \(2\)"),
    (["parallel.data=2"],
     r"parallel\.data = 2 exceeds the \d+ visible devices"),
    (["parallel.subjects=[{'seed': 0}, {'train_frames': [0, 3, 1]}]"],
     r"subject 1: train length 3 differs from subject 0's 2"),
])
def test_multi_subject_configurations_raise(tmp_path, parallel, message):
    cfg = t_load_config(STEP_TINY + DRIVER + [SUBJECTS_OV] + parallel
                        + [f"exp_dir={tmp_path}"])
    with pytest.raises(ValueError, match=message):
        ttrain.training(cfg, progress=False, device='cpu')


def test_empty_subjects_and_another_capacity_raise(tmp_path, monkeypatch):
    cfg = t_load_config(STEP_TINY + ["parallel.subjects=[]"])
    with pytest.raises(ValueError, match='non-empty list'):
        tms_mod.MultiSubjectScene(cfg, device='cpu')
    subject_cfg = tms_mod.subject_scene_cfg

    def capacity_of_subject_1(cfg, overrides):
        out = subject_cfg(cfg, overrides)
        if overrides.get('seed') == 1:
            out['model']['gaussian']['capacity'] = 2048
        return out

    monkeypatch.setattr(tms_mod, 'subject_scene_cfg', capacity_of_subject_1)
    cfg = t_load_config(STEP_TINY + [SUBJECTS_OV])
    with pytest.raises(ValueError,
                       match="subject 1: capacity 2048 differs from "
                             "subject 0's 1024"):
        tms_mod.MultiSubjectScene(cfg, device='cpu')
