"""B frames per optimizer step (`parallel.frames_per_step`) of
gsavatar_torch against gsavatar's, on the CPU.

One B = 2 step of the tiny avatar (tests/test_torch_train.py's shape) is
taken by both packages from the same state: the JAX side is
`gsavatar/parallel/shard.py:make_sharded_train_step` over a one-device
(data 1, model 1) mesh, built and first called inside its sharding scope,
with the pairs route in interpret mode (K1, K2) at iteration 6000 (every
delay gate open); the port's is `parallel/shard.py:make_batch_train_step`
on the JAX state (`convert`), the JAX ground truth and the JAX step's own
draws (`torch_parity.jax_draws` over two frame keys). The driver tests are
port-only: the B = 1 route against the plain route, the frames a B = 2 run
pops, and the configurations one device cannot run.

Tolerances, those of tests/test_torch_train.py, and why:
* the reduced metrics: the means (loss terms, PSNR, the mean loss) 1e-4
  relative, since the images agree to bench.py's render gates and not bit
  for bit; the sums (overflow counts) and the maxima (pair count, rect
  side) and `n_alive` exactly;
* gradient leaves, read from both packages' Adam first moments after the
  step (m = 0.1 g, for the converter of the clipped gradient plus the
  latent weight decay): bench.py's gate, mean error < 1e-3 of the largest
  value and cosine > 0.999;
* the densify statistics: the visible counts and the radii exactly, the
  gradient norms as a gradient leaf;
* the B = 1 route and the plain route: bit for bit (the same draws and
  operations)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import (STEP_TINY, close, grad_gate, jax_conv_mu,
                          jax_draws)

from gsavatar_torch import convert
from gsavatar_torch import train as ttrain
from gsavatar_torch.config import load_config as t_load_config
from gsavatar_torch.core.optim import FIELDS
from gsavatar_torch.parallel.shard import make_batch_train_step
from gsavatar_torch.scene import Scene as TScene

from gsavatar.config import load_config as j_load_config
from gsavatar.parallel.context import sharding_scope
from gsavatar.parallel.mesh import make_mesh
from gsavatar.parallel.shard import make_sharded_train_step, stack_cameras
from gsavatar.scene import Scene as JScene
from gsavatar.train import loss_weights as j_loss_weights

ITERATION = 6000   # past every delay gate: every module gets a gradient
B = 2
# tests/test_parallel_driver.py:22-49: a densify (iteration 4) and an
# opacity reset (iteration 5) inside 6 iterations
DRIVER = ["model.gaussian.delay=1", "opt.densify_from_iter=2",
          "opt.densification_interval=4", "opt.densify_until_iter=100",
          "opt.opacity_reset_interval=5", "opt.iterations=6",
          "test_interval=0", "seed=0"]
SUMS = ('overflow/pairs', 'overflow/tile', 'overflow/rect')
MAXIMA = ('raster/n_pairs', 'raster/max_rect_side')


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope='module')
def batch():
    """One B = 2 step of each package from the same state, frames and
    draws."""
    jcfg = j_load_config(overrides=["dataset=synthetic"] + STEP_TINY + [
        "rasterizer.backend=pallas_interpret", "rasterizer.chunk=32"])
    js = JScene(jcfg, seed=0)
    jstate = js.init_state()
    before = _np(jstate)
    ts = TScene(t_load_config(STEP_TINY), seed=0, device='cpu')
    tstate = ts.init_state()
    ts.converter.load_state_dict(convert.converter_state(
        before.conv_params['params']))
    tstate.gauss_params, tstate.gauss_aux = convert.arena(
        before.gauss_params, before.gauss_aux)
    tstate.gauss_adam = convert.arena_adam(before.gauss_adam)
    bucket = js.bucket_for(int(before.gauss_aux.alive.sum()))

    jcams = [js.train_dataset[i] for i in range(B)]
    tcams = [ts.train_dataset[i].replace(
        image=torch.from_numpy(np.asarray(jc.image)),
        mask=torch.from_numpy(np.asarray(jc.mask))) for i, jc in
        enumerate(jcams)]
    rng_next, draws = jax_draws(
        jstate.rng, tuple(jcams[0].rots.shape), ts.n_reg_pts,
        int(ts.skinning_pool_pts.shape[0]), ts.converter.pose_noise,
        ts.converter.view_noise, frames=B)
    wj = dict(j_loss_weights(jcfg, ITERATION), _in_densify_window=1.0)
    wt = dict(ttrain.loss_weights(ts.cfg, ITERATION), _in_densify_window=1.0)
    xyz_lr = float(js.xyz_lr_fn(ITERATION))

    mesh = make_mesh(1, data=1, model=1)
    with sharding_scope(mesh):
        j_step, place = make_sharded_train_step(js, mesh)
        jstate, jbatch = place(jstate, stack_cameras(jcams))
        jstate, jm = j_step(jstate, jbatch, jnp.int32(ITERATION), wj,
                            xyz_lr, active_sh_degree=0, bucket=bucket)
    assert np.array_equal(np.asarray(jstate.rng), np.asarray(rng_next))
    tstate, tm = make_batch_train_step(ts)(
        tstate, tcams, ITERATION, wt, xyz_lr, bucket=bucket, draws=draws)
    return {'before': before, 'j': _np(jstate), 't': tstate,
            'jm': {k: float(v) for k, v in jm.items()},
            'tm': ttrain.host_metrics(tm), 'tm_raw': tm}


def test_batch_metrics_match(batch):
    jm, tm = batch['jm'], batch['tm']
    assert set(tm) == set(jm)
    for k in jm:
        if k in SUMS + MAXIMA + ('n_alive',):
            assert tm[k] == jm[k], k
        else:
            close(tm[k], jm[k], 1e-4, 1e-9, k)
    assert tm['raster/n_pairs'] > 0 and tm['loss'] > 0
    assert tm['loss/perceptual_loss'] > 0 and tm['loss/loss_pose'] > 0


def test_batch_gradients_match(batch):
    """Every arena leaf and converter leaf: the port's Adam first moment
    against the JAX step's, at bench.py's gate."""
    alive = batch['before'].gauss_aux.alive
    ja, ta = batch['j'], batch['t']
    for f in FIELDS:
        grad_gate(getattr(ta.gauss_adam.m, f)[alive],
                  np.asarray(getattr(ja.gauss_adam.m, f))[alive], f)
        assert not getattr(ta.gauss_adam.m, f)[~alive].any(), f
    mu = jax_conv_mu(ja.conv_opt)
    assert set(mu) == set(ta.conv_opt.mu)
    for k, v in ta.conv_opt.mu.items():
        grad_gate(v, mu[k], k)
    assert ta.gauss_adam.step == int(ja.gauss_adam.step) == 1
    assert ta.conv_opt.count == 1


def test_batch_densify_statistics_match(batch):
    """Both frames' visible counts and radii, and the norms of their
    screen-space gradients scaled back by B."""
    ta, ja = batch['t'].gauss_aux, batch['j'].gauss_aux
    np.testing.assert_array_equal(ta.denom.numpy(), ja.denom)
    np.testing.assert_array_equal(ta.max_radii2d.numpy(), ja.max_radii2d)
    # a Gaussian seen in both frames counts twice
    assert float(ta.denom.max()) == B
    grad_gate(ta.xyz_gradient_accum, ja.xyz_gradient_accum,
              'xyz_gradient_accum')


def _tensors(state):
    out = {'generator': state.generator.get_state()}
    for part in ('gauss_params', 'gauss_aux'):
        out.update({f'{part}.{k}': v
                    for k, v in vars(getattr(state, part)).items()})
    for which in ('m', 'v'):
        out.update({f'adam.{which}.{k}': v for k, v in
                    vars(getattr(state.gauss_adam, which)).items()})
    out.update({f'conv.{k}': v.detach() for k, v in state.conv_params.items()})
    out.update({f'mu.{k}': v for k, v in state.conv_opt.mu.items()})
    out.update({f'nu.{k}': v for k, v in state.conv_opt.nu.items()})
    return out


def _driver(tmp_path, tag, extra=()):
    cfg = t_load_config(STEP_TINY + DRIVER + list(extra)
                        + [f"exp_dir={tmp_path / tag}"])
    _, state, logger = ttrain.training(cfg, log_every=1, progress=False,
                                       device='cpu')
    return state, logger


@pytest.fixture(scope='module')
def plain_run(tmp_path_factory):
    return _driver(tmp_path_factory.mktemp('plain'), 'plain')


@pytest.mark.parametrize('route', [
    ["parallel.data=1", "parallel.model=1"],
    # frames_per_step without data and model is ignored, as in JAX
    ["parallel.frames_per_step=2"]])
def test_one_frame_route_is_the_plain_route(plain_run, tmp_path, route):
    """6 iterations with a densify and a reset: the same logged losses,
    the same densify counts and the same final state, bit for bit."""
    state0, log0 = plain_run
    state1, log1 = _driver(tmp_path, 'b1', route)
    rows = lambda lg, key: {r['step']: r[key] for r in lg.history
                            if key in r}
    for key in ('loss/total_loss', 'psnr', 'n_alive', 'densify/n_alive'):
        assert rows(log1, key) == rows(log0, key), key
    assert len(rows(log0, 'loss/total_loss')) == 6
    assert rows(log0, 'densify/n_alive')
    want, got = _tensors(state0), _tensors(state1)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_frames_per_step_pops_the_jax_frames(batch, tmp_path, monkeypatch):
    """{data 1, model 1, frames_per_step 2} picks two frames per iteration
    in the order the JAX driver's sampler (`gsavatar/train.py:598-602`)
    pops them from default_rng(seed); its logged metrics are the keys of
    the JAX sharded step's output (no `compile/*`: nothing is compiled)."""
    picks = []
    device_camera = TScene.device_camera

    def recording(self, idx, split='train'):
        picks.append((idx, split))
        return device_camera(self, idx, split)

    monkeypatch.setattr(TScene, 'device_camera', recording)
    _, logger = _driver(tmp_path, 'b2', [
        "parallel.data=1", "parallel.model=1", "parallel.frames_per_step=2",
        "opt.iterations=4", "seed=3"])
    rng, stack, want = np.random.default_rng(3), [], []
    for _ in range(4 * B):
        if not stack:
            stack = list(range(2))
        want.append((stack.pop(int(rng.integers(len(stack)))), 'train'))
    assert picks == want
    rows = [r for r in logger.history if 'loss' in r]
    assert [r['step'] for r in rows] == [1, 2, 3, 4]
    for r in rows:
        assert set(r) - {'step', 'time', 'iter_time'} == set(batch['jm'])
    assert set(batch['tm_raw']) == set(batch['jm'])


@pytest.mark.parametrize('parallel, message', [
    (["parallel.data=2", "parallel.model=1", "parallel.frames_per_step=3"],
     r"parallel\.frames_per_step \(3\) must be a multiple of "
     r"parallel\.data \(2\)"),
    (["parallel.data=1", "parallel.model=2"],
     r"parallel\.data x parallel\.model = 2 exceeds the 1 visible devices"),
    (["parallel.data=2", "parallel.model=1"],
     r"parallel\.data x parallel\.model = 2 exceeds the 1 visible devices"),
])
def test_configurations_one_device_cannot_run_raise(tmp_path, parallel,
                                                    message):
    cfg = t_load_config(STEP_TINY + DRIVER + parallel
                        + [f"exp_dir={tmp_path}"])
    with pytest.raises(ValueError, match=message):
        ttrain.training(cfg, device='cpu')
