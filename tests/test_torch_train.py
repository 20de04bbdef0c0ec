"""One training step of gsavatar_torch against gsavatar's on the CPU.

The tiny synthetic avatar (the scene of tests/test_train_e2e.py) is built
by both packages from one config; the port takes the JAX scene's converter
weights, arena, neighbours and ground-truth images, and the JAX step's own
random draws, derived from its state's key exactly as
`gsavatar/train.py:make_step_core` and `models/converter.py` derive them.
JAX runs its rasterizer on the pairs route in interpret mode (K1, K2) and
its segment sums on the cumsum formulation. One jitted JAX step is built
once per module (its compile takes tens of seconds here).

Tolerances, and why:
* loss terms 1e-4 relative: the pair sort is unstable and the two
  transmittances differ in rounding, so the images agree to bench.py's
  render gates, not bit for bit;
* gradient leaves: bench.py's gate (mean error < 1e-3 of the largest value)
  and a cosine > 0.999, per leaf. The JAX step's gradients are read from
  its Adam first moments (after one step m = 0.1 g, for the converter of
  the clipped gradient plus the latent weight decay);
* parameters after the step: Adam's first update is lr * sign(g) wherever
  g is not zero, so an element whose tiny gradient flips sign moves by
  2 lr: the updates agree in cosine > 0.99 and in mean to 2e-2 lr;
* densify statistics: the visible counts and radii exactly, the gradient
  norms like a gradient leaf;
* the 3-step trajectory of the total loss 1e-3 relative."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import STEP_TINY as TINY
from torch_parity import (close, grad_gate, jax_conv_mu, jax_draws,
                          jax_named, to_np)

from gsavatar_torch import convert
from gsavatar_torch.config import load_config as t_load_config
from gsavatar_torch.core.optim import FIELDS
from gsavatar_torch.models.hashgrid import HashGrid as THashGrid
from gsavatar_torch.scene import Scene as TScene
from gsavatar_torch.scene import param_group
from gsavatar_torch.train import make_grad_fn, make_step_core
from gsavatar_torch.train import loss_weights as t_loss_weights
from gsavatar_torch.train import schedule_flags as t_schedule_flags

from gsavatar.config import load_config as j_load_config
from gsavatar.models.hashgrid import HashGrid as JHashGrid
from gsavatar.scene import Scene as JScene
from gsavatar.train import loss_weights as j_loss_weights
from gsavatar.train import make_step_core as j_make_step_core
from gsavatar.train import schedule_flags as j_schedule_flags

ITERATION = 6000   # past every delay gate: every module gets a gradient
STEPS = 3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope='module')
def run():
    """Both scenes, the port's gradients before the step, and STEPS steps
    of each package from the same state with the same draws."""
    jcfg = j_load_config(overrides=["dataset=synthetic"] + TINY + [
        "rasterizer.backend=pallas_interpret", "rasterizer.chunk=32"])
    js = JScene(jcfg, seed=0)
    jstate = js.init_state()
    tcfg = t_load_config(TINY)
    ts = TScene(tcfg, seed=0, device='cpu')
    tstate = ts.init_state()
    ts.converter.load_state_dict(
        convert.converter_state(_np(jstate.conv_params['params'])))
    tstate.gauss_params, tstate.gauss_aux = convert.arena(
        _np(jstate.gauss_params), _np(jstate.gauss_aux))
    tstate.gauss_adam = convert.arena_adam(_np(jstate.gauss_adam))

    bucket = js.bucket_for(int(np.sum(np.asarray(jstate.gauss_aux.alive))))
    assert bucket == ts.bucket_for(int(tstate.gauss_aux.alive.sum()))
    j_step = jax.jit(j_make_step_core(js),
                     static_argnames=('active_sh_degree', 'bucket'))
    cams = []
    for i in range(len(js.train_dataset)):
        jc = js.train_dataset[i]
        cams.append((jc, ts.train_dataset[i].replace(
            image=torch.from_numpy(np.asarray(jc.image)),
            mask=torch.from_numpy(np.asarray(jc.mask)))))
    out = {'js': js, 'ts': ts, 'bucket': bucket, 'cams': cams,
           'before': {'j': _np(jstate), 't': _snapshot(tstate)},
           'j_metrics': [], 't_metrics': [], 'draws': []}
    t_step = make_step_core(ts)
    rng = jstate.rng
    for s in range(STEPS):
        it = ITERATION + s
        jc, tc = cams[s % len(cams)]
        rng_next, (draws,) = jax_draws(
            rng, tuple(jc.rots.shape), ts.n_reg_pts,
            int(ts.skinning_pool_pts.shape[0]), ts.converter.pose_noise,
            ts.converter.view_noise)
        wj = j_loss_weights(jcfg, it)
        wj['_in_densify_window'] = 1.0
        wt = dict(t_loss_weights(tcfg, it), _in_densify_window=1.0)
        xyz_lr = float(js.xyz_lr_fn(it))
        if s == 0:
            _, _, out['t_grads'] = make_grad_fn(ts)(
                tstate, tc, it, wt, draws, 0, bucket, ts.raster_config)
        jstate, jm = j_step(jstate, jc, jnp.int32(it), wj, xyz_lr,
                            active_sh_degree=0, bucket=bucket)
        tstate, tm = t_step(tstate, tc, it, wt, xyz_lr, bucket=bucket,
                            draws=draws)
        assert np.array_equal(np.asarray(jstate.rng), np.asarray(rng_next))
        rng = rng_next
        out['j_metrics'].append({k: float(v) for k, v in jm.items()})
        out['t_metrics'].append({k: float(v) for k, v in tm.items()})
        if s == 0:
            out['after'] = {'j': _np(jstate), 't': _snapshot(tstate)}
    return out


def _snapshot(state):
    """Copies of a port state's tensors (the step updates in place)."""
    c = lambda x: x.detach().clone()
    return dataclasses.replace(
        state, gauss_params=state.gauss_params.map(c),
        gauss_aux=state.gauss_aux.map(c),
        gauss_adam=dataclasses.replace(
            state.gauss_adam, m=state.gauss_adam.m.map(c),
            v=state.gauss_adam.v.map(c)),
        conv_params={k: c(v) for k, v in state.conv_params.items()},
        conv_opt=dataclasses.replace(
            state.conv_opt, mu={k: c(v) for k, v in state.conv_opt.mu.items()},
            nu={k: c(v) for k, v in state.conv_opt.nu.items()}))


def test_loss_terms_match(run):
    jm, tm = run['j_metrics'][0], run['t_metrics'][0]
    terms = [k for k in jm if k.startswith('loss/')]
    assert set(terms) <= set(tm)
    for k in terms:
        close(tm[k], jm[k], 1e-4, 1e-9, k)
    assert tm['raster/n_pairs'] > 0
    assert tm['overflow/pairs'] == jm['overflow/pairs'] == 0
    assert tm['raster/max_rect_side'] == jm['raster/max_rect_side']
    assert tm['loss/perceptual_loss'] > 0 and tm['loss/loss_pose'] > 0


def test_arena_gradients_match(run):
    """Every arena leaf: the port's gradient against the JAX step's, read
    from its first moment (m = 0.1 g on alive slots)."""
    alive = run['before']['j'].gauss_aux.alive
    for f in FIELDS:
        want = np.asarray(getattr(run['after']['j'].gauss_adam.m, f)) / 0.1
        got = to_np(getattr(run['t_grads']['gauss'], f))
        grad_gate(got[alive], want[alive], f)
        assert not got[~alive].any(), f


def test_converter_gradients_match(run):
    """Every converter leaf, clipped as the optimizer clips it (the global
    norm counts the frozen subject constants' gradients too): the JAX first
    moment is 0.1 (clip(g) + wd p)."""
    ts, g = run['ts'], run['t_grads']
    every = list(g['conv'].values()) + list(g['subject'].values())
    clip = min(1.0, 0.1 / float(torch.sqrt(sum((x * x).sum()
                                               for x in every))))
    mu = jax_conv_mu(run['after']['j'].conv_opt)
    p0 = jax_named(run['before']['j'].conv_params)
    assert set(mu) == set(g['conv'])
    for k, got in g['conv'].items():
        wd = ts.conv_tx.wd[param_group(k)]
        grad_gate(to_np(got) * clip, mu[k] / 0.1 - wd * p0[k], k)


def _update_gate(dt, dj, g, lr, name):
    """Parameter updates of one leaf: where the JAX gradient is clearly not
    zero (> 1e-3 of the leaf's largest) both took the same step to 1e-3 lr;
    elsewhere the gradient may be rounding noise, whose sign Adam's first
    step turns into +-lr, so only the mean over all elements is held, to
    0.1 lr (at most a twentieth of them flipped)."""
    dt, dj, g = (np.asarray(x, np.float64).ravel() for x in (dt, dj, g))
    if not np.abs(g).max() > 0:
        assert not np.abs(dt).max() > 0, name
        return
    clear = np.abs(g) > 1e-3 * np.abs(g).max()
    assert np.abs(dt - dj)[clear].max() <= 1e-3 * lr, name
    assert np.abs(dt - dj).mean() <= 0.1 * lr, name


def test_parameters_and_optimizer_states_after_the_step(run):
    alive = run['before']['j'].gauss_aux.alive
    lrs = dict(run['ts'].gauss_lrs(ITERATION),
               xyz=float(run['js'].xyz_lr_fn(ITERATION)))
    tb, ta = run['before']['t'], run['after']['t']
    jb, ja = run['before']['j'], run['after']['j']
    for f in FIELDS:
        dt = to_np(getattr(ta.gauss_params, f) - getattr(tb.gauss_params, f))
        dj = np.asarray(getattr(ja.gauss_params, f)) \
            - np.asarray(getattr(jb.gauss_params, f))
        g = np.asarray(getattr(ja.gauss_adam.m, f)) / 0.1
        _update_gate(dt[alive], dj[alive], g[alive], lrs[f], f)
        assert not dt[~alive].any()
        grad_gate(getattr(ta.gauss_adam.m, f)[alive],
              np.asarray(getattr(ja.gauss_adam.m, f))[alive], f'm/{f}')
        grad_gate(getattr(ta.gauss_adam.v, f)[alive],
              np.asarray(getattr(ja.gauss_adam.v, f))[alive], f'v/{f}')
    assert ta.gauss_adam.step == int(ja.gauss_adam.step) == 1
    assert ta.conv_opt.count == 1
    pa, pb = jax_named(ja.conv_params), jax_named(jb.conv_params)
    mu = jax_conv_mu(ja.conv_opt)
    conv_tx = run['ts'].conv_tx
    for k in ta.conv_params:
        dt = to_np(ta.conv_params[k] - tb.conv_params[k])
        _update_gate(dt, pa[k] - pb[k], mu[k], conv_tx.lr[param_group(k)], k)
        grad_gate(ta.conv_opt.mu[k], mu[k], f'mu/{k}')
        grad_gate(ta.conv_opt.nu[k], (conv_tx.wd[param_group(k)] * pb[k]
                                  + mu[k] / 0.1 - conv_tx.wd[
                                      param_group(k)] * pb[k]) ** 2 * 1e-3,
              f'nu/{k}')


def test_densify_statistics_match(run):
    ta, ja = run['after']['t'].gauss_aux, run['after']['j'].gauss_aux
    np.testing.assert_array_equal(to_np(ta.denom), np.asarray(ja.denom))
    np.testing.assert_array_equal(to_np(ta.max_radii2d),
                                  np.asarray(ja.max_radii2d))
    assert float(ta.denom.sum()) > 0
    grad_gate(ta.xyz_gradient_accum, ja.xyz_gradient_accum,
              'xyz_gradient_accum')


def test_three_step_trajectory(run):
    for s, (jm, tm) in enumerate(zip(run['j_metrics'], run['t_metrics'])):
        close(tm['loss/total_loss'], jm['loss/total_loss'], 1e-3, 0,
              f'step {s}')


def test_ground_truth_render_matches_jax():
    """The port renders the hidden target on its pairs route, the JAX
    package on its dense XLA route: bench.py's render gates on the image,
    and at most a 1e-3 fraction of mask pixels on the other side of the
    0.5 alpha cut. At 128x128 the dense route's 256-splat tile capacity
    holds the target (at 64x64 its central tiles overflow)."""
    from torch_parity import assert_render_gates
    from gsavatar.data.synthetic import SyntheticDataset as JSynthetic
    from gsavatar_torch.data.synthetic import SyntheticDataset as TSynthetic
    ov = ["dataset.img_hw=[128,128]", "dataset.n_verts=512",
          "dataset.n_target_gaussians=512", "dataset.train_frames=[0,2,1]",
          "dataset.train_views=['0']"]
    jd = JSynthetic(j_load_config(overrides=["dataset=synthetic"] + ov)
                    .dataset, 'train')
    td = TSynthetic(t_load_config(ov)['dataset'], 'train', gt_device='cpu')
    for i in range(len(jd)):
        jc, tc = jd[i], td[i]
        assert_render_gates(to_np(tc.image), np.asarray(jc.image), 'image')
        assert (to_np(tc.mask) != np.asarray(jc.mask)).mean() < 1e-3
        assert float(tc.mask.mean()) > 0.01


def test_param_groups_cover_the_jax_tree(run):
    """Every JAX converter parameter has a port parameter of the same shape,
    and the optimizer groups follow the JAX label rules: the top module,
    with the latent tables apart."""
    jax_params = jax_named(run['before']['j'].conv_params)
    port = run['ts'].converter.state_dict()
    assert set(jax_params) == set(dict(run['ts'].converter.named_parameters()))
    for k, v in jax_params.items():
        assert tuple(port[k].shape) == v.shape, k
    want = {'rigid.lbs_network.lin0.weight': 'rigid',
            'non_rigid.hashgrid.table': 'non_rigid',
            'non_rigid.pose_encoder.layer_0.weight': 'non_rigid',
            'texture.latent.weight': 'tex_latent',
            'texture.mlp.lin0.weight': 'texture',
            'pose_correction.betas': 'pose_correction'}
    for k, g in want.items():
        assert k in port and param_group(k) == g, k


def test_loss_weights_and_schedule_flags():
    jcfg = j_load_config(overrides=["dataset=synthetic"])
    tcfg = t_load_config()
    for it in (0, 999, 1000, 3000, 6000):
        assert t_loss_weights(tcfg, it) == j_loss_weights(jcfg, it)
    kw = dict(densify_until=10000, densify_from=500, densify_interval=100,
              opacity_reset_interval=3000, gauss_delay=1000, white_bg=True)
    for it in (500, 1000, 1100, 3000, 6000, 10000):
        assert t_schedule_flags(it, **kw) == j_schedule_flags(it, **kw)


def test_hashgrid_table_gradient_f32():
    """The table gradient through `_HashGather`, an f32 segment sum (K3's
    plain version), against the JAX custom VJP (its cumsum formulation):
    within 1e-5 of the largest entry."""
    rng = np.random.default_rng(3)
    x = rng.uniform(-1.05, 1.05, (300, 3)).astype(np.float32)
    table = rng.uniform(-0.05, 0.05, (6, 1 << 12, 2)).astype(np.float32)
    ct = rng.normal(size=(300, 12)).astype(np.float32)
    jm = JHashGrid(n_levels=6, log2_hashmap_size=12, base_resolution=4,
                   max_resolution=256)
    _, vjp = jax.vjp(lambda t: jm.apply({'params': {'table': t}},
                                        jnp.asarray(x)), jnp.asarray(table))
    (want,) = vjp(jnp.asarray(ct))
    tm = THashGrid(n_levels=6, log2_hashmap_size=12, base_resolution=4,
                   max_resolution=256)
    tm.load_state_dict({'table': torch.from_numpy(table)})
    out = tm(torch.from_numpy(x))
    (got,) = torch.autograd.grad(out, tm.table, torch.from_numpy(ct))
    assert got.dtype == torch.float32 and got.shape == table.shape
    scale = float(np.abs(want).max())
    close(got, want, 0, 1e-5 * scale)
    assert np.abs(to_np(got)).max() > 0
