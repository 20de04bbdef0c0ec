"""The port's training driver, checkpoints, PLY export, evaluation and
prediction under each model variant, on the CPU at the tiny avatar's
shape (64x64, 768 Gaussians in 1024 slots).

For every variant of chip_smoke.py's phase 12 (its widths cut as in
tests/torch_variant_case.py): `train.training` for three iterations with a
validation at 2 and a checkpoint and PLY at 3; the logged metric keys are
the JAX package's for the variant (its fixed keys and one
`loss/loss_<name>` per regularizer the converter returns: none from the
identity deformer or without pose correction, as
gsavatar/models/non_rigid.py and pose_correction.py return none); the
checkpoint loads back bit for bit; `evaluate.predict` scores it on the
test split. For the SH avatar, the PLY holds the 45 `f_rest_*` columns,
reads back bit for bit, and has the bytes the JAX package's
`save_arena_ply` writes for the same arena."""
import dataclasses

import numpy as np
import pytest
import torch

from torch_parity import TINY
from torch_variant_case import VARIANTS

from gsavatar_torch import train as ttrain
from gsavatar_torch.config import load_config
from gsavatar_torch.evaluate import predict
from gsavatar_torch.utils import ply as tply

ITERATIONS = 3
DRIVER = ["dataset.n_target_gaussians=512", "opt.skinning_pool_size=2048",
          "opt.n_reg_pts=128", "model.gaussian.delay=0",
          f"opt.iterations={ITERATIONS}", "test_interval=2",
          "max_val_frames=1", f"checkpoint_iterations=[{ITERATIONS}]",
          f"save_iterations=[{ITERATIONS}]", "seed=0"]
FIXED_KEYS = {'loss/l1_loss', 'loss/ssim_loss', 'loss/mask_loss',
              'loss/loss_skinning', 'loss/xyz_aiap_loss',
              'loss/cov_aiap_loss', 'loss/opacity_loss',
              'loss/perceptual_loss', 'loss/total_loss', 'psnr',
              'overflow/pairs', 'overflow/tile', 'overflow/rect',
              'raster/n_pairs', 'raster/max_rect_side'}


def _reg_keys(cfg):
    model = cfg['model']
    keys = set()
    if model['pose_correction']['name'] != 'none':
        keys.add('loss/loss_pose')
    if model['deformer']['non_rigid']['name'] != 'identity':
        keys |= {'loss/loss_nr_xyz', 'loss/loss_nr_scale',
                 'loss/loss_nr_rot'}
    return keys


def _tensors(state):
    out = {}
    for part in ('gauss_params', 'gauss_aux'):
        for f in dataclasses.fields(getattr(state, part)):
            out[f'{part}.{f.name}'] = getattr(getattr(state, part), f.name)
    for which in ('m', 'v'):
        for f in dataclasses.fields(state.gauss_adam.m):
            out[f'adam.{which}.{f.name}'] = getattr(
                getattr(state.gauss_adam, which), f.name)
    out.update({f'conv.{k}': v.detach() for k, v in state.conv_params.items()})
    out.update({f'mu.{k}': v for k, v in state.conv_opt.mu.items()})
    out.update({f'nu.{k}': v for k, v in state.conv_opt.nu.items()})
    return out


@pytest.mark.parametrize('variant', sorted(VARIANTS))
def test_variant_training_checkpoint_and_predict(variant, tmp_path):
    cfg = load_config(TINY + DRIVER + VARIANTS[variant]
                      + [f"exp_dir={tmp_path}"])
    scene, state, logger = ttrain.training(cfg, log_every=1, progress=False,
                                           device='cpu')
    steps = [r for r in logger.history if 'loss/total_loss' in r]
    assert [r['step'] for r in steps] == list(range(1, ITERATIONS + 1))
    want = FIXED_KEYS | _reg_keys(cfg)
    for r in steps:
        assert set(k for k in r if k.startswith(('loss/', 'overflow/',
                                                 'raster/', 'psnr'))) \
            == want, variant
        assert np.isfinite(r['loss/total_loss'])
    assert any('val/test_psnr' in r for r in logger.history)
    assert state.conv_opt.count == ITERATIONS

    back, it = scene.load_checkpoint(str(tmp_path / f'ckpt{ITERATIONS}.pt'))
    assert it == ITERATIONS
    a, b = _tensors(back), _tensors(state)
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k

    res = predict(dict(cfg, mode='test',
                       load_ckpt=str(tmp_path / f'ckpt{ITERATIONS}.pt')),
                  device='cpu')
    assert np.isfinite(res['psnr']) and res['time_ms'] > 0


def test_sh_avatar_ply_round_trip(tmp_path):
    """The SH avatar's PLY: 3 f_dc and 45 f_rest columns per Gaussian, read
    back bit for bit, and the JAX writer's bytes for the same arena."""
    from gsavatar.core import gaussians as JG
    from gsavatar.utils import ply as jply
    import jax.numpy as jnp
    cfg = load_config(TINY + DRIVER + VARIANTS['v_hannw_sh']
                      + [f"exp_dir={tmp_path}", "test_interval=0"])
    _, state, _ = ttrain.training(cfg, log_every=1, progress=False,
                                  device='cpu')
    path = tmp_path / 'point_cloud' / f'iteration_{ITERATIONS}' \
        / 'point_cloud.ply'
    back = tply.load_gaussian_ply(str(path), 3)
    params, aux = state.gauss_params, state.gauss_aux
    alive = aux.alive.numpy()
    assert back['features_rest'].shape == (int(alive.sum()), 15, 3)
    assert back['features_dc'].shape == (int(alive.sum()), 1, 3)
    for f in ('xyz', 'features_dc', 'features_rest', 'opacity', 'scaling',
              'rotation'):
        assert np.array_equal(back[f], getattr(params, f).numpy()[alive]), f
    header = path.read_bytes().split(b'end_header')[0]
    assert header.count(b'f_rest_') == 45 and header.count(b'f_dc_') == 3
    jp = JG.GaussianParams(**{f: jnp.asarray(getattr(params, f).numpy())
                              for f in ('xyz', 'features_dc',
                                        'features_rest', 'scaling',
                                        'rotation', 'opacity')})
    ja = JG.empty_aux(alive.shape[0]).replace(alive=jnp.asarray(alive))
    jply.save_arena_ply(str(tmp_path / 'j.ply'), jp, ja)
    assert (tmp_path / 'j.ply').read_bytes() == path.read_bytes()
