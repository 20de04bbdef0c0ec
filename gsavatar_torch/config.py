"""The port's configuration as a plain Python dict.

Counterpart of `gsavatar/config/config.py` for what the render path, the
training driver and the evaluation read. The root config
(`configs/config.yaml`) and the choices of each config group
(`configs/<group>/<choice>.yaml`) are written out here as dicts, so that
the port needs no YAML parser; `load_config` composes them as the JAX
`load_config` does: the root, then one choice of each group in the order
dataset, pose_correction, texture, rigid, non_rigid, option (a `group=choice`
override, else `DEFAULT_GROUPS`), then the `dotted.key=value` overrides,
then the `${...}` interpolations. Override values are read as Python
literals (`[540,540]`, `['0']`, `0.1`) or the words `true`/`false`/`null`.

Every choice of the JAX package's groups is admitted: `pose_correction=
direct|none`, `texture=shallow_mlp|mlp|sh`, `rigid=skinning_field|smpl_nn|
identity`, `non_rigid=hashgrid|mlp|hannw_mlp|identity` and `option=iter15k|
iter30k|iter40k|iter50k|no_mask|no_val|test_all`. The dataset group may
name `synthetic` (the port's default, where the JAX package's is
`zjumocap_377_mono`) or one of the real subjects of `DATASETS`
(`zjumocap_*_mono`, `ps_*`): the root config's dataset keys merged with that
subject's, its `dataset_name`, and its other blocks (the `opt:` of
`ps_female_3`). An unknown choice raises. Keys that the JAX package reads
with a default in its code rather than from its yaml
(`opt.bucket_granularity`, `log_every`, `max_val_frames`,
`strict_overflow`) are here at that default. `parallel.frames_per_step`
and `parallel.subjects` (a list of dataset overrides, one per subject),
which the JAX package reads with `get` and its yaml leaves out, stay
absent unless an override sets them (`parallel.frames_per_step=2`,
`"parallel.subjects=[{'seed': 0}, {'seed': 1}]"`)."""
from __future__ import annotations

import ast
import copy
import re
from typing import Iterable, Optional

# configs/config.yaml: the root config without its group defaults (the
# keys the port reads), and the keys that the JAX package reads with a
# default in its code
ROOT = {
    'model': {
        'gaussian': {'use_sh': True, 'sh_degree': 3, 'delay': 1000,
                     'capacity': 262144},
        'pose_correction': {'name': 'direct'},
        'deformer': {'rigid': {'name': 'identity'},
                     'non_rigid': {'name': 'identity'}},
    },
    'opt': {
        'iterations': 60000,
        'grad_clip': 0.1,
        'position_lr_init': 0.00016,
        'position_lr_final': 1.6e-06,
        'position_lr_delay_mult': 0.01,
        'position_lr_max_steps': 30000,
        'feature_lr': 0.0025,
        'opacity_lr': 0.05,
        'scaling_lr': 0.005,
        'rotation_lr': 0.001,
        'pose_correction_lr': 0.0001,
        'rigid_lr': 0.0001,
        'non_rigid_lr': 0.001,
        'lr_ratio': 0.01,
        'lambda_l1': 1.0,
        'lambda_dssim': 0.0,
        'lambda_perceptual': 0.01,
        'mask_loss_type': 'l1',
        'lambda_mask': 0.1,
        'lambda_opacity': 0.0,
        'lambda_skinning': [10, 1000, 0.1],
        'lambda_pose': 0.0,
        'lambda_aiap_xyz': 1.0,
        'lambda_aiap_cov': 100.0,
        'percent_dense': 0.01,
        'densification_interval': 100,
        'opacity_reset_interval': 3000,
        'densify_from_iter': 500,
        'densify_until_iter': 45000,
        'densify_grad_threshold': 0.0002,
        'opacity_threshold': 0.05,
        'n_reg_pts': 1024,
        'skinning_pool_size': 65536,
        'bucket_granularity': 4096,
    },
    'pipeline': {'pose_noise': 0.1},
    'rasterizer': {'max_pairs': 2097152, 'max_rect': 8},
    'parallel': {'data': 0, 'model': 0},
    'name': '${dataset_name}-${pose_name}-${rigid_name}-${non_rigid_name}-'
            '${texture_name}-${tag}',
    'tag': 'default',
    'seed': -1,
    'mode': 'train',
    'exp_dir': None,
    'log_every': 10,
    'test_interval': 2000,
    'test_iterations': [],
    'save_iterations': [30000],
    'checkpoint_iterations': [],
    'max_val_frames': None,
    'strict_overflow': False,
    'start_checkpoint': None,
    'load_ckpt': None,
}

# the port's default dataset group: configs/dataset/synthetic.yaml with the
# root's dataset keys that its loader reads
SYNTHETIC = {
    'dataset_name': 'synthetic',
    'dataset': {
        'name': 'synthetic',
        'test_mode': 'view',
        'train_smpl': False,
        'padding': 0.1,
        'white_background': False,
        'n_verts': 2048,
        'n_points': 8192,
        'n_target_gaussians': 4096,
        'train_views': ['0', '1'],
        'val_views': ['2'],
        'train_frames': [0, 8, 1],
        'val_frames': [0, 1, 1],
        'test_frames': {'view': [0, 8, 4], 'video': [0, 8, 1],
                        'all': [0, 8, 1]},
        'predict_frames': [0, 0, 1],
        'img_hw': [256, 256],
        'seed': 0,
    },
}

_POSE_ENCODER = {'num_joints': 24, 'rel_joints': False, 'dim_per_joint': 6,
                 'out_dim': -1}
_NR_REG = {'lambda_nr_xyz': 0.0, 'lambda_nr_scale': 0.0, 'lambda_nr_rot': 0.0,
           'non_rigid_lr': 0.001}


def _mlp_texture(name, feature_dim, dim, n_neurons, n_hidden_layers, opt):
    return {
        'texture_name': name,
        'model': {
            'gaussian': {'use_sh': False, 'feature_dim': feature_dim},
            'texture': {
                'name': 'mlp', 'feature_dim': '${model.gaussian.feature_dim}',
                'use_xyz': False, 'use_cov': False, 'use_normal': False,
                'sh_degree': 3, 'non_rigid_dim': dim, 'latent_dim': dim,
                'cano_view_dir': True, 'view_noise': 45,
                'mlp': {'n_neurons': n_neurons,
                        'n_hidden_layers': n_hidden_layers, 'skip_in': [],
                        'cond_in': [], 'multires': 0}}},
        'opt': dict(opt, texture_lr=0.001, tex_latent_lr=0.001,
                    latent_weight_decay=0.05)}


def _non_rigid(name, short, opt, **body):
    return {'non_rigid_name': short,
            'model': {'deformer': {'non_rigid': dict(name=name, **body)}},
            'opt': opt}


def _deformer_mlp(**extra):
    return dict({'n_neurons': 256, 'n_hidden_layers': 8, 'skip_in': [4],
                 'cond_in': [0], 'multires': 6}, **extra)


# the other config groups: the port's copies of configs/<group>/<choice>.yaml
# (each a block of the whole config), merged over the root in the JAX
# package's group order
GROUPS = {
    'pose_correction': {
        'direct': {'pose_name': 'direct', 'dataset': {'train_smpl': True},
                   'model': {'pose_correction': {'name': 'direct',
                                                 'delay': 5000}},
                   'opt': {'pose_correction_lr': 0.0001,
                           'lambda_pose': 0.0}},
        'none': {'pose_name': 'none', 'dataset': {'train_smpl': False},
                 'model': {'pose_correction': {'name': 'none'}}},
    },
    'texture': {
        'shallow_mlp': _mlp_texture('shallow_mlp', 32, 16, 64, 2,
                                    {'feature_lr': 0.001}),
        'mlp': _mlp_texture('mlp', 128, 64, 256, 4, {}),
        'sh': {'texture_name': 'sh',
               'model': {'gaussian': {'use_sh': True, 'sh_degree': 3},
                         'texture': {'name': 'sh2rgb', 'cano_view_dir': True,
                                     'view_noise': 45, 'non_rigid_dim': 0}}},
    },
    'rigid': {
        'skinning_field': {
            'rigid_name': 'mlp_field',
            'model': {'deformer': {'rigid': {
                'name': 'skinning_field', 'distill': False, 'res': 64,
                'z_ratio': 4, 'd_out': 25, 'soft_blend': 20,
                'n_reg_pts': 1024,
                'skinning_network': {'otype': 'VanillaMLP', 'n_neurons': 128,
                                     'n_hidden_layers': 4, 'skip_in': [],
                                     'cond_in': [], 'multires': 0}}}},
            'opt': {'lambda_skinning': [10, 1000, 0.1], 'rigid_lr': 0.0001}},
        'smpl_nn': {'rigid_name': 'smpl_nn',
                    'model': {'deformer': {'rigid': {'name': 'smpl_nn'}}}},
        'identity': {'rigid_name': 'identity',
                     'model': {'deformer': {'rigid': {'name': 'identity'}}}},
    },
    'non_rigid': {
        'hashgrid': _non_rigid(
            'hashgrid', 'ingp', dict(_NR_REG, nr_latent_lr=0.001),
            scale_offset='logit', rot_offset='mult', delay=3000,
            feature_dim='${model.texture.non_rigid_dim}', latent_dim=0,
            pose_encoder=_POSE_ENCODER,
            hashgrid={'n_levels': 16, 'n_features_per_level': 2,
                      'log2_hashmap_size': 16, 'base_resolution': 16,
                      'per_level_scale': 1.447269237440378,
                      'max_resolution': 2048},
            mlp={'n_neurons': 128, 'n_hidden_layers': 3, 'skip_in': [],
                 'cond_in': [0], 'multires': 0, 'last_layer_init': False}),
        'mlp': _non_rigid(
            'mlp', 'mlp', dict(_NR_REG, nr_latent_lr=0.001),
            scale_offset='logit', rot_offset='mult', delay=3000,
            feature_dim='${model.texture.non_rigid_dim}', latent_dim=0,
            pose_encoder=_POSE_ENCODER,
            mlp=_deformer_mlp(last_layer_init=False)),
        'hannw_mlp': _non_rigid(
            'hannw_mlp', 'hannw_mlp', _NR_REG, scale_offset='logit',
            rot_offset='add', pose_encoder=_POSE_ENCODER,
            mlp=_deformer_mlp(embedder={'kick_in_iter': 3000,
                                        'full_band_iter': 10000})),
        'identity': _non_rigid('identity', 'identity', {}, delay=0),
    },
    'option': {
        'iter15k': {'opt': {'iterations': 15000, 'lr_ratio': 0.1,
                            'densify_until_iter': 10000},
                    'test_interval': 1000},
        'iter30k': {'opt': {'iterations': 30000, 'lr_ratio': 0.1,
                            'densify_until_iter': 15000}},
        'iter40k': {'opt': {'iterations': 40000, 'lr_ratio': 0.1,
                            'densify_until_iter': 20000}},
        'iter50k': {'opt': {'iterations': 50000, 'lr_ratio': 0.1,
                            'densify_until_iter': 25000}},
        'no_mask': {'opt': {'lambda_mask': 0.0, 'lambda_opacity': 0.001}},
        'no_val': {'test_interval': 0, 'test_iterations': []},
        'test_all': {'dataset': {'test_mode': 'all'}},
    },
}

# each group's choice when the overrides name none (the dataset group's is
# the port's own, synthetic, where the JAX package's is zjumocap_377_mono)
DEFAULT_GROUPS = {'dataset': 'synthetic', 'pose_correction': 'direct',
                  'texture': 'shallow_mlp', 'rigid': 'skinning_field',
                  'non_rigid': 'hashgrid', 'option': 'iter15k'}

# the root config's dataset keys under every real subject (config.yaml)
DATASET_ROOT = {'preload': True, 'train_smpl': False, 'test_mode': 'view',
                'predict_seq': 0, 'freeview': False, 'resolution': -1,
                'padding': 0.1, 'white_background': False, 'eval': False}

_ZJU_VAL = [str(v) for v in range(2, 24)]


def _zju(name, subject, root, train_views, val_views, test_video,
         predict_views, n, val_frames=(0, 1, 1), **extra):
    ds = {'name': name, 'root_dir': root, 'subject': subject,
          'refine': False, 'train_views': train_views,
          'val_views': val_views,
          'test_views': {'view': '${dataset.val_views}',
                         'video': test_video, 'all': []},
          'predict_views': predict_views,
          'train_frames': [0, n, 1], 'val_frames': list(val_frames),
          'test_frames': {'view': [0, n, 30], 'video': [0, n, 1],
                          'all': [0, n, 1]},
          'predict_frames': [0, 0, 1], 'img_hw': [512, 512],
          'lanczos': False, 'resolution': -1, 'white_background': False,
          'eval': False}
    ds.update(extra)
    return ds


def _ps(subject, train, val, pose, n_all):
    return {'name': 'people_snapshot',
            'root_dir': '../../data/peoplesnapshot_arah-format/'
                        'people_snapshot_public',
            'subject': subject, 'train_frames': train, 'val_frames': val,
            'test_frames': {'pose': pose, 'all': [0, n_all, 1]},
            'predict_frames': [0, 0, 1], 'img_hw': [540, 540],
            'resolution': -1, 'white_background': False, 'eval': False}


# the real subjects: the port's copies of configs/dataset/<group>.yaml,
# each as the top-level blocks the group sets
DATASETS = {
    'zjumocap_001_mono': {'dataset_name': 'zju_001_mono', 'dataset': _zju(
        'mydataset', 'CoreView_001', './data/ZJUMoCap', ['1'], ['1'],
        ['12'], ['1'], 540, val_frames=(1701, 1702, 1),
        train_frames=[0, 1700, 1])},
    'zjumocap_377_mono': {'dataset_name': 'zju_377_mono', 'dataset': _zju(
        'zjumocap', 'CoreView_377', './data/ZJUMoCap', ['1', '2'],
        _ZJU_VAL[3:], _ZJU_VAL[3:], ['3', '4'], 570, freeview=False)},
    'zjumocap_386_mono': {'dataset_name': 'zju_386_mono', 'dataset': _zju(
        'zjumocap', 'CoreView_386', './data/ZJUMoCap', ['1'], _ZJU_VAL,
        ['12'], ['1'], 540)},
    'zjumocap_387_mono': {'dataset_name': 'zju_387_mono', 'dataset': _zju(
        'zjumocap', 'CoreView_387', '../../data/ZJUMoCap', ['1'], _ZJU_VAL,
        ['12'], ['1'], 540, padding=[0.1, 0.1, 0.4])},
    'zjumocap_392_mono': {'dataset_name': 'zju_392_mono', 'dataset': _zju(
        'zjumocap', 'CoreView_392', '../../data/ZJUMoCap', ['1'], _ZJU_VAL,
        ['12'], ['1'], 0)},
    'zjumocap_393_mono': {'dataset_name': 'zju_393_mono', 'dataset': _zju(
        'zjumocap', 'CoreView_393', '../../data/ZJUMoCap', ['1'], _ZJU_VAL,
        ['12'], ['1'], 0)},
    'zjumocap_394_mono': {'dataset_name': 'zju_394_mono', 'dataset': _zju(
        'zjumocap', 'CoreView_394', '../../data/ZJUMoCap', ['1'], _ZJU_VAL,
        ['12'], ['1'], 475)},
    'ps_female_3': {'dataset_name': 'ps_female_3', 'dataset': _ps(
        'female-3-casual', [0, 446, 4], [446, 447, 4], [446, 648, 4], 648),
        'opt': {'densify_grad_threshold': 0.0001}},
    'ps_female_4': {'dataset_name': 'ps_female_4', 'dataset': _ps(
        'female-4-casual', [0, 336, 4], [335, 336, 4], [335, 524, 4], 524)},
    'ps_male_3': {'dataset_name': 'ps_male_3', 'dataset': _ps(
        'male-3-casual', [0, 456, 4], [456, 457, 4], [456, 676, 4], 676)},
    'ps_male_4': {'dataset_name': 'ps_male_4', 'dataset': _ps(
        'male-4-casual', [0, 660, 6], [660, 661, 6], [660, 873, 6], 873)},
}
DATASETS['zjumocap_394_mono']['dataset']['test_views']['figure'] = ['22']
DATASETS['zjumocap_394_mono']['dataset']['test_frames']['figure'] = [
    390, 391, 1]

# the bench shape of the JAX package (bench.py:248-258): the synthetic
# avatar at 540x540 with 50,000 Gaussians in an arena of 131072, a hidden
# target of 50,000 Gaussians for the ground truth and a skinning pool of
# 16384 points
BENCH_OVERRIDES = (
    "dataset.img_hw=[540,540]",
    "dataset.n_verts=4096",
    "dataset.n_points=50000",
    "dataset.n_target_gaussians=50000",
    "opt.skinning_pool_size=16384",
    "dataset.train_frames=[0,4,1]",
    "model.gaussian.capacity=131072",
    "rasterizer.max_pairs=2097152",
    "rasterizer.max_rect=8",
)

_WORDS = {'true': True, 'false': False, 'null': None, 'none': None}


def _parse(value: str):
    if value.lower() in _WORDS:
        return _WORDS[value.lower()]
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = (_merge(out[k], v) if isinstance(v, dict)
                  and isinstance(out.get(k), dict) else copy.deepcopy(v))
    return out


_INTERP = re.compile(r'\$\{([^}]+)\}')
# a YAML 1.1 reader leaves "1e-4" a string; such strings become floats
_NUMERIC = re.compile(r'[+-]?(\d+\.?\d*|\.\d+)[eE][+-]?\d+')


def _interpolate(node, root: dict, depth: int = 0):
    """`${a.b}` as a whole string takes the value of key a.b (a copy);
    inside a longer string, its text. An exponent-only number string
    becomes a float. References deeper than 16 raise (a cycle)."""
    if depth > 16:
        raise ValueError("interpolation cycle")
    if isinstance(node, dict):
        return {k: _interpolate(v, root, depth) for k, v in node.items()}
    if isinstance(node, list):
        return [_interpolate(v, root, depth) for v in node]
    if isinstance(node, str):
        def value(path):
            cur = root
            for part in path.split('.'):
                cur = cur[part]
            return _interpolate(cur, root, depth + 1)
        m = _INTERP.fullmatch(node)
        if m:
            return copy.deepcopy(value(m.group(1)))
        if _NUMERIC.fullmatch(node):
            return float(node)
        return _INTERP.sub(lambda mm: str(value(mm.group(1))), node)
    return node


def load_config_from_dict(data: dict) -> dict:
    """`data` with its `${...}` references resolved, on a deep copy: the
    dict itself is left as it is."""
    return _interpolate(copy.deepcopy(data), data)


def load_config(overrides: Optional[Iterable[str]] = None) -> dict:
    """The root config merged with one choice of each group (`group=choice`
    overrides, else DEFAULT_GROUPS) in the JAX package's order, then the
    `dotted.key=value` overrides, then the `${...}` interpolations. A
    choice the JAX package has no file for raises."""
    overrides = list(overrides or ())
    choice = dict(DEFAULT_GROUPS)
    for ov in overrides:
        if '=' not in ov:
            raise ValueError(f"override must be key=value: {ov}")
        key, value = ov.split('=', 1)
        if key in choice:
            admitted = (['synthetic'] + sorted(DATASETS) if key == 'dataset'
                        else sorted(GROUPS[key]))
            if value not in admitted:
                raise ValueError(f"{key}={value}: the choices are "
                                 f"{admitted}")
            choice[key] = value
    cfg = copy.deepcopy(ROOT)
    if choice['dataset'] == 'synthetic':
        cfg = _merge(cfg, SYNTHETIC)
    else:
        group = DATASETS[choice['dataset']]
        cfg = _merge(cfg, {k: v for k, v in group.items() if k != 'dataset'})
        cfg['dataset'] = _merge(DATASET_ROOT, group['dataset'])
    for key in ('pose_correction', 'texture', 'rigid', 'non_rigid',
                'option'):
        cfg = _merge(cfg, GROUPS[key][choice[key]])
    for ov in overrides:
        key, value = ov.split('=', 1)
        if key in choice:
            continue
        node = cfg
        parts = key.split('.')
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _parse(value)
    return _interpolate(cfg, cfg)
