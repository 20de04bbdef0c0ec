"""The port's configuration as a plain Python dict.

Counterpart of `gsavatar/config/config.py` for what the render path, the
training driver and the evaluation read:
the defaults of `configs/config.yaml` composed with its default groups
(`pose_correction/direct`, `texture/shallow_mlp`, `rigid/skinning_field`,
`non_rigid/hashgrid`, `option/iter15k`) and `dataset/synthetic.yaml`, with
the `${...}` interpolations resolved. Written out as a dict so that the port
needs no YAML parser. `load_config(["a.b.c=value", ...])` applies dotted
overrides; values are read as Python literals (`[540,540]`, `['0']`, `0.1`)
or the words `true`/`false`/`null`. The dataset group may name `synthetic`
(the port's default, where the JAX package's is `zjumocap_377_mono`) or one
of the real subjects of `DATASETS` (`zjumocap_*_mono`, `ps_*`): the root
config's dataset keys merged with that subject's, its `dataset_name`, and
its other blocks (the `opt:` of `ps_female_3`). A whole-string
`${dotted.key}` value (`test_views.view: ${dataset.val_views}`) is resolved
after the overrides. Every other config group may name only its default:
the port has no other yet. Keys that
the JAX package reads with a default in its code rather than from its yaml
(`opt.bucket_granularity`, `log_every`, `max_val_frames`,
`strict_overflow`) are here at that default."""
from __future__ import annotations

import ast
import copy
import re
from typing import Iterable, Optional

DEFAULTS = {
    'model': {
        'gaussian': {
            'use_sh': False,
            'sh_degree': 3,
            'feature_dim': 32,
            'capacity': 262144,
            'delay': 1000,
        },
        'pose_correction': {'name': 'direct', 'delay': 5000},
        'deformer': {
            'rigid': {
                'name': 'skinning_field',
                'distill': False,
                'd_out': 25,
                'soft_blend': 20,
                'skinning_network': {
                    'n_neurons': 128,
                    'n_hidden_layers': 4,
                    'skip_in': [],
                    'cond_in': [],
                    'multires': 0,
                },
            },
            'non_rigid': {
                'name': 'hashgrid',
                'scale_offset': 'logit',
                'rot_offset': 'mult',
                'delay': 3000,
                'feature_dim': 16,
                'latent_dim': 0,
                'pose_encoder': {
                    'num_joints': 24,
                    'rel_joints': False,
                    'dim_per_joint': 6,
                    'out_dim': -1,
                },
                'hashgrid': {
                    'n_levels': 16,
                    'n_features_per_level': 2,
                    'log2_hashmap_size': 16,
                    'base_resolution': 16,
                    'per_level_scale': 1.447269237440378,
                    'max_resolution': 2048,
                },
                'mlp': {
                    'n_neurons': 128,
                    'n_hidden_layers': 3,
                    'skip_in': [],
                    'cond_in': [0],
                    'multires': 0,
                },
            },
        },
        'texture': {
            'name': 'mlp',
            'feature_dim': 32,
            'use_xyz': False,
            'use_cov': False,
            'use_normal': False,
            'sh_degree': 3,
            'non_rigid_dim': 16,
            'latent_dim': 16,
            'cano_view_dir': True,
            'view_noise': 45,
            'mlp': {
                'n_neurons': 64,
                'n_hidden_layers': 2,
                'skip_in': [],
                'cond_in': [],
                'multires': 0,
            },
        },
    },
    'dataset': {
        'name': 'synthetic',
        'test_mode': 'view',
        'train_smpl': True,
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
    'opt': {
        'iterations': 15000,
        'grad_clip': 0.1,
        'position_lr_init': 0.00016,
        'position_lr_final': 1.6e-06,
        'position_lr_delay_mult': 0.01,
        'position_lr_max_steps': 30000,
        'feature_lr': 0.001,
        'opacity_lr': 0.05,
        'scaling_lr': 0.005,
        'rotation_lr': 0.001,
        'pose_correction_lr': 0.0001,
        'rigid_lr': 0.0001,
        'non_rigid_lr': 0.001,
        'nr_latent_lr': 0.001,
        'texture_lr': 0.001,
        'tex_latent_lr': 0.001,
        'latent_weight_decay': 0.05,
        'lr_ratio': 0.1,
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
        'lambda_nr_xyz': 0.0,
        'lambda_nr_scale': 0.0,
        'lambda_nr_rot': 0.0,
        'densification_interval': 100,
        'opacity_reset_interval': 3000,
        'densify_from_iter': 500,
        'densify_until_iter': 10000,
        'densify_grad_threshold': 0.0002,
        'opacity_threshold': 0.05,
        'percent_dense': 0.01,
        'bucket_granularity': 4096,
        'n_reg_pts': 1024,
        'skinning_pool_size': 65536,
    },
    'pipeline': {'pose_noise': 0.1},
    'rasterizer': {'max_pairs': 2097152, 'max_rect': 8},
    'parallel': {'data': 0, 'model': 0},
    'dataset_name': 'synthetic',
    'name': '${dataset_name}-direct-mlp_field-ingp-shallow_mlp-default',
    'seed': -1,
    'mode': 'train',
    'exp_dir': None,
    'log_every': 10,
    'test_interval': 1000,
    'test_iterations': [],
    'save_iterations': [30000],
    'checkpoint_iterations': [],
    'max_val_frames': None,
    'strict_overflow': False,
    'start_checkpoint': None,
    'load_ckpt': None,
}

# the root config's dataset keys under every real subject (config.yaml,
# with train_smpl from pose_correction/direct)
DATASET_ROOT = {'preload': True, 'train_smpl': True, 'test_mode': 'view',
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

# config groups and the only choice the port has for each (the dataset
# group also takes the subjects of DATASETS)
GROUPS = {'dataset': 'synthetic', 'pose_correction': 'direct',
          'texture': 'shallow_mlp', 'rigid': 'skinning_field',
          'non_rigid': 'hashgrid', 'option': 'iter15k'}

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


def _interpolate(node, root: dict):
    """`${a.b}` as a whole string takes the value of key a.b (a copy);
    inside a longer string, its text."""
    if isinstance(node, dict):
        return {k: _interpolate(v, root) for k, v in node.items()}
    if isinstance(node, list):
        return [_interpolate(v, root) for v in node]
    if isinstance(node, str) and '${' in node:
        def value(path):
            cur = root
            for part in path.split('.'):
                cur = cur[part]
            return _interpolate(cur, root)
        m = re.fullmatch(r'\$\{([^}]+)\}', node)
        if m:
            return copy.deepcopy(value(m.group(1)))
        return re.sub(r'\$\{([^}]+)\}', lambda mm: str(value(mm.group(1))),
                      node)
    return node


def load_config(overrides: Optional[Iterable[str]] = None) -> dict:
    """A fresh copy of DEFAULTS, with the dataset group given by a
    `dataset=<group>` override, then `dotted.key=value` overrides."""
    overrides = list(overrides or ())
    cfg = copy.deepcopy(DEFAULTS)
    for ov in overrides:
        if '=' not in ov:
            raise ValueError(f"override must be key=value: {ov}")
        key, value = ov.split('=', 1)
        if key == 'dataset' and value in DATASETS:
            group = DATASETS[value]
            cfg = _merge(cfg, {k: v for k, v in group.items()
                               if k != 'dataset'})
            cfg['dataset'] = _merge(DATASET_ROOT, group['dataset'])
        elif key in GROUPS and value != GROUPS[key]:
            raise NotImplementedError(
                f"{key}={value}: the port has only {key}={GROUPS[key]}"
                + (f" or one of {sorted(DATASETS)}" if key == 'dataset'
                   else ""))
    for ov in overrides:
        key, value = ov.split('=', 1)
        if key in GROUPS:
            continue
        node = cfg
        parts = key.split('.')
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _parse(value)
    return _interpolate(cfg, cfg)
