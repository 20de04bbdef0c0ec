"""The port's configuration as a plain Python dict.

Counterpart of `gsavatar/config/config.py` for what the render path, the
training driver and the evaluation read:
the defaults of `configs/config.yaml` composed with its default groups
(`pose_correction/direct`, `texture/shallow_mlp`, `rigid/skinning_field`,
`non_rigid/hashgrid`, `option/iter15k`) and `dataset/synthetic.yaml`, with
the `${...}` interpolations resolved. Written out as a dict so that the port
needs no YAML parser. `load_config(["a.b.c=value", ...])` applies dotted
overrides; values are read as Python literals (`[540,540]`, `['0']`, `0.1`)
or the words `true`/`false`/`null`. A config group (`dataset=synthetic`)
may name only the group's default: the port has no other yet. Keys that
the JAX package reads with a default in its code rather than from its yaml
(`opt.bucket_granularity`, `log_every`, `max_val_frames`,
`strict_overflow`) are here at that default."""
from __future__ import annotations

import ast
import copy
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
    'name': 'synthetic-direct-mlp_field-ingp-shallow_mlp-default',
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

# config groups and the only choice the port has for each
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


def load_config(overrides: Optional[Iterable[str]] = None) -> dict:
    """A fresh copy of DEFAULTS with `dotted.key=value` overrides applied."""
    cfg = copy.deepcopy(DEFAULTS)
    for ov in overrides or ():
        if '=' not in ov:
            raise ValueError(f"override must be key=value: {ov}")
        key, value = ov.split('=', 1)
        if key in GROUPS:
            if value != GROUPS[key]:
                raise NotImplementedError(
                    f"{key}={value}: the port has only {key}={GROUPS[key]}")
            continue
        node = cfg
        parts = key.split('.')
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _parse(value)
    return cfg
