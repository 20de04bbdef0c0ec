"""Training scene: datasets, converter, rasterizer config, optimizers, state.

Counterpart of `gsavatar/scene.py` (`Scene`, `TrainState`,
`converter_optimizer`, `save_checkpoint`, `load_checkpoint`). The Scene
owns what is fixed for a run (the datasets of `data.load_dataset`, their
cameras' ground truth on the scene's device, the
converter module, the raster config, the background, the skinning pool,
the schedules); `init_state` makes the `TrainState` that
`train.make_train_step` advances.

The converter's parameters live in the converter module: `TrainState.
conv_params` is the module's own named parameters, and the step updates
them, the arena and the optimizer states in place.

A checkpoint is one `torch.save` file, `<dir>/ckpt<iteration>.pt`, of the
whole state: the arena, its aux, the arena Adam with its step, the
converter's state dict, the converter optimizer's state, the draws'
generator state and the iteration. Loading gives the state back bit for
bit; a file without one of those fields raises (the JAX package's lenient
restore exists for older orbax layouts, which the port never wrote)."""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict

import torch

from gsavatar_torch import tracing
from gsavatar_torch.core import gaussians as G
from gsavatar_torch.core.optim import ArenaAdamState, init_adam
from gsavatar_torch.data import load_dataset
from gsavatar_torch.device import resolve_device
from gsavatar_torch.inference import raster_config_from, torch_generator
from gsavatar_torch.models.converter import build_converter
from gsavatar_torch.ops.conv_adam import Plan, conv_adam_step
from gsavatar_torch.ops.sampling import sample_skinning_pool
from gsavatar_torch.utils.transforms import expon_lr_schedule


# the test dataset of each mode
TEST_SPLIT = {'train': 'val', 'test': 'test', 'predict': 'predict'}


# the converter optimizer's groups, in the order of K5's step and decay rows
GROUPS = ('rigid', 'non_rigid', 'nr_latent', 'pose_correction', 'texture',
          'tex_latent')


def param_group(name: str) -> str:
    """The converter optimizer's group of a state-dict name, by the JAX
    package's `label_fn` rules: the top module, with the latent tables of
    the non-rigid deformer and the texture in groups of their own."""
    parts = name.split('.')
    latent = 'latent' in parts
    if parts[0] in ('rigid', 'pose_correction'):
        return parts[0]
    if parts[0] == 'texture':
        return 'tex_latent' if latent else 'texture'
    return 'nr_latent' if latent else 'non_rigid'


@dataclasses.dataclass
class ConverterOptState:
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    count: int


class ConverterOptimizer:
    """The converter's optimizer, optax's chain written out: first
    `clip_by_global_norm(grad_clip)` over every converter gradient (by hand:
    `torch.nn.utils.clip_grad_norm_` divides by norm + 1e-6, optax does not),
    then per group `add_decayed_weights` (the two latent groups), Adam
    (0.9, 0.999, eps 1e-15 after the square root, bias-corrected) and the
    step -lr * gamma^t with gamma = lr_ratio^(1 / iterations). As in the
    JAX package, the global norm also counts the gradients of the frozen
    subject constants (`GaussianConverter.subject_constants`), which are
    not updated.

    CUDA tensors take K5 (`ops/conv_adam.py`: two launches a step, the
    norm and the update), CPU tensors the plain version, `step_plain`."""

    B1, B2, EPS = 0.9, 0.999, 1e-15

    def __init__(self, cfg: dict, iterations: int):
        opt = cfg['opt']
        self.gamma = float(opt['lr_ratio']) ** (1.0 / iterations)
        self.grad_clip = float(opt.get('grad_clip', 0.0))
        wd = float(opt.get('latent_weight_decay', 0.05))
        self.lr = {g: float(opt.get(f'{g}_lr', 0.0)) for g in GROUPS}
        self.wd = {g: (wd if g in ('nr_latent', 'tex_latent') else 0.0)
                   for g in self.lr}
        self.plan = Plan()
        self._group_ids = (None, None)

    def init(self, params: Dict[str, torch.Tensor]) -> ConverterOptState:
        return ConverterOptState(
            mu={k: torch.zeros_like(p) for k, p in params.items()},
            nu={k: torch.zeros_like(p) for k, p in params.items()}, count=0)

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor], state: ConverterOptState,
             frozen_grads: Dict[str, torch.Tensor] = None
             ) -> ConverterOptState:
        """Updates `params` and `state` (its moments and count) in place
        and returns `state`. `frozen_grads` count in the clip's global norm
        only. A group may be empty (the rigid group under `rigid=identity`),
        and so may the whole converter (the plain-3DGS variant has no
        parameter)."""
        if params:
            device = next(iter(params.values())).device
            if device.type == 'cuda':
                self._kernel_step(params, grads, state, frozen_grads)
                tracing.count('update/conv_kernel', 1)
            elif device.type == 'cpu':
                self.step_plain(params, grads, state, frozen_grads)
            else:
                raise ValueError(f"the converter's optimizer runs on CUDA or "
                                 f"CPU tensors, not {device}")
        state.count += 1
        return state

    def _kernel_step(self, params, grads, state, frozen_grads):
        """K5 on the CUDA tensors: the host computes the bias corrections
        and step sizes as `step_plain` does (f32 on the CPU) and hands them
        to the kernel as scalars; it reads nothing from the device."""
        names = tuple(params)
        if self._group_ids[0] != names:
            self._group_ids = (names, tuple(GROUPS.index(param_group(k))
                                            for k in names))
        count = state.count + 1
        f32 = lambda x: torch.tensor(x, dtype=torch.float32)
        clip = max(self.grad_clip, 0.0)
        adam = [clip, 1 - self.B1, self.B1, 1 - self.B2, self.B2,
                float(1 - f32(self.B1) ** count),
                float(1 - f32(self.B2) ** count), self.EPS]
        steps = [float(f32(-self.lr[g] * self.gamma ** state.count))
                 for g in GROUPS]
        frozen = list((frozen_grads or {}).values()) if clip else []
        conv_adam_step(self.plan, list(params.values()),
                       [state.mu[k] for k in names],
                       [state.nu[k] for k in names],
                       [grads[k] for k in names], frozen,
                       self._group_ids[1], adam, steps,
                       [self.wd[g] for g in GROUPS])

    @torch.no_grad()
    def step_plain(self, params: Dict[str, torch.Tensor],
                   grads: Dict[str, torch.Tensor], state: ConverterOptState,
                   frozen_grads: Dict[str, torch.Tensor] = None) -> None:
        """The plain version of K5, on any device: one eager expression per
        operation and leaf, as the chain reads. Updates `params` and the
        state's moments in place; `step` advances the count."""
        if self.grad_clip > 0:
            every = list(grads.values()) + list((frozen_grads or {}).values())
            g_norm = torch.sqrt(sum((g * g).sum() for g in every))
            keep = g_norm < self.grad_clip
            grads = {k: torch.where(keep, g, g / g_norm * self.grad_clip)
                     for k, g in grads.items()}
        count = state.count + 1
        f32 = lambda x: torch.tensor(x, dtype=torch.float32)
        # one host-to-device copy each per step, not one per parameter
        dev = next(iter(params.values())).device
        bc1 = (1 - f32(self.B1) ** count).to(dev)
        bc2 = (1 - f32(self.B2) ** count).to(dev)
        for k, p in params.items():
            group = param_group(k)
            u = grads[k]
            if self.wd[group]:
                u = u + self.wd[group] * p
            mu = (1 - self.B1) * u + self.B1 * state.mu[k]
            nu = (1 - self.B2) * (u * u) + self.B2 * state.nu[k]
            upd = (mu / bc1) / (torch.sqrt(nu / bc2) + self.EPS)
            step_size = float(f32(-self.lr[group] * self.gamma ** state.count))
            p.add_(step_size * upd)
            state.mu[k].copy_(mu)
            state.nu[k].copy_(nu)


def checkpoint_path(save_dir: str, iteration: int) -> str:
    """`<save_dir>/ckpt<iteration>.pt`, absolute, its directory made."""
    os.makedirs(save_dir, exist_ok=True)
    return os.path.abspath(os.path.join(save_dir, f"ckpt{iteration}.pt"))


@dataclasses.dataclass
class TrainState:
    gauss_params: G.GaussianParams
    gauss_aux: G.GaussianAux
    gauss_adam: ArenaAdamState
    conv_params: Dict[str, torch.Tensor]   # the converter's own parameters
    conv_opt: ConverterOptState
    generator: torch.Generator             # the step's random draws


class Scene:
    def __init__(self, cfg: dict, seed: int = 0, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        split = TEST_SPLIT[cfg.get('mode', 'train')]
        self.train_dataset = load_dataset(cfg['dataset'], 'train',
                                          device=self.device)
        self.test_dataset = load_dataset(cfg['dataset'], split,
                                         device=self.device)
        self.metadata = md = self.train_dataset.metadata
        self.cameras_extent = float(md['cameras_extent'])

        gcfg = cfg['model']['gaussian']
        self.use_sh = bool(gcfg['use_sh'])
        self.max_sh_degree = int(gcfg.get('sh_degree', 3))
        self.feature_dim = int(gcfg.get('feature_dim', 32))
        self.capacity = int(gcfg.get('capacity', 1 << 17))
        self.gauss_delay = int(gcfg.get('delay', 0))

        self.assets = self.train_dataset.assets
        self.converter = build_converter(
            cfg, md, self.assets, generator=torch_generator(seed)).to(
                self.device)
        self.raster_config = raster_config_from(cfg)
        white = cfg['dataset'].get('white_background', False)
        self.background = torch.full((3,), 1.0 if white else 0.0,
                                     device=self.device)

        opt = cfg['opt']
        pool_pts, pool_w = sample_skinning_pool(
            md['smpl_verts'], md['faces'], md['skinning_weights'],
            pool_size=int(opt.get('skinning_pool_size', 65536)))
        self.skinning_pool_pts = md['aabb'].normalize(
            torch.as_tensor(pool_pts), sym=True).to(self.device)
        self.skinning_pool_w = torch.as_tensor(pool_w, device=self.device)
        self.n_reg_pts = int(opt.get('n_reg_pts', 1024))

        self.xyz_lr_fn = expon_lr_schedule(
            lr_init=float(opt['position_lr_init']) * self.cameras_extent,
            lr_final=float(opt['position_lr_final']) * self.cameras_extent,
            lr_delay_mult=float(opt['position_lr_delay_mult']),
            max_steps=int(opt['position_lr_max_steps']))
        self.conv_tx = ConverterOptimizer(cfg, int(opt['iterations']))
        self._seed = seed

    def init_state(self) -> TrainState:
        """The arena seeded from the point cloud (with its neighbours), zero
        Adam moments, the converter's parameters and a fresh optimizer
        state, and the generator of the step's draws."""
        points, colors = self.train_dataset.readPointCloud()
        params, aux = G.create_from_pcd(
            points, colors, self.capacity, self.use_sh, self.max_sh_degree,
            self.feature_dim, device=self.device)
        conv_params = dict(self.converter.named_parameters())
        return TrainState(
            gauss_params=params, gauss_aux=aux, gauss_adam=init_adam(params),
            conv_params=conv_params,
            conv_opt=self.conv_tx.init(conv_params),
            generator=torch_generator(self._seed + 1))

    def device_camera(self, idx: int, split: str = 'train'):
        """Camera `idx` of the training ('train') or test split, on the
        scene's device with its ground truth (cached by the dataset)."""
        ds = self.train_dataset if split == 'train' else self.test_dataset
        return ds[idx]

    def bucket_for(self, n_alive: int) -> int:
        """The alive-prefix bucket: n_alive rounded up to
        opt.bucket_granularity (0: the whole capacity)."""
        g = int(self.cfg['opt'].get('bucket_granularity', 4096))
        if g <= 0:
            return self.capacity
        return min(self.capacity, max(g, int(math.ceil(n_alive / g)) * g))

    def gauss_lrs(self, iteration: int) -> dict:
        """Per-field learning rates of the arena Adam."""
        opt = self.cfg['opt']
        feature_ratio = 20.0 if self.use_sh else 1.0
        return {
            'xyz': self.xyz_lr_fn(iteration),
            'features_dc': float(opt['feature_lr']),
            'features_rest': float(opt['feature_lr']) / feature_ratio,
            'opacity': float(opt['opacity_lr']),
            'scaling': float(opt['scaling_lr']),
            'rotation': float(opt['rotation_lr']),
        }

    def active_sh_degree(self, iteration: int) -> int:
        """The SH degree ramp: +1 every 1000 iterations up to the maximum."""
        if not self.use_sh:
            return 0
        return min(iteration // 1000, self.max_sh_degree)

    def save_checkpoint(self, state: TrainState, iteration: int,
                        save_dir: str) -> str:
        path = checkpoint_path(save_dir, iteration)
        torch.save(self.checkpoint(state, iteration), path)
        return path

    def checkpoint(self, state: TrainState, iteration: int) -> dict:
        """What `save_checkpoint` writes."""
        fields = lambda p: {f.name: getattr(p, f.name)
                            for f in dataclasses.fields(p)}
        return {
            'gauss_params': fields(state.gauss_params),
            'gauss_aux': fields(state.gauss_aux),
            'gauss_adam': {'m': fields(state.gauss_adam.m),
                           'v': fields(state.gauss_adam.v),
                           'step': state.gauss_adam.step},
            'converter': self.converter.state_dict(),
            'conv_opt': {'mu': state.conv_opt.mu, 'nu': state.conv_opt.nu,
                         'count': state.conv_opt.count},
            'generator': state.generator.get_state(),
            'iteration': iteration,
        }

    def load_checkpoint(self, path: str):
        """(TrainState, iteration) from `path`; loads the converter's
        weights into `self.converter`."""
        ckpt = read_checkpoint(path, self.device)
        self.converter.load_state_dict(ckpt['converter'])
        adam = ckpt['gauss_adam']
        conv_opt = ckpt['conv_opt']
        generator = torch.Generator()
        generator.set_state(ckpt['generator'])
        state = TrainState(
            gauss_params=G.GaussianParams(**ckpt['gauss_params']),
            gauss_aux=G.GaussianAux(**ckpt['gauss_aux']),
            gauss_adam=ArenaAdamState(m=G.GaussianParams(**adam['m']),
                                      v=G.GaussianParams(**adam['v']),
                                      step=int(adam['step'])),
            conv_params=dict(self.converter.named_parameters()),
            conv_opt=ConverterOptState(mu=conv_opt['mu'], nu=conv_opt['nu'],
                                       count=int(conv_opt['count'])),
            generator=generator)
        return state, int(ckpt['iteration'])


CHECKPOINT_FIELDS = ('gauss_params', 'gauss_aux', 'gauss_adam', 'converter',
                     'conv_opt', 'generator', 'iteration')


def read_checkpoint(path: str, device) -> dict:
    """The fields of a checkpoint file, tensors on `device` (the generator
    state stays on the CPU). A missing field raises."""
    ckpt = torch.load(path, map_location=device, weights_only=True)
    missing = [k for k in CHECKPOINT_FIELDS if k not in ckpt]
    if missing:
        raise ValueError(f"checkpoint {path} lacks {missing}")
    ckpt['generator'] = ckpt['generator'].cpu()
    return ckpt
