"""The plain reference of one training step, for one frame.

A frozen copy of the training step of `gsavatar_torch` (`train.py`:
`loss_weights`, `draw`, `make_loss_fn`, `make_batch_grad_fn`,
`make_batch_step_core`, `schedule_flags`, `densify_draws`,
`densify_step`, `refresh_knn`; `scene.py`: `param_group`,
`ConverterOptimizer`, `bucket_for`, the Scene's skinning pool, schedules
and learning rates) over the plain
modules of `plain/`: the compositor and the segment sums in plain PyTorch,
no kernel. It builds its own converter, skinning pool and neighbours from
the configuration and the subject; it takes from the benchmark only the
inputs: the weights, the frames and the draws' generator state."""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch

from .plain import losses as L
from .plain.core import gaussians as G
from .plain.core.densify import (add_stats_prefix, densify_and_prune,
                                 reset_opacity)
from .plain.core.optim import FIELDS, ArenaAdamState, adam_step
from .plain.models.converter import build_converter
from .plain.ops import lpips as lpips_mod
from .plain.ops.knn import knn_self
from .plain.ops.rasterizer import RasterizeConfig
from .plain.ops.sampling import sample_skinning_pool
from .plain.ops.ssim import ssim
from .plain.renderer import render
from .plain.utils.transforms import draw_view_angles, expon_lr_schedule

LOSS_WEIGHT_KEYS = ("lambda_l1", "lambda_dssim", "lambda_perceptual",
                    "lambda_mask", "lambda_skinning", "lambda_aiap_xyz",
                    "lambda_aiap_cov", "lambda_pose", "lambda_nr_xyz",
                    "lambda_nr_scale", "lambda_nr_rot", "lambda_opacity")


def loss_weights(cfg: dict, iteration: int) -> dict:
    return {k: L.C(iteration, cfg['opt'].get(k, 0.0))
            for k in LOSS_WEIGHT_KEYS}


def in_densify_window(cfg: dict, iteration: int) -> bool:
    return (iteration < int(cfg['opt']['densify_until_iter'])
            and iteration > int(cfg['model']['gaussian'].get('delay', 0)))


def schedule_flags(cfg: dict, iteration: int):
    """(in_window, do_densify, do_reset, use_screen_size_prune) at
    `iteration`."""
    opt = cfg['opt']
    in_window = in_densify_window(cfg, iteration)
    do_densify = (in_window
                  and iteration > int(opt['densify_from_iter'])
                  and iteration % int(opt['densification_interval']) == 0)
    do_reset = in_window and (
        iteration % int(opt['opacity_reset_interval']) == 0
        or (bool(cfg['dataset'].get('white_background', False))
            and iteration == int(opt['densify_from_iter'])))
    return (in_window, do_densify, do_reset,
            iteration > int(opt['opacity_reset_interval']))


def bucket_for(cfg: dict, n_alive: int) -> int:
    """`Scene.bucket_for`: n_alive rounded up to the granularity."""
    cap = int(cfg['model']['gaussian']['capacity'])
    g = int(cfg['opt'].get('bucket_granularity', 4096))
    if g <= 0:
        return cap
    return min(cap, max(g, int(math.ceil(n_alive / g)) * g))


def neighbours(cfg: dict, xyz, alive):
    """`refresh_knn` over an arena whose alive slots are a prefix: the
    neighbours of the first `bucket_for(n_alive)` slots."""
    b = bucket_for(cfg, int(alive.sum()))
    return knn_self(xyz[:b], G.K_NEIGHBORS, mask=alive[:b])


def param_group(name: str) -> str:
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
    """optax's chain: clip by the global norm (the frozen subject
    constants' gradients count in it), weight decay on the latent groups,
    Adam (0.9, 0.999, eps 1e-15), step -lr * gamma^t."""

    B1, B2, EPS = 0.9, 0.999, 1e-15

    def __init__(self, cfg: dict):
        opt = cfg['opt']
        self.gamma = float(opt['lr_ratio']) ** (1.0 / int(opt['iterations']))
        self.grad_clip = float(opt.get('grad_clip', 0.0))
        wd = float(opt.get('latent_weight_decay', 0.05))
        self.lr = {g: float(opt.get(f'{g}_lr', 0.0)) for g in (
            'rigid', 'non_rigid', 'nr_latent', 'pose_correction', 'texture',
            'tex_latent')}
        self.wd = {g: (wd if g in ('nr_latent', 'tex_latent') else 0.0)
                   for g in self.lr}

    @torch.no_grad()
    def step(self, params, grads, state: ConverterOptState, frozen_grads
             ) -> ConverterOptState:
        if self.grad_clip > 0:
            every = list(grads.values()) + list(frozen_grads.values())
            g_norm = torch.sqrt(sum((g * g).sum() for g in every))
            keep = g_norm < self.grad_clip
            grads = {k: torch.where(keep, g, g / g_norm * self.grad_clip)
                     for k, g in grads.items()}
        count = state.count + 1
        f32 = lambda x: torch.tensor(x, dtype=torch.float32)
        dev = next(iter(params.values())).device
        bc1 = (1 - f32(self.B1) ** count).to(dev)
        bc2 = (1 - f32(self.B2) ** count).to(dev)
        mu, nu = {}, {}
        for k, p in params.items():
            group = param_group(k)
            u = grads[k]
            if self.wd[group]:
                u = u + self.wd[group] * p
            mu[k] = (1 - self.B1) * u + self.B1 * state.mu[k]
            nu[k] = (1 - self.B2) * (u * u) + self.B2 * state.nu[k]
            upd = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + self.EPS)
            step_size = float(f32(-self.lr[group] * self.gamma ** state.count))
            p.add_(step_size * upd)
        return ConverterOptState(mu=mu, nu=nu, count=count)


@dataclasses.dataclass
class RefState:
    params: G.GaussianParams
    aux: G.GaussianAux         # alive, the densify statistics, neighbours
    adam: ArenaAdamState
    conv_opt: ConverterOptState
    bucket: int
    densified: int = 0

    @property
    def alive(self):
        return self.aux.alive


class RefTrainer:
    """The step of one subject: its converter (the given weights loaded),
    skinning pool, raster config and schedules."""

    def __init__(self, cfg: dict, subject, conv_weights, device):
        self.cfg = cfg
        self.device = torch.device(device)
        md = subject.metadata
        gcfg = cfg['model']['gaussian']
        self.use_sh = bool(gcfg['use_sh'])
        self.max_sh_degree = int(gcfg.get('sh_degree', 3))
        self.gauss_delay = int(gcfg.get('delay', 0))
        self.converter = build_converter(cfg, md, subject.assets).to(
            self.device)
        self.converter.load_state_dict(conv_weights)
        h, w = cfg['dataset']['img_hw']
        r = cfg['rasterizer']
        self.raster_config = RasterizeConfig(
            width=int(w), height=int(h), max_pairs=int(r['max_pairs']),
            max_rect=int(r['max_rect']))
        white = cfg['dataset'].get('white_background', False)
        self.background = torch.full((3,), 1.0 if white else 0.0,
                                     device=self.device)
        opt = cfg['opt']
        pool_pts, pool_w = sample_skinning_pool(
            md['smpl_verts'], md['faces'], md['skinning_weights'],
            pool_size=int(opt.get('skinning_pool_size', 65536)))
        self.pool_pts = md['aabb'].normalize(
            torch.as_tensor(pool_pts), sym=True).to(self.device)
        self.pool_w = torch.as_tensor(pool_w, device=self.device)
        self.n_reg_pts = int(opt.get('n_reg_pts', 1024))
        extent = self.extent = float(md['cameras_extent'])
        self.xyz_lr_fn = expon_lr_schedule(
            lr_init=float(opt['position_lr_init']) * extent,
            lr_final=float(opt['position_lr_final']) * extent,
            lr_delay_mult=float(opt['position_lr_delay_mult']),
            max_steps=int(opt['position_lr_max_steps']))
        self.conv_tx = ConverterOptimizer(cfg)
        self.mask_kind = opt.get('mask_loss_type', 'l1')
        self.crop_hw = tuple(opt.get('perceptual_crop_hw', (256, 256)))

    def state(self, arena: Dict[str, torch.Tensor], alive, iteration: int,
              adam_step: int, bucket: int) -> RefState:
        """The schedule's state at `iteration` from the given arena: zero
        moments and densify statistics, the arena's Adam at `adam_step`,
        the converter's count at `iteration`, the neighbours of the first
        `bucket` rows, dead rows never a neighbour."""
        params = G.GaussianParams(**{k: v.clone() for k, v in arena.items()})
        n = alive.shape[0]
        zeros = torch.zeros(n, device=self.device)
        aux = G.GaussianAux(
            alive=alive.clone(), max_radii2d=zeros,
            xyz_gradient_accum=zeros.clone(), denom=zeros.clone(),
            nn_ix=torch.zeros((n, G.K_NEIGHBORS), dtype=torch.int32,
                              device=self.device))
        self.refresh_knn(params, aux, bucket)
        conv = dict(self.converter.named_parameters())
        return RefState(
            params=params, aux=aux,
            adam=ArenaAdamState(m=params.map(torch.zeros_like),
                                v=params.map(torch.zeros_like),
                                step=adam_step),
            conv_opt=ConverterOptState(
                mu={k: torch.zeros_like(p) for k, p in conv.items()},
                nu={k: torch.zeros_like(p) for k, p in conv.items()},
                count=iteration),
            bucket=bucket)

    @staticmethod
    def refresh_knn(params, aux, bucket: int):
        aux.nn_ix[:bucket] = knn_self(params.xyz[:bucket], G.K_NEIGHBORS,
                                      mask=aux.alive[:bucket])

    def iterate(self, st: RefState, camera, iteration: int,
                generator: torch.Generator):
        """One iteration of the training loop, in place: the step, then
        densify and `refresh_knn` when due, then the opacity reset when
        due, each drawing from `generator` in the program's order; returns
        the step's loss."""
        _, do_densify, do_reset, use_ss = schedule_flags(self.cfg, iteration)
        loss = self.step(st, camera, iteration, self.draw(generator),
                         st.bucket)
        if do_densify:
            n = st.params.xyz.shape[0]
            eps1, eps2 = (torch.randn((n, 3), generator=generator)
                          .to(self.device) for _ in range(2))
            opt = self.cfg['opt']
            with torch.no_grad():
                st.params, st.aux, st.adam, info = densify_and_prune(
                    st.params, st.aux, st.adam, eps1, eps2,
                    grad_threshold=float(opt['densify_grad_threshold']),
                    min_opacity=float(opt['opacity_threshold']),
                    extent=float(self.extent),
                    percent_dense=float(opt['percent_dense']),
                    use_screen_size_prune=use_ss)
            st.bucket = bucket_for(self.cfg, int(info['n_alive']))
            self.refresh_knn(st.params, st.aux, st.bucket)
            st.densified += 1
        if do_reset:
            with torch.no_grad():
                st.params, st.adam = reset_opacity(st.params, st.adam,
                                                   st.alive)
        return loss

    def draw(self, generator: torch.Generator):
        """`train.draw`: the pose gate and noise, the view-noise angles and
        the skinning minibatch, in that order from `generator`."""
        vn = float(self.converter.view_noise)
        d = dict(pose_apply=float(torch.rand(1, generator=generator)[0]
                                  <= 0.5),
                 pose_noise=torch.randn((1, 24, 9), generator=generator),
                 view_angles=draw_view_angles(generator, vn, vn, vn),
                 sel=torch.randint(0, self.pool_pts.shape[0],
                                   (self.n_reg_pts,), generator=generator))
        return _Draws(d['pose_apply'], d['pose_noise'].to(self.device),
                      d['view_angles'].to(self.device),
                      d['sel'].to(self.device))

    def loss(self, params_b, alive, nn_ix, means2d, camera, iteration,
             weights, draws, deg):
        conv = self.converter
        gview = G.Gaussians(params=params_b, alive=alive,
                            active_sh_degree=deg,
                            max_sh_degree=self.max_sh_degree,
                            use_sh=self.use_sh)
        pkg = render(conv, gview, camera, iteration, self.raster_config,
                     self.background, train=True, draws=draws,
                     means2d_offset=means2d)
        gt, gt_mask = camera.image, camera.mask
        w = weights
        loss = (w['lambda_l1'] * L.l1_loss(pkg.render, gt)
                + w['lambda_dssim'] * (1.0 - ssim(pkg.render, gt))
                + w['lambda_mask'] * L.mask_loss(pkg.opacity_render, gt_mask,
                                                 self.mask_kind)
                + w['lambda_skinning'] * conv.skinning_loss(
                    self.pool_pts[draws.sel], self.pool_w[draws.sel]))
        ax, ac = L.full_aiap_loss(gview, pkg.deformed_gaussians, nn_ix=nn_ix)
        loss = (loss + w['lambda_aiap_xyz'] * ax + w['lambda_aiap_cov'] * ac
                + w['lambda_opacity'] * L.opacity_entropy_loss(
                    pkg.deformed_gaussians.get_opacity,
                    pkg.deformed_gaussians.alive))
        lam = self.cfg['opt'].get('lambda_perceptual', 0.0)
        lams = list(lam)[::2] if isinstance(lam, (list, tuple)) else [lam]
        if any(float(v) > 0 for v in lams):
            fg_r, fg_gt = L.foreground_crop(pkg.render, gt, gt_mask,
                                            self.crop_hw)
            loss = loss + w['lambda_perceptual'] * lpips_mod.lpips(fg_r,
                                                                   fg_gt)
        for name, value in pkg.loss_reg.items():
            loss = loss + w.get(f'lambda_{name}', 0.0) * value
        return loss, pkg.radii

    def step(self, st: RefState, camera, iteration: int, draws, bucket: int):
        """One optimizer step at `iteration`, in place; returns the loss."""
        cfg = self.cfg
        weights = loss_weights(cfg, iteration)
        deg = (min(iteration // 1000, self.max_sh_degree) if self.use_sh
               else 0)
        xyz_lr = float(self.xyz_lr_fn(iteration))
        params_b = st.params.map(lambda x: x[:bucket].detach()
                                 .requires_grad_())
        means2d = torch.zeros((bucket, 2), device=self.device,
                              requires_grad=True)
        consts = self.converter.subject_constants()
        for c in consts.values():
            c.requires_grad_(True)
        conv = dict(self.converter.named_parameters())
        try:
            loss, radii = self.loss(
                params_b, st.alive[:bucket], st.aux.nn_ix[:bucket], means2d,
                camera, iteration, weights, draws, deg)
            groups = [conv, consts, {f: getattr(params_b, f) for f in FIELDS},
                      {'means2d': means2d}]
            leaves = [x for g in groups for x in g.values()]
            flat = iter(torch.autograd.grad(loss, leaves, allow_unused=True))
        finally:
            for c in consts.values():
                c.requires_grad_(False)
        grads = [{k: (lambda g: torch.zeros_like(x) if g is None else g)(
            next(flat)) for k, x in g.items()} for g in groups]
        with torch.no_grad():
            st.conv_opt = self.conv_tx.step(conv, grads[0], st.conv_opt,
                                            frozen_grads=grads[1])
            lrs = {'xyz': xyz_lr, 'features_dc': float(cfg['opt']['feature_lr']),
                   'features_rest': float(cfg['opt']['feature_lr'])
                   / (20.0 if self.use_sh else 1.0),
                   'opacity': float(cfg['opt']['opacity_lr']),
                   'scaling': float(cfg['opt']['scaling_lr']),
                   'rotation': float(cfg['opt']['rotation_lr'])}
            head = lambda p: p.map(lambda x: x[:bucket])
            new_p, adam = adam_step(
                head(st.params), G.GaussianParams(**grads[2]),
                ArenaAdamState(m=head(st.adam.m), v=head(st.adam.v),
                               step=st.adam.step),
                lrs, st.alive[:bucket], apply=iteration >= self.gauss_delay)
            for f in FIELDS:
                for full, new in ((st.params, new_p), (st.adam.m, adam.m),
                                  (st.adam.v, adam.v)):
                    getattr(full, f)[:bucket] = getattr(new, f)
            st.adam.step = adam.step
            if in_densify_window(cfg, iteration):
                st.aux = add_stats_prefix(st.aux, grads[3]['means2d'], radii)
        return loss.detach()


@dataclasses.dataclass
class _Draws:
    pose_apply: float
    pose_noise: torch.Tensor
    view_angles: torch.Tensor
    sel: torch.Tensor
