"""One training iteration of the avatar.

Counterpart of `gsavatar/train.py`: `loss_weights`, `schedule_flags`,
`make_loss_fn`, `make_step_core` and `make_train_step`. One step renders
the camera at `train=True`, assembles every loss term (L1, D-SSIM, mask,
skinning, AIAP, opacity, LPIPS on the foreground crop, the model
regularizers), runs the backward pass (through K2 and K3 on the card),
steps the converter's optimizer and the arena Adam, and adds the densify
statistics. There is no `jit`: the port's arrays are dynamic, so `bucket`
(the alive prefix) is a slice, and `pair_bucket` / `rect_window` map onto
the rasterizer's `max_pairs` / `max_rect`.

torch cannot replay `jax.random`, so the step's random draws are explicit
(`TrainDraws`): the pose-noise gate and noise, the view-noise angles and
the skinning minibatch. A step given `draws=None` draws them from the
state's generator."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.profiler import record_function

from gsavatar_torch import losses as L
from gsavatar_torch.core import gaussians as G
from gsavatar_torch.core.densify import add_stats_prefix
from gsavatar_torch.core.optim import FIELDS, ArenaAdamState, adam_step
from gsavatar_torch.ops import lpips as lpips_mod
from gsavatar_torch.ops.ssim import ssim
from gsavatar_torch.renderer import render
from gsavatar_torch.utils.transforms import draw_view_angles

LOSS_WEIGHT_KEYS = ("lambda_l1", "lambda_dssim", "lambda_perceptual",
                    "lambda_mask", "lambda_skinning", "lambda_aiap_xyz",
                    "lambda_aiap_cov", "lambda_pose", "lambda_nr_xyz",
                    "lambda_nr_scale", "lambda_nr_rot", "lambda_opacity")


def loss_weights(cfg: dict, iteration: int) -> dict:
    return {k: L.C(iteration, cfg['opt'].get(k, 0.0))
            for k in LOSS_WEIGHT_KEYS}


def schedule_flags(iteration: int, *, densify_until: int, densify_from: int,
                   densify_interval: int, opacity_reset_interval: int,
                   gauss_delay: int, white_bg: bool):
    """The densification schedule: (in_window, do_densify, do_reset,
    use_screen_size_prune), everything inside the
    `gauss_delay < iteration < densify_until` window."""
    in_window = (iteration < densify_until) and (iteration > gauss_delay)
    do_densify = (in_window and iteration > densify_from
                  and iteration % densify_interval == 0)
    do_reset = in_window and (
        iteration % opacity_reset_interval == 0
        or (white_bg and iteration == densify_from))
    use_screen_size_prune = iteration > opacity_reset_interval
    return in_window, do_densify, do_reset, use_screen_size_prune


@dataclasses.dataclass
class TrainDraws:
    """The random draws of one training step."""
    pose_apply: float          # 1.0 when the pose noise applies (p = 0.5)
    pose_noise: torch.Tensor   # (1, 24, 9) standard normal
    view_angles: torch.Tensor  # (3,) view-noise angles in degrees
    sel: torch.Tensor          # (n_reg_pts,) skinning-pool minibatch

    def to(self, device) -> "TrainDraws":
        return dataclasses.replace(
            self, pose_noise=self.pose_noise.to(device),
            view_angles=self.view_angles.to(device), sel=self.sel.to(device))


def draw(scene, generator: torch.Generator) -> TrainDraws:
    """One step's draws from `generator` (a CPU generator), on the scene's
    device."""
    vn = float(scene.converter.view_noise)
    return TrainDraws(
        pose_apply=float(torch.rand(1, generator=generator)[0] <= 0.5),
        pose_noise=torch.randn((1, 24, 9), generator=generator),
        view_angles=draw_view_angles(generator, vn, vn, vn),
        sel=torch.randint(0, scene.skinning_pool_pts.shape[0],
                          (scene.n_reg_pts,), generator=generator),
    ).to(scene.device)


def _perceptual_on(cfg: dict) -> bool:
    lam = cfg['opt'].get('lambda_perceptual', 0.0)
    if isinstance(lam, (list, tuple)):
        return any(float(v) > 0 for v in list(lam)[::2])
    return float(lam) > 0


def make_loss_fn(scene):
    """loss_fn(gauss_params, alive, nn_ix, means2d_offset, camera,
    iteration, weights, draws, active_sh_degree, raster_cfg) ->
    (loss, metrics, radii), with the converter's parameters those of
    `scene.converter`."""
    converter = scene.converter
    mask_kind = scene.cfg['opt'].get('mask_loss_type', 'l1')
    use_perceptual = _perceptual_on(scene.cfg)
    crop_hw = tuple(scene.cfg['opt'].get('perceptual_crop_hw', (256, 256)))

    def loss_fn(gauss_params, alive, nn_ix, means2d_offset, camera,
                iteration, weights, draws: TrainDraws,
                active_sh_degree: int, raster_cfg):
        gview = G.Gaussians(params=gauss_params, alive=alive,
                            active_sh_degree=active_sh_degree,
                            max_sh_degree=scene.max_sh_degree,
                            use_sh=scene.use_sh)
        pkg = render(converter, gview, camera, iteration, raster_cfg,
                     scene.background, train=True, draws=draws,
                     means2d_offset=means2d_offset)
        gt, gt_mask = camera.image, camera.mask
        with record_function('train/losses'):
            loss_l1 = L.l1_loss(pkg.render, gt)
            loss_dssim = 1.0 - ssim(pkg.render, gt)
            loss_mask = L.mask_loss(pkg.opacity_render, gt_mask, mask_kind)
            loss_skinning = converter.skinning_loss(
                scene.skinning_pool_pts[draws.sel],
                scene.skinning_pool_w[draws.sel])
            loss_ax, loss_ac = L.full_aiap_loss(gview, pkg.deformed_gaussians,
                                                nn_ix=nn_ix)
            loss_opacity = L.opacity_entropy_loss(
                pkg.deformed_gaussians.get_opacity,
                pkg.deformed_gaussians.alive)

            w = weights
            loss = (w['lambda_l1'] * loss_l1
                    + w['lambda_dssim'] * loss_dssim
                    + w['lambda_mask'] * loss_mask
                    + w['lambda_skinning'] * loss_skinning
                    + w['lambda_aiap_xyz'] * loss_ax
                    + w['lambda_aiap_cov'] * loss_ac
                    + w['lambda_opacity'] * loss_opacity)
            if use_perceptual:
                fg_r, fg_gt = L.foreground_crop(pkg.render, gt, gt_mask,
                                                crop_hw)
                loss_perceptual = lpips_mod.lpips(fg_r, fg_gt)
                loss = loss + w['lambda_perceptual'] * loss_perceptual
            else:
                loss_perceptual = torch.zeros((), device=scene.device)
            for name, value in pkg.loss_reg.items():
                loss = loss + w.get(f'lambda_{name}', 0.0) * value

        metrics = {
            'loss/l1_loss': loss_l1, 'loss/ssim_loss': loss_dssim,
            'loss/mask_loss': loss_mask,
            'loss/loss_skinning': loss_skinning,
            'loss/xyz_aiap_loss': loss_ax, 'loss/cov_aiap_loss': loss_ac,
            'loss/opacity_loss': loss_opacity,
            'loss/perceptual_loss': loss_perceptual,
            'loss/total_loss': loss,
            'psnr': L.psnr(pkg.render, gt),
        }
        for name, value in pkg.loss_reg.items():
            metrics[f'loss/loss_{name}'] = value
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update({
            'overflow/pairs': pkg.pair_overflow,
            'overflow/rect': pkg.rect_dropped,
            'raster/n_pairs': pkg.n_pairs,
            'raster/max_rect_side': int(pkg.max_rect_side),
        })
        return loss, metrics, pkg.radii

    return loss_fn


def make_grad_fn(scene):
    """grad_fn(state, camera, iteration, weights, draws, active_sh_degree,
    bucket, raster_cfg) -> (metrics, radii, grads): the forward pass and the
    backward pass of one step over the first `bucket` arena rows, without
    the optimizer updates. `grads` holds 'conv' (by parameter name),
    'subject' (the converter's frozen constants, by buffer name), 'gauss'
    (GaussianParams) and 'means2d' (bucket, 2), the screen-space gradient
    of the densify statistics."""
    loss_core = make_loss_fn(scene)

    def grad_fn(state, camera, iteration, weights, draws, active_sh_degree,
                bucket, raster_cfg):
        params_b = state.gauss_params.map(
            lambda x: x[:bucket].detach().requires_grad_())
        means2d = torch.zeros((bucket, 2), device=scene.device,
                              requires_grad=True)
        consts = scene.converter.subject_constants()
        for c in consts.values():
            c.requires_grad_(True)
        try:
            loss, metrics, radii = loss_core(
                params_b, state.gauss_aux.alive[:bucket],
                state.gauss_aux.nn_ix[:bucket], means2d, camera, iteration,
                weights, draws, active_sh_degree, raster_cfg)
            groups = {'conv': state.conv_params, 'subject': consts,
                      'gauss': {f: getattr(params_b, f) for f in FIELDS},
                      'means2d': {'': means2d}}
            leaves = [x for g in groups.values() for x in g.values()]
            with record_function('train/backward'):
                flat = iter(torch.autograd.grad(loss, leaves,
                                                allow_unused=True))
        finally:
            for c in consts.values():
                c.requires_grad_(False)
        grads = {name: {k: (lambda g: torch.zeros_like(x) if g is None
                            else g)(next(flat)) for k, x in g.items()}
                 for name, g in groups.items()}
        return metrics, radii, {
            'conv': grads['conv'], 'subject': grads['subject'],
            'gauss': G.GaussianParams(**grads['gauss']),
            'means2d': grads['means2d']['']}

    return grad_fn


def make_step_core(scene):
    """step_core(state, camera, iteration, weights, xyz_lr,
    active_sh_degree=0, bucket=0, pair_bucket=0, rect_window=0, draws=None)
    -> (state, metrics). Updates `state` in place: the converter's
    parameters and optimizer state, the arena's first `bucket` rows and
    their Adam moments, and (when weights['_in_densify_window'] > 0) the
    densify statistics."""
    grad_fn = make_grad_fn(scene)

    def step_core(state, camera, iteration: int, weights: dict,
                  xyz_lr: float, active_sh_degree: int = 0, bucket: int = 0,
                  pair_bucket: int = 0, rect_window: int = 0,
                  draws: Optional[TrainDraws] = None):
        bucket = bucket or scene.capacity
        r_cfg = scene.raster_config
        if pair_bucket:
            r_cfg = dataclasses.replace(r_cfg, max_pairs=pair_bucket)
        if rect_window:
            r_cfg = dataclasses.replace(r_cfg, max_rect=rect_window)
        if draws is None:
            draws = draw(scene, state.generator)
        metrics, radii, grads = grad_fn(state, camera, iteration, weights,
                                        draws, active_sh_degree, bucket,
                                        r_cfg)
        with torch.no_grad(), record_function('train/update'):
            state.conv_opt = scene.conv_tx.step(
                state.conv_params, grads['conv'], state.conv_opt,
                frozen_grads=grads['subject'])

            lrs = dict(scene.gauss_lrs(0), xyz=xyz_lr)
            head = lambda p: p.map(lambda x: x[:bucket])
            params_b, adam = adam_step(
                head(state.gauss_params), grads['gauss'],
                ArenaAdamState(m=head(state.gauss_adam.m),
                               v=head(state.gauss_adam.v),
                               step=state.gauss_adam.step),
                lrs, state.gauss_aux.alive[:bucket],
                apply=iteration >= scene.gauss_delay)
            for f in FIELDS:
                for full, new in ((state.gauss_params, params_b),
                                  (state.gauss_adam.m, adam.m),
                                  (state.gauss_adam.v, adam.v)):
                    getattr(full, f)[:bucket] = getattr(new, f)
            state.gauss_adam.step = adam.step

            if weights.get('_in_densify_window', 0.0) > 0:
                state.gauss_aux = add_stats_prefix(
                    state.gauss_aux, grads['means2d'], radii)
        metrics['n_alive'] = state.gauss_aux.alive.sum()
        return state, metrics

    return step_core


# the training step is `make_step_core` as it is: there is nothing to compile
make_train_step = make_step_core
