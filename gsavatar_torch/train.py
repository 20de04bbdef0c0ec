"""Training: one iteration of the avatar, densify, validation and the driver.

Counterpart of `gsavatar/train.py`: `loss_weights`, `schedule_flags`,
`make_loss_fn`, `make_step_core`, `make_train_step`, `make_densify_step`
(here `densify_step`, `opacity_reset_step`, `refresh_knn`),
`make_validation`, `training` (around `TrainLoop`) and `main`. One step
renders the camera at `train=True`, assembles every loss term (L1, D-SSIM,
mask, skinning, AIAP, opacity, LPIPS on the foreground crop, the model
regularizers), runs the backward pass (through K2 and K3 on the card),
steps the converter's optimizer and the arena Adam, and adds the densify
statistics. The one-frame step is the B = 1 case of `make_batch_step_core`,
which renders B frames, takes the mean of their losses and makes one
backward pass and one optimizer step (`parallel/shard.py` reduces its
metrics, and over a mesh sums the data ranks' gradients between the
backward pass and the update). There is no `jit`: the port's arrays are
dynamic, so `bucket` (the alive prefix) is a slice, and `pair_bucket` /
`rect_window` map onto the rasterizer's `max_pairs` / `max_rect`.

torch cannot replay `jax.random`, so the step's random draws are explicit
(`TrainDraws`): the pose-noise gate and noise, the view-noise angles and
the skinning minibatch. A step given `draws=None` draws them from the
state's generator through `draw`; a densify round draws its split noise
through `densify_draws`. The frames are picked as the JAX driver picks
them, popping without replacement through `np.random.default_rng(seed)`,
so both packages visit the same frames.

The driver (`training`, `gsavatar/train.py:446-790`) runs the JAX driver's
routes in its order: `parallel.subjects` goes to
`parallel/multi_subject.py`; `parallel.data` = D >= 1 with
`parallel.model` = M >= 1 takes B = `parallel.frames_per_step` (else D)
frames per step over a D x M mesh (`parallel/mesh.py`,
`parallel/shard.py:make_sharded_train_step`; `gsavatar/train.py:485-520,
641-652`), with the JAX driver's ValueErrors when B is not a multiple of D
or D x M is not the world size of the process group. With D x M > 1 each
process is one rank (`torchrun`, or `main`'s own spawn, one rank per GPU):
every rank pops the same frames, renders its data row's, and runs
validation, densify, the reset and `refresh_knn` on its own copy of the
state, which stays equal to rank 0's bit for bit; the log, the PLY, the
checkpoints and the prints are rank 0's (`gsavatar/train.py:475, 519,
769`). Each iteration picks its B frames, the schedule, the step,
validation when due (before densify and the reset), densify and prune then
`refresh_knn` over the new alive-prefix bucket, the opacity reset, the log
and the overflow alarm, the PLY and the checkpoint. `TrainLoop` holds one
subject's part of that (the frames, the schedule, the step, densify, the
reset and the alarm), which the multi-subject driver runs once a subject.
The JAX driver also right-sizes its pair arena and tile window from the
observed workload (its pair/rect ladder), because XLA compiles one step
per static shape. The port's pair arrays are sized by their count, so it
runs at the config's `max_pairs` / `max_rect` ceilings and keeps only the
alarm: the pair overflow and `rect_dropped` counts (summed over a batch's
frames) are host integers in every step, so it checks them every
iteration, and `strict_overflow` raises. `save_val_images` writes each
validation frame's GT | render | 5x|error| strip as a PNG (`save_strip`);
`profile_trace_dir` takes a `torch.profiler` trace of iterations
[`profile_start_iter` (10), `profile_stop_iter` (start + 3)) on rank 0
(`TraceWindow`), where the JAX driver takes a `jax.profiler` trace, with
the tracer's summary beside it. Each iteration is one `tracing.unit`."""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from gsavatar_torch import losses as L
from gsavatar_torch import tracing
from gsavatar_torch.core import gaussians as G
from gsavatar_torch.core.densify import (add_stats_prefix, densify_and_prune,
                                         reset_opacity)
from gsavatar_torch.core.optim import FIELDS, ArenaAdamState, adam_step
from gsavatar_torch.ops import lpips as lpips_mod
from gsavatar_torch.ops.knn import knn_self
from gsavatar_torch.ops.ssim import ssim
from gsavatar_torch.parallel.context import sharding_scope
from gsavatar_torch.renderer import render
from gsavatar_torch.scene import Scene
from gsavatar_torch.utils import ply, png
from gsavatar_torch.utils.logging import MetricLogger
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
        with tracing.span('train/losses'):
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
            # the pairs route has no per-tile capacity (nor has the JAX
            # package's, which reports 0 under this key too)
            'overflow/tile': 0,
            'overflow/rect': pkg.rect_dropped,
            'raster/n_pairs': pkg.n_pairs,
            'raster/max_rect_side': int(
                tracing.device_read(pkg.max_rect_side)),
        })
        return loss, metrics, pkg.radii

    return loss_fn


def make_batch_grad_fn(scene):
    """grad_fn(state, cameras, iteration, weights, draws, active_sh_degree,
    bucket, raster_cfg, frames=0) -> (loss, metrics, radii, grads): the
    forward pass of each of the n `cameras` with its entry of `draws`, the
    sum of their losses over `frames` (default n: their mean), and one
    backward pass over the first `bucket` arena rows, without the optimizer
    updates. `metrics` and `radii` hold one entry per frame. `grads` holds
    'conv' (by parameter name), 'subject' (the converter's frozen
    constants, by buffer name), 'gauss' (GaussianParams) and 'means2d', a
    list of n (bucket, 2) screen-space gradients of that loss (the densify
    statistics). A rank of a mesh passes the batch's B as `frames`: the
    ranks' gradients then add up to the gradient of the batch's mean."""
    loss_core = make_loss_fn(scene)

    def grad_fn(state, cameras, iteration, weights, draws, active_sh_degree,
                bucket, raster_cfg, frames: int = 0):
        params_b = state.gauss_params.map(
            lambda x: x[:bucket].detach().requires_grad_())
        means2d = [torch.zeros((bucket, 2), device=scene.device,
                               requires_grad=True) for _ in cameras]
        consts = scene.converter.subject_constants()
        for c in consts.values():
            c.requires_grad_(True)
        try:
            losses, metrics, radii = [], [], []
            for camera, d, m2d in zip(cameras, draws, means2d):
                loss, m, r = loss_core(
                    params_b, state.gauss_aux.alive[:bucket],
                    state.gauss_aux.nn_ix[:bucket], m2d, camera, iteration,
                    weights, d, active_sh_degree, raster_cfg)
                losses.append(loss)
                metrics.append(m)
                radii.append(r)
            loss = torch.stack(losses).sum() / (frames or len(losses))
            groups = {'conv': state.conv_params, 'subject': consts,
                      'gauss': {f: getattr(params_b, f) for f in FIELDS},
                      'means2d': dict(enumerate(means2d))}
            leaves = [x for g in groups.values() for x in g.values()]
            with tracing.span('train/backward'):
                flat = iter(torch.autograd.grad(loss, leaves,
                                                allow_unused=True))
        finally:
            for c in consts.values():
                c.requires_grad_(False)
        grads = {name: {k: (lambda g: torch.zeros_like(x) if g is None
                            else g)(next(flat)) for k, x in g.items()}
                 for name, g in groups.items()}
        return loss.detach(), metrics, radii, {
            'conv': grads['conv'], 'subject': grads['subject'],
            'gauss': G.GaussianParams(**grads['gauss']),
            'means2d': list(grads['means2d'].values())}

    return grad_fn


def make_grad_fn(scene):
    """grad_fn(state, camera, iteration, weights, draws, active_sh_degree,
    bucket, raster_cfg) -> (metrics, radii, grads): `make_batch_grad_fn`
    for one camera, with grads['means2d'] its (bucket, 2) gradient."""
    batch_grad_fn = make_batch_grad_fn(scene)

    def grad_fn(state, camera, iteration, weights, draws, active_sh_degree,
                bucket, raster_cfg):
        _, (metrics,), (radii,), grads = batch_grad_fn(
            state, [camera], iteration, weights, [draws], active_sh_degree,
            bucket, raster_cfg)
        return metrics, radii, dict(grads, means2d=grads['means2d'][0])

    return grad_fn


def make_batch_step_core(scene, exchange=None):
    """core(state, cameras, iteration, weights, xyz_lr, active_sh_degree=0,
    bucket=0, pair_bucket=0, rect_window=0, draws=None) -> (state, loss,
    metrics): one optimizer step over the B frames of `cameras`, their
    per-frame metrics a list. Updates `state` in place: the converter's
    parameters and optimizer state (one step, the clip over the gradient
    of the mean loss), the arena's first `bucket` rows and their Adam
    moments, and (when weights['_in_densify_window'] > 0) the densify
    statistics, frame by frame in order, each frame's screen-space
    gradient scaled by B back to its own (`gsavatar/parallel/shard.py:
    180-187`). `draws=None` draws B `TrainDraws` from the state's
    generator, in frame order.

    `exchange` (`parallel/shard.py:DataExchange`, on a mesh with D > 1
    `data` ranks) makes `cameras` this rank's n rows of a batch of
    B = n D: the core draws all B (or takes the B `draws` given), renders
    its rows, and between the backward pass and the update the exchange
    sums the gradients and gathers the B frames' metrics, radii and
    screen-space gradients over the `data` group."""
    grad_fn = make_batch_grad_fn(scene)

    def core(state, cameras, iteration: int, weights: dict, xyz_lr: float,
             active_sh_degree: int = 0, bucket: int = 0, pair_bucket: int = 0,
             rect_window: int = 0, draws=None):
        bucket = bucket or scene.capacity
        r_cfg = scene.raster_config
        if pair_bucket:
            r_cfg = dataclasses.replace(r_cfg, max_pairs=pair_bucket)
        if rect_window:
            r_cfg = dataclasses.replace(r_cfg, max_rect=rect_window)
        n = len(cameras)
        size, index = (exchange.size, exchange.index) if exchange else (1, 0)
        frames = n * size
        if draws is None:
            draws = [draw(scene, state.generator) for _ in range(frames)]
        loss, metrics, radii, grads = grad_fn(
            state, cameras, iteration, weights,
            draws[index * n:(index + 1) * n], active_sh_degree, bucket, r_cfg,
            frames)
        if exchange is not None:
            with tracing.span('train/exchange'):
                loss, metrics, radii, grads = exchange(metrics, radii, grads)
        with torch.no_grad(), tracing.span('train/update'):
            with tracing.span('update/converter'):
                state.conv_opt = scene.conv_tx.step(
                    state.conv_params, grads['conv'], state.conv_opt,
                    frozen_grads=grads['subject'])

            with tracing.span('update/arena'):
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
                with tracing.span('update/stats'):
                    for g, r in zip(grads['means2d'], radii):
                        state.gauss_aux = add_stats_prefix(
                            state.gauss_aux, g * frames if frames > 1 else g,
                            r)
        return state, loss, metrics

    return core


def make_step_core(scene):
    """step_core(state, camera, iteration, weights, xyz_lr,
    active_sh_degree=0, bucket=0, pair_bucket=0, rect_window=0, draws=None)
    -> (state, metrics): `make_batch_step_core` for one camera, with
    metrics['n_alive']."""
    core = make_batch_step_core(scene)

    def step_core(state, camera, iteration: int, weights: dict,
                  xyz_lr: float, active_sh_degree: int = 0, bucket: int = 0,
                  pair_bucket: int = 0, rect_window: int = 0,
                  draws: Optional[TrainDraws] = None):
        state, _, (metrics,) = core(
            state, [camera], iteration, weights, xyz_lr, active_sh_degree,
            bucket, pair_bucket, rect_window,
            None if draws is None else [draws])
        metrics['n_alive'] = state.gauss_aux.alive.sum()
        return state, metrics

    return step_core


# the training step is `make_step_core` as it is: there is nothing to compile
make_train_step = make_step_core


def densify_draws(state, iteration: int):
    """The split draws of a densify round at `iteration`: two (N, 3)
    standard normals from the state's generator, on the arena's device.
    (The iteration is what the JAX package seeds its draws with; a test
    that replays them replaces this function.)"""
    n = state.gauss_params.xyz.shape[0]
    dev = state.gauss_params.xyz.device
    return tuple(torch.randn((n, 3), generator=state.generator).to(dev)
                 for _ in range(2))


@torch.no_grad()
def densify_step(scene, state, eps1, eps2, use_screen_size_prune: bool):
    """Densify and prune the arena (`core/densify.py`) with the config's
    thresholds; returns (state, info), info's counts still on the device."""
    opt = scene.cfg['opt']
    with tracing.span('densify/round'):
        params, aux, adam, info = densify_and_prune(
            state.gauss_params, state.gauss_aux, state.gauss_adam, eps1,
            eps2, grad_threshold=float(opt['densify_grad_threshold']),
            min_opacity=float(opt['opacity_threshold']),
            extent=scene.cameras_extent,
            percent_dense=float(opt['percent_dense']),
            use_screen_size_prune=bool(use_screen_size_prune))
    state.gauss_params, state.gauss_aux, state.gauss_adam = params, aux, adam
    return state, info


@torch.no_grad()
def opacity_reset_step(state):
    state.gauss_params, state.gauss_adam = reset_opacity(
        state.gauss_params, state.gauss_adam, state.gauss_aux.alive)
    return state


@torch.no_grad()
def refresh_knn(state, bucket: int):
    """Recompute the cached AIAP neighbours over the alive prefix
    `[:bucket]`, dead slots never a neighbour (after every densify and
    every resume)."""
    with tracing.span('densify/knn'):
        state.gauss_aux.nn_ix[:bucket] = knn_self(
            state.gauss_params.xyz[:bucket], G.K_NEIGHBORS,
            mask=state.gauss_aux.alive[:bucket])
    return state


def host_metrics(metrics: dict) -> dict:
    """Every value of `metrics` as a Python float, with one device read for
    all its tensors."""
    keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
    vals = dict(zip(keys, tracing.device_read(torch.stack([
        metrics[k].detach().double().reshape(()) for k in keys])).tolist()
        if keys else []))
    return {k: vals[k] if k in vals else float(v)
            for k, v in metrics.items()}


@torch.no_grad()
def save_strip(img, camera, path: str) -> None:
    """The evidence strip GT | render | 5 x |error| of a validation frame
    (each clipped to [0, 1], times 255 and truncated) as an (H, 3W, 3)
    8-bit PNG at `path`."""
    gt = torch.clamp(camera.image, 0.0, 1.0)
    err = torch.clamp(5.0 * torch.abs(img - gt), 0.0, 1.0)
    strip = torch.cat([gt, img, err], dim=1)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    png.write_png(path, (strip * 255).to(torch.uint8).cpu().numpy())


def make_validation(scene):
    """validation(state, iteration, logger, exp_dir=None,
    max_val_frames=None, bucket=0, quiet=False, save_images=False) ->
    results: renders the test split and
    every (len/10)-th training frame at eval, and reports per split the
    means of l1, PSNR, SSIM and LPIPS (f32, keyed by its weight source),
    the opacity histogram of the alive slots and their count. A frame
    whose pairs overflow or whose rects are clamped raises the overflow
    alarm as a training step does. `quiet` (a rank other than 0) prints
    and writes nothing. `save_images` writes each frame's `save_strip` to
    `<exp_dir>/validation/iter_<n>/<split>_<image name>.png`."""
    key = lpips_mod.metric_key()

    @torch.no_grad()
    def render_and_score(state, camera, active_sh_degree: int = 0,
                         bucket: int = 0):
        gview = G.make_view(state.gauss_params, state.gauss_aux,
                            active_sh_degree=active_sh_degree,
                            max_sh_degree=scene.max_sh_degree,
                            use_sh=scene.use_sh, bucket=bucket)
        pkg = render(scene.converter, gview, camera, 10 ** 9,
                     scene.raster_config, scene.background)
        img = torch.clamp(pkg.render, 0.0, 1.0)
        gt = torch.clamp(camera.image, 0.0, 1.0)
        out = {'l1_loss': L.l1_loss(img, gt), 'psnr': L.psnr(img, gt),
               'ssim': ssim(img, gt), key: lpips_mod.lpips(img, gt)}
        return out, pkg, img

    def validation(state, iteration: int, logger, exp_dir=None,
                   max_val_frames=None, bucket: int = 0, quiet: bool = False,
                   save_images: bool = False):
        deg = scene.active_sh_degree(iteration)
        n_train = len(scene.train_dataset)
        splits = {'test': list(range(len(scene.test_dataset))),
                  'train': list(range(0, n_train, max(n_train // 10, 1)))}
        if max_val_frames:
            splits = {k: v[:max_val_frames] for k, v in splits.items()}
        results = {}
        for name, idxs in splits.items():
            acc: dict = {}
            for i in idxs:
                camera = scene.device_camera(
                    i, 'train' if name == 'train' else 'test')
                m, pkg, img = render_and_score(state, camera, deg, bucket)
                overflow_alarm(scene.cfg, iteration, pkg.pair_overflow,
                               pkg.rect_dropped, quiet=quiet)
                if save_images and exp_dir and not quiet:
                    save_strip(img, camera, os.path.join(
                        exp_dir, 'validation', f'iter_{iteration}',
                        f'{name}_{camera.image_name}.png'))
                for k, v in host_metrics(m).items():
                    acc.setdefault(k, []).append(v)
            for k, v in acc.items():
                results[f'val/{name}_{k}'] = float(np.mean(v))
        results['val/opacity_histogram'] = opacity_histogram(
            state).tolist()
        results['val/total_points'] = int(state.gauss_aux.alive.sum())
        if logger is not None:
            logger.log(iteration, results)
        if 'val/test_psnr' in results and not quiet:
            print(f"\n[ITER {iteration}] Evaluating test: "
                  f"PSNR {results['val/test_psnr']:.2f}", flush=True)
        return results

    return validation


@torch.no_grad()
def opacity_histogram(state):
    """20 bins of the alive slots' opacities over [0, 1], the last bin
    closed, as `jnp.histogram` bins them (f32 counts)."""
    op = torch.sigmoid(state.gauss_params.opacity[:, 0])
    x = torch.where(state.gauss_aux.alive, op, -1.0)
    edges = torch.linspace(0.0, 1.0, 21, device=x.device)
    idx = torch.searchsorted(edges, x, right=True)
    idx = torch.where(x == edges[-1], 20, idx)
    return torch.bincount(idx, minlength=22)[1:21].to(torch.float32)


def overflow_alarm(cfg, iteration: int, pairs: int, rect: int,
                   quiet: bool = False) -> bool:
    """Print the JAX driver's warning when work was dropped (unless
    `quiet`: a rank other than 0); raise with `strict_overflow`. True when
    it fired."""
    if pairs + rect <= 0:
        return False
    msg = (f"[gsavatar_torch] WARNING iter {iteration}: rasterizer overflow "
           f"(pairs={pairs}, rect={rect}) — splats are being "
           f"DROPPED or cropped. Raise rasterizer.max_pairs / max_rect.")
    if not quiet:
        print(msg, flush=True)
    if bool(cfg.get('strict_overflow', False)):
        raise RuntimeError(msg)
    return True


def alive_bucket(scene, state) -> int:
    """The bucket of a run's first step: the alive count's, when the alive
    slots are the prefix that densify's compaction makes, else the whole
    capacity."""
    alive = state.gauss_aux.alive.cpu()
    n_alive = int(alive.sum())
    return scene.bucket_for(n_alive) if bool(alive[:n_alive].all()) \
        else scene.capacity


class TrainLoop:
    """One subject's training loop: its state, the schedule (from `cfg`),
    the frame picker, the alive-prefix bucket and the one-shot overflow
    alarm, and one iteration in two halves, `step` and `after_step`, with
    validation (when due) between them as the JAX driver orders it.
    `step_fn` is a `make_train_step` or a sharded step. Frames are popped
    without replacement from the training frames, refilled when empty,
    through `np.random.default_rng(seed)` (`gsavatar/train.py:641-652`).
    `training` drives one loop, `parallel/multi_subject.py` one a subject.
    The module's functions are looked up when called, so that a caller may
    replace them."""

    def __init__(self, cfg: dict, scene, state, step_fn, seed: int = 0):
        opt = cfg['opt']
        self.cfg, self.scene, self.state, self.step_fn = (cfg, scene, state,
                                                          step_fn)
        self.flags = dict(
            densify_until=int(opt['densify_until_iter']),
            densify_from=int(opt['densify_from_iter']),
            densify_interval=int(opt['densification_interval']),
            opacity_reset_interval=int(opt['opacity_reset_interval']),
            gauss_delay=int(cfg['model']['gaussian'].get('delay', 0)),
            white_bg=bool(cfg['dataset'].get('white_background', False)))
        self.rng = np.random.default_rng(seed)
        self.frames: list = []
        self.bucket = alive_bucket(scene, state)
        self.alarmed = False

    def next_frame(self) -> int:
        """The index of the next training frame."""
        if not self.frames:
            self.frames = list(range(len(self.scene.train_dataset)))
        return self.frames.pop(int(self.rng.integers(len(self.frames))))

    def step(self, iteration: int, cameras) -> dict:
        """The loss weights and the densify window of `iteration`, its
        position learning rate and SH degree, then one step of `step_fn` on
        `cameras` at the bucket; returns the step's metrics."""
        weights = loss_weights(self.cfg, iteration)
        in_window = schedule_flags(iteration, **self.flags)[0]
        weights['_in_densify_window'] = 1.0 if in_window else 0.0
        self.state, metrics = self.step_fn(
            self.state, cameras, iteration, weights,
            float(self.scene.xyz_lr_fn(iteration)),
            active_sh_degree=self.scene.active_sh_degree(iteration),
            bucket=self.bucket)
        return metrics

    def after_step(self, iteration: int):
        """Densify and prune when due (one device read for its counts), the
        new bucket and `refresh_knn` over it, then the opacity reset when
        due. Returns the round's counts as host integers, None without a
        round."""
        _, do_densify, do_reset, use_ss = schedule_flags(iteration,
                                                         **self.flags)
        counts = None
        if do_densify:
            eps1, eps2 = densify_draws(self.state, iteration)
            self.state, info = densify_step(self.scene, self.state, eps1,
                                            eps2, use_ss)
            counts = {k: int(v) for k, v in zip(info, tracing.device_read(
                torch.stack(list(info.values()))).tolist())}
            self.bucket = self.scene.bucket_for(counts['n_alive'])
            refresh_knn(self.state, self.bucket)
        if do_reset:
            opacity_reset_step(self.state)
        return counts

    def alarm(self, iteration: int, pairs: int, rect: int,
              quiet: bool = False) -> None:
        """`overflow_alarm` until it first fires."""
        if not self.alarmed:
            self.alarmed = overflow_alarm(self.cfg, iteration, pairs, rect,
                                          quiet=quiet)


def training(cfg: dict, scene=None, max_iterations=None, log_every: int = 10,
             progress: bool = True, device=None):
    """The optimization loop; returns (scene, final state, logger). Runs on
    the GPU unless `device` (or the given scene's) is the CPU.
    `parallel.subjects` (with no scene given) trains each subject's avatar
    (`parallel/multi_subject.py`, which returns its own triple);
    `parallel.data` = D >= 1 with `parallel.model` = M >= 1 takes B =
    `parallel.frames_per_step` (else D) frames per step over a D x M mesh
    (`parallel/shard.py:make_sharded_train_step`). With D x M > 1 this
    process is one rank of a process group of D x M ranks
    (`parallel/mesh.py:initialize_distributed`, from `torchrun`'s
    environment unless the caller set one up), on `cuda:LOCAL_RANK` under
    NCCL unless `device` says otherwise; every rank returns its state,
    and rank 0 alone its logger (None elsewhere)."""
    par = cfg.get('parallel') or {}
    if scene is None and par.get('subjects'):
        from gsavatar_torch.parallel.multi_subject import \
            training_multi_subject
        return training_multi_subject(cfg, max_iterations=max_iterations,
                                      log_every=log_every, progress=progress,
                                      device=device)
    mesh_data = int(par.get('data', 0) or 0)
    mesh_model = int(par.get('model', 0) or 0)
    use_mesh = mesh_data >= 1 and mesh_model >= 1
    batch_frames = int(par.get('frames_per_step', 0) or mesh_data) \
        if use_mesh else 1
    mesh = None
    if use_mesh:
        from gsavatar_torch.parallel import mesh as mesh_mod
        from gsavatar_torch.parallel import shard
        if batch_frames % mesh_data != 0:
            raise ValueError(f"parallel.frames_per_step ({batch_frames}) "
                             f"must be a multiple of parallel.data "
                             f"({mesh_data})")
        n_dev = mesh_data * mesh_model
        if n_dev > 1:
            mesh_mod.initialize_distributed()
        mesh_mod.require_world(n_dev, 'parallel.data x parallel.model')
        mesh = mesh_mod.make_mesh(n_dev, data=mesh_data, model=mesh_model)
        if device is None:
            device = mesh_mod.rank_device()
    lead = mesh is None or mesh.rank == 0
    seed = max(int(cfg.get('seed', -1)), 0)
    scene = scene or Scene(cfg, seed=seed, device=device)
    iterations = int(max_iterations or cfg['opt']['iterations'])

    start_checkpoint = cfg.get('start_checkpoint')
    if start_checkpoint:
        state, first_iteration = scene.load_checkpoint(str(start_checkpoint))
        first_iteration += 1
        if lead:
            print(f"Resuming from {start_checkpoint} at iteration "
                  f"{first_iteration}")
    else:
        state = scene.init_state()
        first_iteration = 1

    exp_dir = cfg.get('exp_dir') or os.path.join('exp',
                                                 str(cfg.get('name', 'run')))
    logger = None
    if lead:
        os.makedirs(exp_dir, exist_ok=True)
        logger = MetricLogger(os.path.join(exp_dir, 'metrics.jsonl'))
        logger.log(0, {'lpips_weights': lpips_mod.weights_kind()})

    if use_mesh:
        step = shard.make_sharded_train_step(scene, mesh)
        state = shard.put_replicated(state, mesh)
        if lead and progress and mesh_mod.world_size() > 1:
            print(f"Training over mesh {mesh.shape} "
                  f"({mesh_mod.world_size()} ranks)", flush=True)
    else:
        step = make_train_step(scene)
    validation = make_validation(scene)

    # every rank pops the same frames
    loop = TrainLoop(cfg, scene, state, step, seed)
    if start_checkpoint:
        refresh_knn(loop.state, loop.bucket)

    checkpoint_iterations = list(cfg.get('checkpoint_iterations') or [])
    checkpoint_iterations.append(iterations)
    save_iterations = list(cfg.get('save_iterations') or [])
    test_interval = int(cfg.get('test_interval', 0) or 0)
    test_iterations = set(cfg.get('test_iterations') or [])
    max_val_frames = cfg.get('max_val_frames')

    # `profile_trace_dir`: a torch.profiler trace of iterations
    # [profile_start_iter, profile_stop_iter), written by rank 0
    trace_dir = cfg.get('profile_trace_dir') if lead else None
    trace_start = int(cfg.get('profile_start_iter', 10))
    trace_stop = int(cfg.get('profile_stop_iter', trace_start + 3))
    trace = TraceWindow(trace_dir, trace_start, trace_stop, scene.device)
    save_val_images = bool(cfg.get('save_val_images', False))

    scope = sharding_scope(mesh) if use_mesh else contextlib.nullcontext()
    t0 = time.time()
    with scope:
        for iteration in range(first_iteration, iterations + 1):
            trace.at(iteration)
            with tracing.unit(iteration, 'train/step'):
                idxs = [loop.next_frame() for _ in range(batch_frames)]
                if use_mesh:
                    cameras = [scene.device_camera(i, 'train')
                               for i in shard.put_batch(idxs, mesh)]
                else:
                    cameras = scene.device_camera(idxs[0], 'train')
                metrics = loop.step(iteration, cameras)

                # validation before densify and the reset, as the JAX driver
                # does; on every rank (the compositor's ranges), logged by
                # rank 0
                if (test_interval > 0 and iteration % test_interval == 0) \
                        or iteration in test_iterations:
                    validation(loop.state, iteration, logger, exp_dir,
                               max_val_frames=max_val_frames,
                               bucket=loop.bucket, quiet=not lead,
                               save_images=save_val_images)
                    t0 = time.time()   # validation is not iteration time

                counts = loop.after_step(iteration)
                if counts and logger:
                    logger.log(iteration, {f'densify/{k}': v
                                           for k, v in counts.items()})

                # the counts are host integers (a batch step's, summed over
                # its frames), equal on every rank
                loop.alarm(iteration, metrics['overflow/pairs'],
                           metrics['overflow/rect'], quiet=not lead)
                if logger and (iteration % log_every == 0 or iteration == 1):
                    m = host_metrics(metrics)
                    m['iter_time'] = (time.time() - t0) / log_every * 1000.0
                    logger.log(iteration, m)
                    if progress and (iteration % (log_every * 10) == 0
                                     or iteration == 1):
                        print(f"[{iteration}/{iterations}] "
                              f"loss={m['loss/total_loss']:.5f} "
                              f"psnr={m['psnr']:.2f} n={int(m['n_alive'])} "
                              f"({m['iter_time']:.0f} ms/it)", flush=True)
                if iteration % log_every == 0 or iteration == 1:
                    t0 = time.time()

                if lead and iteration in save_iterations:
                    ply.save_arena_ply(
                        os.path.join(exp_dir, 'point_cloud',
                                     f'iteration_{iteration}',
                                     'point_cloud.ply'),
                        loop.state.gauss_params, loop.state.gauss_aux)
                if lead and iteration in checkpoint_iterations:
                    scene.save_checkpoint(loop.state, iteration, exp_dir)
    trace.at(trace_stop)

    return scene, loop.state, logger


class TraceWindow:
    """A `torch.profiler` trace (CPU, and CUDA on a GPU) from iteration
    `start` up to `stop`: `at(iteration)` starts it at `start` and, at
    `stop`, synchronizes the device (the last step's kernels finish inside
    the trace, as the JAX driver blocks on the positions) and writes
    `<trace_dir>/trace_<start>_<stop>.json`, a Chrome trace, and beside it
    `spans_<start>_<stop>.json`, the tracer's `summary()` of the window
    (the tracer is on for the window unless it was on already). A run that
    ends inside the window writes them then. No `trace_dir`, no trace."""

    def __init__(self, trace_dir, start: int, stop: int, device):
        self.trace_dir, self.start, self.stop = trace_dir, start, stop
        self.device = torch.device(device)
        self.prof = None
        self.path = None
        self.owns_tracer = False

    def at(self, iteration: int) -> None:
        if not self.trace_dir:
            return
        if self.prof is None and iteration == self.start:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == 'cuda':
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.owns_tracer = not tracing.enabled()
            if self.owns_tracer:
                tracing.enable()
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()
        elif self.prof is not None and iteration >= self.stop:
            if self.device.type == 'cuda':
                torch.cuda.synchronize(self.device)
            self.prof.stop()
            if self.owns_tracer:
                tracing.disable()
            os.makedirs(self.trace_dir, exist_ok=True)
            self.path = os.path.join(self.trace_dir,
                                     f'trace_{self.start}_{self.stop}.json')
            self.prof.export_chrome_trace(self.path)
            with open(os.path.join(self.trace_dir, f'spans_{self.start}_'
                                   f'{self.stop}.json'), 'w') as f:
                json.dump(tracing.summary(), f, indent=1)
            self.prof = None


def ranks_of(cfg: dict) -> int:
    """The ranks a config trains on: parallel.data x parallel.model, or
    parallel.data with subjects; 1 on the plain route."""
    par = cfg.get('parallel') or {}
    data = int(par.get('data', 0) or 0)
    model = int(par.get('model', 0) or 0)
    if par.get('subjects'):
        return max(data, 1)
    return data * model if data >= 1 and model >= 1 else 1


def _rank_main(rank: int, cfg: dict, world: int, port: int) -> None:
    """One rank that `main` started: torchrun's environment, then the
    driver, then the process group's end."""
    import torch.distributed as dist
    os.environ.update(MASTER_ADDR='127.0.0.1', MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    try:
        training(cfg, log_every=int(cfg.get('log_every', 10) or 10),
                 progress=rank == 0)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def main(argv=None):
    """`python -m gsavatar_torch.train [key=value ...]`: train the avatar
    on the GPU, logging to `<exp_dir>/metrics.jsonl`. A config on more than
    one rank (`ranks_of`) joins the process group under `torchrun
    --nproc_per_node=<ranks> -m gsavatar_torch.train ...`; started plainly,
    it starts its ranks itself with `torch.multiprocessing.spawn`, one per
    GPU, as one JAX process drives every visible device."""
    import sys
    from gsavatar_torch.config import load_config
    from gsavatar_torch.parallel import mesh as mesh_mod
    cfg = load_config(list(argv if argv is not None else sys.argv[1:]))
    cfg['exp_dir'] = cfg.get('exp_dir') or os.path.join('exp',
                                                        str(cfg['name']))
    ranks = ranks_of(cfg)
    if ranks > 1 and 'RANK' not in os.environ:
        n_gpus = torch.cuda.device_count()
        if ranks > n_gpus:
            raise ValueError(f"the config trains on {ranks} ranks, which "
                             f"exceeds the {n_gpus} visible GPUs")
        print(f"Optimizing {cfg['exp_dir']} on {ranks} GPUs")
        torch.multiprocessing.spawn(
            _rank_main, args=(cfg, ranks, mesh_mod.free_port()),
            nprocs=ranks)
    else:
        if int(os.environ.get('RANK', 0)) == 0:
            print(f"Optimizing {cfg['exp_dir']}")
        training(cfg, log_every=int(cfg.get('log_every', 10) or 10),
                 progress=int(os.environ.get('RANK', 0)) == 0)
    if int(os.environ.get('RANK', 0)) == 0:
        print("\nTraining complete.")


if __name__ == '__main__':
    main()
