"""S avatars trained in one run (BASELINE config 5: four ZJU-MoCap
subjects).

Counterpart of `gsavatar/parallel/multi_subject.py`. `cfg.parallel.
subjects` is a list of dataset overrides, one per subject; subject i is
the single-subject config with its overrides (`subject_scene_cfg`), built
as a `Scene` with seed + i. The JAX package stacks the S states on a
leading axis and vmaps the single-subject step over it, which needs every
subject at one static shape: one bucket (the max over the subjects), the
skinning pools as stacked inputs, the subject constants in a flax variable
collection. The port keeps per-subject buffers instead, a list of S
`TrainState`s, and runs the single-subject `step_core`, `densify_step`,
`opacity_reset_step` and `refresh_knn` on each subject's own state, in
subject order: each subject with its own Scene (its skinning pool, AABB
and SMPL tables), at its own bucket, and with the split noise of each
densify drawn from its own state's generator (the JAX package gives every
lane `PRNGKey(iteration)`). So subject i of a multi-subject run equals, bit
for bit on the same device, the single-subject run of `train.training`
with seed + i and dataset overrides i: the same frames (`default_rng(seed +
i)`), the same draws, the same operations.

`parallel.data = D > 1` puts subject i on `cuda:(i // (S / D))`; the
subjects still run one after another from one host thread."""
from __future__ import annotations

import copy
import os
import time
from typing import List, Optional

import numpy as np
import torch

from gsavatar_torch import train
from gsavatar_torch.device import resolve_device
from gsavatar_torch.scene import Scene
from gsavatar_torch.utils.logging import MetricLogger


def subject_scene_cfg(cfg: dict, overrides: dict) -> dict:
    """One subject's single-subject config: the base config with the
    subject's dataset overrides applied and the multi-subject routing
    removed."""
    out = copy.deepcopy(cfg)
    out['parallel'] = dict(out.get('parallel') or {}, subjects=None, data=0,
                           model=0)
    out['dataset'].update(copy.deepcopy(dict(overrides or {})))
    return out


def subject_devices(n_subjects: int, data: int, device=None) -> list:
    """Each subject's device: `device` (the GPU by default) for all, or with
    `data` = D > 1, subject i on cuda:(i // (S / D))."""
    if data <= 1:
        return [resolve_device(device)] * n_subjects
    if n_subjects % data != 0:
        raise ValueError(f"subjects ({n_subjects}) must be divisible by "
                         f"parallel.data ({data})")
    n_gpus = torch.cuda.device_count()
    if data > n_gpus:
        raise ValueError(f"parallel.data = {data} exceeds the {n_gpus} "
                         f"visible GPUs")
    per = n_subjects // data
    return [torch.device('cuda', i // per) for i in range(n_subjects)]


class MultiSubjectScene:
    """S single-subject Scenes that share the architecture, the arena
    capacity, the raster config (so the image size), the train length and
    the skinning pool's shape; a subject that differs in one raises a
    ValueError naming the subject and the field."""

    def __init__(self, cfg: dict, seed: int = 0, device=None):
        subs = list((cfg.get('parallel') or {}).get('subjects') or [])
        if not subs:
            raise ValueError("cfg.parallel.subjects must be a non-empty "
                             "list of per-subject dataset overrides")
        devices = subject_devices(
            len(subs), int(cfg['parallel'].get('data', 0) or 0), device)
        self.cfg = cfg
        self.scenes: List[Scene] = [
            Scene(subject_scene_cfg(cfg, ov), seed=seed + i, device=dev)
            for i, (ov, dev) in enumerate(zip(subs, devices))]
        fields = {
            'capacity': lambda s: s.capacity,
            'use_sh': lambda s: s.use_sh,
            'sh_degree': lambda s: s.max_sh_degree,
            'raster_config': lambda s: s.raster_config,
            'train length': lambda s: len(s.train_dataset),
            'pool shape': lambda s: tuple(s.skinning_pool_pts.shape),
        }
        s0 = self.scenes[0]
        for i, s in enumerate(self.scenes[1:], 1):
            for name, get in fields.items():
                if get(s) != get(s0):
                    raise ValueError(f"subject {i}: {name} {get(s)} differs "
                                     f"from subject 0's {get(s0)}")
        self.n_subjects = len(self.scenes)

    def init_states(self) -> list:
        return [s.init_state() for s in self.scenes]


def make_multi_subject_step(ms: MultiSubjectScene):
    """ms_step(states, cameras, iteration, weights, active_sh_degree=0,
    buckets=None, draws=None) -> (states, metrics): each subject's
    `train.make_step_core` on its own state and camera, in subject order,
    at its own bucket and learning rate; `metrics` and `draws` (to replay)
    hold one entry per subject."""
    cores = [train.make_step_core(s) for s in ms.scenes]

    def ms_step(states, cameras, iteration: int, weights: dict,
                active_sh_degree: int = 0, buckets=None, draws=None):
        metrics = []
        for i, (core, scene) in enumerate(zip(cores, ms.scenes)):
            states[i], m = core(
                states[i], cameras[i], iteration, weights,
                float(scene.xyz_lr_fn(iteration)),
                active_sh_degree=active_sh_degree,
                bucket=buckets[i] if buckets else 0,
                draws=None if draws is None else draws[i])
            metrics.append(m)
        return states, metrics

    return ms_step


def make_multi_subject_densify(ms: MultiSubjectScene):
    """(densify_step, opacity_reset_step, refresh_knn) over the subjects'
    states: `densify_step(states, iteration, use_screen_size_prune)` ->
    (states, infos) with each subject's split noise from its own state's
    generator (`train.densify_draws`); `opacity_reset_step(states)`;
    `refresh_knn(states, buckets)`."""

    def densify_step(states, iteration: int, use_screen_size_prune: bool):
        infos = []
        for i, scene in enumerate(ms.scenes):
            eps1, eps2 = train.densify_draws(states[i], iteration)
            states[i], info = train.densify_step(scene, states[i], eps1, eps2,
                                                 use_screen_size_prune)
            infos.append(info)
        return states, infos

    def opacity_reset_step(states):
        return [train.opacity_reset_step(s) for s in states]

    def refresh_knn(states, buckets):
        return [train.refresh_knn(s, b) for s, b in zip(states, buckets)]

    return densify_step, opacity_reset_step, refresh_knn


def training_multi_subject(cfg: dict, max_iterations=None,
                           log_every: int = 10, progress: bool = True,
                           device=None,
                           ms: Optional[MultiSubjectScene] = None):
    """The multi-subject driver: the single-subject driver's schedule and
    loss weights, each subject's frames popped without replacement from
    `default_rng(seed + i)`, every subject advancing one iteration per
    loop. Logs per-subject validation under `subject{i}/...`, the densify
    counts as lists over the subjects, and rows of each metric's mean over
    the subjects beside `subject{i}/<key>`; writes each subject's final
    checkpoint under `exp_dir/subject{i}`. `ms`, the subjects' scenes, is
    built from `cfg` unless given. Returns (MultiSubjectScene, the S
    states, logger)."""
    par = cfg.get('parallel') or {}
    if int(par.get('model', 0) or 0) > 1:
        raise ValueError("multi-subject training shards subjects over "
                         "'data'; use model=1")
    seed = max(int(cfg.get('seed', -1)), 0)
    ms = ms or MultiSubjectScene(cfg, seed=seed, device=device)
    S = ms.n_subjects
    opt = cfg['opt']
    iterations = int(max_iterations or opt['iterations'])

    ms_step = make_multi_subject_step(ms)
    densify_step, opacity_reset_step, refresh_knn = \
        make_multi_subject_densify(ms)
    states = ms.init_states()

    exp_dir = cfg.get('exp_dir') or os.path.join(
        'exp', str(cfg.get('name', 'run')) + '-ms')
    os.makedirs(exp_dir, exist_ok=True)
    logger = MetricLogger(os.path.join(exp_dir, 'metrics.jsonl'))

    buckets = [train.alive_bucket(s, st) for s, st in zip(ms.scenes, states)]
    flags = dict(densify_until=int(opt['densify_until_iter']),
                 densify_from=int(opt['densify_from_iter']),
                 densify_interval=int(opt['densification_interval']),
                 opacity_reset_interval=int(opt['opacity_reset_interval']),
                 gauss_delay=int(cfg['model']['gaussian'].get('delay', 0)),
                 white_bg=bool(cfg['dataset'].get('white_background',
                                                   False)))

    # subject i picks its frames as its single-subject run does
    rngs = [np.random.default_rng(seed + i) for i in range(S)]
    stacks: List[list] = [[] for _ in range(S)]

    def next_frame_idx(i):
        if not stacks[i]:
            stacks[i] = list(range(len(ms.scenes[i].train_dataset)))
        return stacks[i].pop(int(rngs[i].integers(len(stacks[i]))))

    test_interval = int(cfg.get('test_interval', 0) or 0)
    max_val_frames = cfg.get('max_val_frames')
    validations = [train.make_validation(s) for s in ms.scenes]
    overflow_alarmed = False

    t0 = time.time()
    for iteration in range(1, iterations + 1):
        weights = train.loss_weights(cfg, iteration)
        in_window, do_densify, do_reset, use_ss = train.schedule_flags(
            iteration, **flags)
        weights['_in_densify_window'] = 1.0 if in_window else 0.0
        cameras = [s.device_camera(next_frame_idx(i), 'train')
                   for i, s in enumerate(ms.scenes)]
        states, metrics = ms_step(
            states, cameras, iteration, weights,
            active_sh_degree=ms.scenes[0].active_sh_degree(iteration),
            buckets=buckets)

        if test_interval > 0 and iteration % test_interval == 0:
            for i, validation in enumerate(validations):
                res = validation(states[i], iteration, None, exp_dir,
                                 max_val_frames=max_val_frames,
                                 bucket=buckets[i])
                logger.log(iteration, {f'subject{i}/{k}': v
                                       for k, v in res.items()})
            t0 = time.time()   # validation is not iteration time

        if do_densify:
            states, infos = densify_step(states, iteration, use_ss)
            counts = [dict(zip(info, torch.stack(list(info.values()))
                               .tolist())) for info in infos]
            logger.log(iteration, {f'densify/{k}': [int(c[k]) for c in counts]
                                   for k in counts[0]})
            buckets = [s.bucket_for(int(c['n_alive']))
                       for s, c in zip(ms.scenes, counts)]
            states = refresh_knn(states, buckets)
        if do_reset:
            states = opacity_reset_step(states)

        for m in metrics:
            if overflow_alarmed:
                break
            overflow_alarmed = train.overflow_alarm(
                cfg, iteration, m['overflow/pairs'], m['overflow/rect'])
        if iteration % log_every == 0 or iteration == 1:
            hosts = [train.host_metrics(m) for m in metrics]
            row = {}
            for k in hosts[0]:
                row[k] = float(np.mean([h[k] for h in hosts]))
                for i, h in enumerate(hosts):
                    row[f'subject{i}/{k}'] = h[k]
            row['iter_time'] = (time.time() - t0) / log_every * 1000.0
            logger.log(iteration, row)
            if progress and (iteration % (log_every * 10) == 0
                             or iteration == 1):
                print(f"[{iteration}/{iterations}] S={S} "
                      f"loss={row['loss/total_loss']:.5f} "
                      f"psnr={row['psnr']:.2f} "
                      f"({row['iter_time']:.0f} ms/it)", flush=True)
            t0 = time.time()

    for i, (s, st) in enumerate(zip(ms.scenes, states)):
        s.save_checkpoint(st, iterations, os.path.join(exp_dir, f'subject{i}'))
    return ms, states, logger
