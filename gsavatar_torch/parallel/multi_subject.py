"""S avatars trained in one run (BASELINE config 5: four ZJU-MoCap
subjects).

Counterpart of `gsavatar/parallel/multi_subject.py`. `cfg.parallel.
subjects` is a list of dataset overrides, one per subject; subject i is
the single-subject config with its overrides (`subject_scene_cfg`),
built as a `Scene` with seed + i. The JAX package stacks the S states on
a leading axis and vmaps the single-subject step over it, which needs
every subject at one static shape: one bucket (the max over the
subjects), the skinning pools as stacked inputs, the subject constants
in a flax variable collection. The port keeps per-subject buffers
instead, a list of S `TrainState`s, and runs the single-subject
iteration (`train.TrainLoop`: the step, densify, the opacity reset and
`refresh_knn`) on each subject's own state, in subject order: each
subject with its own Scene (its skinning pool, AABB and SMPL tables), at
its own bucket, and with the split noise of each densify drawn from its
own state's generator (the JAX package gives every lane
`PRNGKey(iteration)`). So subject i of a multi-subject run equals, bit
for bit on the same device, the single-subject run of `train.training`
with seed + i and dataset overrides i: the same frames
(`default_rng(seed + i)`), the same draws, the same operations.

With `parallel.data` = D > 1 the run is D ranks of a process group
(`parallel/mesh.py`), and data rank d trains the subjects
[d S/D, (d + 1) S/D), the block that `P('data')` gives in JAX's
`_subject_sharding` (`multi_subject.py:98-110, 229-234`); its subjects
run one after another from its host thread. The subjects exchange no
gradient. Rank 0 gathers each subject's metrics, validation and densify
counts (`Mesh.gather_rows`), and alone writes the log and every
subject's checkpoint (a remote subject's bytes broadcast from its
rank)."""
from __future__ import annotations

import copy
import io
import os
import time
from typing import List, Optional

import numpy as np
import torch

from gsavatar_torch import train
from gsavatar_torch.parallel import mesh as mesh_mod
from gsavatar_torch.scene import Scene, checkpoint_path
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


class MultiSubjectScene:
    """The single-subject Scenes of the subjects `subjects` (global
    indices, default all S) on `device`, subject i with seed + i. They
    share the architecture, the arena capacity, the raster config (so the
    image size), the train length and the skinning pool's shape; a subject
    that differs in one raises a ValueError naming the subject and the
    field."""

    def __init__(self, cfg: dict, seed: int = 0, device=None,
                 subjects: Optional[range] = None):
        subs = list((cfg.get('parallel') or {}).get('subjects') or [])
        if not subs:
            raise ValueError("cfg.parallel.subjects must be a non-empty "
                             "list of per-subject dataset overrides")
        self.cfg = cfg
        self.n_subjects = len(subs)
        self.subjects = range(len(subs)) if subjects is None else subjects
        self.scenes: List[Scene] = [
            Scene(subject_scene_cfg(cfg, subs[i]), seed=seed + i,
                  device=device) for i in self.subjects]
        fields = {
            'capacity': lambda s: s.capacity,
            'use_sh': lambda s: s.use_sh,
            'sh_degree': lambda s: s.max_sh_degree,
            'raster_config': lambda s: s.raster_config,
            'train length': lambda s: len(s.train_dataset),
            'pool shape': lambda s: tuple(s.skinning_pool_pts.shape),
        }
        s0, i0 = self.scenes[0], self.subjects[0]
        for i, s in zip(self.subjects[1:], self.scenes[1:]):
            for name, get in fields.items():
                if get(s) != get(s0):
                    raise ValueError(f"subject {i}: {name} {get(s)} differs "
                                     f"from subject {i0}'s {get(s0)}")

    def init_states(self) -> list:
        return [s.init_state() for s in self.scenes]


def make_multi_subject_step(ms: MultiSubjectScene):
    """ms_step(states, cameras, iteration, weights, active_sh_degree=0,
    buckets=None, draws=None) -> (states, metrics): each subject's
    `train.make_step_core` on its own state and camera, in subject order,
    at its own bucket and learning rate; `metrics` and `draws` (to replay)
    hold one entry per subject. The counterpart of the JAX package's
    vmapped subject step; the driver steps each subject through its
    `train.TrainLoop`, the same operations."""
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


def training_multi_subject(cfg: dict, max_iterations=None,
                           log_every: int = 10, progress: bool = True,
                           device=None,
                           ms: Optional[MultiSubjectScene] = None):
    """The multi-subject driver: one `train.TrainLoop` a subject, its frames
    popped without replacement from `default_rng(seed + i)`, every subject
    advancing one iteration per loop. With `parallel.data` = D > 1 this
    process is one of D ranks and trains its block of the subjects (on
    `cuda:LOCAL_RANK` under NCCL unless `device` says otherwise). Rank 0
    logs per-subject validation under `subject{i}/...`, the densify counts
    as lists over the subjects, and rows of each metric's mean over the
    subjects beside `subject{i}/<key>`, and writes each subject's final
    checkpoint under `exp_dir/subject{i}`. `ms`, this rank's subjects'
    scenes, is built from `cfg` unless given. Returns (MultiSubjectScene,
    this rank's states, logger; None on the other ranks)."""
    par = cfg.get('parallel') or {}
    if int(par.get('model', 0) or 0) > 1:
        raise ValueError("multi-subject training shards subjects over "
                         "'data'; use model=1")
    S = len(par.get('subjects') or [])
    D = max(int(par.get('data', 0) or 0), 1)
    if S % D != 0:
        raise ValueError(f"subjects ({S}) must be divisible by "
                         f"parallel.data ({D})")
    if D > 1:
        mesh_mod.initialize_distributed()
        mesh_mod.require_world(D, 'parallel.data')
        device = device or mesh_mod.rank_device()
    mesh = mesh_mod.make_mesh(D, data=D, model=1) if D > 1 else None
    rank = mesh.rank if mesh else 0
    lead = rank == 0
    per = S // D
    mine = range(rank * per, (rank + 1) * per)
    seed = max(int(cfg.get('seed', -1)), 0)
    ms = ms or MultiSubjectScene(cfg, seed=seed, device=device,
                                 subjects=mine)
    if ms.subjects != mine:
        raise ValueError(f"the scenes hold subjects {list(ms.subjects)}, "
                         f"this rank trains {list(mine)}")
    iterations = int(max_iterations or cfg['opt']['iterations'])

    def gather(rows: dict) -> list:
        """{subject: row} of this rank's subjects -> the S rows."""
        return mesh.gather_rows(rows, S) if mesh else \
            [rows[i] for i in range(S)]

    # subject i picks its frames as its single-subject run does
    loops = [train.TrainLoop(cfg, s, state, train.make_train_step(s), seed + i)
             for i, s, state in zip(mine, ms.scenes, ms.init_states())]

    exp_dir = cfg.get('exp_dir') or os.path.join(
        'exp', str(cfg.get('name', 'run')) + '-ms')
    logger = None
    if lead:
        os.makedirs(exp_dir, exist_ok=True)
        logger = MetricLogger(os.path.join(exp_dir, 'metrics.jsonl'))

    test_interval = int(cfg.get('test_interval', 0) or 0)
    max_val_frames = cfg.get('max_val_frames')
    validations = [train.make_validation(s) for s in ms.scenes]

    t0 = time.time()
    for iteration in range(1, iterations + 1):
        cameras = [lp.scene.device_camera(lp.next_frame(), 'train')
                   for lp in loops]
        metrics = [lp.step(iteration, c) for lp, c in zip(loops, cameras)]

        if test_interval > 0 and iteration % test_interval == 0:
            results = gather({i: validation(
                lp.state, iteration, None, exp_dir,
                max_val_frames=max_val_frames, bucket=lp.bucket,
                quiet=not lead) for i, lp, validation in
                zip(mine, loops, validations)})
            for i, res in enumerate(results):
                if logger:
                    logger.log(iteration, {f'subject{i}/{k}': v
                                           for k, v in res.items()})
            t0 = time.time()   # validation is not iteration time

        counts = [lp.after_step(iteration) for lp in loops]
        if counts[0] is not None:      # every subject's schedule is cfg's
            counts = gather(dict(zip(mine, counts)))
            if logger:
                logger.log(iteration, {f'densify/{k}': [c[k] for c in counts]
                                       for k in counts[0]})

        # every rank sees every subject's counts, so all raise together;
        # the run has one alarm, the first loop's
        for c in gather({i: {'pairs': m['overflow/pairs'],
                             'rect': m['overflow/rect']}
                         for i, m in zip(mine, metrics)}):
            loops[0].alarm(iteration, c['pairs'], c['rect'], quiet=not lead)
        if iteration % log_every == 0 or iteration == 1:
            hosts = gather({i: train.host_metrics(m)
                            for i, m in zip(mine, metrics)})
            row = {}
            for k in hosts[0]:
                row[k] = float(np.mean([h[k] for h in hosts]))
                for i, h in enumerate(hosts):
                    row[f'subject{i}/{k}'] = h[k]
            row['iter_time'] = (time.time() - t0) / log_every * 1000.0
            if logger:
                logger.log(iteration, row)
            if lead and progress and (iteration % (log_every * 10) == 0
                                      or iteration == 1):
                print(f"[{iteration}/{iterations}] S={S} "
                      f"loss={row['loss/total_loss']:.5f} "
                      f"psnr={row['psnr']:.2f} "
                      f"({row['iter_time']:.0f} ms/it)", flush=True)
            t0 = time.time()

    states = [lp.state for lp in loops]
    for i in range(S):
        owner = i // per
        payload = None
        if owner == rank:
            j = i - mine[0]
            if lead:
                ms.scenes[j].save_checkpoint(
                    states[j], iterations,
                    os.path.join(exp_dir, f'subject{i}'))
                continue
            buf = io.BytesIO()
            torch.save(ms.scenes[j].checkpoint(states[j], iterations), buf)
            payload = buf.getvalue()
        elif owner == 0:
            continue
        payload = mesh.broadcast_bytes(payload, owner)
        if lead:
            with open(checkpoint_path(os.path.join(exp_dir, f'subject{i}'),
                                      iterations), 'wb') as f:
                f.write(payload)
    return ms, states, logger
