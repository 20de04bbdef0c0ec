"""Training: one subject, one frame a step, as `gsavatar_torch.train.training`
runs it, from the schedule's state at `start_iteration` made from the seed.

Set-up builds the program's `Scene` and `TrainState` and loads the seed's
weights into them (zero Adam moments; the arena's Adam step at
`arena_adam_step`, the converter's count at the start iteration). It
drives that state through `check_steps` steps, a densify round and its
`refresh_knn` among them, whose losses, first gradients (read back from
the optimizers' moments), parameter changes after three steps and arena
after the round the plain reference recomputes after the window. It then
drives the same state on through `settle_rounds` more densify rounds, so
that the window opens on an arena densify has settled and every path it
takes has run. The window goes on from there: each iteration is the
driver's (the loss weights and the schedule, the step, densify and
`refresh_knn` when due, the opacity reset when due, the overflow alarm,
the log every `log_every` iterations), with one timestamp a step."""
from __future__ import annotations

import gc
import statistics
import tempfile
import time

import numpy as np
import torch
from torch.profiler import profile, record_function

from perfbench.harness import check, counts, inputs, timing, trace as tr
from perfbench.harness import device as dv, env

B1 = 0.9          # both optimizers' first-moment decay
CHANGE_STEPS = 3  # the parameters' change is compared after this many steps


class Loop:
    """The program's training state and one driver iteration over it."""

    def __init__(self, cfg: dict, seed: int, device, log_dir: str):
        from gsavatar_torch import train as T
        from gsavatar_torch.scene import Scene
        from gsavatar_torch.utils.logging import MetricLogger
        self.T, self.cfg = T, cfg
        self.scene = Scene(cfg, seed=seed, device=device)
        self.state = self.scene.init_state()
        self.step_fn = T.make_train_step(self.scene)
        opt = cfg['opt']
        self.flags = dict(
            densify_until=int(opt['densify_until_iter']),
            densify_from=int(opt['densify_from_iter']),
            densify_interval=int(opt['densification_interval']),
            opacity_reset_interval=int(opt['opacity_reset_interval']),
            gauss_delay=int(cfg['model']['gaussian'].get('delay', 0)),
            white_bg=bool(cfg['dataset'].get('white_background', False)))
        self.log_every = int(cfg.get('log_every', 10) or 10)
        self.logger = MetricLogger(f'{log_dir}/metrics.jsonl')
        self.alarmed = False
        self.pairs_dropped = 0
        self.bucket = 0
        self.densified = 0
        self.rounds = []        # (iteration, n_alive, time) of each round
        self.round_info = {}    # the last round's counts

    def load(self, w, iteration: int, seed: int, adam_step: int):
        """The seed's weights and the schedule's state at `iteration`, the
        arena's Adam at step `adam_step`."""
        from gsavatar_torch.core.optim import init_adam
        s, st = self.scene, self.state
        with torch.no_grad():
            for k, p in s.converter.named_parameters():
                p.copy_(w.conv[k])
            for f, v in w.arena.items():
                getattr(st.gauss_params, f).copy_(v)
            st.gauss_aux.alive.copy_(w.alive)
            for f in ('max_radii2d', 'xyz_gradient_accum', 'denom'):
                getattr(st.gauss_aux, f).zero_()
        st.gauss_adam = init_adam(st.gauss_params)
        st.gauss_adam.step = adam_step
        st.conv_opt = s.conv_tx.init(st.conv_params)
        st.conv_opt.count = iteration
        st.generator = inputs.cpu_generator(inputs.derived_seed(seed, 3))
        self.bucket = self.T.alive_bucket(s, st)
        self.T.refresh_knn(st, self.bucket)

    def iterate(self, iteration: int, camera):
        """One iteration of `train.training`'s loop; returns its metrics."""
        T, s = self.T, self.scene
        weights = T.loss_weights(self.cfg, iteration)
        in_window, do_densify, do_reset, use_ss = T.schedule_flags(
            iteration, **self.flags)
        weights['_in_densify_window'] = 1.0 if in_window else 0.0
        xyz_lr = float(s.xyz_lr_fn(iteration))
        deg = s.active_sh_degree(iteration)
        self.state, metrics = self.step_fn(
            self.state, camera, iteration, weights, xyz_lr,
            active_sh_degree=deg, bucket=self.bucket)
        if do_densify:
            self.densify(iteration, use_ss)
        if do_reset:
            T.opacity_reset_step(self.state)
        self.pairs_dropped += metrics['overflow/pairs']
        if not self.alarmed:
            self.alarmed = T.overflow_alarm(
                self.cfg, iteration, metrics['overflow/pairs'],
                metrics['overflow/rect'])
        if iteration % self.log_every == 0:
            self.logger.log(iteration, T.host_metrics(metrics))
        return metrics

    def densify(self, iteration: int, use_ss: bool):
        T = self.T
        with record_function('bench/densify'):
            eps1, eps2 = T.densify_draws(self.state, iteration)
            self.state, dinfo = T.densify_step(self.scene, self.state, eps1,
                                               eps2, use_ss)
            dinfo = dict(zip(dinfo, torch.stack(list(dinfo.values()))
                             .tolist()))
            self.bucket = self.scene.bucket_for(int(dinfo['n_alive']))
            T.refresh_knn(self.state, self.bucket)
        self.densified += 1
        self.round_info = dinfo
        self.rounds.append((iteration, int(dinfo['n_alive']),
                            time.perf_counter()))


def frame_order(n: int, length: int, seed: int):
    """`train.training`'s frame pick, popping without replacement from the
    training frames and refilling, from a generator of the seed."""
    rng = np.random.default_rng(inputs.derived_seed(seed, 4))
    out, stack = [], []
    while len(out) < length:
        if not stack:
            stack = list(range(n))
        out.append(stack.pop(int(rng.integers(len(stack)))))
    return out


def run(cell, seed: int, seconds: float, traced: bool, device='cuda',
        control: bool = False):
    """One run of the cell; with `control`, also the control's readings:
    the reference in the program's place, its f32 products in TF32."""
    cfg = cell.config['config']
    traffic = cell.traffic
    it0 = int(traffic['start_iteration'])
    n_check = int(traffic['check_steps'])
    w = inputs.make_weights(cfg, seed, device,
                            opacity_noise=traffic.get('opacity_noise'),
                            max_scale=traffic.get('max_scale'))
    log_dir = tempfile.TemporaryDirectory()
    loop = Loop(cfg, seed, device, log_dir.name)
    ds = loop.scene.train_dataset
    cams = [loop.scene.device_camera(i, 'train') for i in range(len(ds))]
    order = frame_order(len(cams), int(traffic['frame_order_length']), seed)
    adam_step = int(traffic['arena_adam_step'])

    # the checked steps, from the seed's weights, through the window's own
    # call: the first gradients, the parameters after three steps, the
    # arena after the densify round among them, every step's loss
    loop.load(w, it0, seed, adam_step)
    snap = {'gen': [], 'loss': [], 'cams': [], 'bucket': loop.bucket}
    for j in range(1, n_check + 1):
        snap['gen'].append(loop.state.generator.get_state())
        snap['cams'].append(order[j])
        rounds = loop.densified
        m = loop.iterate(it0 + j, cams[order[j]])
        snap['loss'].append(m['loss/total_loss'].detach().clone())
        if j == 1:
            snap['grad'] = _first_grads(loop, w)
        if j == CHANGE_STEPS:
            snap['after'] = _params(loop, w)
        if loop.densified > rounds:
            snap['densified'] = _arena(loop, w)
    snap['round'] = dict(loop.round_info)
    # the ground truth both sides train on: the program's renders of the
    # synthetic target (PERF.md, Open questions)
    snap['gt'] = [(cams[i].image.clone(), cams[i].mask.clone())
                  for i in snap['cams']]

    # set-up drives the same state on through `settle_rounds` rounds, so
    # that the window opens on an arena that densify has settled; every
    # path of the window (steps at each size, densify, `refresh_knn`) has
    # run by then
    it = it0 + n_check
    settle_to = loop.densified + int(traffic['settle_rounds'])
    while loop.densified < settle_to:
        it += 1
        loop.iterate(it, cams[order[it - it0]])
    trace_at = _trace_slice(cfg, it + 2, int(traffic['trace_steps'])) \
        if traced else None
    if trace_at:
        # a traced run opens its window on the slice, so that the slice
        # always runs and the untraced steps after it give the rate
        while it + 2 < trace_at[0]:
            it += 1
            loop.iterate(it, cams[order[it - it0]])
    it += 1
    if traced:
        # the profiler's first start sets up its tracer: not in the window
        with profile(activities=dv.activities(device)):
            loop.iterate(it, cams[order[it - it0]])
    else:
        loop.iterate(it, cams[order[it - it0]])
    dv.sync(device)
    set_up = list(loop.rounds)
    env.settle()

    prof, steps, pairs, sl = None, 0, [], {}
    t0 = time.perf_counter()
    now = t0
    while now - t0 < seconds:
        it += 1
        if trace_at and it == trace_at[0]:
            dv.sync(device)
            prof = profile(activities=dv.activities(device))
            prof.start()
            sl = {'t0': time.perf_counter(), 'it0': it, 'd0': loop.densified}
        m = loop.iterate(it, cams[order[it - it0]])
        steps += 1
        if 'it0' in sl and 'it1' not in sl:
            pairs.append((m['raster/n_pairs'], loop.bucket))
            if it + 1 == trace_at[1]:
                _stop(prof, sl, it, loop, device)
        now = time.perf_counter()
    dv.sync(device)
    t_end = time.perf_counter()
    peak = dv.peak_bytes(device)
    if 'it0' in sl and 'it1' not in sl:
        _stop(prof, sl, it, loop, device)
    if 'after' in sl and it + 1 > sl['it1']:
        # the untraced steps after the slice
        sl['rate'] = timing.rate(it + 1 - sl['it1'], t_end - sl['after'])

    out = {'attempted': steps, 'failed': 0, 'memory_peak_bytes': peak,
           't0': t0}
    if traced:
        out['trace'] = _reduce(cfg, prof, sl, pairs)
    else:
        out['metrics'] = {'train_it_per_s': timing.rate(steps, t_end - t0)}
    first_losses = [float(x) for x in snap['loss']]
    out['pairs_dropped'] = loop.pairs_dropped
    # each round's alive count; in the window also the seconds since the
    # window opened
    out['diag'] = {'checked_round': snap['round'],
                   'rounds_set_up': [n for _, n, _ in set_up],
                   'rounds_window': [(n, round(t - t0, 3)) for _, n, t in
                                     loop.rounds[len(set_up):]],
                   'bucket_end': loop.bucket}
    del loop, cams, prof
    log_dir.cleanup()
    gc.collect()
    if dv.is_cuda(device):
        torch.cuda.empty_cache()
    dv.f32_matmuls(False)
    prog = (first_losses, snap['grad'], snap['after'],
            snap.get('densified'))
    ref = reference_steps(cfg, w, snap, it0, adam_step, device)
    find_neighbours(cfg, prog[3])
    out['readings'] = readings(w, prog, ref)
    out['diag']['loss_gaps'] = loss_gaps(prog[0], ref[0])
    out['diag']['worst_change'] = [out['readings']['worst_change_leaf'],
                                   out['readings']['worst_change_gap']]
    out['diag']['knn_gap'] = out['readings']['knn_gap']
    if control:
        dv.f32_matmuls(True)
        ctl = reference_steps(cfg, w, snap, it0, adam_step, device)
        dv.f32_matmuls(False)
        find_neighbours(cfg, ctl[3])
        out['control'] = readings(w, ctl, ref)
        out['diag']['control_loss_gaps'] = loss_gaps(ctl[0], ref[0])
    return out


def _first_grads(loop, w):
    """The first step's gradients as the optimizers got them: the first
    moments over (1 - B1), the converter's clipped (with the latent groups'
    weight decay), the arena's at its alive rows."""
    st = loop.state
    g = {f'conv.{k}': v / (1 - B1) for k, v in st.conv_opt.mu.items()}
    for f in w.arena:
        g[f'arena.{f}'] = getattr(st.gauss_adam.m, f) / (1 - B1)
    return {k: v.detach().clone() for k, v in g.items()}


def _params(loop, w):
    st = loop.state
    p = {f'conv.{k}': v for k, v in loop.scene.converter.named_parameters()}
    for f in w.arena:
        p[f'arena.{f}'] = getattr(st.gauss_params, f)
    return {k: v.detach().clone() for k, v in p.items()}


def _arena(loop, w):
    """The arena after a densify round: its alive mask, fields and cached
    neighbours."""
    st = loop.state
    out = {f: getattr(st.gauss_params, f).detach().clone() for f in w.arena}
    out['alive'] = st.gauss_aux.alive.clone()
    out['nn_ix'] = st.gauss_aux.nn_ix.clone()
    return out


def _trace_slice(cfg, first: int, n: int):
    """The traced iterations: `n` steps around the window's first densify
    round, which the slice then holds."""
    interval = int(cfg['opt']['densification_interval'])
    d = ((first + interval - 1) // interval) * interval
    start = max(first, d - n // 2)
    return start, start + n


def _stop(prof, sl, it, loop, device):
    dv.sync(device)
    sl.update(t1=time.perf_counter(), it1=it + 1, d1=loop.densified)
    prof.stop()
    sl['after'] = time.perf_counter()


def _reduce(cfg, prof, sl, pairs):
    c = counts.step_counts(cfg, pairs)
    extra = {'densify_rounds': sl['d1'] - sl['d0']}
    if 'rate' in sl:
        extra['rate'] = sl['rate']
    return tr.reduce(prof, sl['t1'] - sl['t0'], sl['it1'] - sl['it0'], c,
                     extra)


def reference_steps(cfg, w, snap, it0, adam_step, device):
    """The checked steps again in the plain reference, from the same
    weights, frames, ground truth and draws: (losses, first gradients,
    parameters after `CHANGE_STEPS` steps, the arena after the densify
    round)."""
    from perfbench.reference.train_step import RefTrainer
    ref = RefTrainer(cfg, w.subject, w.conv, device)
    st = ref.state(w.arena, w.alive, it0, adam_step, snap['bucket'])
    losses, grads, after, dens = [], None, None, None
    for j, (idx, gen_state, (img, mask)) in enumerate(
            zip(snap['cams'], snap['gen'], snap['gt']), start=1):
        cam = w.subject._camera(idx).to(device).replace(image=img, mask=mask)
        gen = torch.Generator()
        gen.set_state(gen_state)
        losses.append(float(ref.iterate(st, cam, it0 + j, gen)))
        if j == 1:
            grads = {f'conv.{k}': v / (1 - B1)
                     for k, v in st.conv_opt.mu.items()}
            for f in w.arena:
                grads[f'arena.{f}'] = getattr(st.adam.m, f) / (1 - B1)
        if j == CHANGE_STEPS:
            after = {f'conv.{k}': v.detach().clone() for k, v in
                     ref.converter.named_parameters()}
            for f in w.arena:
                after[f'arena.{f}'] = getattr(st.params, f).clone()
        if st.densified and dens is None:
            dens = {f: getattr(st.params, f).clone() for f in w.arena}
            dens['alive'] = st.alive.clone()
            dens['nn_ix'] = st.aux.nn_ix.clone()
    return losses, grads, after, dens


def find_neighbours(cfg, dens):
    """The neighbours the reference finds over a side's arena after its
    round (`dens['nn_ref']`), which `knn_gap` holds its cache against: the
    round itself is held against the reference's own."""
    from perfbench.reference.train_step import neighbours
    if dens is not None:
        dens['nn_ref'] = neighbours(cfg, dens['xyz'], dens['alive'])


def readings(w, prog, ref):
    """The numbers compared: the first step's loss gap (against the
    reference's loss), the first gradient's worst leaf
    (`check.worst_leaf_gap`), the median leaf's gap of the parameters'
    change after `CHANGE_STEPS` steps over the leaves the reference's
    gradient moves (`check.moved_leaves`), and the densify round's
    `check.densify_gaps`. The later steps' loss gaps and the change's
    worst leaf, which Adam's sign on rounding-level gradients and flips at
    thresholds drive from seed to seed, and `knn_gap`, which the control
    does not move, are read but not compared (PERF.md section 2)."""
    (p_loss, p_grad, p_after, p_dens), (r_loss, r_grad, r_after, r_dens) = \
        prog, ref
    start = {f'conv.{k}': w.conv[k] for k in w.trained}
    start.update({f'arena.{f}': v for f, v in w.arena.items()})
    leaves = sorted(r_grad)
    moved = check.moved_leaves({k: r_grad[k] for k in leaves})
    change = check.leaf_gaps(
        {k: p_after[k] - start[k] for k in moved},
        {k: r_after[k] - start[k] for k in moved}, moved)
    worst = max(change, key=change.get)
    return {
        'first_loss_gap': loss_gaps(p_loss, r_loss)[0],
        'grad_gap': check.worst_leaf_gap(p_grad, r_grad, leaves),
        'median_change_gap': statistics.median(change.values()),
        **check.densify_gaps(p_dens, r_dens, list(w.arena)),
        'worst_change_gap': change[worst], 'worst_change_leaf': worst,
    }


def loss_gaps(prog, ref):
    """Each checked step's loss gap against the reference's loss."""
    return [abs(p - r) / abs(r) for p, r in zip(prog, ref)]
