"""Playback: one viewer in a closed loop, the per-frame path of
`gsavatar_torch.apps.render_series.render_series` without its PNG write.

Set-up builds the avatar (`InferenceScene`) from the seed's weights and a
seeded SMPL motion (`MotionSeries`), then warms up. Each frame of the
window runs `MotionSeries.camera_pose_fields`, `live_camera` on the orbit,
`InferenceScene.render_frame`, the clamp and a device sync, and takes one
timestamp. After the window the frames that the seed picked are rendered
again by the plain reference and compared."""
from __future__ import annotations

import gc
import time

import numpy as np
import torch
from torch.profiler import profile, record_function

from perfbench.harness import check, counts, inputs, timing, trace as tr
from perfbench.harness import device as dv, env
from perfbench.reference.playback import RefPlayback, orbit_rotation


def _program(cell, w, motion, device):
    from gsavatar_torch.core import gaussians as G
    from gsavatar_torch.data import load_dataset
    from gsavatar_torch.inference import AvatarState, InferenceScene
    from gsavatar_torch.models.converter import build_converter
    from gsavatar_torch.motion.series import MotionSeries
    cfg = cell.config['config']
    train = load_dataset(cfg['dataset'], 'train')
    # the program's own buffers (AABBs, SMPL tables), the seed's parameters
    conv = build_converter(cfg, train.metadata, train.assets).state_dict()
    conv.update({k: w.conv[k] for k in w.trained})
    cap = w.alive.shape[0]
    params = G.GaussianParams(**{k: v.clone() for k, v in w.arena.items()})
    aux = G.empty_aux(cap, device)
    aux.alive.copy_(w.alive)
    scene = InferenceScene(cfg, train.metadata, train.assets,
                           AvatarState(params, aux, conv),
                           device=device)
    series = MotionSeries(motion, train.assets, device=device)
    return scene, series


def run(cell, seed: int, seconds: float, traced: bool, device='cuda',
        control: bool = False):
    """One run of the cell; with `control`, also the control's readings:
    the reference in the program's place, its f32 products in TF32."""
    from gsavatar_torch.camera.live import live_camera
    traffic = cell.traffic
    cfg = cell.config['config']
    w = inputs.make_weights(cfg, seed, device)
    motion = inputs.motion(traffic, seed)
    scene, series = _program(cell, w, motion, device)
    h, wd = cfg['dataset']['img_hw']
    orbit, radius = int(traffic['orbit_frames']), float(traffic['radius'])
    T = np.array([0.0, 0.0, radius], np.float32)
    R = [orbit_rotation(2 * np.pi * j / orbit) for j in range(orbit)]
    n_motion = len(motion['pose'])
    rng = np.random.default_rng(inputs.derived_seed(seed, 5))
    check_at = set(rng.choice(int(traffic['check_within_frames']),
                              int(traffic['check_frames']),
                              replace=False).tolist())
    kept = {}

    def frame(k):
        with record_function('bench/pose'):
            rots, jtrs, bt = series.camera_pose_fields(k % n_motion,
                                                       scene.metadata)
            cam = live_camera(R[k % orbit], T, width=wd, height=h, rots=rots,
                              Jtrs=jtrs, bone_transforms=bt, frame_id=k,
                              device=device)
        pkg = scene.render_frame(cam)
        pkg.render.clamp(0, 1)
        dv.sync(device)
        return cam, pkg

    for k in range(int(traffic['warmup_frames'])):
        frame(k)
    if traced:
        # the profiler's first start sets up its tracer: not in the window
        with profile(activities=dv.activities(device)):
            frame(0)
    env.settle()

    lat, prof, slice_info, pairs, dropped = [], None, None, [], 0
    n_trace = int(traffic['trace_frames']) if traced else 0
    if n_trace:
        prof = profile(activities=dv.activities(device))
        prof.start()
    t0 = time.perf_counter()
    last = t0
    k = 0
    while last - t0 < seconds:
        cam, pkg = frame(k)
        now = time.perf_counter()
        lat.append(now - last)
        last = now
        if k in check_at:
            kept[k] = (cam, pkg)
        dropped += pkg.pair_overflow
        if k < n_trace:
            pairs.append(pkg.n_pairs)
            if k + 1 == n_trace:
                prof.stop()
                slice_info = (now - t0, k + 1, pairs)
                last = time.perf_counter()
        k += 1
    t_end = time.perf_counter()
    peak = dv.peak_bytes(device)
    if prof is not None and slice_info is None:
        prof.stop()
        slice_info = (t_end - t0, k, pairs)

    out = {'attempted': k, 'failed': 0, 'memory_peak_bytes': peak,
           't0': t0, 'pairs_dropped': dropped}
    if traced:
        out['trace'] = _reduce(cell, prof, slice_info, lat)
    else:
        out['metrics'] = {
            'serve_frame_p95_ms': 1e3 * timing.percentile(lat, 95)}
        out['diag'] = {'p50_ms': 1e3 * timing.percentile(lat, 50),
                       'max_ms': 1e3 * max(lat)}
    del scene, series, prof
    gc.collect()
    if dv.is_cuda(device):
        torch.cuda.empty_cache()
    dv.f32_matmuls(False)
    ref = reference_frames(cell, w, motion, sorted(kept), device)
    out['readings'] = check.frame_gaps([kept[k] for k in sorted(kept)], ref)
    if control:
        dv.f32_matmuls(True)
        out['control'] = check.frame_gaps(
            reference_frames(cell, w, motion, sorted(kept), device), ref)
        dv.f32_matmuls(False)
    return out


def _reduce(cell, prof, slice_info, lat):
    slice_s, n, pairs = slice_info
    cfg = cell.config['config']
    c = counts.frame_counts(cfg, pairs, int(cfg['dataset']['n_points']))
    # the frame rate of the window after the traced slice, untraced
    rest = lat[n:]
    extra = {'rate': timing.rate(len(rest), sum(rest))} if rest else {}
    return tr.reduce(prof, slice_s, n, c, extra)


def reference_frames(cell, w, motion, frames, device):
    """The given frames of the loop, rendered by the plain reference:
    (camera, render) each."""
    ref = RefPlayback(cell.config['config'], w.subject, w.conv, w.arena,
                      w.alive, device)
    traffic = cell.traffic
    return [ref.frame(k, motion, int(traffic['orbit_frames']),
                      float(traffic['radius'])) for k in frames]
