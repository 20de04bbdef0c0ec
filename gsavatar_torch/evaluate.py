"""Evaluation and prediction: the render loop, its metrics, `predict`.

Counterpart of `gsavatar/evaluate.py` (`evaluate`, `predict`, `main`).
`evaluate` renders every camera through the scene, clips the image to
[0, 1], times each frame on the host clock around work that ends in a
device sync, and reports the mean frame time without the first frame.
Given an evaluator (`metrics.get_evaluator`) and cameras that carry their
ground truth, it also scores each frame (PSNR, SSIM and LPIPS over the
mask) and writes the means to `<out_dir>/results.npz` under `metrics/<k>`,
as the JAX package does. `predict(cfg)` loads a checkpoint of the port
into an `InferenceScene` and evaluates the config's split: the test split
with metrics (`mode=test`), the predict split without (`mode=predict`), or
in `mode=train` the validation split with metrics. Saving frames as PNG
is not ported (the GPU machine has no image library)."""
from __future__ import annotations

import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from gsavatar_torch.device import synchronize


def evaluate(scene, cameras: Sequence, n_frames: Optional[int] = None,
             iteration: Optional[int] = None, keep_renders: bool = False,
             evaluator=None, out_dir: Optional[str] = None) -> dict:
    """Render `n_frames` frames (default: one per camera), cycling over
    `cameras`. Returns the per-frame times and counters, the mean time
    without the first frame ('time_ms'), the clipped images and alphas when
    `keep_renders`, and with `evaluator` the mean of each metric
    ('metrics'), which `out_dir` also receives as results.npz."""
    cams = [c.to(scene.device) for c in cameras]
    n = n_frames or len(cams)
    out = {'frame_ms': [], 'n_pairs': [], 'pair_overflow': [],
           'rect_dropped': [], 'images': [], 'alphas': []}
    frame_metrics: dict = {}
    for i in range(n):
        cam = cams[i % len(cams)]
        t0 = time.perf_counter()
        pkg = scene.render_frame(cam, iteration)
        img = torch.clamp(pkg.render, 0.0, 1.0)
        synchronize(scene.device)
        out['frame_ms'].append((time.perf_counter() - t0) * 1000.0)
        out['n_pairs'].append(pkg.n_pairs)
        out['pair_overflow'].append(pkg.pair_overflow)
        out['rect_dropped'].append(pkg.rect_dropped)
        if keep_renders:
            out['images'].append(img)
            out['alphas'].append(pkg.opacity_render)
        if evaluator is not None:
            gt = torch.clamp(cam.image, 0.0, 1.0)
            for k, v in evaluator(img, gt, valid_mask=cam.mask).items():
                frame_metrics.setdefault(k, []).append(v)
    times = out['frame_ms']
    out['time_ms'] = (sum(times[1:]) / (len(times) - 1) if len(times) > 1
                      else times[0] if times else 0.0)
    if evaluator is not None:
        results = {k: float(np.mean(v)) for k, v in frame_metrics.items()}
        results['time_ms'] = out['time_ms']
        out['metrics'] = results
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            np.savez(os.path.join(out_dir, 'results.npz'),
                     **{f'metrics/{k}': v for k, v in results.items()})
    return out


def predict(cfg: dict, device=None) -> dict:
    """Evaluate the checkpoint `cfg['load_ckpt']` (default
    `<exp_dir>/ckpt<opt.iterations>.pt`) at its iteration on the split of
    `cfg['mode']`; returns the metric means and 'time_ms', and writes
    results.npz under `<exp_dir>/eval_<dataset.test_mode>` when metrics are
    computed."""
    from gsavatar_torch.data.synthetic import SyntheticDataset
    from gsavatar_torch.inference import InferenceScene
    from gsavatar_torch.metrics import get_evaluator
    from gsavatar_torch.scene import TEST_SPLIT
    exp_dir = cfg.get('exp_dir') or os.path.join('exp', str(cfg['name']))
    ckpt = cfg.get('load_ckpt') or os.path.join(
        exp_dir, f"ckpt{int(cfg['opt']['iterations'])}.pt")
    scene = InferenceScene.from_checkpoint(cfg, ckpt, device=device)
    mode = cfg.get('mode', 'test')
    compute_metrics = mode != 'predict'
    ds = SyntheticDataset(cfg['dataset'], TEST_SPLIT[mode],
                          gt_device=scene.device if compute_metrics else None)
    test_mode = cfg['dataset'].get('test_mode', 'view')
    res = evaluate(scene, [ds[i] for i in range(len(ds))],
                   iteration=scene.iteration,
                   evaluator=(get_evaluator(str(cfg['dataset']['name']))
                              if compute_metrics else None),
                   out_dir=os.path.join(exp_dir, f"eval_{test_mode}"))
    return res.get('metrics', {'time_ms': res['time_ms']})


def main(argv=None):
    """`python -m gsavatar_torch.evaluate mode=test load_ckpt=... [key=value
    ...]`: evaluate a checkpoint on the GPU and print the metric means."""
    import sys
    from gsavatar_torch.config import load_config
    cfg = load_config(list(argv if argv is not None else sys.argv[1:]))
    cfg['exp_dir'] = cfg.get('exp_dir') or os.path.join('exp',
                                                        str(cfg['name']))
    results = predict(cfg)
    print(results)
    return results


if __name__ == '__main__':
    main()
