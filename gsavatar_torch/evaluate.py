"""Evaluation and prediction: the render loop, its metrics and frames,
`predict`, `main`.

Counterpart of `gsavatar/evaluate.py` (`composite_over_original`,
`evaluate`, `predict`, `main`). `evaluate` renders every camera through
the scene, clips the image to [0, 1], times each frame on the host clock
around work that ends in a device sync, and reports the mean frame time
without the first frame. Given an evaluator (`metrics.get_evaluator`) and
cameras that carry their ground truth, it also scores each frame. With
`save_images` it writes each frame as `<out_dir>/<image_name>.png` (the
clipped image times 255, truncated to uint8, as the JAX package's PIL
path writes it; `utils/png.py` encodes it), and with `save_composite`
also `<image_name>_composite.png`, the render over the camera's frame.
Whenever frames are saved or metrics computed, the metric means and
'time_ms' go to `<out_dir>/results.npz` under `metrics/<k>`.
`predict(cfg)` loads a checkpoint of the port into an `InferenceScene` and
evaluates the split of `cfg['mode']` from `data.load_dataset` (the test
split with metrics, the predict split without, in `mode=train` the
validation split with metrics), saving its frames under
`<exp_dir or 'exp'>/eval_<dataset.test_mode>`."""
from __future__ import annotations

import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from gsavatar_torch import tracing
from gsavatar_torch.device import synchronize
from gsavatar_torch.utils import png


def composite_over_original(img: np.ndarray, original: np.ndarray,
                            threshold: float = 0.0) -> np.ndarray:
    """The render where it is not black, the original frame elsewhere."""
    mask = img.sum(axis=-1) > threshold
    return np.where(mask[..., None], img, original)


def to_uint8(img: torch.Tensor) -> np.ndarray:
    """An image in [0, 1] as the uint8 frame the JAX package saves:
    (img * 255) truncated."""
    return tracing.device_read((img * 255).to(torch.uint8)).numpy()


def evaluate(scene, cameras: Sequence, n_frames: Optional[int] = None,
             iteration: Optional[int] = None, keep_renders: bool = False,
             evaluator=None, out_dir: Optional[str] = None,
             save_images: bool = False, save_composite: bool = False
             ) -> dict:
    """Render `n_frames` frames (default: one per camera), cycling over
    `cameras`. Returns the per-frame times and counters, the mean time
    without the first frame ('time_ms'), the clipped images and alphas when
    `keep_renders`, and with `evaluator` the mean of each metric
    ('metrics'). `out_dir` receives the frames (`save_images`,
    `save_composite`) and results.npz."""
    cams = [c.to(scene.device) for c in cameras]
    n = n_frames or len(cams)
    out = {'frame_ms': [], 'n_pairs': [], 'pair_overflow': [],
           'rect_dropped': [], 'images': [], 'alphas': []}
    if save_images:
        os.makedirs(out_dir, exist_ok=True)
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
        if save_images:
            arr = to_uint8(img)
            png.write_png(os.path.join(out_dir, f"{cam.image_name}.png"), arr)
            if save_composite and cam.image is not None:
                orig = to_uint8(torch.clamp(cam.image, 0.0, 1.0))
                png.write_png(
                    os.path.join(out_dir, f"{cam.image_name}_composite.png"),
                    composite_over_original(arr, orig))
    times = out['frame_ms']
    out['time_ms'] = (sum(times[1:]) / (len(times) - 1) if len(times) > 1
                      else times[0] if times else 0.0)
    results = {k: float(np.mean(v)) for k, v in frame_metrics.items()}
    results['time_ms'] = out['time_ms']
    if evaluator is not None:
        out['metrics'] = results
    if out_dir and (save_images or evaluator is not None):
        os.makedirs(out_dir, exist_ok=True)
        np.savez(os.path.join(out_dir, 'results.npz'),
                 **{f'metrics/{k}': v for k, v in results.items()})
    return out


def predict(cfg: dict, device=None) -> dict:
    """Evaluate the checkpoint `cfg['load_ckpt']` (default
    `<exp_dir>/ckpt<opt.iterations>.pt`) at its iteration on the split of
    `cfg['mode']`; returns the metric means and 'time_ms'. Frames and
    results.npz go under `<exp_dir or 'exp'>/eval_<dataset.test_mode>`;
    the predict split, which is not scored, loads no ground truth."""
    from gsavatar_torch.data import load_dataset
    from gsavatar_torch.inference import InferenceScene
    from gsavatar_torch.metrics import get_evaluator
    from gsavatar_torch.scene import TEST_SPLIT
    exp_dir = cfg.get('exp_dir') or os.path.join('exp', str(cfg['name']))
    ckpt = cfg.get('load_ckpt') or os.path.join(
        exp_dir, f"ckpt{int(cfg['opt']['iterations'])}.pt")
    scene = InferenceScene.from_checkpoint(cfg, ckpt, device=device)
    mode = cfg.get('mode', 'test')
    compute_metrics = mode != 'predict'
    ds = load_dataset(cfg['dataset'], TEST_SPLIT[mode], device=scene.device,
                      ground_truth=compute_metrics)
    test_mode = cfg['dataset'].get('test_mode', 'view')
    # the JAX package's default: <exp_dir or 'exp'>/eval_<test_mode>
    out_dir = os.path.join(cfg.get('exp_dir') or 'exp', f"eval_{test_mode}")
    res = evaluate(scene, [ds[i] for i in range(len(ds))],
                   iteration=scene.iteration,
                   evaluator=(get_evaluator(str(cfg['dataset']['name']))
                              if compute_metrics else None),
                   out_dir=out_dir, save_images=True)
    return res.get('metrics', {'time_ms': res['time_ms']})


# predict-mode names of the predict sequences, by dataset
PREDICT_NAMES = {
    'zjumocap': {0: 'dance0', 1: 'dance1', 2: 'flipping', 3: 'canonical'},
    'people_snapshot': {0: 'rotation', 1: 'dance2'},
}


def run_suffix(cfg: dict) -> Optional[str]:
    """The run's suffix, as the JAX package's `main` sets `cfg['suffix']`:
    `test-<test_mode>`, `predict-<sequence name>`, plus `-freeview`."""
    mode = cfg.get('mode', 'test')
    ds = cfg['dataset']
    suffix = None
    if mode == 'test':
        suffix = f"test-{ds.get('test_mode', 'view')}"
    elif mode == 'predict':
        seq = int(ds.get('predict_seq', 0))
        names = PREDICT_NAMES['zjumocap' if ds['name'] == 'zjumocap'
                              else 'people_snapshot']
        suffix = f"predict-{names.get(seq, str(seq))}"
    if ds.get('freeview', False):
        suffix = (suffix or '') + '-freeview'
    return suffix


def main(argv=None):
    """`python -m gsavatar_torch.evaluate mode=test load_ckpt=... [key=value
    ...]`: evaluate a checkpoint on the GPU, save its frames and print the
    metric means."""
    import sys
    from gsavatar_torch.config import load_config
    cfg = load_config(list(argv if argv is not None else sys.argv[1:]))
    suffix = run_suffix(cfg)
    if suffix is not None:
        cfg['suffix'] = suffix
    cfg['exp_dir'] = cfg.get('exp_dir') or os.path.join('exp',
                                                        str(cfg['name']))
    results = predict(cfg)
    print(results)
    return results


if __name__ == '__main__':
    main()
