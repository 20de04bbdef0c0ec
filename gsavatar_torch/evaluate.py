"""The evaluation render loop, predict mode.

Counterpart of the render loop of `gsavatar/evaluate.py:evaluate` with
`compute_metrics=False`: render every camera, clip the image to [0, 1],
time each frame on the host clock around work that ends in a device sync,
and report the mean frame time without the first frame. The metrics
(PSNR/SSIM/LPIPS) and saving frames come with later slices."""
from __future__ import annotations

import time
from typing import Optional, Sequence

import torch

from gsavatar_torch.device import synchronize


def evaluate(scene, cameras: Sequence, n_frames: Optional[int] = None,
             iteration: Optional[int] = None, keep_renders: bool = False
             ) -> dict:
    """Render `n_frames` frames (default: one per camera), cycling over
    `cameras`. Returns the per-frame times and counters, the mean time
    without the first frame ('time_ms'), and the clipped images and alphas
    when `keep_renders`."""
    cams = [c.to(scene.device) for c in cameras]
    n = n_frames or len(cams)
    out = {'frame_ms': [], 'n_pairs': [], 'pair_overflow': [],
           'rect_dropped': [], 'images': [], 'alphas': []}
    for i in range(n):
        t0 = time.perf_counter()
        pkg = scene.render_frame(cams[i % len(cams)], iteration)
        img = torch.clamp(pkg.render, 0.0, 1.0)
        synchronize(scene.device)
        out['frame_ms'].append((time.perf_counter() - t0) * 1000.0)
        out['n_pairs'].append(pkg.n_pairs)
        out['pair_overflow'].append(pkg.pair_overflow)
        out['rect_dropped'].append(pkg.rect_dropped)
        if keep_renders:
            out['images'].append(img)
            out['alphas'].append(pkg.opacity_render)
    times = out['frame_ms']
    out['time_ms'] = (sum(times[1:]) / (len(times) - 1) if len(times) > 1
                      else times[0] if times else 0.0)
    return out
