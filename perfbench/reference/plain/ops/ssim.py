# Frozen copy of gsavatar_torch/ops/ssim.py for the benchmark's plain reference (run
# on every device with the kernels' plain versions); it imports nothing of
# the program and is not edited when the program changes.
"""SSIM with the 3DGS 11x11 Gaussian window.

Counterpart of `gsavatar/ops/ssim.py`: images are (H, W, C) float; the
separable window (sigma 1.5) runs as two depthwise `conv2d`s with zero
padding of window // 2; constants C1 = 0.01^2, C2 = 0.03^2; the mean of the
SSIM map. The blurs are `conv.conv2d_f32`: f32 on every device, with
cuDNN's TF32 off in both directions."""
from __future__ import annotations

import functools

import numpy as np
import torch

from .conv import conv2d_f32


@functools.lru_cache()
def _window(window_size: int, sigma: float) -> np.ndarray:
    x = np.arange(window_size)
    g = np.exp(-((x - window_size // 2) ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _blur(img, window_size: int):
    """Depthwise separable Gaussian blur of an (H, W, C) image."""
    C = img.shape[-1]
    g = torch.as_tensor(_window(window_size, 1.5), device=img.device)
    x = img.permute(2, 0, 1)[None]                        # (1, C, H, W)
    pad = window_size // 2
    x = conv2d_f32(x, g.reshape(1, 1, -1, 1).expand(C, 1, -1, 1),
                   padding=(pad, 0), groups=C)
    x = conv2d_f32(x, g.reshape(1, 1, 1, -1).expand(C, 1, 1, -1),
                   padding=(0, pad), groups=C)
    return x[0].permute(1, 2, 0)


def ssim(img1, img2, window_size: int = 11):
    """Mean SSIM of an (H, W, C) image pair."""
    mu1 = _blur(img1, window_size)
    mu2 = _blur(img2, window_size)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _blur(img1 * img1, window_size) - mu1_sq
    sigma2_sq = _blur(img2 * img2, window_size) - mu2_sq
    sigma12 = _blur(img1 * img2, window_size) - mu1_mu2
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / \
        ((mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    return ssim_map.mean()
