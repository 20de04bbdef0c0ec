# Frozen copy of gsavatar_torch/ops/lpips.py for the benchmark's plain reference (run
# on every device with the kernels' plain versions); it imports nothing of
# the program and is not edited when the program changes.
"""LPIPS perceptual distance with the VGG16 and AlexNet backbones.

Counterpart of `gsavatar/ops/lpips.py` (`_NETS`, `random_weights`, the
exported-bundle loader, `lpips`): the backbone's conv stack, unit-
normalized activations at 5 tap points, 1x1 "lin" weights, spatial mean,
layer sum; inputs scaled from [0, 1] to [-1, 1] and then by the ImageNet
constants. The backbone runs in f32 on every device: the convolutions are
`conv.conv2d_f32`, `torch.nn.functional.conv2d` with cuDNN's TF32 off in
both directions (the JAX package leaves them to XLA).

Weights: the exported .npz bundle at `weights/lpips_<net>.npz` under the
repository root when it exists, else the deterministic random backbone of
`random_weights` (numpy-seeded, so both packages build the same arrays).
`metric_key` names the metric by that source, as the JAX package does:
'lpips' for the exported bundle, 'lpips_rand' for the random backbone.

An image smaller than `min_size(net)` on a side leaves a tap an empty map,
whose mean the JAX package reports as NaN: 16 px for VGG (four 2x2
pools), 31 px for Alex (the 11x11 stride-4 convolution and two 3/2
pools). `lpips` returns NaN there (torch's pooling would raise)."""
from __future__ import annotations

import functools
from pathlib import Path
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from .conv import conv2d_f32

# per stage: an optional (kernel, stride) max-pool, then (out_ch, kernel,
# stride, pad) convolutions, each followed by ReLU; taps at the stage ends
VGG = [
    {'pool': None, 'convs': [(64, 3, 1, 1), (64, 3, 1, 1)]},
    {'pool': (2, 2), 'convs': [(128, 3, 1, 1), (128, 3, 1, 1)]},
    {'pool': (2, 2), 'convs': [(256, 3, 1, 1)] * 3},
    {'pool': (2, 2), 'convs': [(512, 3, 1, 1)] * 3},
    {'pool': (2, 2), 'convs': [(512, 3, 1, 1)] * 3},
]
ALEX = [
    {'pool': None, 'convs': [(64, 11, 4, 2)]},
    {'pool': (3, 2), 'convs': [(192, 5, 1, 2)]},
    {'pool': (3, 2), 'convs': [(384, 3, 1, 1)]},
    {'pool': None, 'convs': [(256, 3, 1, 1)]},
    {'pool': None, 'convs': [(256, 3, 1, 1)]},
]
NETS = {'vgg': VGG, 'alex': ALEX}

_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)
_WEIGHTS = Path(__file__).resolve().parents[2] / 'weights'


def _bundle(net: str) -> Path:
    return _WEIGHTS / f'lpips_{net}.npz'


def min_size(net: str = 'vgg') -> int:
    """The least image side for which every tap's map is non-empty."""
    def out(n):
        for stage in NETS[net]:
            if stage['pool'] is not None:
                k, st = stage['pool']
                n = (n - k) // st + 1 if n >= k else 0
            for _, k, st, pad in stage['convs']:
                n = (n + 2 * pad - k) // st + 1 if n + 2 * pad >= k else 0
            if n <= 0:
                return 0
        return n
    return next(n for n in range(1, 1024) if out(n) > 0)


@functools.lru_cache()
def random_weights(seed: int = 0, net: str = 'vgg') -> Dict[str, np.ndarray]:
    """The deterministic random backbone: He-normal convs, zero biases, lin
    weights 1/C (a per-layer mean)."""
    rng = np.random.default_rng(seed)
    out = {}
    i, in_ch = 0, 3
    taps = []
    for stage in NETS[net]:
        for ch, k, _, _ in stage['convs']:
            fan_in = in_ch * k * k
            out[f'conv{i}_w'] = rng.normal(
                0.0, np.sqrt(2.0 / fan_in), (ch, in_ch, k, k)).astype(
                    np.float32)
            out[f'conv{i}_b'] = np.zeros((ch,), np.float32)
            in_ch = ch
            i += 1
        taps.append(in_ch)
    for li, ch in enumerate(taps):
        out[f'lin{li}_w'] = np.full((1, ch, 1, 1), 1.0 / ch, np.float32)
    return out


@functools.lru_cache()
def _device_weights(device: str, net: str) -> Dict[str, torch.Tensor]:
    bundle = _bundle(net)
    w = dict(np.load(bundle)) if bundle.exists() \
        else random_weights(net=net)
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
            for k, v in w.items()}


def weights_kind(net: str = 'vgg') -> str:
    """'exported' with the bundle, 'random' without."""
    return 'exported' if _bundle(net).exists() else 'random'


def metric_key(net: str = 'vgg') -> str:
    return 'lpips' if weights_kind(net) == 'exported' else 'lpips_rand'


def get_weights(device, net: str = 'vgg') -> Dict[str, torch.Tensor]:
    return _device_weights(str(torch.device(device)), net)


def _features(x, wts, net):
    feats = []
    i = 0
    for stage in NETS[net]:
        if stage['pool'] is not None:
            k, s = stage['pool']
            x = F.max_pool2d(x, k, s)
        for _, _, stride, pad in stage['convs']:
            x = F.relu(conv2d_f32(x, wts[f'conv{i}_w'], wts[f'conv{i}_b'],
                                  stride=stride, padding=pad))
            i += 1
        feats.append(x)
    return feats


def lpips(img1, img2, weights=None, normalize: bool = True,
          net: str = 'vgg'):
    """img (H, W, 3) in [0, 1] (normalize=True) or [-1, 1] -> scalar."""
    if min(img1.shape[0], img1.shape[1]) < min_size(net):
        return torch.full((), float('nan'), device=img1.device)
    wts = weights if weights is not None else get_weights(img1.device, net)
    shift = torch.as_tensor(_SHIFT, device=img1.device).reshape(1, 3, 1, 1)
    scale = torch.as_tensor(_SCALE, device=img1.device).reshape(1, 3, 1, 1)

    def prep(im):
        x = im.permute(2, 0, 1)[None]                     # NCHW
        if normalize:
            x = 2.0 * x - 1.0
        return (x - shift) / scale

    total = 0.0
    for li, (a, b) in enumerate(zip(_features(prep(img1), wts, net),
                                    _features(prep(img2), wts, net))):
        na = torch.rsqrt((a * a).sum(1, keepdim=True) + 1e-10)
        nb = torch.rsqrt((b * b).sum(1, keepdim=True) + 1e-10)
        d = (a * na - b * nb) ** 2
        total = total + (d * wts[f'lin{li}_w']).sum(1).mean()
    return total
