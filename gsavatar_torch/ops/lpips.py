"""LPIPS perceptual distance with the VGG16 backbone.

Counterpart of `gsavatar/ops/lpips.py` (`_NETS['vgg']`, `random_weights`,
the exported-bundle loader, `lpips`): the backbone's conv stack, unit-
normalized activations at 5 tap points, 1x1 "lin" weights, spatial mean,
layer sum; inputs scaled from [0, 1] to [-1, 1] and then by the ImageNet
constants. The backbone runs in f32 on every device: the convolutions are
`conv.conv2d_f32`, `torch.nn.functional.conv2d` with cuDNN's TF32 off in
both directions (the JAX package leaves them to XLA).

Weights: the exported .npz bundle at `weights/lpips_vgg.npz` under the
repository root when it exists, else the deterministic random backbone of
`random_weights` (numpy-seeded, so both packages build the same arrays).
`metric_key` names the metric by that source, as the JAX package does:
'lpips' for the exported bundle, 'lpips_rand' for the random backbone."""
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

_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)
_BUNDLE = Path(__file__).resolve().parents[2] / 'weights' / 'lpips_vgg.npz'


@functools.lru_cache()
def random_weights(seed: int = 0) -> Dict[str, np.ndarray]:
    """The deterministic random backbone: He-normal convs, zero biases, lin
    weights 1/C (a per-layer mean)."""
    rng = np.random.default_rng(seed)
    out = {}
    i, in_ch = 0, 3
    taps = []
    for stage in VGG:
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
def _device_weights(device: str) -> Dict[str, torch.Tensor]:
    w = dict(np.load(_BUNDLE)) if _BUNDLE.exists() else random_weights()
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
            for k, v in w.items()}


def weights_kind() -> str:
    """'exported' with the bundle, 'random' without."""
    return 'exported' if _BUNDLE.exists() else 'random'


def metric_key() -> str:
    return 'lpips' if weights_kind() == 'exported' else 'lpips_rand'


def get_weights(device) -> Dict[str, torch.Tensor]:
    return _device_weights(str(torch.device(device)))


def _features(x, wts):
    feats = []
    i = 0
    for stage in VGG:
        if stage['pool'] is not None:
            k, s = stage['pool']
            x = F.max_pool2d(x, k, s)
        for _, _, stride, pad in stage['convs']:
            x = F.relu(conv2d_f32(x, wts[f'conv{i}_w'], wts[f'conv{i}_b'],
                                  stride=stride, padding=pad))
            i += 1
        feats.append(x)
    return feats


def lpips(img1, img2, weights=None, normalize: bool = True):
    """img (H, W, 3) in [0, 1] (normalize=True) or [-1, 1] -> scalar."""
    if min(img1.shape[0], img1.shape[1]) < 2 ** (len(VGG) - 1):
        # four 2x2 pools leave the last stage an empty map, whose mean the
        # JAX package reports as NaN (torch's pool raises instead)
        return torch.full((), float('nan'), device=img1.device)
    wts = weights if weights is not None else get_weights(img1.device)
    shift = torch.as_tensor(_SHIFT, device=img1.device).reshape(1, 3, 1, 1)
    scale = torch.as_tensor(_SCALE, device=img1.device).reshape(1, 3, 1, 1)

    def prep(im):
        x = im.permute(2, 0, 1)[None]                     # NCHW
        if normalize:
            x = 2.0 * x - 1.0
        return (x - shift) / scale

    total = 0.0
    for li, (a, b) in enumerate(zip(_features(prep(img1), wts),
                                    _features(prep(img2), wts))):
        na = torch.rsqrt((a * a).sum(1, keepdim=True) + 1e-10)
        nb = torch.rsqrt((b * b).sum(1, keepdim=True) + 1e-10)
        d = (a * na - b * nb) ** 2
        total = total + (d * wts[f'lin{li}_w']).sum(1).mean()
    return total
