"""Evaluation metrics of a rendered frame.

Counterpart of `gsavatar/metrics.py`: PSNR = -10 log10 MSE (over the mask's
pixels when a mask is given), SSIM (the 3DGS window) over the mask's
bounding box, and LPIPS-VGG over that box in f32, keyed by the weight
source (`ops/lpips.py:metric_key`: 'lpips' with the exported bundle,
'lpips_rand' with the random backbone). Images are (H, W, 3) tensors in
[0, 1], masks (H, W); a mask pixel counts where it is > 0, for the PSNR as
for the box (the JAX package indexes with the mask as it is, which needs a
boolean one). `PSEvaluator`, the PeopleSnapshot bundle that
`get_evaluator('people_snapshot')` returns, scores the whole image: PSNR,
SSIM, and LPIPS with the Alex backbone in f32."""
from __future__ import annotations

import torch

from gsavatar_torch.ops import lpips as lpips_mod
from gsavatar_torch.ops.ssim import ssim


def psnr(img, gt, valid_mask=None) -> float:
    value = (img - gt) ** 2
    if valid_mask is not None:
        value = value[valid_mask > 0]
    return float(-10.0 * torch.log10(value.mean()))


def _bbox_of_mask(mask):
    """(y0, y1, x0, x1) of the pixels > 0, the whole image for an empty
    mask. One host read."""
    m = (mask > 0).cpu()
    ys = torch.nonzero(m.any(1)).flatten()
    xs = torch.nonzero(m.any(0)).flatten()
    if len(ys) == 0:
        return 0, mask.shape[0], 0, mask.shape[1]
    return int(ys[0]), int(ys[-1]) + 1, int(xs[0]), int(xs[-1]) + 1


def _crop(img, gt, valid_mask):
    if valid_mask is None:
        return img, gt
    y0, y1, x0, x1 = _bbox_of_mask(valid_mask)
    return img[y0:y1, x0:x1], gt[y0:y1, x0:x1]


def ssim_masked(img, gt, valid_mask=None) -> float:
    """SSIM over the mask's bounding box."""
    return float(ssim(*_crop(img, gt, valid_mask)))


class Evaluator:
    """The ZJU-MoCap metric bundle: PSNR over the mask, SSIM and LPIPS-VGG
    over the mask's bounding box."""

    @torch.no_grad()
    def __call__(self, img, gt, valid_mask=None) -> dict:
        a, b = _crop(img, gt, valid_mask)
        return {'psnr': psnr(img, gt, valid_mask), 'ssim': float(ssim(a, b)),
                lpips_mod.metric_key(): float(lpips_mod.lpips(a, b))}


class PSEvaluator:
    """The PeopleSnapshot metric bundle: PSNR, SSIM and LPIPS-Alex, each
    over the whole image (the mask is not used)."""

    @torch.no_grad()
    def __call__(self, img, gt, valid_mask=None) -> dict:
        return {'psnr': psnr(img, gt), 'ssim': float(ssim(img, gt)),
                lpips_mod.metric_key('alex'):
                float(lpips_mod.lpips(img, gt, net='alex'))}


def get_evaluator(dataset_name: str):
    return PSEvaluator() if dataset_name == 'people_snapshot' \
        else Evaluator()
