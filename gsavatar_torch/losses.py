"""Loss terms of the training step.

Counterpart of `gsavatar/losses.py`: the `C(iteration, value)` piecewise
schedule, L1, the mask loss, the AIAP (as-isometric-as-possible) terms over
cached neighbours, the opacity entropy, the static foreground crop for
LPIPS and PSNR. The AIAP neighbour gathers go through `segsum.gather_rows`,
whose backward is a sort and K3 instead of a scatter-add."""
from __future__ import annotations

import torch

from gsavatar_torch import tracing
from gsavatar_torch.ops import knn
from gsavatar_torch.ops.segsum import gather_rows


def C(iteration: int, value):
    """Piecewise-constant schedule: a scalar passes through; a list
    [v0, it1, v1, it2, v2, ...] gives vi once iteration >= iti."""
    if isinstance(value, (int, float, str)):
        return float(value)
    value_list = [0] + list(value)
    i = 0
    while i < len(value_list):
        if iteration >= value_list[i]:
            i += 2
        else:
            break
    return float(value_list[i - 1])


def l1_loss(a, b):
    return (a - b).abs().mean()


def mask_loss(opacity_img, gt_mask, kind: str):
    """(H, W) alpha render against the ground-truth mask."""
    if kind == 'bce':
        o = torch.clamp(opacity_img, 1e-3, 1.0 - 1e-3)
        return -(gt_mask * torch.log(o)
                 + (1 - gt_mask) * torch.log(1 - o)).mean()
    if kind == 'l1':
        return (opacity_img - gt_mask).abs().mean()
    raise ValueError(kind)


def _safe_norm(x, dim=-1):
    """sqrt with an epsilon, so that duplicate points (dead slots, fresh
    clones) have a defined gradient."""
    return torch.sqrt((x * x).sum(dim) + 1e-20)


def aiap_loss(x_can, x_obs, nn_ix, alive):
    """L1 between canonical and deformed neighbour distances, masked to
    alive slots: the single-attribute form."""
    k = nn_ix.shape[1]
    flat = nn_ix.reshape(-1)
    can_nb = gather_rows(x_can, flat).reshape(-1, k, x_can.shape[-1])
    obs_nb = gather_rows(x_obs, flat).reshape(-1, k, x_obs.shape[-1])
    err = (_safe_norm(x_can[:, None, :] - can_nb)
           - _safe_norm(x_obs[:, None, :] - obs_nb)).abs()
    w = alive[:, None].to(err.dtype)
    return (err * w).sum() / torch.clamp_min(w.sum() * err.shape[1], 1.0)


def full_aiap_loss(gs_can, gs_obs, n_neighbors: int = 5, nn_ix=None):
    """Both AIAP terms (xyz, covariance) over shared canonical neighbours,
    in the JAX package's columnar (C, k, N) form: the four neighbour
    gathers (xyz and covariance, canonical and observed) are four
    `gather_rows`. Pass the cached `nn_ix` (N, k) to skip the KNN."""
    xyz_can, xyz_obs = gs_can.get_xyz, gs_obs.get_xyz
    cov_can, cov_obs = gs_can.get_covariance(), gs_obs.get_covariance()
    alive = gs_can.alive
    if nn_ix is None:
        nn_ix = knn.knn_self(xyz_can, n_neighbors, mask=alive)
    n, k = nn_ix.shape
    flat = nn_ix.T.reshape(-1)            # slot-major: block j = slot j

    def dist(x):
        c = x.shape[-1]
        nb = gather_rows(x, flat).T.reshape(c, k, n)
        d = x.T.reshape(c, 1, n) - nb
        return torch.sqrt((d * d).sum(0) + 1e-20)          # (k, N)

    err_xyz = (dist(xyz_can) - dist(xyz_obs)).abs()
    err_cov = (dist(cov_can) - dist(cov_obs)).abs()
    w = alive.to(err_xyz.dtype)[None, :]
    denom = torch.clamp_min(w.sum() * k, 1.0)
    return (err_xyz * w).sum() / denom, (err_cov * w).sum() / denom


def opacity_entropy_loss(opacity, alive):
    """Binary entropy of the opacities, masked to alive slots."""
    eps = 1e-6
    o = opacity.reshape(-1)
    ent = -(o * torch.log(o + eps) + (1 - o) * torch.log(1 - o + eps))
    w = alive.to(ent.dtype)
    return (ent * w).sum() / torch.clamp_min(w.sum(), 1.0)


def foreground_crop(render, gt, mask, crop_hw):
    """A (crop_hw) window of both images centred on the mask's centroid and
    clamped to the image (the image centre for an empty mask). The window's
    corner is read on the host (one sync), so that the crop is a slice."""
    h, w = render.shape[0], render.shape[1]
    ch, cw = min(crop_hw[0], h), min(crop_hw[1], w)
    total = torch.clamp_min(mask.sum(), 1e-6)
    ys = torch.arange(h, dtype=mask.dtype, device=mask.device)
    xs = torch.arange(w, dtype=mask.dtype, device=mask.device)
    cy = (mask.sum(1) * ys).sum() / total
    cx = (mask.sum(0) * xs).sum() / total
    y0 = torch.clamp(torch.round(cy).to(torch.int32) - ch // 2, 0, h - ch)
    x0 = torch.clamp(torch.round(cx).to(torch.int32) - cw // 2, 0, w - cw)
    y0, x0 = tracing.device_read(torch.stack([y0, x0])).tolist()
    return (render[y0:y0 + ch, x0:x0 + cw], gt[y0:y0 + ch, x0:x0 + cw])


def psnr(a, b):
    return -10.0 * torch.log10(((a - b) ** 2).mean())
