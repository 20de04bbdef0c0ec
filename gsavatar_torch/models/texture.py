"""Colour decoding: the latent MLP.

Counterpart of `gsavatar/models/texture.py:ColorMLP` and `_view_dirs`:
per-Gaussian feature ++ SH bases of the canonical view direction ++
non-rigid feature ++ per-frame latent -> MLP -> sigmoid RGB. The SH
texture and the optional xyz / covariance / normal inputs come with a later
slice."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from gsavatar_torch.core.gaussians import Gaussians
from gsavatar_torch.ops import sh as sh_ops
from gsavatar_torch.utils import transforms as T
from .mlp import VanillaCondMLP


def _view_dirs(gaussians: Gaussians, camera, cano_view_dir: bool,
               view_noise_rot=None):
    """Per-Gaussian unit view directions, rotated back into the canonical
    frame by R_fwd^T when asked to and when a rigid transform exists, then
    by the training-time view-noise rotation `view_noise_rot` (3, 3)."""
    dir_pp = gaussians.get_xyz - camera.camera_center[None, :]
    if cano_view_dir and gaussians.fwd_transform is not None:
        R_bwd = gaussians.fwd_transform[:, :3, :3].transpose(1, 2)
        dir_pp = T.matvec3(R_bwd, dir_pp)
        if view_noise_rot is not None:
            dir_pp = (dir_pp[..., :, None] * view_noise_rot[None]).sum(-2)
    return dir_pp / (torch.linalg.vector_norm(dir_pp, dim=1, keepdim=True)
                     + 1e-12)


class ColorMLP(nn.Module):
    def __init__(self, feature_dim: int = 32, sh_degree: int = 3,
                 cano_view_dir: bool = True, non_rigid_dim: int = 16,
                 latent_dim: int = 16, n_frames: int = 1,
                 mlp_cfg: Optional[dict] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.sh_degree = sh_degree
        self.cano_view_dir = cano_view_dir
        self.non_rigid_dim = non_rigid_dim
        self.latent_dim = latent_dim
        dim_in = (feature_dim
                  + ((sh_degree + 1) ** 2 - 1 if sh_degree > 0 else 0)
                  + non_rigid_dim + latent_dim)
        if latent_dim > 0:
            self.latent = nn.Embedding(n_frames, latent_dim)
            with torch.no_grad():
                nn.init.normal_(self.latent.weight, 0.0, 1.0,
                                generator=generator)
        cfg = mlp_cfg or {}
        self.mlp = VanillaCondMLP(
            dim_in=dim_in, dim_cond=0, dim_out=3,
            n_neurons=cfg.get('n_neurons', 64),
            n_hidden_layers=cfg.get('n_hidden_layers', 2),
            skip_in=tuple(cfg.get('skip_in', ())),
            cond_in=tuple(cfg.get('cond_in', ())),
            multires=cfg.get('multires', 0), generator=generator)

    def forward(self, gaussians: Gaussians, camera, latent_idx: int,
                view_noise_rot=None):
        feats = gaussians.get_features[..., 0]            # (N, feature_dim)
        n = feats.shape[0]
        parts = [feats]
        if self.sh_degree > 0:
            dirs = _view_dirs(gaussians, camera, self.cano_view_dir,
                              view_noise_rot)
            parts.append(sh_ops.eval_sh_bases(self.sh_degree, dirs)[:, 1:])
        if self.non_rigid_dim > 0:
            parts.append(gaussians.non_rigid_feature)
        if self.latent_dim > 0:
            parts.append(self.latent.weight[latent_idx][None].expand(
                n, self.latent_dim))
        return torch.sigmoid(self.mlp(torch.cat(parts, dim=1)))


def get_texture(cfg: dict, metadata: dict, generator=None):
    extra = [k for k in ('use_xyz', 'use_cov', 'use_normal') if cfg.get(k)]
    if cfg['name'] != 'mlp' or extra:
        raise ValueError(f"texture {cfg['name']!r} with {extra} is not part "
                         "of the render path's configuration (mlp)")
    n_frames = max(len(metadata.get('frame_dict') or {}), 1)
    return ColorMLP(
        feature_dim=cfg['feature_dim'], sh_degree=cfg.get('sh_degree', 0),
        cano_view_dir=cfg.get('cano_view_dir', False),
        non_rigid_dim=cfg.get('non_rigid_dim', 0),
        latent_dim=cfg.get('latent_dim', 0), n_frames=n_frames,
        mlp_cfg=dict(cfg.get('mlp', {}) or {}),
        generator=generator)
